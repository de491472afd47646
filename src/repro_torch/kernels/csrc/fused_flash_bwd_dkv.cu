// Fused schedule-driven flash-attention backward, dk/dv, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// fused_flash_bwd_dkv (_fused_dkv_kernel, launched by pl.pallas_call at
// :708).  One launch computes d kxt / d vxt of one executor run for ALL
// stacked workers, per extended-buffer row, summed over every step that
// consumes the row, every GQA member of its kv head and every q tile:
//   p = exp(s - L),  ds = p * (g_o . v - delta) * scale,
//   dv += p^T . g_o,  dk += ds^T . q
// with the run-final lse L and delta = g_o . o_out - g_lse of each q row
// (ops._fused_pl_bwd).
//
// Grid: Pallas walks (kh, kv-tile, step, group, q-tile) over the
// kv-sorted bwd_q/bwd_kv tables and carries dk/dv scratch across one kv
// row's steps.  Here a host segment table over bwd_kv (one (lo, hi) step
// range per distinct extended-buffer row, steps on the kv trash row
// excluded) gives one block one (worker, kv-row segment, kv head, kv
// tile): it loops over the segment's steps, the kv head's H/KH group
// members and the q slot's q tiles, accumulates dk and dv in f32
// registers and writes once.  No atomics: a run is bitwise
// reproducible.  Rows no segment names are never written (the wrapper
// allocates zeros: the reference's _visited mask).
//
// What bounds it on the H100: f32 FMA throughput on the CUDA cores (4
// D-long FMA chains per valid pair, no tensor cores).  One kv row per thread
// (dk, dv in registers, the row's k and v in padded shared rows), q and
// g_o tiles staged once per block as f32 and read as broadcasts, and a
// q tile no key of the block can see is skipped before its bytes load
// (causal runs skip the q tiles above the diagonal).
//
// Layouts (row-major, contiguous; N = stacked workers):
//   qs [N, SL, H, bs, D], kxt/vxt [N, EX, KH, bs, D] (f32 or bf16)
//   bwd_q/bwd_kv [N, S] (kv-row-sorted); q_seg/q_pos [N, SL, bs];
//   k_seg/k_pos [N, S, bs] (kv metadata in bwd order); seg_lo/seg_hi
//   [N, G]; lse/delta [N, SL, H, bs] f32; go [N, SL, H, bs, D] f32;
//   dk/dv [N, EX, KH, bs, D] f32 (written only on segment rows).

#include "attn_bwd_common.cuh"

namespace {

using namespace fcp_bwd;

template <typename T, int D, int BQ>
__global__ void __launch_bounds__(kThreads) fused_dkv_kernel(
    const T* __restrict__ qs, const T* __restrict__ kxt,
    const T* __restrict__ vxt, const int* __restrict__ bwd_q,
    const int* __restrict__ bwd_kv, const int* __restrict__ q_seg,
    const int* __restrict__ q_pos, const int* __restrict__ k_seg,
    const int* __restrict__ k_pos, const int* __restrict__ seg_lo,
    const int* __restrict__ seg_hi, const float* __restrict__ lse,
    const float* __restrict__ go, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int SL, int EX, int S,
    int G, int H, int KH, int bs, float scale, int kind, int window,
    int chunk) {
  static_assert(BQ <= 32, "validity bits live in one 32-bit word");
  constexpr int P = D + 1;                    // padded own rows
  const int n = blockIdx.z / G;
  const int g = blockIdx.z % G;
  const int lo = seg_lo[n * G + g];
  const int hi = seg_hi[n * G + g];
  if (lo >= hi) return;                       // block-uniform exit
  const int kh = blockIdx.y;
  const int group = H / KH;
  const int tid = threadIdx.x;
  const int kr = blockIdx.x * kThreads + tid;
  const bool live = kr < bs;
  const int kv = bwd_kv[n * S + lo];

  __shared__ float k_s[kThreads * P];
  __shared__ float v_s[kThreads * P];
  __shared__ __align__(16) float q_t[BQ][D];
  __shared__ __align__(16) float go_t[BQ][D];
  __shared__ float lse_t[BQ];
  __shared__ float dl_t[BQ];
  __shared__ float zero_t[BQ];
  __shared__ int qseg_t[BQ];
  __shared__ int qpos_t[BQ];

  float* k_row = k_s + tid * P;
  float* v_row = v_s + tid * P;
  float ak[D], av[D];
  const size_t krow = (((size_t)n * EX + kv) * KH + kh) * bs + kr;
  if (live) {
    const T* kp = kxt + krow * D;
    const T* vp = vxt + krow * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      k_row[d] = to_f32(kp[d]);
      v_row[d] = to_f32(vp[d]);
      ak[d] = av[d] = 0.f;
    }
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) k_row[d] = v_row[d] = ak[d] = av[d] = 0.f;
  }
  for (int i = tid; i < BQ; i += kThreads) zero_t[i] = 0.f;

  for (int s = lo; s < hi; ++s) {
    const int slot = bwd_q[n * S + s];
    // all steps of the segment read the same kv block: same metadata
    int sk = kPad, pk = 0;
    if (live) {
      sk = k_seg[((size_t)n * S + s) * bs + kr];
      pk = k_pos[((size_t)n * S + s) * bs + kr];
    }
    const int* qsg = q_seg + ((size_t)n * SL + slot) * bs;
    const int* qps = q_pos + ((size_t)n * SL + slot) * bs;
    for (int m = 0; m < group; ++m) {
      const int h = kh * group + m;
      const size_t hrow = (((size_t)n * SL + slot) * H + h) * bs;
      for (int q0 = 0; q0 < bs; q0 += BQ) {
        __syncthreads();                      // last tile's readers done
        for (int i = tid; i < BQ; i += kThreads) {
          const int qq = q0 + i;
          const bool in = qq < bs;
          qseg_t[i] = in ? qsg[qq] : kPad;    // past the block: invalid
          qpos_t[i] = in ? qps[qq] : 0;
          lse_t[i] = in ? lse[hrow + qq] : 0.f;
          dl_t[i] = in ? delta[hrow + qq] : 0.f;
        }
        __syncthreads();
        unsigned valid = 0u;
        if (live && sk != kPad) {
#pragma unroll
          for (int i = 0; i < BQ; ++i)
            if (qseg_t[i] == sk && visible(kind, window, chunk, qpos_t[i], pk))
              valid |= 1u << i;
        }
        if (!__syncthreads_or(valid != 0u)) continue;
        for (int e = tid; e < BQ * D; e += kThreads) {
          const int i = e / D, d = e - i * D, qq = q0 + i;
          const bool in = qq < bs;
          q_t[i][d] = in ? to_f32(qs[(hrow + qq) * D + d]) : 0.f;
          go_t[i][d] = in ? go[(hrow + qq) * D + d] : 0.f;
        }
        __syncthreads();
        if (valid == 0u) continue;
        dkv_tile<D, BQ>(ak, av, k_row, v_row, q_t, go_t, lse_t, dl_t,
                        zero_t, valid, scale);
      }
    }
  }

  if (live) {
    float* kp = dk + krow * D;
    float* vp = dv + krow * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      kp[d] = ak[d];
      vp[d] = av[d];
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* qs, const void* kxt, const void* vxt,
                   const int* bwd_q, const int* bwd_kv, const int* q_seg,
                   const int* q_pos, const int* k_seg, const int* k_pos,
                   const int* seg_lo, const int* seg_hi, const float* lse,
                   const float* go, const float* delta, float* dk, float* dv,
                   int N, int SL, int EX, int S, int G, int H, int KH,
                   int bs, float scale, int kind, int window, int chunk,
                   cudaStream_t stream) {
  constexpr int BQ = D > 32 ? 16 : 32;        // static shared memory < 48 KB
  const dim3 grid((bs + kThreads - 1) / kThreads, KH, N * G);
  fused_dkv_kernel<T, D, BQ><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(qs), static_cast<const T*>(kxt),
      static_cast<const T*>(vxt), bwd_q, bwd_kv, q_seg, q_pos, k_seg, k_pos,
      seg_lo, seg_hi, lse, go, delta, dk, dv, SL, EX, S, G, H, KH, bs, scale,
      kind, window, chunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* qs, const void* kxt,
                       const void* vxt, const int* bwd_q, const int* bwd_kv,
                       const int* q_seg, const int* q_pos, const int* k_seg,
                       const int* k_pos, const int* seg_lo,
                       const int* seg_hi, const float* lse, const float* go,
                       const float* delta, float* dk, float* dv, int N,
                       int SL, int EX, int S, int G, int H, int KH, int bs,
                       float scale, int kind, int window, int chunk,
                       cudaStream_t stream) {
#define FCP_CASE(DD)                                                       \
  case DD:                                                                 \
    return launch<T, DD>(qs, kxt, vxt, bwd_q, bwd_kv, q_seg, q_pos, k_seg, \
                         k_pos, seg_lo, seg_hi, lse, go, delta, dk, dv, N, \
                         SL, EX, S, G, H, KH, bs, scale, kind, window,     \
                         chunk, stream);
  switch (D) {
    FCP_CASE(32)
    FCP_CASE(64)
    default:
      return cudaErrorInvalidValue;
  }
#undef FCP_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (qs, kxt and vxt share it).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int fcp_fused_flash_bwd_dkv(
    const void* qs, const void* kxt, const void* vxt, const void* bwd_q,
    const void* bwd_kv, const void* q_seg, const void* q_pos,
    const void* k_seg, const void* k_pos, const void* seg_lo,
    const void* seg_hi, const void* lse, const void* go, const void* delta,
    void* dk, void* dv, int N, int SL, int EX, int S, int G, int H, int KH,
    int bs, int D, int dtype, float scale, int kind, int window, int chunk,
    void* stream) {
  if (N * G == 0) return 0;
  const auto* bq = static_cast<const int*>(bwd_q);
  const auto* bkv = static_cast<const int*>(bwd_kv);
  const auto* qsg = static_cast<const int*>(q_seg);
  const auto* qps = static_cast<const int*>(q_pos);
  const auto* ksg = static_cast<const int*>(k_seg);
  const auto* kps = static_cast<const int*>(k_pos);
  const auto* slo = static_cast<const int*>(seg_lo);
  const auto* shi = static_cast<const int*>(seg_hi);
  const auto* L = static_cast<const float*>(lse);
  const auto* g = static_cast<const float*>(go);
  const auto* dl = static_cast<const float*>(delta);
  auto* ok = static_cast<float*>(dk);
  auto* ov = static_cast<float*>(dv);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, qs, kxt, vxt, bq, bkv, qsg, qps, ksg, kps,
                             slo, shi, L, g, dl, ok, ov, N, SL, EX, S, G, H,
                             KH, bs, scale, kind, window, chunk, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, qs, kxt, vxt, bq, bkv, qsg, qps,
                                     ksg, kps, slo, shi, L, g, dl, ok, ov, N,
                                     SL, EX, S, G, H, KH, bs, scale, kind,
                                     window, chunk, st);
  return cudaErrorInvalidValue;
}
