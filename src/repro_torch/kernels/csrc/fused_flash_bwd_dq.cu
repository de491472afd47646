// Fused schedule-driven flash-attention backward, dq, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// fused_flash_bwd_dq (_fused_dq_kernel, launched by pl.pallas_call at
// :581).  One launch computes d qs of one executor run for ALL stacked
// workers.  The gradient of a run's merge chain collapses onto the
// run-final softmax stats (ops._fused_pl_bwd): for every step of a q slot
//   ds = exp(s - L) * (g_o . v - delta) * scale,  dq += ds . k
// with L the run-final lse of the slot and delta = g_o . o_out - g_lse,
// so no per-step lse is needed.
//
// Grid: as the forward (fused_flash_fwd.cu).  Pallas walks (h, q-tile,
// step, kv-tile) in order and carries the dq scratch across a q slot's
// steps; GPU blocks run in parallel and in no order.  The forward's host
// segment table (one (lo, hi) step range per distinct q slot of the
// q-slot-sorted run, trash steps excluded) gives one block one (worker,
// segment, head, q tile): it loops over the segment's steps and each
// step's kv tiles, accumulates dq in f32 registers and writes once.  No
// atomics, so a run is bitwise reproducible.  Slots no segment names are
// never written: the wrapper allocates dq with zeros (the reference's
// _visited mask).
//
// What bounds it on the H100: f32 FMA throughput on the CUDA cores (3
// D-long FMA chains per valid (q, k) pair, no tensor cores), far below
// the bf16 roofline.  The design keeps the rest cheap as the forward does:
// one q row per thread (q and dq in registers, g_o in a padded shared
// row), K/V tiles staged once per block as f32 and read as broadcasts,
// and tiles no row of the block can see are skipped before their bytes
// are loaded.
//
// Layouts (row-major, contiguous; N = stacked workers):
//   qs [N, SL, H, bs, D], kxt/vxt [N, EX, KH, bs, D] (f32 or bf16)
//   step_q/step_kv [N, S]; q_seg/q_pos [N, SL, bs]; k_seg/k_pos [N, S, bs]
//   seg_lo/seg_hi [N, G]; lse/delta [N, SL, H, bs] f32; go [N, SL, H, bs, D]
//   f32; dq [N, SL, H, bs, D] f32 (written only on segment slots).

#include "attn_bwd_common.cuh"

namespace {

using namespace fcp_bwd;

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads) fused_dq_kernel(
    const T* __restrict__ qs, const T* __restrict__ kxt,
    const T* __restrict__ vxt, const int* __restrict__ step_q,
    const int* __restrict__ step_kv, const int* __restrict__ q_seg,
    const int* __restrict__ q_pos, const int* __restrict__ k_seg,
    const int* __restrict__ k_pos, const int* __restrict__ seg_lo,
    const int* __restrict__ seg_hi, const float* __restrict__ lse,
    const float* __restrict__ go, const float* __restrict__ delta,
    float* __restrict__ dq, int SL, int EX, int S, int G, int H, int KH,
    int bs, float scale, int kind, int window, int chunk) {
  static_assert(BK <= 32, "validity bits live in one 32-bit word");
  constexpr int P = D + 1;                    // padded g_o row
  const int n = blockIdx.z / G;
  const int g = blockIdx.z % G;
  const int lo = seg_lo[n * G + g];
  const int hi = seg_hi[n * G + g];
  if (lo >= hi) return;                       // block-uniform exit
  const int h = blockIdx.y;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x;
  const int row = blockIdx.x * kThreads + tid;
  const bool live = row < bs;
  const int slot = step_q[n * S + lo];

  __shared__ __align__(16) float k_s[BK][D];
  __shared__ __align__(16) float v_s[BK][D];
  __shared__ float go_s[kThreads * P];
  __shared__ int kseg_s[BK];
  __shared__ int kpos_s[BK];

  float q[D], acc[D];
  float L = 0.f, dl = 0.f;
  int sq = kPad, pq = 0;
  const size_t qrow = (((size_t)n * SL + slot) * H + h) * bs + row;
  float* go_row = go_s + tid * P;
  if (live) {
    const T* qp = qs + qrow * D;
    const float* gp = go + qrow * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      q[d] = to_f32(qp[d]);
      go_row[d] = gp[d];
      acc[d] = 0.f;
    }
    L = lse[qrow];
    dl = delta[qrow];
    sq = q_seg[((size_t)n * SL + slot) * bs + row];
    pq = q_pos[((size_t)n * SL + slot) * bs + row];
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) q[d] = acc[d] = go_row[d] = 0.f;
  }

  for (int s = lo; s < hi; ++s) {
    const int kv = step_kv[n * S + s];
    const size_t kvbase = (((size_t)n * EX + kv) * KH + kh) * bs;
    const int* ksg = k_seg + ((size_t)n * S + s) * bs;
    const int* kps = k_pos + ((size_t)n * S + s) * bs;
    for (int k0 = 0; k0 < bs; k0 += BK) {
      __syncthreads();                        // last tile's readers done
      for (int j = tid; j < BK; j += kThreads) {
        const int kk = k0 + j;
        kseg_s[j] = kk < bs ? ksg[kk] : kPad;  // past the block: invalid
        kpos_s[j] = kk < bs ? kps[kk] : 0;
      }
      __syncthreads();
      unsigned valid = 0u;
      if (live && sq != kPad) {
#pragma unroll
        for (int j = 0; j < BK; ++j)
          if (kseg_s[j] == sq && visible(kind, window, chunk, pq, kpos_s[j]))
            valid |= 1u << j;
      }
      if (!__syncthreads_or(valid != 0u)) continue;
      for (int i = tid; i < BK * D; i += kThreads) {
        const int j = i / D, kk = k0 + j;
        const size_t off = (kvbase + kk) * D + (i - j * D);
        k_s[j][i - j * D] = kk < bs ? to_f32(kxt[off]) : 0.f;
        v_s[j][i - j * D] = kk < bs ? to_f32(vxt[off]) : 0.f;
      }
      __syncthreads();
      if (valid == 0u) continue;
      dq_tile<D, BK>(q, acc, go_row, k_s, v_s, valid, L, dl, 0.f, scale);
    }
  }

  if (live) {
    float* op = dq + qrow * D;
#pragma unroll
    for (int d = 0; d < D; ++d) op[d] = acc[d];
  }
}

template <typename T, int D>
cudaError_t launch(const void* qs, const void* kxt, const void* vxt,
                   const int* step_q, const int* step_kv, const int* q_seg,
                   const int* q_pos, const int* k_seg, const int* k_pos,
                   const int* seg_lo, const int* seg_hi, const float* lse,
                   const float* go, const float* delta, float* dq, int N,
                   int SL, int EX, int S, int G, int H, int KH, int bs,
                   float scale, int kind, int window, int chunk,
                   cudaStream_t stream) {
  constexpr int BK = 32;
  const dim3 grid((bs + kThreads - 1) / kThreads, H, N * G);
  fused_dq_kernel<T, D, BK><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(qs), static_cast<const T*>(kxt),
      static_cast<const T*>(vxt), step_q, step_kv, q_seg, q_pos, k_seg,
      k_pos, seg_lo, seg_hi, lse, go, delta, dq, SL, EX, S, G, H, KH, bs,
      scale, kind, window, chunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* qs, const void* kxt,
                       const void* vxt, const int* step_q,
                       const int* step_kv, const int* q_seg,
                       const int* q_pos, const int* k_seg, const int* k_pos,
                       const int* seg_lo, const int* seg_hi,
                       const float* lse, const float* go,
                       const float* delta, float* dq, int N, int SL, int EX,
                       int S, int G, int H, int KH, int bs, float scale,
                       int kind, int window, int chunk,
                       cudaStream_t stream) {
#define FCP_CASE(DD)                                                       \
  case DD:                                                                 \
    return launch<T, DD>(qs, kxt, vxt, step_q, step_kv, q_seg, q_pos,      \
                         k_seg, k_pos, seg_lo, seg_hi, lse, go, delta, dq, \
                         N, SL, EX, S, G, H, KH, bs, scale, kind, window,  \
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
extern "C" int fcp_fused_flash_bwd_dq(
    const void* qs, const void* kxt, const void* vxt, const void* step_q,
    const void* step_kv, const void* q_seg, const void* q_pos,
    const void* k_seg, const void* k_pos, const void* seg_lo,
    const void* seg_hi, const void* lse, const void* go, const void* delta,
    void* dq, int N, int SL, int EX, int S, int G, int H, int KH, int bs,
    int D, int dtype, float scale, int kind, int window, int chunk,
    void* stream) {
  if (N * G == 0) return 0;
  const auto* sq = static_cast<const int*>(step_q);
  const auto* skv = static_cast<const int*>(step_kv);
  const auto* qsg = static_cast<const int*>(q_seg);
  const auto* qps = static_cast<const int*>(q_pos);
  const auto* ksg = static_cast<const int*>(k_seg);
  const auto* kps = static_cast<const int*>(k_pos);
  const auto* slo = static_cast<const int*>(seg_lo);
  const auto* shi = static_cast<const int*>(seg_hi);
  const auto* L = static_cast<const float*>(lse);
  const auto* g = static_cast<const float*>(go);
  const auto* dl = static_cast<const float*>(delta);
  auto* out = static_cast<float*>(dq);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, qs, kxt, vxt, sq, skv, qsg, qps, ksg, kps,
                             slo, shi, L, g, dl, out, N, SL, EX, S, G, H, KH,
                             bs, scale, kind, window, chunk, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, qs, kxt, vxt, sq, skv, qsg, qps,
                                     ksg, kps, slo, shi, L, g, dl, out, N,
                                     SL, EX, S, G, H, KH, bs, scale, kind,
                                     window, chunk, st);
  return cudaErrorInvalidValue;
}
