// Fused schedule-driven flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// fused_flash_fwd (_fused_fwd_kernel, launched by pl.pallas_call at :463).
// One launch computes one executor run for ALL stacked workers: for every
// q slot the run visits, an online softmax over the slot's contiguous
// steps, seeded from the incoming accumulator as (acc, m, l) =
// (o_in, lse_in, 1), finalized as o = acc / l, lse = m + log l.
//
// Why the TPU grid is not carried over: Pallas walks (h, q-tile, step,
// kv-tile) in order and carries the (acc, m, l) scratch across the step
// axis with first/last flags.  GPU blocks run in parallel and in no
// order, so that grid would race.  Instead a host table splits each
// worker's q-slot-sorted steps into segments (one (lo, hi) per distinct
// q slot), and one block owns one (worker, segment, head, q-tile): it
// seeds from the accumulator, loops over its segment's steps and each
// step's kv tiles, and writes once.  No atomics, so the merge order is
// fixed and a run is bitwise reproducible.
//
// What bounds it on the H100: this first version multiplies on the CUDA
// cores in f32 (no wgmma), so it is bound by f32 FMA issue, far below the
// bf16 tensor-core roofline the work would allow.  The design keeps the
// rest cheap: each thread owns one q row (q and the accumulator live in
// registers), K/V tiles are staged once per block in shared memory as f32
// and read as broadcasts, tiles that no row of the block can see (causal
// or cross-document) are skipped before their K/V bytes are loaded, and
// the accumulators touch device memory once per run.  Tensor-core tiles
// (wgmma + TMA) are the next step.
//
// Layouts (row-major, contiguous; N = stacked workers):
//   qs [N, SL, H, bs, D], kxt/vxt [N, EX, KH, bs, D] (f32 or bf16)
//   step_q/step_kv [N, S]; q_seg/q_pos [N, SL, bs]; k_seg/k_pos [N, S, bs]
//   seg_lo/seg_hi [N, G]  (empty segments have lo == hi)
//   acc_o [N, SL, H, bs, D] f32, acc_lse [N, SL, H, bs] f32 — updated in
//   place: only the slots some segment names are written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;   // finite: the seed rescale needs it
constexpr int kPad = -1;
constexpr int kThreads = 64;        // one q row per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// MaskSpec.visible: kind 0 causal, 1 sliding_window, 2 chunked, 3 full
__device__ __forceinline__ bool visible(int kind, int window, int chunk,
                                        int pq, int pk) {
  bool ok = kind == 3 || pq >= pk;
  if (window) ok = ok && (pq - pk < window);
  if (chunk) ok = ok && (pq / chunk == pk / chunk);
  return ok;
}

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads) fused_fwd_kernel(
    const T* __restrict__ qs, const T* __restrict__ kxt,
    const T* __restrict__ vxt, const int* __restrict__ step_q,
    const int* __restrict__ step_kv, const int* __restrict__ q_seg,
    const int* __restrict__ q_pos, const int* __restrict__ k_seg,
    const int* __restrict__ k_pos, const int* __restrict__ seg_lo,
    const int* __restrict__ seg_hi, float* __restrict__ acc_o,
    float* __restrict__ acc_lse, int SL, int EX, int S, int G, int H,
    int KH, int bs, float scale, int kind, int window, int chunk) {
  static_assert(BK <= 32, "validity bits live in one 32-bit word");
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
  __shared__ int kseg_s[BK];
  __shared__ int kpos_s[BK];

  float q[D], acc[D];
  float m = kNegInf, l = 1.f;
  int sq = kPad, pq = 0;
  const size_t qrow = (((size_t)n * SL + slot) * H + h) * bs + row;
  if (live) {
    const T* qp = qs + qrow * D;
    const float* ap = acc_o + qrow * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      q[d] = to_f32(qp[d]);
      acc[d] = ap[d];
    }
    m = acc_lse[qrow];
    sq = q_seg[((size_t)n * SL + slot) * bs + row];
    pq = q_pos[((size_t)n * SL + slot) * bs + row];
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) q[d] = acc[d] = 0.f;
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
      // a tile no row of the block can see leaves (acc, m, l) unchanged
      if (!__syncthreads_or(valid != 0u)) continue;
      for (int i = tid; i < BK * D; i += kThreads) {
        const int j = i / D, kk = k0 + j;
        const size_t off = (kvbase + kk) * D + (i - j * D);
        k_s[j][i - j * D] = kk < bs ? to_f32(kxt[off]) : 0.f;
        v_s[j][i - j * D] = kk < bs ? to_f32(vxt[off]) : 0.f;
      }
      __syncthreads();
      if (valid == 0u) continue;              // exact: alpha = 1, p = 0
      float sc[BK];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < BK; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) dot = fmaf(q[d], k_s[j][d], dot);
        sc[j] = (valid >> j) & 1u ? dot * scale : kNegInf;
        mx = fmaxf(mx, sc[j]);
      }
      const float m_new = fmaxf(m, mx);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < BK; ++j) {
        const float p = (valid >> j) & 1u ? expf(sc[j] - m_new) : 0.f;
        l += p;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] = fmaf(p, v_s[j][d], acc[d]);
      }
      m = m_new;
    }
  }

  if (live) {
    const float ls = fmaxf(l, 1e-37f);        // >= alpha * 1 + mass > 0
    float* ap = acc_o + qrow * D;
#pragma unroll
    for (int d = 0; d < D; ++d) ap[d] = acc[d] / ls;
    acc_lse[qrow] = m + logf(ls);
  }
}

template <typename T, int D>
cudaError_t launch(const void* qs, const void* kxt, const void* vxt,
                   const int* step_q, const int* step_kv, const int* q_seg,
                   const int* q_pos, const int* k_seg, const int* k_pos,
                   const int* seg_lo, const int* seg_hi, float* acc_o,
                   float* acc_lse, int N, int SL, int EX, int S, int G,
                   int H, int KH, int bs, float scale, int kind, int window,
                   int chunk, cudaStream_t stream) {
  constexpr int BK = D > 64 ? 16 : 32;        // registers: q, acc, scores
  const dim3 grid((bs + kThreads - 1) / kThreads, H, N * G);
  fused_fwd_kernel<T, D, BK><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(qs), static_cast<const T*>(kxt),
      static_cast<const T*>(vxt), step_q, step_kv, q_seg, q_pos, k_seg,
      k_pos, seg_lo, seg_hi, acc_o, acc_lse, SL, EX, S, G, H, KH, bs, scale,
      kind, window, chunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* qs, const void* kxt,
                       const void* vxt, const int* step_q,
                       const int* step_kv, const int* q_seg,
                       const int* q_pos, const int* k_seg, const int* k_pos,
                       const int* seg_lo, const int* seg_hi, float* acc_o,
                       float* acc_lse, int N, int SL, int EX, int S, int G,
                       int H, int KH, int bs, float scale, int kind,
                       int window, int chunk, cudaStream_t stream) {
#define FCP_CASE(DD)                                                       \
  case DD:                                                                 \
    return launch<T, DD>(qs, kxt, vxt, step_q, step_kv, q_seg, q_pos,      \
                         k_seg, k_pos, seg_lo, seg_hi, acc_o, acc_lse, N,  \
                         SL, EX, S, G, H, KH, bs, scale, kind, window,     \
                         chunk, stream);
  switch (D) {
    FCP_CASE(32)
    FCP_CASE(64)
    FCP_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef FCP_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (qs, kxt and vxt share it).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int fcp_fused_flash_fwd(
    const void* qs, const void* kxt, const void* vxt, const void* step_q,
    const void* step_kv, const void* q_seg, const void* q_pos,
    const void* k_seg, const void* k_pos, const void* seg_lo,
    const void* seg_hi, void* acc_o, void* acc_lse, int N, int SL, int EX,
    int S, int G, int H, int KH, int bs, int D, int dtype, float scale,
    int kind, int window, int chunk, void* stream) {
  if (N * G == 0) return 0;
  const auto* sq = static_cast<const int*>(step_q);
  const auto* skv = static_cast<const int*>(step_kv);
  const auto* qsg = static_cast<const int*>(q_seg);
  const auto* qps = static_cast<const int*>(q_pos);
  const auto* ksg = static_cast<const int*>(k_seg);
  const auto* kps = static_cast<const int*>(k_pos);
  const auto* slo = static_cast<const int*>(seg_lo);
  const auto* shi = static_cast<const int*>(seg_hi);
  auto* ao = static_cast<float*>(acc_o);
  auto* al = static_cast<float*>(acc_lse);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, qs, kxt, vxt, sq, skv, qsg, qps, ksg, kps,
                             slo, shi, ao, al, N, SL, EX, S, G, H, KH, bs,
                             scale, kind, window, chunk, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, qs, kxt, vxt, sq, skv, qsg, qps,
                                     ksg, kps, slo, shi, ao, al, N, SL, EX,
                                     S, G, H, KH, bs, scale, kind, window,
                                     chunk, st);
  return cudaErrorInvalidValue;
}
