// Shared device code of the fused attention backward kernels (sm_90a):
// fused_flash_bwd_dq.cu and fused_flash_bwd_dkv.cu.
//
// The two inner loops below are the whole arithmetic of a flash backward
// with the softmax statistics already known (the reference's
// _fused_dq_kernel / _fused_dkv_kernel,
// src/repro/kernels/flash_attention.py):
//   p  = exp(q.k * scale - lse)            on valid (q, k) pairs
//   ds = p * (go.v - delta + dlse) * scale
//   dq += ds * k,   dk += ds * q,   dv += p * go
// dlse is 0 in the fused kernels, whose delta already holds -g_lse.
// Everything is f32; bf16 inputs are upcast when a tile is staged.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fcp_bwd {

constexpr float kNegInf = -1e30f;
constexpr int kPad = -1;
constexpr int kThreads = 64;        // one q row (dq) or one kv row (dkv)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// MaskSpec.visible: kind 0 causal, 1 sliding_window, 2 chunked, 3 full
__device__ __forceinline__ bool visible(int kind, int window, int chunk,
                                        int pq, int pk) {
  bool ok = kind == 3 || pq >= pk;
  if (window) ok = ok && (pq - pk < window);
  if (chunk) ok = ok && (pq / chunk == pk / chunk);
  return ok;
}

// dq of one q row against one staged kv tile.  q and dq live in the
// thread's registers; go_row is the thread's own row of g_o in shared
// memory (padded, so the warp's rows fall in distinct banks); k_s / v_s
// rows are read as broadcasts.  Bit j of `valid` marks key j visible.
template <int D, int BK>
__device__ __forceinline__ void dq_tile(const float (&q)[D], float (&dq)[D],
                                        const float* go_row,
                                        const float (*k_s)[D],
                                        const float (*v_s)[D],
                                        unsigned valid, float lse,
                                        float delta, float dlse,
                                        float scale) {
#pragma unroll 4
  for (int j = 0; j < BK; ++j) {
    if (!((valid >> j) & 1u)) continue;
    float dot = 0.f, dov = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dot = fmaf(q[d], k_s[j][d], dot);
      dov = fmaf(go_row[d], v_s[j][d], dov);
    }
    const float p = expf(dot * scale - lse);
    const float ds = p * ((dov - delta) + dlse) * scale;
#pragma unroll
    for (int d = 0; d < D; ++d) dq[d] = fmaf(ds, k_s[j][d], dq[d]);
  }
}

// dk / dv of one kv row against one staged q tile of BQ rows.  dk and dv
// live in the thread's registers; k_row / v_row are the thread's own
// padded rows in shared memory; q_t / go_t rows are read as broadcasts.
template <int D, int BQ>
__device__ __forceinline__ void dkv_tile(float (&dk)[D], float (&dv)[D],
                                         const float* k_row,
                                         const float* v_row,
                                         const float (*q_t)[D],
                                         const float (*go_t)[D],
                                         const float* lse_t,
                                         const float* delta_t,
                                         const float* dlse_t,
                                         unsigned valid, float scale) {
#pragma unroll 2
  for (int i = 0; i < BQ; ++i) {
    if (!((valid >> i) & 1u)) continue;
    float dot = 0.f, dov = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dot = fmaf(q_t[i][d], k_row[d], dot);
      dov = fmaf(go_t[i][d], v_row[d], dov);
    }
    const float p = expf(dot * scale - lse_t[i]);
    const float ds = p * ((dov - delta_t[i]) + dlse_t[i]) * scale;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dv[d] = fmaf(p, go_t[i][d], dv[d]);
      dk[d] = fmaf(ds, q_t[i][d], dk[d]);
    }
  }
}

}  // namespace fcp_bwd
