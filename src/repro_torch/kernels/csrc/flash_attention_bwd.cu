// Varlen flash-attention backward for Hopper (sm_90a): dq, and dk/dv.
//
// Replaces the TPU kernels of src/repro/kernels/flash_attention.py:
// flash_attention_bwd — _bwd_dq_kernel (launched by pl.pallas_call at
// :264) and _bwd_dkv_kernel (at :289).  They are the backward of
// flash_attention_fwd.cu on the per-step executor path: one (q, kv)
// block pair per batch row, with the cotangent of the lse output
// (dlse), which is non-zero because every partial feeds a flash merge:
//   p = exp(s - lse),  ds = p * (do . v - delta + dlse) * scale
//   dq = ds . k,  dk = sum over group members of ds^T . q,  dv = p^T . do
// delta = sum(do * o) is computed by the wrapper, as the reference
// computes it outside its kernel.
//
// Grid: Pallas walks the kv tiles (dq) or the (group member, q tile)
// pairs (dk/dv) in order and carries the sum in VMEM scratch.  Here the
// sequential axis is a loop inside the block: dq — one block per
// (batch row, head, 64 q rows), looping over the kv tiles; dk/dv — one
// block per (batch row, kv head, 64 kv rows), looping over the group
// members and q tiles.  Sums stay in f32 registers and are written once
// in the input dtype.  No atomics.
//
// What bounds it on the H100: f32 FMA throughput on the CUDA cores (3
// and 4 D-long FMA chains per valid pair), as in the fused backward
// kernels, whose inner loops these share (attn_bwd_common.cuh).  Tiles
// no row of the block can see are skipped before their bytes load.
//
// Layouts (row-major, contiguous): q/do [B, H, Sq, D] (do f32), k/v
// [B, KH, Sk, D]; seg_q/pos_q [B, Sq], seg_k/pos_k [B, Sk];
// lse/delta/dlse [B, H, Sq] f32; dq [B, H, Sq, D], dk/dv [B, KH, Sk, D]
// in the dtype of q/k/v.

#include "attn_bwd_common.cuh"

namespace {

using namespace fcp_bwd;

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads) bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ seg_q,
    const int* __restrict__ pos_q, const int* __restrict__ seg_k,
    const int* __restrict__ pos_k, const float* __restrict__ lse,
    const float* __restrict__ dout, const float* __restrict__ delta,
    const float* __restrict__ dlse, T* __restrict__ dq, int H, int KH,
    int Sq, int Sk, float scale, int kind, int window, int chunk) {
  static_assert(BK <= 32, "validity bits live in one 32-bit word");
  constexpr int P = D + 1;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x;
  const int row = blockIdx.x * kThreads + tid;
  const bool live = row < Sq;

  __shared__ __align__(16) float k_s[BK][D];
  __shared__ __align__(16) float v_s[BK][D];
  __shared__ float go_s[kThreads * P];
  __shared__ int kseg_s[BK];
  __shared__ int kpos_s[BK];

  float qr[D], acc[D];
  float L = 0.f, dl = 0.f, dls = 0.f;
  int sq = kPad, pq = 0;
  const size_t qrow = ((size_t)b * H + h) * Sq + row;
  float* go_row = go_s + tid * P;
  if (live) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qr[d] = to_f32(q[qrow * D + d]);
      go_row[d] = dout[qrow * D + d];
      acc[d] = 0.f;
    }
    L = lse[qrow];
    dl = delta[qrow];
    dls = dlse[qrow];
    sq = seg_q[(size_t)b * Sq + row];
    pq = pos_q[(size_t)b * Sq + row];
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = acc[d] = go_row[d] = 0.f;
  }
  const size_t kvbase = ((size_t)b * KH + kh) * Sk;
  const int* ksg = seg_k + (size_t)b * Sk;
  const int* kps = pos_k + (size_t)b * Sk;

  for (int k0 = 0; k0 < Sk; k0 += BK) {
    __syncthreads();
    for (int j = tid; j < BK; j += kThreads) {
      const int kk = k0 + j;
      kseg_s[j] = kk < Sk ? ksg[kk] : kPad;
      kpos_s[j] = kk < Sk ? kps[kk] : 0;
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
      k_s[j][i - j * D] = kk < Sk ? to_f32(k[off]) : 0.f;
      v_s[j][i - j * D] = kk < Sk ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();
    if (valid == 0u) continue;
    dq_tile<D, BK>(qr, acc, go_row, k_s, v_s, valid, L, dl, dls, scale);
  }

  if (live) {
#pragma unroll
    for (int d = 0; d < D; ++d) dq[qrow * D + d] = from_f32<T>(acc[d]);
  }
}

template <typename T, int D, int BQ>
__global__ void __launch_bounds__(kThreads) bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ seg_q,
    const int* __restrict__ pos_q, const int* __restrict__ seg_k,
    const int* __restrict__ pos_k, const float* __restrict__ lse,
    const float* __restrict__ dout, const float* __restrict__ delta,
    const float* __restrict__ dlse, T* __restrict__ dk,
    T* __restrict__ dv, int H, int KH, int Sq, int Sk, float scale,
    int kind, int window, int chunk) {
  static_assert(BQ <= 32, "validity bits live in one 32-bit word");
  constexpr int P = D + 1;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int group = H / KH;
  const int tid = threadIdx.x;
  const int kr = blockIdx.x * kThreads + tid;
  const bool live = kr < Sk;

  __shared__ float k_s[kThreads * P];
  __shared__ float v_s[kThreads * P];
  __shared__ __align__(16) float q_t[BQ][D];
  __shared__ __align__(16) float go_t[BQ][D];
  __shared__ float lse_t[BQ];
  __shared__ float dl_t[BQ];
  __shared__ float dls_t[BQ];
  __shared__ int qseg_t[BQ];
  __shared__ int qpos_t[BQ];

  float* k_row = k_s + tid * P;
  float* v_row = v_s + tid * P;
  float ak[D], av[D];
  const size_t krow = ((size_t)b * KH + kh) * Sk + kr;
  int sk = kPad, pk = 0;
  if (live) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      k_row[d] = to_f32(k[krow * D + d]);
      v_row[d] = to_f32(v[krow * D + d]);
      ak[d] = av[d] = 0.f;
    }
    sk = seg_k[(size_t)b * Sk + kr];
    pk = pos_k[(size_t)b * Sk + kr];
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) k_row[d] = v_row[d] = ak[d] = av[d] = 0.f;
  }
  const int* qsg = seg_q + (size_t)b * Sq;
  const int* qps = pos_q + (size_t)b * Sq;

  for (int m = 0; m < group; ++m) {
    const size_t hrow = ((size_t)b * H + kh * group + m) * Sq;
    for (int q0 = 0; q0 < Sq; q0 += BQ) {
      __syncthreads();
      for (int i = tid; i < BQ; i += kThreads) {
        const int qq = q0 + i;
        const bool in = qq < Sq;
        qseg_t[i] = in ? qsg[qq] : kPad;
        qpos_t[i] = in ? qps[qq] : 0;
        lse_t[i] = in ? lse[hrow + qq] : 0.f;
        dl_t[i] = in ? delta[hrow + qq] : 0.f;
        dls_t[i] = in ? dlse[hrow + qq] : 0.f;
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
        const bool in = qq < Sq;
        q_t[i][d] = in ? to_f32(q[(hrow + qq) * D + d]) : 0.f;
        go_t[i][d] = in ? dout[(hrow + qq) * D + d] : 0.f;
      }
      __syncthreads();
      if (valid == 0u) continue;
      dkv_tile<D, BQ>(ak, av, k_row, v_row, q_t, go_t, lse_t, dl_t, dls_t,
                      valid, scale);
    }
  }

  if (live) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dk[krow * D + d] = from_f32<T>(ak[d]);
      dv[krow * D + d] = from_f32<T>(av[d]);
    }
  }
}

struct Args {
  const void *q, *k, *v;
  const int *seg_q, *pos_q, *seg_k, *pos_k;
  const float *lse, *dout, *delta, *dlse;
  int B, H, KH, Sq, Sk;
  float scale;
  int kind, window, chunk;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_dq(const Args& a, void* dq) {
  constexpr int BK = 32;
  const dim3 grid((a.Sq + kThreads - 1) / kThreads, a.H, a.B);
  bwd_dq_kernel<T, D, BK><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.seg_q, a.pos_q, a.seg_k, a.pos_k,
      a.lse, a.dout, a.delta, a.dlse, static_cast<T*>(dq), a.H, a.KH, a.Sq,
      a.Sk, a.scale, a.kind, a.window, a.chunk);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv) {
  constexpr int BQ = D > 32 ? 16 : 32;        // static shared memory < 48 KB
  const dim3 grid((a.Sk + kThreads - 1) / kThreads, a.KH, a.B);
  bwd_dkv_kernel<T, D, BQ><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.seg_q, a.pos_q, a.seg_k, a.pos_k,
      a.lse, a.dout, a.delta, a.dlse, static_cast<T*>(dk),
      static_cast<T*>(dv), a.H, a.KH, a.Sq, a.Sk, a.scale, a.kind,
      a.window, a.chunk);
  return cudaGetLastError();
}

Args make_args(const void* q, const void* k, const void* v,
               const void* seg_q, const void* pos_q, const void* seg_k,
               const void* pos_k, const void* lse, const void* dout,
               const void* delta, const void* dlse, int B, int H, int KH,
               int Sq, int Sk, float scale, int kind, int window,
               int chunk, void* stream) {
  return Args{q, k, v,
              static_cast<const int*>(seg_q), static_cast<const int*>(pos_q),
              static_cast<const int*>(seg_k), static_cast<const int*>(pos_k),
              static_cast<const float*>(lse),
              static_cast<const float*>(dout),
              static_cast<const float*>(delta),
              static_cast<const float*>(dlse), B, H, KH, Sq, Sk, scale,
              kind, window, chunk, static_cast<cudaStream_t>(stream)};
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and the outputs share it);
// D is 32 or 64.  Each returns cudaGetLastError() after its launch.
extern "C" int fcp_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* seg_q,
    const void* pos_q, const void* seg_k, const void* pos_k,
    const void* lse, const void* dout, const void* delta, const void* dlse,
    void* dq, int B, int H, int KH, int Sq, int Sk, int D, int dtype,
    float scale, int kind, int window, int chunk, void* stream) {
  if (B * H * Sq == 0) return 0;
  const Args a = make_args(q, k, v, seg_q, pos_q, seg_k, pos_k, lse, dout,
                           delta, dlse, B, H, KH, Sq, Sk, scale, kind,
                           window, chunk, stream);
  if (dtype == 0 && D == 32) return launch_dq<float, 32>(a, dq);
  if (dtype == 0 && D == 64) return launch_dq<float, 64>(a, dq);
  if (dtype == 1 && D == 32) return launch_dq<__nv_bfloat16, 32>(a, dq);
  if (dtype == 1 && D == 64) return launch_dq<__nv_bfloat16, 64>(a, dq);
  return cudaErrorInvalidValue;
}

extern "C" int fcp_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* seg_q,
    const void* pos_q, const void* seg_k, const void* pos_k,
    const void* lse, const void* dout, const void* delta, const void* dlse,
    void* dk, void* dv, int B, int H, int KH, int Sq, int Sk, int D,
    int dtype, float scale, int kind, int window, int chunk, void* stream) {
  if (B * KH * Sk == 0) return 0;
  const Args a = make_args(q, k, v, seg_q, pos_q, seg_k, pos_k, lse, dout,
                           delta, dlse, B, H, KH, Sq, Sk, scale, kind,
                           window, chunk, stream);
  if (dtype == 0 && D == 32) return launch_dkv<float, 32>(a, dk, dv);
  if (dtype == 0 && D == 64) return launch_dkv<float, 64>(a, dk, dv);
  if (dtype == 1 && D == 32) return launch_dkv<__nv_bfloat16, 32>(a, dk, dv);
  if (dtype == 1 && D == 64) return launch_dkv<__nv_bfloat16, 64>(a, dk, dv);
  return cudaErrorInvalidValue;
}
