// Varlen flash-attention forward for Hopper (sm_90a), batched and strided.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention_fwd (_fwd_kernel, launched by pl.pallas_call at :126):
// normalized attention plus log-sum-exp over one (q, kv) range under
// (segment, position) masking; a fully masked row gives o = 0,
// lse = NEG_INF.  On the serving path it is the context-parallel decode
// kernel (Sq = 1): one launch per layer covers every decode slot and every
// sequence shard of the cache, with the shards as extra batch rows.
//
// What bounds it on the H100: at Sq = 1 the work is ~2 flops per cache
// byte, so it is bound by reading the KV cache from device memory.  The
// design therefore (a) reads the cache in its own layout [B, S, KH, D]
// through strides — no transposed copy of the cache per token, which in
// eager PyTorch would move the whole cache each step; (b) checks each
// tile's mask metadata before loading it, so the tiles past a sequence's
// length (seg = -1) cost no K/V bytes; (c) loads each K/V tile once per
// block, coalesced, into shared memory.  One block owns one
// (batch row, head, q row); its threads split the keys, each keeping its
// own online-softmax state, and the block merges the partial states at
// the end in a fixed order (no atomics).  A split-KV variant, which would
// spread one long row over several blocks, is a later step.
//
// Layouts: q [B, H, Sq, D], k/v [B, KH, Sk, D] with any element strides
// (unit stride on D); seg_q/pos_q [B, Sq] and seg_k/pos_k [B, Sk] with a
// batch stride (0 = shared by the batch) and unit stride within a row.
// Outputs o [B, H, Sq, D] and lse [B, H, Sq], f32, contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kPad = -1;
constexpr int kThreads = 64;        // one key of each tile per thread
constexpr int kWarps = kThreads / 32;

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

struct Strides {
  long long qb, qh, qs;       // q
  long long kb, kh, ks;       // k and v
  long long sqb, skb;         // seg/pos batch strides
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ seg_q,
    const int* __restrict__ pos_q, const int* __restrict__ seg_k,
    const int* __restrict__ pos_k, float* __restrict__ o,
    float* __restrict__ lse, int H, int KH, int Sq, int Sk, Strides st,
    float scale, int kind, int window, int chunk) {
  constexpr int P = D + 1;                    // padded row: no bank clash
  __shared__ float q_s[D];
  __shared__ float k_s[kThreads * P];
  __shared__ float v_s[kThreads * P];
  __shared__ float red[kWarps][D];
  __shared__ float m_red[kWarps];

  const int i = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sq = seg_q[b * st.sqb + i];
  const int pq = pos_q[b * st.sqb + i];
  const T* qp = q + b * st.qb + h * st.qh + i * st.qs;
  const T* kp = k + b * st.kb + kh * st.kh;
  const T* vp = v + b * st.kb + kh * st.kh;
  for (int d = tid; d < D; d += kThreads) q_s[d] = to_f32(qp[d]);

  float m = kNegInf, l = 0.f, acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;

  for (int k0 = 0; k0 < Sk; k0 += kThreads) {
    const int kk = k0 + tid;
    bool valid = false;
    if (kk < Sk && sq != kPad) {
      const int sk = seg_k[b * st.skb + kk];
      valid = sk == sq &&
              visible(kind, window, chunk, pq, pos_k[b * st.skb + kk]);
    }
    // also the barrier that retires the previous tile's readers
    if (!__syncthreads_or(valid)) continue;
    for (int e = tid; e < kThreads * D; e += kThreads) {
      const int j = e / D, d = e - j * D;
      const bool in = k0 + j < Sk;
      k_s[j * P + d] = in ? to_f32(kp[(k0 + j) * st.ks + d]) : 0.f;
      v_s[j * P + d] = in ? to_f32(vp[(k0 + j) * st.ks + d]) : 0.f;
    }
    __syncthreads();
    if (!valid) continue;
    float dot = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) dot = fmaf(q_s[d], k_s[tid * P + d], dot);
    const float s = dot * scale;
    const float m_new = fmaxf(m, s);
    const float alpha = expf(m - m_new);
    const float p = expf(s - m_new);
    l = l * alpha + p;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = fmaf(p, v_s[tid * P + d], acc[d] * alpha);
    m = m_new;
  }

  // merge the threads' partial states: block max, then weighted sums
  float mx = m;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) m_red[warp] = mx;
  __syncthreads();
  float M = m_red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) M = fmaxf(M, m_red[w]);
  const float w_t = expf(m - M);              // empty thread: l = acc = 0
  float L = l * w_t;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    L += __shfl_xor_sync(0xffffffffu, L, off);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    float x = acc[d] * w_t;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_xor_sync(0xffffffffu, x, off);
    if (lane == 0) red[warp][d] = x;
  }
  __shared__ float l_red[kWarps];
  if (lane == 0) l_red[warp] = L;
  __syncthreads();
  float Lt = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) Lt += l_red[w];
  const float ls = fmaxf(Lt, 1e-37f);
  const long long orow = ((long long)b * H + h) * Sq + i;
  for (int d = tid; d < D; d += kThreads) {
    float x = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) x += red[w][d];
    o[orow * D + d] = Lt > 0.f ? x / ls : 0.f;
  }
  if (tid == 0) lse[orow] = Lt > 0.f ? M + logf(ls) : kNegInf;
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const int* seg_q, const int* pos_q, const int* seg_k,
                       const int* pos_k, float* o, float* lse, int B, int H,
                       int KH, int Sq, int Sk, const Strides& st,
                       float scale, int kind, int window, int chunk,
                       cudaStream_t stream) {
  const dim3 grid(Sq, H, B);
#define FCP_CASE(DD)                                                        \
  case DD:                                                                  \
    fwd_kernel<T, DD><<<grid, kThreads, 0, stream>>>(                       \
        static_cast<const T*>(q), static_cast<const T*>(k),                 \
        static_cast<const T*>(v), seg_q, pos_q, seg_k, pos_k, o, lse, H,    \
        KH, Sq, Sk, st, scale, kind, window, chunk);                        \
    return cudaGetLastError();
  switch (D) {
    FCP_CASE(32)
    FCP_CASE(64)
    default:
      return cudaErrorInvalidValue;
  }
#undef FCP_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k and v share it).  Strides are in
// elements.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int fcp_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* seg_q,
    const void* pos_q, const void* seg_k, const void* pos_k, void* o,
    void* lse, int B, int H, int KH, int Sq, int Sk, int D, int dtype,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long segq_sb, long long segk_sb,
    float scale, int kind, int window, int chunk, void* stream) {
  if (B * H * Sq == 0) return 0;
  const Strides st{q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, segq_sb, segk_sb};
  const auto* sgq = static_cast<const int*>(seg_q);
  const auto* psq = static_cast<const int*>(pos_q);
  const auto* sgk = static_cast<const int*>(seg_k);
  const auto* psk = static_cast<const int*>(pos_k);
  auto* op = static_cast<float*>(o);
  auto* lp = static_cast<float*>(lse);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, sgq, psq, sgk, psk, op, lp, B, H,
                             KH, Sq, Sk, st, scale, kind, window, chunk, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, sgq, psq, sgk, psk, op, lp,
                                     B, H, KH, Sq, Sk, st, scale, kind,
                                     window, chunk, s);
  return cudaErrorInvalidValue;
}
