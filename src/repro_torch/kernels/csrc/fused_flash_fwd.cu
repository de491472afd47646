// Fused schedule-driven flash-attention forward for Hopper (sm_90a), on
// the tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// fused_flash_fwd (_fused_fwd_kernel :346, launched by pl.pallas_call at
// :463, masked by _mask_tile :52).  One launch computes one executor run
// for ALL stacked workers: for every q slot the run visits, an online
// softmax over the slot's contiguous steps, seeded from the incoming
// accumulator as (acc, m, l) = (o_in, lse_in, 1), finalized as o = acc /
// l, lse = m + log l.
//
// Why the TPU grid is not carried over: Pallas walks (h, q-tile, step,
// kv-tile) in order and carries the (acc, m, l) scratch across the step
// axis with first/last flags.  GPU blocks run in parallel and in no
// order, so that grid would race.  Instead a host table splits each
// worker's q-slot-sorted steps into segments (one (lo, hi) per distinct
// q slot), and one block owns one (worker, segment, head, 64-row q tile):
// it seeds from the accumulator, loops over its segment's steps and each
// step's kv tiles, and writes once.  No atomics, so the merge order is
// fixed and a run is bitwise reproducible.  Within a segment the last q
// tiles start first: a causal mask shows them the most keys.
//
// What bounds it on the H100: at the serve shape (the widest run of the
// bucket-2048 prefill plan: 4 workers, 6 steps, H 32, 512-row blocks, D
// 64, bf16) the valid pairs need 3.3e10 flop on 2.2e8 bytes, ~150 flop a
// byte: the bytes set the floor (0.065 ms), the operations close behind.
// What holds the kernel is the latency of each warp's chain S -> softmax
// -> P.V, tile after tile (PERF.md section 6).  The block's four warps hold
// its 64 q rows as mma.sync fragments, 16 rows each; Q loads once for the
// whole segment (the q slot is constant across it), and every (step, kv
// tile) pair goes through the shared forward tile of attn_mma.cuh: S =
// Q.K^T and acc += P.V on the tensor cores (P split into bf16 hi + lo,
// f32 q/k/v split too), K and V through a cp.async ring that runs across
// step boundaries, the online softmax in f32 registers.  Every tile's
// class is found at the start, before any K/V byte loads: tiles no pair
// of the block can see (causal or cross-document) are skipped, tiles
// where every pair is valid take no per-element test.  128 registers a
// thread let four blocks share an SM, so other warps run while one
// waits.  The accumulators touch device memory once per run, as in the
// reference.
//
// Layouts (row-major, contiguous; N = stacked workers):
//   qs [N, SL, H, bs, D], kxt/vxt [N, EX, KH, bs, D] (f32 or bf16)
//   step_q/step_kv [N, S]; q_seg/q_pos [N, SL, bs]; k_seg/k_pos [N, S, bs]
//   seg_lo/seg_hi [N, G]  (empty segments have lo == hi)
//   acc_o [N, SL, H, bs, D] f32, acc_lse [N, SL, H, bs] f32 — updated in
//   place: only the slots some segment names are written.

#include <cstdint>

#include "attn_mma.cuh"

namespace {

using namespace fcp_mma;

template <typename T>
constexpr bool kIsF32 = std::is_same<T, float>::value;

template <int D>
constexpr int kLd = D + 8;          // padded bf16 row of an ldmatrix tile

// blocks an SM the registers must allow: bf16 builds of D <= 64 at <= 128
// registers a thread (four blocks: the tile loop is bound by latency, so
// more warps in flight pay), the others (f32 hi and lo fragments, D =
// 128) at <= 255
template <typename T, int D>
constexpr int kMinBlocks = kIsF32<T> || D > 64 ? 2 : 4;

template <typename T, int D>
constexpr int kStageBytes = kRows * (kIsF32<T> ? D : kLd<D>) * (int)sizeof(T);

template <int D>
constexpr int kPlaneBytes = kRows * kLd<D> * 2;

// the ring's two K and V slots, for f32 the hi / lo planes of both, each
// slot's seg/pos; the tile classes follow (S * ceil(bs / 64) bytes, set
// at launch: a segment has at most S steps)
template <typename T, int D>
constexpr int kSmem = 4 * kStageBytes<T, D> +
                      (kIsF32<T> ? 4 * kPlaneBytes<D> : 0) + 2 * 2 * kRows * 4;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T, D>)
    fused_fwd_kernel(const T* __restrict__ qs, const T* __restrict__ kxt,
                     const T* __restrict__ vxt,
                     const int* __restrict__ step_q,
                     const int* __restrict__ step_kv,
                     const int* __restrict__ q_seg,
                     const int* __restrict__ q_pos,
                     const int* __restrict__ k_seg,
                     const int* __restrict__ k_pos,
                     const int* __restrict__ seg_lo,
                     const int* __restrict__ seg_hi,
                     float* __restrict__ acc_o, float* __restrict__ acc_lse,
                     int SL, int EX, int S, int G, int H, int KH, int bs,
                     float scale, int kind, int window, int chunk) {
  constexpr bool kF32 = kIsF32<T>;
  constexpr int LD = kLd<D>;
  constexpr int kStageLd = kF32 ? D : LD;
  constexpr int kPlane = kRows * LD;  // elements
  const int n = blockIdx.z / G;
  const int lo = seg_lo[n * G + blockIdx.z % G];
  const int hi = seg_hi[n * G + blockIdx.z % G];
  if (lo >= hi) return;                       // block-uniform exit
  extern __shared__ __align__(16) unsigned char smem[];
  // ring: slot s holds K at stage(2s), V at stage(2s + 1); f32 planes,
  // then each slot's seg / pos, then the tile classes
  auto stage = [&](int i) {
    return reinterpret_cast<T*>(smem + i * kStageBytes<T, D>);
  };
  bf16* planes = reinterpret_cast<bf16*>(smem + 4 * kStageBytes<T, D>);
  int* meta = reinterpret_cast<int*>(smem + 4 * kStageBytes<T, D> +
                                     (kF32 ? 4 * kPlaneBytes<D> : 0));
  unsigned char* cls = reinterpret_cast<unsigned char*>(meta + 2 * 2 * kRows);

  const int h = blockIdx.y;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3;
  // the last q tiles first: under a causal mask they see the most keys
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows, w0 = q0 + 16 * warp;
  const int ra = w0 + (lane >> 2), rb = ra + 8;
  const int slot = step_q[n * S + lo];
  const size_t qrow = (((size_t)n * SL + slot) * H + h) * bs;  // row 0
  const int* qsg = q_seg + ((size_t)n * SL + slot) * bs;
  const int* qps = q_pos + ((size_t)n * SL + slot) * bs;
  const int sa = ra < bs ? qsg[ra] : kPad, sb = rb < bs ? qsg[rb] : kPad;
  const int pa = ra < bs ? qps[ra] : 0, pb = rb < bs ? qps[rb] : 0;

  AFrags<D / 16, kF32> qf;
  load_a<D>(qf, qs + qrow * D, w0, bs, lane);
  // seed (acc, m, l) = (o_in, lse_in, 1): m in log2 units, l on one lane
  // of the quad (the four parts add up to the row's l)
  FwdAcc<D> acc;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? rb : ra;
    const bool in = row < bs;
    acc.m[r] = in ? acc_lse[qrow + row] * kLog2e : kNegInf;
    acc.l[r] = in && t == 0 ? 1.f : 0.f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float2 x = in ? *reinterpret_cast<const float2*>(
                                acc_o + (qrow + row) * D + 8 * j + 2 * t)
                          : make_float2(0.f, 0.f);
      acc.o[j][2 * r] = x.x;
      acc.o[j][2 * r + 1] = x.y;
    }
  }
  const float sl2 = scale * kLog2e;

  // the segment's (step, kv tile) pairs, j = (s - lo) * nkt + tile
  const int nkt = (bs + kRows - 1) / kRows;
  const int nt = (hi - lo) * nkt;
  auto kv_meta = [&](int j, const int*& sg, const int*& ps, int& r0,
                     int& nrow) {
    const size_t s = (size_t)n * S + lo + j / nkt;
    sg = k_seg + s * bs;
    ps = k_pos + s * bs;
    r0 = (j % nkt) * kRows;
    nrow = bs;
  };
  classify_tiles(cls, nt, tile_ranges(qsg, qps, q0, bs, lane), kv_meta,
                 kind, window, chunk, warp, lane);
  __syncthreads();
  auto load = [&](int j, int slot_) {
    const int s = lo + j / nkt, r0 = (j % nkt) * kRows;
    const size_t kv = (((size_t)n * EX + step_kv[n * S + s]) * KH + kh) * bs;
    stage_tile<T, D>(stage(2 * slot_), kStageLd, kxt + kv * D, r0, bs, tid);
    stage_tile<T, D>(stage(2 * slot_ + 1), kStageLd, vxt + kv * D, r0, bs,
                     tid);
    const size_t ms = ((size_t)n * S + s) * bs;
    stage_meta(meta + slot_ * 2 * kRows, meta + slot_ * 2 * kRows + kRows,
               k_seg + ms, k_pos + ms, r0, bs, tid);
  };
  auto body = [&](int slot_, int j) {
    const bf16 *kt, *vt, *ktl = nullptr, *vtl = nullptr;
    if constexpr (kF32) {
      split_tile<D>(reinterpret_cast<const float*>(stage(2 * slot_)), planes,
                    planes + kPlane, LD, tid);
      split_tile<D>(reinterpret_cast<const float*>(stage(2 * slot_ + 1)),
                    planes + 2 * kPlane, planes + 3 * kPlane, LD, tid);
      __syncthreads();
      kt = planes;
      ktl = planes + kPlane;
      vt = planes + 2 * kPlane;
      vtl = planes + 3 * kPlane;
    } else {
      kt = reinterpret_cast<const bf16*>(stage(2 * slot_));
      vt = reinterpret_cast<const bf16*>(stage(2 * slot_ + 1));
    }
    if (cls[j] == kFull) {
      fwd_tile<true, kF32>(acc, qf, kt, ktl, vt, vtl, LD, ~0u, sl2, lane);
      return;
    }
    const int* sg = meta + slot_ * 2 * kRows;
    const unsigned bits = elem_bits<true>(
        sa, pa, sb, pb, sg, sg + kRows, 0,
        min(kRows, bs - (j % nkt) * kRows), t, kind, window, chunk);
    fwd_tile<false, kF32>(acc, qf, kt, ktl, vt, vtl, LD, bits, sl2, lane);
  };
  tile_pipe(cls, nt, load, body);

  // l >= 1 on every live row (the seed's 1, or the max score's p = 1)
  float ls[2];
  fwd_finish(acc, ls);
  store_acc<float, D>(acc_o + qrow * D, acc.o, w0, bs, lane);
  if (t == 0) {
    if (ra < bs) acc_lse[qrow + ra] = ls[0];
    if (rb < bs) acc_lse[qrow + rb] = ls[1];
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
  const int bytes = kSmem<T, D> + (S * ((bs + kRows - 1) / kRows) + 15) /
                                      16 * 16;
  auto* kernel = fused_fwd_kernel<T, D>;
  // dynamic shared memory above 48 KB: the limit follows the largest
  // launch so far
  static int sized = 0;
  if (bytes > sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    sized = bytes;
  }
  const dim3 grid((bs + kRows - 1) / kRows, H, N * G);
  kernel<<<grid, kThreads, bytes, stream>>>(
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
    FCP_CASE(16)
    FCP_CASE(32)
    FCP_CASE(64)
    FCP_CASE(80)
    FCP_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef FCP_CASE
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (qs, kxt and vxt share it); qs, kxt,
// vxt and acc_o 16-byte aligned.  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int fcp_fused_flash_fwd(
    const void* qs, const void* kxt, const void* vxt, const void* step_q,
    const void* step_kv, const void* q_seg, const void* q_pos,
    const void* k_seg, const void* k_pos, const void* seg_lo,
    const void* seg_hi, void* acc_o, void* acc_lse, int N, int SL, int EX,
    int S, int G, int H, int KH, int bs, int D, int dtype, float scale,
    int kind, int window, int chunk, void* stream) {
  if (N * G == 0) return 0;
  if (!(aligned16(qs) && aligned16(kxt) && aligned16(vxt) &&
        aligned16(acc_o)))
    return cudaErrorMisalignedAddress;
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
