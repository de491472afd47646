// Fused schedule-driven flash-attention backward, dq, for Hopper (sm_90a),
// on the tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// fused_flash_bwd_dq (_fused_dq_kernel :475, launched by pl.pallas_call
// at :581).  One launch computes d qs of one executor run for ALL stacked
// workers.  The gradient of a run's merge chain collapses onto the
// run-final softmax stats (ops._fused_pl_bwd): for every step of a q slot
//   ds = exp(s - L) * (g_o . v - delta) * scale,  dq += ds . k
// with L the run-final lse of the slot and delta = g_o . o_out - g_lse,
// so no per-step lse and no dlse term is needed.
//
// Grid: Pallas walks (h, q-tile, step, kv-tile) in order and carries the
// dq scratch across a q slot's steps; GPU blocks run in parallel and in no
// order.  The forward's host segment table (one (lo, hi) step range per
// distinct q slot of the q-slot-sorted run, trash steps excluded) gives
// one block of four warps one (worker, segment, head, 64 q rows): it
// loops over the segment's steps and each step's 64-key tiles,
// accumulates dq in f32 registers and writes once, as f32.  No atomics
// and one fixed order, so two launches on the same inputs give the same
// bytes.  Slots no segment names are never written: the wrapper
// allocates dq with zeros (the reference's _visited mask).
//
// What bounds it on the H100: at the main path's widest run (4 workers,
// 29 steps, H 32, 512-row blocks, D 64, bf16, causal) the valid pairs
// need 3.1e11 flop (6 D a pair and head) on 3.9e8 bytes: the operations
// set the floor (0.31 ms at the bf16 peak).  The design is kernel 5's
// (flash_attention_bwd.cu) with its loop turned into the segment's: every
// product on the tensor cores through the shared dq tile of attn_mma.cuh
// (S = Q.K^T, dP = dO.V^T, dQ += dS.K, mma.sync m16n8k16, the f32 g_o and
// dS split into bf16 hi + lo); the q slot is fixed for the whole segment,
// so Q, g_o (as hi + lo fragments), lse and delta load once per block,
// into registers.  K/V come through a cp.async ring (tile_pipe) that runs
// across step boundaries: its load maps a flat tile index j to (step lo +
// j / n_kv_tiles, tile j % n_kv_tiles), reads that step's kv slot
// step_kv[s] and stages that step's own k_seg / k_pos rows beside K and
// V.  Every (step, tile) class is found before the loop from the q rows'
// ranges against the step's key ranges (classify_tiles, into a class
// array of S * n_kv_tiles bytes, the most a segment can hold): tiles no
// pair can see load no bytes, tiles where every pair is valid take no
// per-element test.  The last q tiles start first: a causal mask shows
// them the most keys.
//
// ptxas -v (sm_90a; __launch_bounds__(128, 3) caps D <= 64 at 168, (128,
// 2) D = 128 at 255), registers a thread and spill stores / loads in
// bytes: bf16 D=64 168, 0 / 0; D=32 128, 0 / 0; D=128 255, 20 / 16; f32
// D=64 168, 56 / 100; D=32 152, 0 / 0; D=128 255, 12 / 24.  The bf16
// D=64 build holds 80 HMMA and 16 FFMA, D=128 160 and 16 (cuobjdump
// -sass).
//
// Layouts (row-major, contiguous; N = stacked workers):
//   qs [N, SL, H, bs, D], kxt/vxt [N, EX, KH, bs, D] (f32 or bf16)
//   step_q/step_kv [N, S]; q_seg/q_pos [N, SL, bs]; k_seg/k_pos [N, S, bs]
//   seg_lo/seg_hi [N, G]; lse/delta [N, SL, H, bs] f32; go [N, SL, H, bs, D]
//   f32; dq [N, SL, H, bs, D] f32 (written only on segment slots).

#include <cstdint>

#include "attn_mma.cuh"

namespace {

using namespace fcp_mma;

template <typename T>
constexpr bool kIsF32 = std::is_same<T, float>::value;

template <int D>
constexpr int kLd = D + 8;          // padded bf16 row of an ldmatrix tile

template <typename T, int D>
constexpr int kStageBytes = kRows * (kIsF32<T> ? D : kLd<D>) * (int)sizeof(T);

template <int D>
constexpr int kPlaneBytes = kRows * kLd<D> * 2;

// the ring's two K and V slots, for f32 the hi / lo planes of both, each
// slot's k_seg / k_pos; the tile classes follow (set at launch)
template <typename T, int D>
constexpr int kSmem = 4 * kStageBytes<T, D> +
                      (kIsF32<T> ? 4 * kPlaneBytes<D> : 0) + 2 * 2 * kRows * 4;

// blocks an SM the registers must allow: three at D <= 64 (168
// registers a thread), two at D = 128 (255), whose Q, g_o and dq
// fragments alone take 160 registers a thread in bf16
template <int D>
constexpr int kMinBlocks = D > 64 ? 2 : 3;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks<D>) fused_dq_kernel(
    const T* __restrict__ qs, const T* __restrict__ kxt,
    const T* __restrict__ vxt, const int* __restrict__ step_q,
    const int* __restrict__ step_kv, const int* __restrict__ q_seg,
    const int* __restrict__ q_pos, const int* __restrict__ k_seg,
    const int* __restrict__ k_pos, const int* __restrict__ seg_lo,
    const int* __restrict__ seg_hi, const float* __restrict__ lse,
    const float* __restrict__ go, const float* __restrict__ delta,
    float* __restrict__ dq, int SL, int EX, int S, int G, int H, int KH,
    int bs, float scale, int kind, int window, int chunk) {
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
  // then each slot's k_seg / k_pos, then the tile classes
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
  const bool ina = ra < bs, inb = rb < bs;
  const int slot = step_q[n * S + lo];
  const size_t qrow = (((size_t)n * SL + slot) * H + h) * bs;  // row 0
  const int* qsg = q_seg + ((size_t)n * SL + slot) * bs;
  const int* qps = q_pos + ((size_t)n * SL + slot) * bs;
  const int sa = ina ? qsg[ra] : kPad, sb = inb ? qsg[rb] : kPad;
  const int pa = ina ? qps[ra] : 0, pb = inb ? qps[rb] : 0;

  // the slot's rows, once for the whole segment: Q and g_o (hi + lo) as
  // A fragments, the run-final lse (log2 units) and delta
  AFrags<D / 16, kF32> qf;
  AFrags<D / 16, true> of;
  load_a<D>(qf, qs + qrow * D, w0, bs, lane);
  load_a<D>(of, go + qrow * D, w0, bs, lane);
  BwdRows rows;
  rows.la = ina ? lse[qrow + ra] * kLog2e : 0.f;
  rows.lb = inb ? lse[qrow + rb] * kLog2e : 0.f;
  rows.ea = ina ? delta[qrow + ra] : 0.f;
  rows.eb = inb ? delta[qrow + rb] : 0.f;
  rows.ga = rows.gb = 0.f;
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
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
  // tile j's K, V and key metadata into ring slot `sl`: the step's own
  // kv slot and k_seg / k_pos, so the ring crosses step boundaries
  auto load = [&](int j, int sl) {
    const int s = lo + j / nkt, r0 = (j % nkt) * kRows;
    const size_t kv = (((size_t)n * EX + step_kv[n * S + s]) * KH + kh) * bs;
    stage_tile<T, D>(stage(2 * sl), kStageLd, kxt + kv * D, r0, bs, tid);
    stage_tile<T, D>(stage(2 * sl + 1), kStageLd, vxt + kv * D, r0, bs, tid);
    const size_t ms = ((size_t)n * S + s) * bs;
    stage_meta(meta + sl * 2 * kRows, meta + sl * 2 * kRows + kRows,
               k_seg + ms, k_pos + ms, r0, bs, tid);
  };
  auto body = [&](int sl, int j) {
    const bf16 *kt, *vt, *ktl = nullptr, *vtl = nullptr;
    if constexpr (kF32) {
      split_tile<D>(reinterpret_cast<const float*>(stage(2 * sl)), planes,
                    planes + kPlane, LD, tid);
      split_tile<D>(reinterpret_cast<const float*>(stage(2 * sl + 1)),
                    planes + 2 * kPlane, planes + 3 * kPlane, LD, tid);
      __syncthreads();
      kt = planes;
      ktl = planes + kPlane;
      vt = planes + 2 * kPlane;
      vtl = planes + 3 * kPlane;
    } else {
      kt = reinterpret_cast<const bf16*>(stage(2 * sl));
      vt = reinterpret_cast<const bf16*>(stage(2 * sl + 1));
    }
    if (cls[j] == kFull) {
      dq_tile<true, kF32, false, D>(acc, qf, of, kt, ktl, vt, vtl, LD, ~0u,
                                    rows, sl2, scale, lane);
      return;
    }
    const int* sg = meta + sl * 2 * kRows;
    const unsigned bits = elem_bits<true>(
        sa, pa, sb, pb, sg, sg + kRows, 0,
        min(kRows, bs - (j % nkt) * kRows), t, kind, window, chunk);
    // a warp whose 16 rows see no key of the tile adds nothing
    if (__any_sync(0xffffffffu, bits != 0u))
      dq_tile<false, kF32, false, D>(acc, qf, of, kt, ktl, vt, vtl, LD, bits,
                                     rows, sl2, scale, lane);
  };
  tile_pipe(cls, nt, load, body);
  store_acc<float, D>(dq + qrow * D, acc, w0, bs, lane);
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
  // the class array holds the longest segment a run can give: S steps
  const int nkt = (bs + kRows - 1) / kRows;
  const int bytes = kSmem<T, D> + (S * nkt + 15) / 16 * 16;
  auto* kernel = fused_dq_kernel<T, D>;
  // dynamic shared memory above 48 KB: the limit follows the largest
  // launch so far (a launch past the card's limit fails here)
  static int sized = 0;
  if (bytes > sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    sized = bytes;
  }
  const dim3 grid(nkt, H, N * G);
  kernel<<<grid, kThreads, bytes, stream>>>(
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
// vxt and go 16-byte aligned.  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int fcp_fused_flash_bwd_dq(
    const void* qs, const void* kxt, const void* vxt, const void* step_q,
    const void* step_kv, const void* q_seg, const void* q_pos,
    const void* k_seg, const void* k_pos, const void* seg_lo,
    const void* seg_hi, const void* lse, const void* go, const void* delta,
    void* dq, int N, int SL, int EX, int S, int G, int H, int KH, int bs,
    int D, int dtype, float scale, int kind, int window, int chunk,
    void* stream) {
  if (N * G == 0) return 0;
  if (!(aligned16(qs) && aligned16(kxt) && aligned16(vxt) && aligned16(go)))
    return cudaErrorMisalignedAddress;
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
