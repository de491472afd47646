// Fused schedule-driven flash-attention backward, dk/dv, for Hopper
// (sm_90a), on the tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// fused_flash_bwd_dkv (_fused_dkv_kernel :590, launched by pl.pallas_call
// at :708).  One launch computes d kxt / d vxt of one executor run for
// ALL stacked workers, per extended-buffer row, summed over every step
// that consumes the row, every GQA member of its kv head and every q tile:
//   p = exp(s - L),  ds = p * (g_o . v - delta) * scale,
//   dv += p^T . g_o,  dk += ds^T . q
// with the run-final lse L and delta = g_o . o_out - g_lse of each q row
// (ops._fused_pl_bwd), so no dlse term is needed.
//
// Grid: Pallas walks (kh, kv-tile, step, group, q-tile) over the
// kv-sorted bwd_q/bwd_kv tables and carries dk/dv scratch across one kv
// row's steps.  Here a host segment table over bwd_kv (one (lo, hi) step
// range per distinct extended-buffer row, steps on the kv trash row
// excluded) gives one warpgroup one (worker, kv-row segment, kv head, 64
// kv rows): it loops over the segment's (step, group member, 64-row q
// tile) triples, accumulates dk and dv in f32 wgmma accumulators and
// writes once, as f32.  No atomics and one fixed order: two launches on
// the same inputs give the same bytes.  Rows no segment names are never
// written (the wrapper allocates zeros: the reference's _visited mask).
//
// What bounds it on the H100: at the main path's widest run (4 workers,
// 29 steps, H = KH = 32, 512-row blocks, D 64, bf16, causal) the valid
// pairs need 4.1e11 flop (8 D a pair and head) on 8.5e8 bytes: the
// operations set the floor (0.41 ms at the bf16 peak).  The design is
// kernel 6's (flash_attention_bwd.cu) with its loop turned into the
// segment's, through the shared dk/dv tile of attn_mma.cuh (S^T = K.Q^T
// and dP^T = V.dO^T on wgmma m64n64k16 from swizzled shared tiles, then
// dV += P^T.dO and dK += dS^T.Q on wgmma m64nDk16 with P^T and dS^T in
// registers).  The kv row is fixed for the whole segment, and so is its
// metadata (the row's own k_seg / k_pos, read at the segment's first
// step), so K and V become swizzled bf16 tiles once per block.  Step s
// reads q slot bwd_q[s]: its Q tile comes through a two-slot cp.async
// ring, its f32 g_o tile by one bulk copy on an mbarrier (split into
// swizzled hi / lo tiles), its lse / delta rows and q_seg / q_pos rows
// by cp.async beside them.  Every (step, q tile) class is found before
// the loop from the block's key ranges against the q rows' ranges
// (classify_tiles, into a class array of S * n_q_tiles bytes, the most a
// segment can hold; the GQA members share it): tiles no pair can see load
// no bytes, tiles where every pair is valid take no per-element test,
// and a partial tile's validity bits come from its staged q metadata
// while S^T and dP^T run.
//
// At D = 128 the tiles are two 64-column halves (attn_mma.cuh, section
// wgmma), and the dk and dv accumulators take 128 registers a thread, so
// the block runs alone on its SM (kMinBlocks).  A D = 80 row lies in such
// a tile (kTileD): loads and stores move its 80 columns, S^T and dP^T
// take its 5 k16 steps, dV and dK the tile's whole N = 128.  A D = 16 row
// lies in a D = 32 tile alike (one k16 step, N = 32); the pad columns of
// both are zeroed once per block.
//
// ptxas -v (sm_90a; __launch_bounds__(128, 3) caps D <= 64 at 168, (128,
// 1) D = 128 at 255), registers a thread and spill stores / loads in
// bytes: bf16 D=64 168, 8 / 8; D=32 165, 0 / 0; D=128 253, 0 / 0; f32
// D=64 168, 0 / 0; D=32 164, 0 / 0; D=128 247, 0 / 0.  The bf16 D=64
// build holds 52 HGMMA and 64 FFMA, D=128 104 and 64 (cuobjdump -sass).
//
// Layouts (row-major, contiguous; N = stacked workers):
//   qs [N, SL, H, bs, D], kxt/vxt [N, EX, KH, bs, D] (f32 or bf16)
//   bwd_q/bwd_kv [N, S] (kv-row-sorted); q_seg/q_pos [N, SL, bs];
//   k_seg/k_pos [N, S, bs] (kv metadata in bwd order); seg_lo/seg_hi
//   [N, G]; lse/delta [N, SL, H, bs] f32; go [N, SL, H, bs, D] f32;
//   dk/dv [N, EX, KH, bs, D] f32 (written only on segment rows).

#include <cstdint>

#include "attn_mma.cuh"

namespace {

using namespace fcp_mma;

template <typename T>
constexpr bool kIsF32 = std::is_same<T, float>::value;

template <int D>
constexpr int kSwzTileBytes = kRows * kTileD<D> * 2;

// 1024 bytes of alignment slack, the swizzled tiles (6; 8 for f32), the
// f32 g_o tile, the f32 Q tile for f32 q, two lse / delta slots, two
// q_seg / q_pos slots, the mbarrier of the g_o copies; the tile classes
// follow (set at launch).  Like the g_o tile, the f32 Q tile is free once
// split, so one suffices: f32 at D = 128 fits the card's 227 KB only so.
template <typename T, int D>
constexpr int kSmem = 1024 + (kIsF32<T> ? 8 : 6) * kSwzTileBytes<D> +
                      kRows * D * 4 + (kIsF32<T> ? kRows * D * 4 : 0) +
                      2 * 2 * kRows * 4 + 2 * 2 * kRows * 4 + 16;

// blocks an SM the registers must allow: three at D <= 64 (168 registers
// a thread); one at D = 128, whose dk and dv accumulators (64 x 128 f32
// each over the warpgroup) take 128 registers a thread beside S^T and
// dP^T (64), up to 255, and whose tiles take 131 KB (bf16) of the SM's
// shared memory anyway; two for f32 at D <= 64, whose tile products are
// summed apart (attn_mma.cuh, dkv_finish) with all of P^T and dS^T packed
template <typename T, int D>
constexpr int kMinBlocks = D > 64 ? 1 : kIsF32<T> ? 2 : 3;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T, D>)
    fused_dkv_kernel(
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
  constexpr bool kF32 = kIsF32<T>;
  constexpr int kTile = kSwzTileBytes<D>;
  const int n = blockIdx.z / G;
  const int lo = seg_lo[n * G + blockIdx.z % G];
  const int hi = seg_hi[n * G + blockIdx.z % G];
  if (lo >= hi) return;                       // block-uniform exit
  extern __shared__ __align__(16) unsigned char smem_in[];
  // swizzled bf16 tiles on a 1024-byte boundary: Q (ring slots 0 and 1;
  // for f32 q its hi and lo), dO hi, dO lo, the block's K and V (and
  // their lo tiles for f32); then the dense f32 g_o tile (free again once
  // split, so the next one loads during compute), for f32 q the dense
  // f32 Q tile (the same), the lse / delta slots, the q_seg / q_pos
  // slots, the mbarrier and the tile classes
  constexpr int kTiles = kF32 ? 8 : 6;
  unsigned char* tiles =
      smem_in + ((1024u - (smem_u32(smem_in) & 1023u)) & 1023u);
  unsigned char* do_hi = tiles + 2 * kTile;
  unsigned char* do_lo = tiles + 3 * kTile;
  unsigned char* k_hi = tiles + 4 * kTile;
  unsigned char* v_hi = tiles + 5 * kTile;
  unsigned char* k_lo = tiles + 6 * kTile;      // f32 only
  unsigned char* v_lo = tiles + 7 * kTile;
  float* do_raw = reinterpret_cast<float*>(tiles + kTiles * kTile);
  float* q_raw = do_raw + kRows * D;
  float* stats = q_raw + (kF32 ? kRows * D : 0);
  int* qmeta = reinterpret_cast<int*>(stats + 2 * 2 * kRows);
  uint64_t* bar = reinterpret_cast<uint64_t*>(qmeta + 2 * 2 * kRows);
  unsigned char* cls = reinterpret_cast<unsigned char*>(bar + 1);

  const int kh = blockIdx.y;
  const int group = H / KH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3;
  const int k0 = blockIdx.x * kRows, w0 = k0 + 16 * warp;
  const int ra = w0 + (lane >> 2), rb = ra + 8;
  const int row = bwd_kv[n * S + lo];
  const size_t hk = (((size_t)n * EX + row) * KH + kh) * bs;    // row 0
  // the row's metadata: the same at every step of the segment
  const int* ksg = k_seg + ((size_t)n * S + lo) * bs;
  const int* kps = k_pos + ((size_t)n * S + lo) * bs;
  const int sa = ra < bs ? ksg[ra] : kPad, sb = rb < bs ? ksg[rb] : kPad;
  const int pa = ra < bs ? kps[ra] : 0, pb = rb < bs ? kps[rb] : 0;

  if (tid == 0) mbar_init(bar);
  zero_pad_cols<D>(tiles, kTiles, tid);   // D = 16 and 80: padded widths
  // m64nW accumulators of the warpgroup, W = kTileD<D>
  float ak[kTileD<D> / 2], av[kTileD<D> / 2];
#pragma unroll
  for (int i = 0; i < kTileD<D> / 2; ++i) ak[i] = av[i] = 0.f;
  const float sl2 = scale * kLog2e;

  // the segment's (step, member, q tile) triples, j = ((s - lo) * group +
  // m) * nqt + tile; their classes, per (step, q tile), at c = (s - lo) *
  // nqt + tile (the members share the q slot's seg/pos)
  const int nqt = (bs + kRows - 1) / kRows;
  const int per_step = group * nqt;
  const int nt = (hi - lo) * per_step;
  auto q_meta = [&](int c, const int*& sg, const int*& ps, int& r0,
                    int& nrow) {
    const size_t m = ((size_t)n * SL + bwd_q[n * S + lo + c / nqt]) * bs;
    sg = q_seg + m;
    ps = q_pos + m;
    r0 = (c % nqt) * kRows;
    nrow = bs;
  };
  classify_tiles<false>(cls, (hi - lo) * nqt,
                        tile_ranges(ksg, kps, k0, bs, lane), q_meta, kind,
                        window, chunk, warp, lane);
  __syncthreads();                  // the classes and the mbarrier are set
  auto cls_of = [&](int j) {
    return (int)cls[(j / per_step) * nqt + j % nqt];
  };
  auto next = [&](int from) {
    while (from < nt && cls_of(from) == kNone) ++from;
    return from;
  };
  // triple j's Q, g_o, lse / delta and q_seg / q_pos into ring slot `sl`
  auto load = [&](int j, int sl) {
    const int qslot = bwd_q[n * S + lo + j / per_step];
    const int m = (j / nqt) % group, qr0 = (j % nqt) * kRows;
    const size_t hr = (((size_t)n * SL + qslot) * H + kh * group + m) * bs;
    if constexpr (kF32)
      stage_tile<float, D>(q_raw, D, qs + hr * D, qr0, bs, tid);
    else
      stage_swz<D>(tiles + sl * kTile, qs + hr * D, qr0, bs, tid);
    // one bulk copy; a ragged tile's last rows are zeroed (finite values
    // in the masked columns of P^T.dO)
    const int rows = min(kRows, bs - qr0);
    if (tid == 0) bulk_load(do_raw, go + (hr + qr0) * D, rows * D * 4, bar);
    for (int i = rows * D + tid * 4; i < kRows * D; i += kThreads * 4)
      *reinterpret_cast<float4*>(do_raw + i) = make_float4(0.f, 0.f, 0.f, 0.f);
    float* st = stats + sl * 2 * kRows;
    if (bs % 4 == 0) {              // rows of 16 bytes: 16-byte copies
      for (int i = tid; i < 2 * kRows / 4; i += kThreads) {
        const int which = i / (kRows / 4), r = qr0 + 4 * (i % (kRows / 4));
        const float* src = which == 0 ? lse : delta;
        const int bytes = 4 * min(max(bs - r, 0), 4);
        cp_async16(st + 4 * i, bytes ? src + hr + r : src, bytes);
      }
    } else {
      for (int i = tid; i < 2 * kRows; i += kThreads) {
        const int which = i / kRows, r = qr0 + i % kRows;
        const float* src = which == 0 ? lse : delta;
        const bool in = r < bs;
        cp_async4(st + i, in ? src + hr + r : src, in);
      }
    }
    const size_t mr = ((size_t)n * SL + qslot) * bs;
    stage_meta(qmeta + sl * 2 * kRows, qmeta + sl * 2 * kRows + kRows,
               q_seg + mr, q_pos + mr, qr0, bs, tid);
  };

  float s[32], dp[32];               // S^T and dP^T of the staged tile
  int cur = next(0);
  if (cur < nt) load(cur, 0);
  cp_async_commit();
  // the block's K and V as wgmma A tiles, while the first tile loads
  fill_swz<D>(k_hi, k_lo, kxt + hk * D, k0, bs, tid);
  fill_swz<D>(v_hi, v_lo, vxt + hk * D, k0, bs, tid);
  for (int it = 0; cur < nt; ++it) {
    cp_async_wait<0>();
    mbar_wait(bar, it & 1);
    __syncthreads();              // tile `cur` has landed; the last
                                  // tile's products are done
    const int sl = it & 1;
    split_tile_swz<D>(do_raw, do_hi, do_lo, tid);
    if constexpr (kF32)
      split_tile_swz<D>(q_raw, tiles, tiles + kTile, tid);
    fence_async_smem();
    __syncthreads();              // tiles written, the g_o tile is free
    const int nxt = next(cur + 1);
    if (nxt < nt) load(nxt, sl ^ 1);
    cp_async_commit();
    const unsigned char* qh = kF32 ? tiles : tiles + sl * kTile;
    const unsigned char* ql = tiles + kTile;
    dkv_issue<kF32, D>(s, dp, k_hi, k_lo, v_hi, v_lo, qh, ql, do_hi, do_lo);
    // the tile's class and, for a partial one, this lane's validity bits
    // from the staged q metadata, while S^T and dP^T run
    const float* st = stats + sl * 2 * kRows;
    if (cls_of(cur) == kFull) {
      dkv_finish<true, kF32, false, D>(ak, av, s, dp, qh, ql, do_hi, do_lo,
                                       st, ~0u, sl2, scale, lane);
    } else {
      const int* qm = qmeta + sl * 2 * kRows;
      const unsigned bits = elem_bits<false>(
          sa, pa, sb, pb, qm, qm + kRows, 0,
          min(kRows, bs - (cur % nqt) * kRows), t, kind, window, chunk);
      dkv_finish<false, kF32, false, D>(ak, av, s, dp, qh, ql, do_hi, do_lo,
                                        st, bits, sl2, scale, lane);
    }
    cur = nxt;
  }
  cp_async_wait<0>();
  store_acc<float, D>(dk + hk * D, ak, w0, bs, lane);
  store_acc<float, D>(dv + hk * D, av, w0, bs, lane);
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
  // the class array holds the longest segment a run can give: S steps
  const int nqt = (bs + kRows - 1) / kRows;
  const int bytes = kSmem<T, D> + (S * nqt + 15) / 16 * 16;
  auto* kernel = fused_dkv_kernel<T, D>;
  // dynamic shared memory above 48 KB: the limit follows the largest
  // launch so far (a launch past the card's limit fails here)
  static int sized = 0;
  if (bytes > sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    sized = bytes;
  }
  const dim3 grid(nqt, KH, N * G);
  kernel<<<grid, kThreads, bytes, stream>>>(
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
// vxt and go 16-byte aligned (cp.async, the bulk copy).  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int fcp_fused_flash_bwd_dkv(
    const void* qs, const void* kxt, const void* vxt, const void* bwd_q,
    const void* bwd_kv, const void* q_seg, const void* q_pos,
    const void* k_seg, const void* k_pos, const void* seg_lo,
    const void* seg_hi, const void* lse, const void* go, const void* delta,
    void* dk, void* dv, int N, int SL, int EX, int S, int G, int H, int KH,
    int bs, int D, int dtype, float scale, int kind, int window, int chunk,
    void* stream) {
  if (N * G == 0) return 0;
  if (!(aligned16(qs) && aligned16(kxt) && aligned16(vxt) && aligned16(go)))
    return cudaErrorMisalignedAddress;
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
