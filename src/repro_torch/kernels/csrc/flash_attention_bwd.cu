// Varlen flash-attention backward for Hopper (sm_90a): dq, and dk/dv, on
// the tensor cores.
//
// Replaces the TPU kernels of src/repro/kernels/flash_attention.py:
// flash_attention_bwd — _bwd_dq_kernel (launched by pl.pallas_call at
// :264) and _bwd_dkv_kernel (at :289).  They are the backward of
// flash_attention_fwd.cu on the per-step executor path: one (q, kv)
// block pair per batch row, with the cotangent of the lse output
// (dlse), which is non-zero because every partial feeds a flash merge:
//   p = where(valid, exp(s * scale - lse), 0)
//   ds = p * (do . v - delta + dlse) * scale
//   dq = ds . k,  dk = sum over group members of ds^T . q,  dv = p^T . do
// delta = sum(do * o) is computed by the wrapper, as the reference
// computes it outside its kernel.
//
// Grid: Pallas walks the kv tiles (dq) or the (group member, q tile)
// pairs (dk/dv) in order and carries the sum in VMEM scratch.  Here the
// sequential axis is a loop inside the block: dq — one block per
// (batch row, head, 64 q rows), looping over 64-row kv tiles; dk/dv —
// one block per (batch row, kv head, 64 kv rows), looping over the group
// members and the 64-row q tiles.  Four warps, 16 rows of the block
// each.  The sums stay in f32 registers and are written once in the
// input dtype; no atomics, one fixed order, so two launches on the same
// inputs give the same bytes.
//
// What bounds it on the H100: every product runs on the tensor cores
// (bf16 x bf16 -> f32), four per step; no CUDA-core FMA loop is left.
//   dq:    S = Q.K^T, dP = dO.V^T, dQ += dS.K      mma.sync m16n8k16
//   dk/dv: S^T = K.Q^T, dP^T = V.dO^T              wgmma m64n64k16, A and B
//          dV += P^T.dO, dK += dS^T.Q              from shared memory;
//                                                  wgmma m64nDk16, A in
//                                                  registers
// Not the tensor cores' rate bounds them: at the main-path block the
// products, split terms included (below), would take about a quarter of
// the measured time at the bf16 peak (PERF.md).  The rest is the work
// around them — the mask and tile bookkeeping, the exponent and the hi/lo
// packing of P and dS, the split of each f32 dO tile, the copies and
// barriers of each tile — at three blocks of four warps per SM (168
// registers a thread).
//
// The per-tile bodies are the backward tiles of attn_mma.cuh (dq_tile,
// dkv_issue / dkv_finish), which the fused kernels 3 and 4 run too; here
// with their dlse term (kDlse = true).  This file keeps the loops around
// them.
//
// dq (kernel 5): the block's Q and dO rows are mma.sync A fragments in
// registers, loaded once; K/V tiles come through a two-slot cp.async ring
// (the next tile loads while this one computes) in rows padded by 8
// bf16, read with ldmatrix (.trans for the K of dQ).  The accumulator
// fragments of S and dP become P and dS in registers and are re-packed
// as the A operand of dS.K (FA2's trick): they never touch shared memory.
//
// dk/dv (kernel 6): one warpgroup per block.  The block's K and V are
// 128B- (D = 64; D = 128 as two such tiles, one per 64-column half; D =
// 80 in a D = 128 tile, attn_mma.cuh kTileD) or 64B-swizzled (D = 32; D
// = 16 in a D = 32 tile) bf16
// tiles in shared memory,
// read by wgmma through descriptors; each q tile's Q comes through a
// two-slot cp.async ring in the same layout, and its f32 dO in one bulk
// copy (cp.async.bulk, completing an mbarrier) that is split into
// swizzled hi / lo tiles, after which the next tile's copy starts.  The
// same Q and dO tiles serve K-major (S^T, dP^T) and transposed (dV, dK).
// The S^T and dP^T accumulators become P^T and dS^T in registers and are
// the A operand of the dV / dK wgmmas; those of the first half of the
// tile run while the second half is computed, and the next tile's mask
// class is found while S^T and dP^T run.
//
// Precision (attn_mma.cuh, section backward): each f32 operand is split
// into bf16 hi + lo: dP, dS.K and dS^T.Q take 2 products, P^T.dO takes
// 3, S = Q.K^T takes 1 — about 2^-16 per term, 1.7x (dq) and 2x (dk/dv)
// the products of one bf16 pass; with f32 q/k/v (template T = float)
// every product takes 3.  The CPU test
// tests/test_torch_kernels.py::test_split_bf16_scheme_meets_tol_grad
// emulates this arithmetic against the plain version.
//
// Masks: each partner tile is classified from the (segment, position)
// ranges of the two sides (attn_mma.cuh): no valid pair — skipped before
// its bytes load; all valid (one document, visible at the extreme
// positions) — the path with no per-element test; otherwise every lane
// computes the validity bits of its 32 accumulator elements, the block
// skips the tile if none is set (__syncthreads_or), and masked elements
// are set before the exponent (lse is -1e30 on dead rows).
//
// ptxas -v (CUDA 12.8, sm_90a; __launch_bounds__(128, 3) caps both at
// 168 for D <= 64; D = 128 at 255), registers a thread and spill stores /
// loads in bytes:
//   dq     bf16 D=64 162, 0 / 0;   D=32 122, 0 / 0; D=128 250, 0 / 0
//          f32  D=64 168, 40 / 60; D=32 141, 0 / 0; D=128 255, 24 / 44
//   dk/dv  bf16 D=64 168, 28 / 28; D=32 166, 0 / 0; D=128 255, 16 / 16
//          f32  D=64 168, 8 / 8;   D=32 163, 0 / 0; D=128 255, 0 / 0
//
// Layouts (row-major, contiguous, 16-byte aligned): q/do [B, H, Sq, D]
// (do f32), k/v [B, KH, Sk, D]; seg_q/pos_q [B, Sq], seg_k/pos_k [B, Sk];
// lse/delta/dlse [B, H, Sq] f32; dq [B, H, Sq, D], dk/dv [B, KH, Sk, D]
// in the dtype of q/k/v.  D is 16, 32, 64, 80 or 128.

#include <cstdint>

#include "attn_mma.cuh"

namespace {

using namespace fcp_mma;

template <typename T>
constexpr bool kIsF32 = std::is_same<T, float>::value;

template <int D>
constexpr int kLd = D + 8;          // padded bf16 row of an ldmatrix tile

// bytes of one staged 64-row tile of T: bf16 padded (read by ldmatrix as
// it is), f32 dense (split into bf16 planes first)
template <typename T, int D>
constexpr int kStageBytes = kRows * (kIsF32<T> ? D : kLd<D>) * (int)sizeof(T);

template <int D>
constexpr int kPlaneBytes = kRows * kLd<D> * 2;

template <typename T, int D>
constexpr int kDqSmem = 2 * 2 * kStageBytes<T, D> +
                        (kIsF32<T> ? 4 * kPlaneBytes<D> : 0);

template <int D>
constexpr int kSwzTileBytes = kRows * kTileD<D> * 2;

// 1024 bytes of alignment slack, the swizzled tiles (6; 8 for f32), the
// f32 dO tile, two f32 Q slots for f32 q, two lse / delta / dlse slots,
// the mbarrier of the dO copies
template <typename T, int D>
constexpr int kDkvSmem = 1024 + (kIsF32<T> ? 8 : 6) * kSwzTileBytes<D> +
                         kRows * D * 4 + (kIsF32<T> ? 2 * kRows * D * 4 : 0) +
                         2 * 3 * kRows * 4 + 16;

// blocks an SM the registers must allow: three at D <= 64 (168
// registers a thread); at D = 128, two for dq (255: its Q, dO and dq
// fragments take 160 in bf16) and one for dk/dv (255: the dk and dv
// accumulators take 128 beside S^T and dP^T, and its tiles 131 KB of
// shared memory in bf16); two for f32 dk/dv at D <= 64, whose tile
// products are summed apart (attn_mma.cuh, dkv_finish)
template <int D>
constexpr int kDqMinBlocks = D > 64 ? 2 : 3;
template <typename T, int D>
constexpr int kDkvMinBlocks = D > 64 ? 1 : kIsF32<T> ? 2 : 3;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, kDqMinBlocks<D>) bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ seg_q,
    const int* __restrict__ pos_q, const int* __restrict__ seg_k,
    const int* __restrict__ pos_k, const float* __restrict__ lse,
    const float* __restrict__ dout, const float* __restrict__ delta,
    const float* __restrict__ dlse, T* __restrict__ dq, int H, int KH,
    int Sq, int Sk, float scale, int kind, int window, int chunk) {
  constexpr bool kF32 = kIsF32<T>;
  constexpr int LD = kLd<D>;
  constexpr int kStageLd = kF32 ? D : LD;
  extern __shared__ __align__(16) unsigned char smem[];
  // ring: slot s holds K at stage(2s), V at stage(2s + 1); f32 planes after
  auto stage = [&](int i) {
    return reinterpret_cast<T*>(smem + i * kStageBytes<T, D>);
  };
  bf16* planes = reinterpret_cast<bf16*>(smem + 4 * kStageBytes<T, D>);
  constexpr int kPlane = kRows * LD;  // elements

  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kRows, w0 = q0 + 16 * warp;
  const int ra = w0 + g, rb = ra + 8;
  const size_t hq = ((size_t)b * H + h) * Sq;
  const int* qsg = seg_q + (size_t)b * Sq;
  const int* qps = pos_q + (size_t)b * Sq;
  const int* ksg = seg_k + (size_t)b * Sk;
  const int* kps = pos_k + (size_t)b * Sk;
  const T* kb = k + ((size_t)b * KH + kh) * Sk * D;
  const T* vb = v + ((size_t)b * KH + kh) * Sk * D;

  // this lane's two rows: softmax stats and mask metadata
  const bool ina = ra < Sq, inb = rb < Sq;
  // exp(s * scale - lse) as 2^(s * scale * log2e - lse * log2e)
  const float sl2 = scale * kLog2e;
  BwdRows rows;
  rows.la = ina ? lse[hq + ra] * kLog2e : 0.f;
  rows.lb = inb ? lse[hq + rb] * kLog2e : 0.f;
  rows.ea = ina ? delta[hq + ra] : 0.f;
  rows.eb = inb ? delta[hq + rb] : 0.f;
  rows.ga = ina ? dlse[hq + ra] : 0.f;
  rows.gb = inb ? dlse[hq + rb] : 0.f;
  const int sa = ina ? qsg[ra] : kPad, sb = inb ? qsg[rb] : kPad;
  const int pa = ina ? qps[ra] : 0, pb = inb ? qps[rb] : 0;

  AFrags<D / 16, kF32> qf;
  AFrags<D / 16, true> of;
  load_a<D>(qf, q + hq * D, w0, Sq, lane);
  load_a<D>(of, dout + hq * D, w0, Sq, lane);
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const Ranges qr = tile_ranges(qsg, qps, q0, Sq, lane);
  const int nt = (Sk + kRows - 1) / kRows;
  // the first tile at or after `from` with a valid pair (nt if none), its
  // class and this lane's element bits (all set for a full tile); the
  // same answer in every warp, so the block branches together
  auto find = [&](int from, int& cls, unsigned& bits) {
    for (int j = from; j < nt; ++j) {
      const int c = classify(qr, tile_ranges(ksg, kps, j * kRows, Sk, lane),
                             kind, window, chunk);
      if (c == kNone) continue;
      unsigned bb = ~0u;
      if (c == kPartial) {
        bb = elem_bits<true>(sa, pa, sb, pb, ksg, kps, j * kRows, Sk, t,
                             kind, window, chunk);
        if (!__syncthreads_or(bb != 0u)) continue;
      }
      cls = c;
      bits = bb;
      return j;
    }
    return nt;
  };
  auto load = [&](int j, int slot) {
    stage_tile<T, D>(stage(2 * slot), kStageLd, kb, j * kRows, Sk, tid);
    stage_tile<T, D>(stage(2 * slot + 1), kStageLd, vb, j * kRows, Sk, tid);
  };

  int cls = kNone;
  unsigned bits = 0u;
  int cur = find(0, cls, bits);
  if (cur < nt) load(cur, 0);
  cp_async_commit();
  for (int it = 0; cur < nt; ++it) {
    int cls_n = kNone;
    unsigned bits_n = 0u;
    const int nxt = find(cur + 1, cls_n, bits_n);
    __syncthreads();              // the other slot's last readers are done
    if (nxt < nt) load(nxt, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();              // tile `cur` has landed for every thread
    const int slot = it & 1;
    const bf16 *kt, *vt, *ktl = nullptr, *vtl = nullptr;
    if constexpr (kF32) {
      split_tile<D>(reinterpret_cast<const float*>(stage(2 * slot)), planes,
                    planes + kPlane, LD, tid);
      split_tile<D>(reinterpret_cast<const float*>(stage(2 * slot + 1)),
                    planes + 2 * kPlane, planes + 3 * kPlane, LD, tid);
      __syncthreads();
      kt = planes;
      ktl = planes + kPlane;
      vt = planes + 2 * kPlane;
      vtl = planes + 3 * kPlane;
    } else {
      kt = reinterpret_cast<const bf16*>(stage(2 * slot));
      vt = reinterpret_cast<const bf16*>(stage(2 * slot + 1));
    }
    if (cls == kFull)
      dq_tile<true, kF32, true, D>(acc, qf, of, kt, ktl, vt, vtl, LD, bits,
                                   rows, sl2, scale, lane);
    else
      dq_tile<false, kF32, true, D>(acc, qf, of, kt, ktl, vt, vtl, LD, bits,
                                    rows, sl2, scale, lane);
    cur = nxt;
    cls = cls_n;
    bits = bits_n;
  }
  cp_async_wait<0>();
  store_acc<T, D>(dq + hq * D, acc, w0, Sq, lane);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, kDkvMinBlocks<T, D>)
    bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ seg_q,
    const int* __restrict__ pos_q, const int* __restrict__ seg_k,
    const int* __restrict__ pos_k, const float* __restrict__ lse,
    const float* __restrict__ dout, const float* __restrict__ delta,
    const float* __restrict__ dlse, T* __restrict__ dk,
    T* __restrict__ dv, int H, int KH, int Sq, int Sk, float scale,
    int kind, int window, int chunk) {
  constexpr bool kF32 = kIsF32<T>;
  constexpr int kTile = kSwzTileBytes<D>;
  extern __shared__ __align__(16) unsigned char smem_in[];
  // swizzled bf16 tiles on a 1024-byte boundary: Q (ring slots 0 and 1;
  // for f32 q its hi and lo), dO hi, dO lo, the block's K and V (and
  // their lo tiles for f32); then the dense f32 dO tile (free again once
  // split, so the next one loads during compute), for f32 q two dense
  // f32 Q slots, and the lse / delta / dlse slots
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
  float* meta_all = q_raw + (kF32 ? 2 * kRows * D : 0);
  uint64_t* bar = reinterpret_cast<uint64_t*>(meta_all + 2 * 3 * kRows);

  const int kh = blockIdx.y, b = blockIdx.z;
  const int group = H / KH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kRows, w0 = k0 + 16 * warp;
  const int ra = w0 + g, rb = ra + 8;
  const size_t hk = ((size_t)b * KH + kh) * Sk;
  const int* qsg = seg_q + (size_t)b * Sq;
  const int* qps = pos_q + (size_t)b * Sq;
  const int* ksg = seg_k + (size_t)b * Sk;
  const int* kps = pos_k + (size_t)b * Sk;
  const int sa = ra < Sk ? ksg[ra] : kPad, sb = rb < Sk ? ksg[rb] : kPad;
  const int pa = ra < Sk ? kps[ra] : 0, pb = rb < Sk ? kps[rb] : 0;

  if (tid == 0) mbar_init(bar);
  zero_pad_cols<D>(tiles, kTiles, tid);   // D = 16 and 80: padded widths
  __syncthreads();
  // m64nW accumulators of the warpgroup, W = kTileD<D>
  float ak[kTileD<D> / 2], av[kTileD<D> / 2];
#pragma unroll
  for (int i = 0; i < kTileD<D> / 2; ++i) ak[i] = av[i] = 0.f;

  const float sl2 = scale * kLog2e;
  const Ranges kr = tile_ranges(ksg, kps, k0, Sk, lane);
  const int nqt = (Sq + kRows - 1) / kRows, nt = group * nqt;
  // as in the dq kernel, over the (group member, q tile) pairs; the
  // class depends on the q tile only (seg/pos are shared by the heads)
  auto find = [&](int from, int& cls, unsigned& bits) {
    for (int j = from; j < nt; ++j) {
      const int qr0 = (j % nqt) * kRows;
      const int c = classify(tile_ranges(qsg, qps, qr0, Sq, lane), kr, kind,
                             window, chunk);
      if (c == kNone) continue;
      unsigned bb = ~0u;
      if (c == kPartial) {
        bb = elem_bits<false>(sa, pa, sb, pb, qsg, qps, qr0, Sq, t, kind,
                              window, chunk);
        if (!__syncthreads_or(bb != 0u)) continue;
      }
      cls = c;
      bits = bb;
      return j;
    }
    return nt;
  };
  auto load = [&](int j, int slot) {
    const int m = j / nqt, qr0 = (j % nqt) * kRows;
    const size_t hr = ((size_t)b * H + kh * group + m) * Sq;
    if constexpr (kF32)
      stage_tile<float, D>(q_raw + slot * kRows * D, D, q + hr * D, qr0, Sq,
                           tid);
    else
      stage_swz<D>(tiles + slot * kTile, q + hr * D, qr0, Sq, tid);
    // one bulk copy; a ragged tile's last rows are zeroed (finite values
    // in the masked columns of P^T.dO)
    const int rows = min(kRows, Sq - qr0);
    if (tid == 0) bulk_load(do_raw, dout + (hr + qr0) * D, rows * D * 4, bar);
    for (int i = rows * D + tid * 4; i < kRows * D; i += kThreads * 4)
      *reinterpret_cast<float4*>(do_raw + i) = make_float4(0.f, 0.f, 0.f, 0.f);
    float* meta = meta_all + slot * 3 * kRows;
    if (Sq % 4 == 0) {            // rows of 16 bytes: 16-byte copies
      for (int i = tid; i < 3 * kRows / 4; i += kThreads) {
        const int which = i / (kRows / 4), r = qr0 + 4 * (i % (kRows / 4));
        const float* src = which == 0 ? lse : which == 1 ? delta : dlse;
        const int bytes = 4 * min(max(Sq - r, 0), 4);
        cp_async16(meta + 4 * i, bytes ? src + hr + r : src, bytes);
      }
    } else {
      for (int i = tid; i < 3 * kRows; i += kThreads) {
        const int which = i / kRows, r = qr0 + i % kRows;
        const float* src = which == 0 ? lse : which == 1 ? delta : dlse;
        const bool in = r < Sq;
        cp_async4(meta + i, in ? src + hr + r : src, in);
      }
    }
  };

  float s[32], dp[32];               // S^T and dP^T of the staged tile

  // the tile after next is found while this one's first products run
  int cls = kNone, cls_n = kNone;
  unsigned bits = 0u, bits_n = 0u;
  int cur = find(0, cls, bits);
  if (cur < nt) load(cur, 0);
  cp_async_commit();
  // the block's K and V as wgmma A tiles, while the first tile loads
  fill_swz<D>(k_hi, k_lo, k + hk * D, k0, Sk, tid);
  fill_swz<D>(v_hi, v_lo, v + hk * D, k0, Sk, tid);
  int nxt = cur < nt ? find(cur + 1, cls_n, bits_n) : nt;
  for (int it = 0; cur < nt; ++it) {
    cp_async_wait<0>();
    mbar_wait(bar, it & 1);
    __syncthreads();              // tile `cur` has landed; the last
                                  // tile's products are done
    const int slot = it & 1;
    split_tile_swz<D>(do_raw, do_hi, do_lo, tid);
    if constexpr (kF32)
      split_tile_swz<D>(q_raw + slot * kRows * D, tiles, tiles + kTile, tid);
    fence_async_smem();
    __syncthreads();              // tiles written, the dO tile is free
    if (nxt < nt) load(nxt, slot ^ 1);
    cp_async_commit();
    const unsigned char* qh = kF32 ? tiles : tiles + slot * kTile;
    const unsigned char* ql = tiles + kTile;
    dkv_issue<kF32, D>(s, dp, k_hi, k_lo, v_hi, v_lo, qh, ql, do_hi, do_lo);
    int cls_nn = kNone;
    unsigned bits_nn = 0u;
    const int nn = nxt < nt ? find(nxt + 1, cls_nn, bits_nn) : nt;
    const float* meta = meta_all + slot * 3 * kRows;
    if (cls == kFull)
      dkv_finish<true, kF32, true, D>(ak, av, s, dp, qh, ql, do_hi, do_lo,
                                      meta, bits, sl2, scale, lane);
    else
      dkv_finish<false, kF32, true, D>(ak, av, s, dp, qh, ql, do_hi, do_lo,
                                       meta, bits, sl2, scale, lane);
    cur = nxt;
    cls = cls_n;
    bits = bits_n;
    nxt = nn;
    cls_n = cls_nn;
    bits_n = bits_nn;
  }
  cp_async_wait<0>();
  store_acc<T, D>(dk + hk * D, ak, w0, Sk, lane);
  store_acc<T, D>(dv + hk * D, av, w0, Sk, lane);
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
  constexpr int bytes = kDqSmem<T, D>;
  auto* kernel = bwd_dq_kernel<T, D>;
  static bool sized = false;      // dynamic shared memory above 48 KB
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  const dim3 grid((a.Sq + kRows - 1) / kRows, a.H, a.B);
  kernel<<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.seg_q, a.pos_q, a.seg_k, a.pos_k,
      a.lse, a.dout, a.delta, a.dlse, static_cast<T*>(dq), a.H, a.KH, a.Sq,
      a.Sk, a.scale, a.kind, a.window, a.chunk);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv) {
  constexpr int bytes = kDkvSmem<T, D>;
  auto* kernel = bwd_dkv_kernel<T, D>;
  static bool sized = false;      // dynamic shared memory above 48 KB
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  const dim3 grid((a.Sk + kRows - 1) / kRows, a.KH, a.B);
  kernel<<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.seg_q, a.pos_q, a.seg_k, a.pos_k,
      a.lse, a.dout, a.delta, a.dlse, static_cast<T*>(dk),
      static_cast<T*>(dv), a.H, a.KH, a.Sq, a.Sk, a.scale, a.kind,
      a.window, a.chunk);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
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

// FCP_ENTRY selects the entry point a translation unit defines: the build
// compiles this file once per entry (1, 2) and links both objects into
// one library, so the two halves of its instantiations compile at once;
// left undefined, both are defined.
#ifndef FCP_ENTRY
#define FCP_ENTRY 0
#endif

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and the outputs share it);
// D is 16, 32, 64, 80 or 128; q, k, v and dout 16-byte aligned
// (cp.async).  Each returns cudaGetLastError() after its launch.
#if FCP_ENTRY != 2
extern "C" int fcp_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* seg_q,
    const void* pos_q, const void* seg_k, const void* pos_k,
    const void* lse, const void* dout, const void* delta, const void* dlse,
    void* dq, int B, int H, int KH, int Sq, int Sk, int D, int dtype,
    float scale, int kind, int window, int chunk, void* stream) {
  if (B * H * Sq == 0) return 0;
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout)))
    return cudaErrorMisalignedAddress;
  const Args a = make_args(q, k, v, seg_q, pos_q, seg_k, pos_k, lse, dout,
                           delta, dlse, B, H, KH, Sq, Sk, scale, kind,
                           window, chunk, stream);
  if (dtype == 0 && D == 16) return launch_dq<float, 16>(a, dq);
  if (dtype == 1 && D == 16) return launch_dq<__nv_bfloat16, 16>(a, dq);
  if (dtype == 0 && D == 32) return launch_dq<float, 32>(a, dq);
  if (dtype == 0 && D == 64) return launch_dq<float, 64>(a, dq);
  if (dtype == 1 && D == 32) return launch_dq<__nv_bfloat16, 32>(a, dq);
  if (dtype == 1 && D == 64) return launch_dq<__nv_bfloat16, 64>(a, dq);
  if (dtype == 0 && D == 80) return launch_dq<float, 80>(a, dq);
  if (dtype == 1 && D == 80) return launch_dq<__nv_bfloat16, 80>(a, dq);
  if (dtype == 0 && D == 128) return launch_dq<float, 128>(a, dq);
  if (dtype == 1 && D == 128) return launch_dq<__nv_bfloat16, 128>(a, dq);
  return cudaErrorInvalidValue;
}
#endif

#if FCP_ENTRY != 1

extern "C" int fcp_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* seg_q,
    const void* pos_q, const void* seg_k, const void* pos_k,
    const void* lse, const void* dout, const void* delta, const void* dlse,
    void* dk, void* dv, int B, int H, int KH, int Sq, int Sk, int D,
    int dtype, float scale, int kind, int window, int chunk, void* stream) {
  if (B * KH * Sk == 0) return 0;
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout)))
    return cudaErrorMisalignedAddress;
  const Args a = make_args(q, k, v, seg_q, pos_q, seg_k, pos_k, lse, dout,
                           delta, dlse, B, H, KH, Sq, Sk, scale, kind,
                           window, chunk, stream);
  if (dtype == 0 && D == 16) return launch_dkv<float, 16>(a, dk, dv);
  if (dtype == 1 && D == 16) return launch_dkv<__nv_bfloat16, 16>(a, dk, dv);
  if (dtype == 0 && D == 32) return launch_dkv<float, 32>(a, dk, dv);
  if (dtype == 0 && D == 64) return launch_dkv<float, 64>(a, dk, dv);
  if (dtype == 1 && D == 32) return launch_dkv<__nv_bfloat16, 32>(a, dk, dv);
  if (dtype == 1 && D == 64) return launch_dkv<__nv_bfloat16, 64>(a, dk, dv);
  if (dtype == 0 && D == 80) return launch_dkv<float, 80>(a, dk, dv);
  if (dtype == 1 && D == 80) return launch_dkv<__nv_bfloat16, 80>(a, dk, dv);
  if (dtype == 0 && D == 128) return launch_dkv<float, 128>(a, dk, dv);
  if (dtype == 1 && D == 128)
    return launch_dkv<__nv_bfloat16, 128>(a, dk, dv);
  return cudaErrorInvalidValue;
}
#endif
