// Tensor-core building blocks of the attention kernels (sm_90a).
//
// Used by all six: flash_attention_fwd.cu (kernel 2), fused_flash_fwd.cu
// (kernel 1), fused_flash_bwd_dq.cu (kernel 3), fused_flash_bwd_dkv.cu
// (kernel 4) and flash_attention_bwd.cu (kernels 5 and 6).  Everything
// here works on a 64-row block of four warps, 16 rows each:
//
//   * mma.sync m16n8k16, bf16 operands, f32 accumulators, with the
//     fragments of the PTX ISA (g = lane / 4, t = lane % 4):
//       A (16 x 16, row-major): a0 (row g, k 2t..2t+1), a1 (row g+8, k
//       2t..), a2 (row g, k 2t+8..), a3 (row g+8, k 2t+8..);
//       B (16 x 8): b0 (k 2t..2t+1, column g), b1 (k 2t+8.., column g);
//       C (16 x 8): c0, c1 (row g, columns 2t, 2t+1), c2, c3 (row g+8).
//     An accumulator pair of n8 tiles is, element for element, the A
//     fragment of a k16 step (FA2's register re-use: P and dS never go
//     through shared memory).
//   * ldmatrix (.trans for transposed operands) from bf16 tiles whose
//     rows are padded by 8 elements, so the 8 row addresses of each 8x8
//     matrix fall in distinct banks;
//   * wgmma (m64nNk16) with B, and optionally A, from 128B- or
//     64B-swizzled bf16 tiles through descriptors (section wgmma);
//   * cp.async staging of 64-row tiles into a double-buffered ring, and
//     one-thread bulk copies (cp.async.bulk) completing an mbarrier;
//   * the split of an f32 operand x into hi = bf16(x) and lo = bf16(x -
//     hi): x = hi + lo + O(2^-17 |x|), so hi.y + lo.y (+ hi.y_lo) in the
//     f32 accumulator reproduces an f32 product to ~2^-16 per term;
//   * the per-tile mask classes (no valid pair / some / all) from the
//     (segment, position) ranges of the two sides, and the per-element
//     validity bits of a partial tile (_mask_tile of the reference);
//   * the forward tile (section forward): one 64-key step of the online
//     softmax of a warp's 16 query rows, shared by kernels 1 and 2.
//     It replaces the body of the TPU kernels _fwd_kernel (:63) and
//     _fused_fwd_kernel (:346) of src/repro/kernels/flash_attention.py.
//     At the training block (B 4, H 32, 512 x 512 keys, D 64, bf16) the
//     work is 8.6e9 flop on 4.2e7 bytes, at kernel 1's serve shape 3.3e10
//     on 2.2e8: 150-200 flop a byte, under the H100's ~295, so the bytes
//     set the roofline floor with the operations close behind.  What
//     holds the tile on the card is the latency of each warp's chain S ->
//     softmax -> P.V (1.0-1.4 us of SM time per 64 x 64 tile, some three
//     times what mma.sync issue alone needs; PERF.md section 6).  The
//     design keeps every product on the tensor cores (S = Q.K^T and O +=
//     P.V, mma.sync m16n8k16), Q in registers for the whole block, K and
//     V through a cp.async ring (tile_pipe) so the next tile loads while
//     this one computes, P straight from the S accumulators as the A
//     fragment of P.V, the exponent folded into one FMA and one MUFU.EX2
//     per score, and the tiles' classes found before the loop
//     (classify_tiles), so it waits on no metadata load;
//   * the backward tiles (section backward): a warp's dq against one
//     64-key tile (mma.sync) and a warpgroup's dk / dv against one 64-row
//     q tile (wgmma), shared by kernels 3 and 5 (dq) and 4 and 6 (dk /
//     dv).  They replace the bodies of _fused_dq_kernel (:475),
//     _fused_dkv_kernel (:590), _bwd_dq_kernel and _bwd_dkv_kernel
//     (launched at :264 and :289); the one difference between the pairs,
//     the per-step kernels' dlse term, is a compile-time switch.

#pragma once

#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fcp_mma {

constexpr int kPad = -1;
constexpr int kRows = 64;          // rows of a block and of a partner tile
constexpr int kWarps = 4;          // 16 rows each
constexpr int kThreads = kWarps * 32;

using bf16 = __nv_bfloat16;

// MaskSpec.visible: kind 0 causal, 1 sliding_window, 2 chunked, 3 full
__device__ __forceinline__ bool visible(int kind, int window, int chunk,
                                        int pq, int pk) {
  bool ok = kind == 3 || pq >= pk;
  if (window) ok = ok && (pq - pk < window);
  if (chunk) ok = ok && (pq / chunk == pk / chunk);
  return ok;
}

// ---------------------------------------------------------------- PTX

constexpr float kLog2e = 1.4426950408889634f;

// 2^x (MUFU.EX2, as __expf uses it); -inf and large negative x give 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, of which the first `bytes` (0..16) are
// read and the rest zeroed
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// an mbarrier in shared memory that one bulk copy at a time completes
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile(
      "mbarrier.init.shared::cta.b64 [%0], 1;\n"
      "fence.mbarrier_init.release.cluster;\n" ::"r"(smem_u32(bar))
      : "memory");
}

// one thread: copy `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory in one bulk transfer that completes `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%2], [%3], %1, [%0];\n" ::"r"(smem_u32(bar)),
      "r"(bytes), "r"(smem_u32(dst)), "l"(src)
      : "memory");
}

// wait until the phase of `bar` with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a . b  (m16n8k16, bf16 x bf16 -> f32)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ldmatrix lane addresses of a 16 x 16 bf16 block at (row0, col0) of a
// tile with row stride `ld`, giving B fragments of two n8 tiles:
// r[0], r[1] for the first, r[2], r[3] for the second.
//   b_rows: the tile stores B^T (rows are n, columns are k): non-trans.
//   b_cols: the tile stores B (rows are k, columns are n): trans.
__device__ __forceinline__ int b_rows_off(int row0, int col0, int ld,
                                          int lane) {
  return (row0 + (lane & 7) + ((lane >> 4) << 3)) * ld + col0 +
         ((lane >> 3) & 1) * 8;
}

__device__ __forceinline__ int b_cols_off(int row0, int col0, int ld,
                                          int lane) {
  return (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + col0 +
         (lane >> 4) * 8;
}

// ---------------------------------------------------------------- wgmma
//
// Warpgroup products with A from registers (each warp's 16 rows, in the
// mma.sync A layout above) and B from a shared-memory tile of bf16 rows
// of D elements (128 B for D = 64, 64 B for D = 32 and 16), swizzled as the
// descriptor says (128B or 64B: the 16-byte chunk c of row r sits at
// chunk c ^ swz(r)); the tile is 1024-byte aligned.  The accumulator of
// m64nN is, per warp, N / 8 mma.sync C tiles in order.  The same tile
// serves as B both ways: rows as N with k along the row ("K-major", k16
// step = +32 B) and rows as k ("MN-major", transposed, k16 step = +16
// rows); 8-row groups are SBO bytes apart in both.
//
// A D = 128 row (256 B) is wider than the widest swizzle atom, so a D =
// 128 tile is two D = 64 tiles of 64 rows side by side: columns [0, 64),
// then [64, 128) kRows * 128 bytes further.  Each half is a 128B-swizzled
// tile as at D = 64, so every descriptor is a D = 64 one: a K-major k16
// step past column 64 moves to the second half (kstep_off), and an N =
// 128 product is two m64n64 products, one per half (wgmma_nd).
//
// A D = 80 row (160 B, zamba2's heads) is no whole number of swizzle
// atoms, so it lies in a D = 128 tile (kTileD): columns [0, 64) in the
// first half, [64, 80) at the start of the second.  Copies and stores
// touch the 80 columns only.  A product over D as its depth (S^T, dP^T)
// takes the 5 k16 steps of the real columns; one with D as its N (dV,
// dK) runs the whole second half, and its accumulators of columns 80 ..
// 127, which read only never-written tile columns, are never stored.
// That costs 1.6x the dV / dK products of a 5-step tile: a simple layout
// first (a narrower second swizzle would cut it).
//
// A D = 16 row (32 B) is narrower than the narrowest swizzle atom (64B),
// so it lies in a D = 32 tile the same way: columns [0, 16) of each
// 64-byte row.  Its one k16 step is the D = 32 tile's first; the dV / dK
// products run N = 32 (wgmma m64n32k16), twice the work of the real
// columns.  In both padded widths the columns past D are zeroed once per
// block (zero_pad_cols) and never written again, so their accumulators
// hold 0 and are not stored.

// the width of the swizzled tile that holds a row of D elements
template <int D>
constexpr int kTileD = D == 80 ? 128 : D == 16 ? 32 : D;

// columns of one swizzled part of a tile of width W: W, or 64 for W = 128
template <int W>
constexpr int kSwzCols = W < 64 ? W : 64;

template <int W>
__device__ __forceinline__ int swz(int r) {
  static_assert(W == 32 || W == 64 || W == 128,
                "rows of 64 or 128 bytes, or two halves of 128");
  return W == 32 ? ((r >> 1) & 3) : (r & 7);
}

// byte offset of element (r, c) of a swizzled [kRows, W] bf16 tile
template <int W>
__device__ __forceinline__ int swz_off(int r, int c) {
  constexpr int kC = kSwzCols<W>;
  return (c / kC) * (kRows * kC * 2) + r * kC * 2 +
         (((((c % kC) >> 3) ^ swz<W>(r)) << 4) | ((c & 7) * 2));
}

// byte offset of k16 step kd along a K-major row (columns 16 kd ..)
template <int W>
__device__ __forceinline__ int kstep_off(int kd) {
  return swz_off<W>(0, 16 * kd);
}

// byte offset of 16 rows further (an MN-major k16 step)
template <int W>
__device__ __forceinline__ int rows_off(int kk) {
  return kk * 16 * kSwzCols<W> * 2;
}

template <int W>
__device__ __forceinline__ uint64_t gmma_desc(const void* tile) {
  const uint32_t a = smem_u32(tile);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)((8 * kSwzCols<W> * 2) >> 4) << 32) |
         ((uint64_t)(W == 32 ? 2 : 1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until every committed group has completed
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// shared-memory writes of this thread (st.shared, cp.async) made visible
// to the async proxy that wgmma reads through; a barrier follows
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keep registers a wgmma in flight reads or writes where they are
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (+)= a . B, m64n64k16; kTrans: the tile holds B with k along rows
template <int kTrans>
__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc),
        "n"(kTrans));
}

template <int kTrans>
__device__ __forceinline__ void wgmma_n32(float (&d)[16],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc),
        "n"(kTrans));
}

// d (+)= A . B, m64n64k16, both from shared memory (K-major tiles)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(acc));
}

// d += a . B with N = W (the dk / dv products), B the swizzled tile of
// width W at `tile`; W = 128: one m64n64 product per column half, the
// first half's accumulators in d[0, 32), the second's in d[32, 64) (the
// m64n128 accumulator order)
template <int W, int kTrans>
__device__ __forceinline__ void wgmma_nd(float (&d)[W / 2],
                                         const uint32_t (&a)[4],
                                         const unsigned char* tile) {
  if constexpr (W == 128) {
    wgmma_n64<kTrans>(*reinterpret_cast<float(*)[32]>(&d[0]), a,
                      gmma_desc<W>(tile), 1);
    wgmma_n64<kTrans>(*reinterpret_cast<float(*)[32]>(&d[32]), a,
                      gmma_desc<W>(tile + kRows * 128), 1);
  } else if constexpr (W == 64) {
    wgmma_n64<kTrans>(d, a, gmma_desc<W>(tile), 1);
  } else {
    wgmma_n32<kTrans>(d, a, gmma_desc<W>(tile), 1);
  }
}

// cp.async rows [r0, r0 + 64) of a row-major [n, D] bf16 matrix into a
// swizzled tile of width kTileD<D>; rows >= n are zero-filled
template <int D>
__device__ __forceinline__ void stage_swz(unsigned char* dst, const bf16* src,
                                          int r0, int n, int tid) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = tid; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool in = r0 + r < n;
    cp_async16(dst + swz_off<kTileD<D>>(r, c * 8),
               in ? src + (size_t)(r0 + r) * D + c * 8 : src, in ? 16 : 0);
  }
}

// zero the columns [D, kTileD<D>) of n swizzled tiles laid end to end at
// `tiles` (a padded width only; the copies and stores move D columns)
template <int D>
__device__ __forceinline__ void zero_pad_cols(unsigned char* tiles, int n,
                                              int tid) {
  constexpr int W = kTileD<D>;
  if constexpr (W != D) {
    constexpr int kChunks = (W - D) / 8;      // 16-byte chunks a row
    for (int i = tid; i < n * kRows * kChunks; i += kThreads) {
      const int tile = i / (kRows * kChunks), r = (i / kChunks) % kRows;
      const int c = D + (i % kChunks) * 8;
      *reinterpret_cast<uint4*>(tiles + tile * (kRows * W * 2) +
                                swz_off<W>(r, c)) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// ---------------------------------------------------------------- split

__device__ __forceinline__ uint32_t bits_of(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x0, x1) -> packed bf16 hi and lo (x0 in the low half)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits_of(h);
  lo = bits_of(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// (x0, x1) -> packed bf16 hi and lo with hi = x truncated to bf16 (its
// upper 16 bits, one byte permute) and lo = bf16(x - hi): x - hi is exact
// in f32, |lo| < 2^-7 |x|, so hi + lo = x + O(2^-16 |x|) at one F2FP a
// pair instead of two
__device__ __forceinline__ void split2_trunc(float x0, float x1,
                                             uint32_t& hi, uint32_t& lo) {
  const uint32_t u0 = __float_as_uint(x0), u1 = __float_as_uint(x1);
  hi = __byte_perm(u0, u1, 0x7632);
  lo = bits_of(__floats2bfloat162_rn(x0 - __uint_as_float(u0 & 0xffff0000u),
                                     x1 - __uint_as_float(u1 & 0xffff0000u)));
}

// A fragments of one operand: hi always, lo where the operand is f32
template <int N, bool kLo>
struct AFrags {
  uint32_t hi[N][4];
  uint32_t lo[kLo ? N : 1][4];
};

// A fragments of rows [row0, row0 + 16) x all D columns of a row-major
// [n, D] matrix in global memory with row stride ld elements (rows >= n
// read as 0), one per k16 step.  bf16 is taken as it is; f32 is split
// into hi and lo.
template <int D>
__device__ __forceinline__ void load_a(AFrags<D / 16, false>& f,
                                       const bf16* m, int row0, int n,
                                       int lane, long long ld = D) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + g + (i & 1) * 8;
      const int c = 16 * kd + 2 * t + (i >> 1) * 8;
      f.hi[kd][i] =
          r < n ? *reinterpret_cast<const uint32_t*>(m + r * ld + c) : 0u;
    }
}

template <int D>
__device__ __forceinline__ void load_a(AFrags<D / 16, true>& f,
                                       const float* m, int row0, int n,
                                       int lane, long long ld = D) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + g + (i & 1) * 8;
      const int c = 16 * kd + 2 * t + (i >> 1) * 8;
      const float2 x =
          r < n ? *reinterpret_cast<const float2*>(m + r * ld + c)
                : make_float2(0.f, 0.f);
      split2(x.x, x.y, f.hi[kd][i], f.lo[kd][i]);
    }
}

// ---------------------------------------------------------------- tiles

// cp.async rows [r0, r0 + 64) of a [n, D] matrix whose rows are src_ld
// elements apart (16-byte aligned) into a tile with row stride `ld`
// elements; rows >= n are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void stage_tile(T* dst, int ld, const T* src,
                                           int r0, int n, int tid,
                                           long long src_ld = D) {
  constexpr int kPer = 16 / sizeof(T);          // elements per copy
  constexpr int kChunks = D / kPer;             // copies per row
#pragma unroll
  for (int i = tid; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * kPer;
    const bool in = r0 + r < n;
    cp_async16(dst + r * ld + c, in ? src + (r0 + r) * src_ld + c : src,
               in ? 16 : 0);
  }
}

// hi / lo swizzled bf16 tiles (width kTileD<D>) of a staged f32 [64, D]
// tile
template <int D>
__device__ __forceinline__ void split_tile_swz(const float* src,
                                               unsigned char* hi,
                                               unsigned char* lo, int tid) {
#pragma unroll
  for (int i = tid * 4; i < kRows * D; i += kThreads * 4) {
    const int r = i / D, c = i % D;
    const float4 x = *reinterpret_cast<const float4*>(src + i);
    uint2 h, l;
    split2(x.x, x.y, h.x, l.x);
    split2(x.z, x.w, h.y, l.y);
    const int off = swz_off<kTileD<D>>(r, c);
    *reinterpret_cast<uint2*>(hi + off) = h;
    *reinterpret_cast<uint2*>(lo + off) = l;
  }
}

// hi / lo bf16 planes (row stride ld) of a staged f32 [64, D] tile
template <int D>
__device__ __forceinline__ void split_tile(const float* src, bf16* hi,
                                           bf16* lo, int ld, int tid) {
#pragma unroll
  for (int i = tid * 4; i < kRows * D; i += kThreads * 4) {
    const int r = i / D, c = i % D;
    const float4 x = *reinterpret_cast<const float4*>(src + i);
    uint2 h, l;
    split2(x.x, x.y, h.x, l.x);
    split2(x.z, x.w, h.y, l.y);
    *reinterpret_cast<uint2*>(hi + r * ld + c) = h;
    *reinterpret_cast<uint2*>(lo + r * ld + c) = l;
  }
}

// rows [r0, r0 + 64) of a row-major [n, D] matrix into a swizzled bf16
// tile of width kTileD<D> (bf16 as it is; f32 split into a hi and a lo
// tile); rows >= n as 0
template <int D>
__device__ __forceinline__ void fill_swz(unsigned char* hi, unsigned char*,
                                         const bf16* src, int r0, int n,
                                         int tid) {
#pragma unroll
  for (int i = tid * 8; i < kRows * D; i += kThreads * 8) {
    const int r = i / D, c = i % D;
    const uint4 x = r0 + r < n ? *reinterpret_cast<const uint4*>(
                                     src + (size_t)(r0 + r) * D + c)
                               : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(hi + swz_off<kTileD<D>>(r, c)) = x;
  }
}

template <int D>
__device__ __forceinline__ void fill_swz(unsigned char* hi, unsigned char* lo,
                                         const float* src, int r0, int n,
                                         int tid) {
#pragma unroll
  for (int i = tid * 4; i < kRows * D; i += kThreads * 4) {
    const int r = i / D, c = i % D;
    const float4 x = r0 + r < n ? *reinterpret_cast<const float4*>(
                                      src + (size_t)(r0 + r) * D + c)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
    uint2 h, l;
    split2(x.x, x.y, h.x, l.x);
    split2(x.z, x.w, h.y, l.y);
    const int off = swz_off<kTileD<D>>(r, c);
    *reinterpret_cast<uint2*>(hi + off) = h;
    *reinterpret_cast<uint2*>(lo + off) = l;
  }
}

// ---------------------------------------------------------------- masks

// (segment, position) ranges of the candidate rows of a 64-row tile:
// rows inside [0, n) whose segment is not PAD.  `all`: every row is one.
struct Ranges {
  int smin, smax, pmin, pmax;
  bool all;
};

__device__ __forceinline__ Ranges tile_ranges(const int* seg, const int* pos,
                                              int r0, int n, int lane) {
  int s[kRows / 32], p[kRows / 32];
#pragma unroll
  for (int i = 0; i < kRows / 32; ++i) {      // all loads in flight at once
    const int row = r0 + lane + 32 * i;
    s[i] = row < n ? seg[row] : kPad;
    p[i] = row < n ? pos[row] : 0;
  }
  Ranges r{INT_MAX, INT_MIN, INT_MAX, INT_MIN, true};
#pragma unroll
  for (int i = 0; i < kRows / 32; ++i) {
    if (s[i] == kPad) {
      r.all = false;
      continue;
    }
    r.smin = min(r.smin, s[i]);
    r.smax = max(r.smax, s[i]);
    r.pmin = min(r.pmin, p[i]);
    r.pmax = max(r.pmax, p[i]);
  }
  r.smin = __reduce_min_sync(0xffffffffu, r.smin);
  r.smax = __reduce_max_sync(0xffffffffu, r.smax);
  r.pmin = __reduce_min_sync(0xffffffffu, r.pmin);
  r.pmax = __reduce_max_sync(0xffffffffu, r.pmax);
  r.all = __all_sync(0xffffffffu, r.all);
  return r;
}

enum TileClass { kNone = 0, kPartial = 1, kFull = 2 };

// The class of a (q tile, kv tile) pair from its two sides' ranges.
// kNone only where no pair can be valid; kFull only where every pair is
// (one segment on both sides, every row a candidate, visible for the
// extreme positions, hence for all).  The rest is kPartial.
__device__ __forceinline__ int classify(const Ranges& q, const Ranges& k,
                                        int kind, int window, int chunk) {
  if (q.smin > q.smax || k.smin > k.smax || q.smax < k.smin ||
      k.smax < q.smin)
    return kNone;
  if (kind != 3 && q.pmax < k.pmin) return kNone;
  if (window && q.pmin - k.pmax >= window) return kNone;
  if (chunk &&
      (q.pmax / chunk < k.pmin / chunk || q.pmin / chunk > k.pmax / chunk))
    return kNone;
  const bool one = q.all && k.all && q.smin == q.smax &&
                   k.smin == k.smax && q.smin == k.smin;
  const bool vis =
      (kind == 3 || q.pmin >= k.pmax) &&
      (!window || q.pmax - k.pmin < window) &&
      (!chunk ||
       min(q.pmin, k.pmin) / chunk == max(q.pmax, k.pmax) / chunk);
  return one && vis ? kFull : kPartial;
}

// Validity bits of this lane's 32 accumulator elements of a warp's
// 16 x 64 tile: bit 4j + e is element e of n8 tile j (row g for e < 2,
// g + 8 otherwise; column c0 + 8j + 2t + (e & 1)).  The rows' (seg, pos)
// are (sa, pa) / (sb, pb), PAD for a row outside the block's range; the
// columns' come from seg/pos [n].  kRowsQ: rows are queries (dq) or keys
// (dk/dv).
template <bool kRowsQ>
__device__ __forceinline__ unsigned elem_bits(int sa, int pa, int sb, int pb,
                                              const int* seg, const int* pos,
                                              int c0, int n, int t, int kind,
                                              int window, int chunk) {
  unsigned bits = 0u;
#pragma unroll
  for (int j = 0; j < kRows / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = c0 + 8 * j + 2 * t + e;
      const int sc = c < n ? seg[c] : kPad;
      if (sc == kPad) continue;
      const int pc = pos[c];
      const bool va = sc == sa && (kRowsQ ? visible(kind, window, chunk, pa, pc)
                                          : visible(kind, window, chunk, pc, pa));
      const bool vb = sc == sb && (kRowsQ ? visible(kind, window, chunk, pb, pc)
                                          : visible(kind, window, chunk, pc, pb));
      bits |= (va ? 1u : 0u) << (4 * j + e);
      bits |= (vb ? 1u : 0u) << (4 * j + 2 + e);
    }
  return bits;
}

// ---------------------------------------------------------------- store

__device__ __forceinline__ void store2(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}

__device__ __forceinline__ void store2(bf16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

// a warp's 16 x D f32 accumulators to rows row0.. of a row-major [n, D]
// output in T: D / 8 mma.sync C tiles, or the warp's part of a wgmma
// m64nW accumulator, W = kTileD<D> (the same tiles, flat; the columns
// past D are not stored)
template <typename T, int D>
__device__ __forceinline__ void store_acc(T* out, const float (&acc)[D / 8][4],
                                          int row0, int n, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int ra = row0 + g, rb = ra + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t;
    if (ra < n) store2(out + (size_t)ra * D + c, acc[j][0], acc[j][1]);
    if (rb < n) store2(out + (size_t)rb * D + c, acc[j][2], acc[j][3]);
  }
}

template <typename T, int D>
__device__ __forceinline__ void store_acc(T* out,
                                          const float (&acc)[kTileD<D> / 2],
                                          int row0, int n, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int ra = row0 + g, rb = ra + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t;
    if (ra < n) store2(out + (size_t)ra * D + c, acc[4 * j], acc[4 * j + 1]);
    if (rb < n)
      store2(out + (size_t)rb * D + c, acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// ---------------------------------------------------------------- pipe

// The classes (kNone / kPartial / kFull) of partner tiles j = 0 .. nt - 1
// against the block's own ranges `blk`, into cls[j], before the tile
// loop.  kBlockQ: the block's rows are queries and the tiles keys (kernels
// 1-3), or the other way round (kernel 4).  Warp w takes tiles 4w .. 4w +
// 3, then 16 further on, with all their seg/pos loads in flight at once;
// meta(j, seg, pos, r0, n) names tile j's metadata (rows [r0, r0 + 64) of
// seg/pos [n]).  The loop then finds its tiles in shared memory, off the
// critical path.
template <bool kBlockQ = true, typename Meta>
__device__ __forceinline__ void classify_tiles(unsigned char* cls, int nt,
                                               const Ranges& blk, Meta&& meta,
                                               int kind, int window,
                                               int chunk, int warp,
                                               int lane) {
  constexpr int kB = 4;               // tiles a warp classifies at once
  for (int j0 = warp * kB; j0 < nt; j0 += kWarps * kB) {
    int sg[kB][kRows / 32], ps[kB][kRows / 32];
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      const int* seg = nullptr;
      const int* pos = nullptr;
      int r0 = 0, n = 0;
      if (j0 + b < nt) meta(j0 + b, seg, pos, r0, n);
#pragma unroll
      for (int i = 0; i < kRows / 32; ++i) {
        const int row = r0 + lane + 32 * i;
        sg[b][i] = row < n ? seg[row] : kPad;
        ps[b][i] = row < n ? pos[row] : 0;
      }
    }
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      Ranges r{INT_MAX, INT_MIN, INT_MAX, INT_MIN, true};
#pragma unroll
      for (int i = 0; i < kRows / 32; ++i) {
        if (sg[b][i] == kPad) {
          r.all = false;
          continue;
        }
        r.smin = min(r.smin, sg[b][i]);
        r.smax = max(r.smax, sg[b][i]);
        r.pmin = min(r.pmin, ps[b][i]);
        r.pmax = max(r.pmax, ps[b][i]);
      }
      r.smin = __reduce_min_sync(0xffffffffu, r.smin);
      r.smax = __reduce_max_sync(0xffffffffu, r.smax);
      r.pmin = __reduce_min_sync(0xffffffffu, r.pmin);
      r.pmax = __reduce_max_sync(0xffffffffu, r.pmax);
      r.all = __all_sync(0xffffffffu, r.all);
      if (lane == 0 && j0 + b < nt)
        cls[j0 + b] = (unsigned char)(kBlockQ
                                          ? classify(blk, r, kind, window, chunk)
                                          : classify(r, blk, kind, window, chunk));
    }
  }
}

// the first tile at or after `from` that classify_tiles did not rule out
// (nt if none); the same in every thread
__device__ __forceinline__ int next_tile(const unsigned char* cls, int from,
                                         int nt) {
  while (from < nt && cls[from] == kNone) ++from;
  return from;
}

// Walk the kept tiles through a two-slot cp.async ring: load(j, slot)
// issues tile j's copies into a slot, body(slot, j) computes on it once
// it has landed; the next kept tile's copies run meanwhile.  One barrier
// a tile: after it, tile `cur` has landed for every thread and every
// thread is done with the other slot, which the next copy takes.  (A
// third slot measured slower: it leaves room for three blocks an SM, not
// four.)
template <typename Load, typename Body>
__device__ __forceinline__ void tile_pipe(const unsigned char* cls, int nt,
                                          Load&& load, Body&& body) {
  int cur = next_tile(cls, 0, nt);
  if (cur < nt) load(cur, 0);
  cp_async_commit();
  for (int it = 0; cur < nt; ++it) {
    cp_async_wait<0>();
    __syncthreads();
    const int nxt = next_tile(cls, cur + 1, nt);
    if (nxt < nt) load(nxt, (it + 1) & 1);
    cp_async_commit();
    body(it & 1, cur);
    cur = nxt;
  }
}

// cp.async the seg/pos of rows [r0, r0 + 64) of [n] (4-byte copies: any
// alignment) into seg_s / pos_s; rows >= n are zero-filled (elem_bits
// bounds its columns by n)
__device__ __forceinline__ void stage_meta(int* seg_s, int* pos_s,
                                           const int* seg, const int* pos,
                                           int r0, int n, int tid) {
  for (int i = tid; i < 2 * kRows; i += kThreads) {
    const int r = i % kRows;
    const bool in = r0 + r < n;
    const int* src = i < kRows ? seg : pos;
    cp_async4((i < kRows ? seg_s : pos_s) + r, in ? src + r0 + r : src, in);
  }
}

// ---------------------------------------------------------------- forward
//
// The forward tile works on a block of kWarps warps that owns 64 query
// rows, 16 a warp.  The online softmax runs in log2 units: a score s
// enters as x = s * scale * log2e, the running max m is kept in the same
// units and p = 2^(x - m) (one FMA and one MUFU.EX2).  Per lane: the
// accumulator fragments of rows g and g + 8 (D / 8 n8 tiles), their m,
// and this lane's part of each row's sum l — the quad's four parts add
// up to it, so a tile reduces only the row max over the quad.

constexpr float kNegInf = -1e30f;   // the reference's finite NEG_INF
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

template <int D>
struct FwdAcc {
  float o[D / 8][4];
  float m[2];
  float l[2];
};

// empty rows: (acc, m, l) = (0, NEG_INF, 0)
template <int D>
__device__ __forceinline__ void fwd_init(FwdAcc<D>& a) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    a.o[j][0] = a.o[j][1] = a.o[j][2] = a.o[j][3] = 0.f;
  a.m[0] = a.m[1] = kNegInf;
  a.l[0] = a.l[1] = 0.f;
}

// One 64-key tile of the online softmax: S = Q.K^T on the tensor cores
// (with f32 operands 3 products: hi.hi + hi.lo + lo.hi), the mask (kFull:
// none; otherwise this lane's `bits`, laid out as elem_bits<true> lays
// them out), the update of (acc, m, l), and acc += P.V with P split into
// bf16 hi + lo by split2_trunc (2 products; 3 with an f32 V).  P is the S
// accumulator re-packed as the A fragment of the k16 steps.  kt / vt: the
// staged bf16 K and V tiles (rows are keys, row stride ld), ktl / vtl:
// their lo planes (f32 only).
template <bool kFull, bool kF32, int D>
__device__ __forceinline__ void fwd_tile(FwdAcc<D>& a,
                                         const AFrags<D / 16, kF32>& qf,
                                         const bf16* kt, const bf16* ktl,
                                         const bf16* vt, const bf16* vtl,
                                         int ld, unsigned bits, float sl2,
                                         int lane) {
  constexpr int kN8 = kRows / 8;      // n8 tiles of scores
  float s[kN8][4];
#pragma unroll
  for (int j = 0; j < kN8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  if constexpr (kF32) {
    float sl[kN8][4];                 // the lo terms: shorter mma chains
#pragma unroll
    for (int j = 0; j < kN8; ++j)
      sl[j][0] = sl[j][1] = sl[j][2] = sl[j][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
#pragma unroll
      for (int c = 0; c < kRows / 16; ++c) {
        const int off = b_rows_off(16 * c, 16 * kd, ld, lane);
        uint32_t kf[4], kl[4];
        ldsm_x4(kf, kt + off);
        ldsm_x4(kl, ktl + off);
        mma(s[2 * c], qf.hi[kd], kf[0], kf[1]);
        mma(s[2 * c + 1], qf.hi[kd], kf[2], kf[3]);
        mma(sl[2 * c], qf.hi[kd], kl[0], kl[1]);
        mma(sl[2 * c + 1], qf.hi[kd], kl[2], kl[3]);
        mma(sl[2 * c], qf.lo[kd], kf[0], kf[1]);
        mma(sl[2 * c + 1], qf.lo[kd], kf[2], kf[3]);
      }
#pragma unroll
    for (int j = 0; j < kN8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += sl[j][e];
  } else {
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
#pragma unroll
      for (int c = 0; c < kRows / 16; ++c) {
        uint32_t kf[4];
        ldsm_x4(kf, kt + b_rows_off(16 * c, 16 * kd, ld, lane));
        mma(s[2 * c], qf.hi[kd], kf[0], kf[1]);
        mma(s[2 * c + 1], qf.hi[kd], kf[2], kf[3]);
      }
  }

  // masked scores to -inf; the tile's row max over the quad
  float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
  for (int j = 0; j < kN8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (!kFull)
        if (!((bits >> (4 * j + e)) & 1u)) s[j][e] = neg_inf();
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
  float mn[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    mn[r] = fmaxf(a.m[r], mx[r] * sl2);     // -inf * sl2 = -inf: no change
    const float alpha = exp2_approx(a.m[r] - mn[r]);
    a.m[r] = mn[r];
    a.l[r] *= alpha;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      a.o[j][2 * r] *= alpha;
      a.o[j][2 * r + 1] *= alpha;
    }
  }
#pragma unroll
  for (int j = 0; j < kN8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2_approx(fmaf(s[j][e], sl2, -mn[e >> 1]));
      s[j][e] = p;
      a.l[e >> 1] += p;
    }

  // acc += P.V, one k16 step per 16 keys.  The tensor cores add to their
  // accumulator with truncation, so a running acc fed to every mma drifts
  // toward zero over a long row (a scale bias of o): each k16 step's
  // products go to a zeroed fragment and join acc by FADD
#pragma unroll
  for (int kc = 0; kc < kRows / 16; ++kc) {
    uint32_t ph[4], pl[4];
    split2_trunc(s[2 * kc][0], s[2 * kc][1], ph[0], pl[0]);
    split2_trunc(s[2 * kc][2], s[2 * kc][3], ph[1], pl[1]);
    split2_trunc(s[2 * kc + 1][0], s[2 * kc + 1][1], ph[2], pl[2]);
    split2_trunc(s[2 * kc + 1][2], s[2 * kc + 1][3], ph[3], pl[3]);
#pragma unroll
    for (int nd = 0; nd < D / 16; ++nd) {
      const int off = b_cols_off(16 * kc, 16 * nd, ld, lane);
      uint32_t vf[4], vl[4];
      ldsm_x4_t(vf, vt + off);
      if constexpr (kF32) ldsm_x4_t(vl, vtl + off);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float t[4] = {0.f, 0.f, 0.f, 0.f};
        mma(t, ph, vf[2 * h], vf[2 * h + 1]);
        mma(t, pl, vf[2 * h], vf[2 * h + 1]);
        if constexpr (kF32) mma(t, ph, vl[2 * h], vl[2 * h + 1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) a.o[2 * nd + h][e] += t[e];
      }
    }
  }
}

// Finalize: l summed over the quad, o = acc / l, lse = m ln 2 + ln l (m
// back from log2 units); a row with l = 0 (no valid key and no seed)
// gives o = 0 and lse = NEG_INF, the reference's fully masked row.
template <int D>
__device__ __forceinline__ void fwd_finish(FwdAcc<D>& a, float (&lse)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = a.l[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const bool live = l > 0.f;
    lse[r] = live ? a.m[r] * kLn2 + logf(l) : kNegInf;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      a.o[j][2 * r] = live ? a.o[j][2 * r] / l : 0.f;
      a.o[j][2 * r + 1] = live ? a.o[j][2 * r + 1] / l : 0.f;
    }
  }
}

// ---------------------------------------------------------------- backward
//
// The backward tiles compute, on the valid (q, k) pairs of a tile,
//   p = exp(s * scale - L),  ds = p * (g_o . v - delta (+ dlse)) * scale
//   dq += ds . k,  dk += ds^T . q,  dv += p^T . g_o
// with L the q row's lse (the run-final lse in the fused kernels) and
// delta = g_o . o_out (- g_lse in the fused kernels, whose delta carries
// the lse cotangent, so they take kDlse = false; the per-step kernels add
// their dlse input, kDlse = true).  The exponent runs in log2 units as in
// the forward: L enters as L * log2e, p = 2^(s * scale * log2e - L').
// Masked elements get x = -1e30 before the exponent (p = 0); lse is
// -1e30 on dead rows.
//
// Precision: the reference computes every product in f32, and g_o, p and
// ds are genuine f32 values (g_o is the cotangent of an f32 output), so
// one bf16 rounding (2^-9 per term) would miss TOL_GRAD where signed
// terms cancel.  Each f32 operand is split into bf16 hi + lo and the
// partial products are summed in the f32 accumulator: S = Q.K^T takes 1
// product, dP, dS.K and dS^T.Q take 2 (hi and lo against an exact bf16
// operand), P^T.dO takes 3 (hi.hi + hi.lo + lo.hi) — about 2^-16 a term.
// With f32 q/k/v (kF32) they are split too and every product takes 3.
// The CPU tests test_split_bf16_scheme_meets_tol_grad and
// test_split_bf16_fused_scheme_meets_tol_grad (tests/test_torch_kernels.py)
// emulate this arithmetic against the plain versions.

// the stats of a lane's two q rows g and g + 8 of its warp (dq tiles)
struct BwdRows {
  float la, lb;                       // lse * log2e
  float ea, eb;                       // delta
  float ga, gb;                       // dlse (kDlse only)
};

// dq += dS.K of a warp's 16 q rows against one staged 64-key tile, 16
// keys at a time: S = Q.K^T and dP = dO.V^T (mma.sync m16n8k16, dO split
// into hi + lo), P and dS in the accumulator registers, re-packed as the
// A fragment of dS.K (dS split).  kt / vt: the bf16 K and V tiles (rows
// are keys, row stride ld, read with ldmatrix; .trans for the K of dQ),
// ktl / vtl their lo planes (kF32 only).  `bits` as elem_bits<true> lays
// them out (ignored when kFull).
template <bool kFull, bool kF32, bool kDlse, int D>
__device__ __forceinline__ void dq_tile(float (&acc)[D / 8][4],
                                        const AFrags<D / 16, kF32>& qf,
                                        const AFrags<D / 16, true>& of,
                                        const bf16* kt, const bf16* ktl,
                                        const bf16* vt, const bf16* vtl,
                                        int ld, unsigned bits,
                                        const BwdRows& r, float sl2,
                                        float scale, int lane) {
#pragma unroll 1
  for (int c = 0; c < kRows / 16; ++c) {
    // the lo terms go to their own accumulators: shorter mma chains
    float s[2][4] = {}, dp[2][4] = {}, sl[2][4] = {}, dpl[2][4] = {};
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      const int off = b_rows_off(16 * c, 16 * kd, ld, lane);
      uint32_t kf[4], vf[4];
      ldsm_x4(kf, kt + off);
      ldsm_x4(vf, vt + off);
      mma(s[0], qf.hi[kd], kf[0], kf[1]);
      mma(s[1], qf.hi[kd], kf[2], kf[3]);
      mma(dp[0], of.hi[kd], vf[0], vf[1]);
      mma(dp[1], of.hi[kd], vf[2], vf[3]);
      mma(dpl[0], of.lo[kd], vf[0], vf[1]);
      mma(dpl[1], of.lo[kd], vf[2], vf[3]);
      if constexpr (kF32) {
        uint32_t kl[4], vl[4];
        ldsm_x4(kl, ktl + off);
        ldsm_x4(vl, vtl + off);
        mma(sl[0], qf.hi[kd], kl[0], kl[1]);
        mma(sl[1], qf.hi[kd], kl[2], kl[3]);
        mma(sl[0], qf.lo[kd], kf[0], kf[1]);
        mma(sl[1], qf.lo[kd], kf[2], kf[3]);
        mma(dpl[0], of.hi[kd], vl[0], vl[1]);
        mma(dpl[1], of.hi[kd], vl[2], vl[3]);
      }
    }
    // P and dS in place; pairs of them become the A fragment of dS.K
    uint32_t ah[4], al[4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool ok = true;
        if constexpr (!kFull) ok = (bits >> (4 * (2 * c + j) + e)) & 1u;
        const bool hi = e >= 2;
        const float sv = kF32 ? s[j][e] + sl[j][e] : s[j][e];
        const float x = ok ? fmaf(sv, sl2, -(hi ? r.lb : r.la)) : -1e30f;
        const float p = exp2_approx(x);
        float g = dp[j][e] + dpl[j][e] - (hi ? r.eb : r.ea);
        if constexpr (kDlse) g += hi ? r.gb : r.ga;
        ds[e] = p * (g * scale);
      }
      split2(ds[0], ds[1], ah[2 * j], al[2 * j]);
      split2(ds[2], ds[3], ah[2 * j + 1], al[2 * j + 1]);
    }
#pragma unroll
    for (int nd = 0; nd < D / 16; ++nd) {
      const int off = b_cols_off(16 * c, 16 * nd, ld, lane);
      uint32_t kf[4];
      ldsm_x4_t(kf, kt + off);
      mma(acc[2 * nd], ah, kf[0], kf[1]);
      mma(acc[2 * nd + 1], ah, kf[2], kf[3]);
      mma(acc[2 * nd], al, kf[0], kf[1]);
      mma(acc[2 * nd + 1], al, kf[2], kf[3]);
      if constexpr (kF32) {
        uint32_t kl[4];
        ldsm_x4_t(kl, ktl + off);
        mma(acc[2 * nd], ah, kl[0], kl[1]);
        mma(acc[2 * nd + 1], ah, kl[2], kl[3]);
      }
    }
  }
}

// The dk / dv tile of a warpgroup's 64 kv rows against one staged 64-row
// q tile, in two calls around whatever the block overlaps with them.
// dkv_issue: S^T = K.Q^T and dP^T = V.dO^T (wgmma m64n64k16, A and B from
// swizzled shared tiles: the block's K / V, the staged Q and the dO hi /
// lo tiles; lo tiles of K, V and Q for kF32), committed, not waited.
template <bool kF32, int D>
__device__ __forceinline__ void dkv_issue(
    float (&s)[32], float (&dp)[32], const unsigned char* k_hi,
    const unsigned char* k_lo, const unsigned char* v_hi,
    const unsigned char* v_lo, const unsigned char* qh,
    const unsigned char* ql, const unsigned char* do_hi,
    const unsigned char* do_lo) {
  constexpr int W = kTileD<D>;         // the k16 steps: D's columns only
  wgmma_fence();
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    const int off = kstep_off<W>(kd);
    const uint64_t ak = gmma_desc<W>(k_hi + off);
    const uint64_t bq = gmma_desc<W>(qh + off);
    wgmma_ss_n64(s, ak, bq, kd > 0);
    if constexpr (kF32) {
      wgmma_ss_n64(s, ak, gmma_desc<W>(ql + off), 1);
      wgmma_ss_n64(s, gmma_desc<W>(k_lo + off), bq, 1);
    }
  }
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    const int off = kstep_off<W>(kd);
    const uint64_t av = gmma_desc<W>(v_hi + off);
    const uint64_t bo = gmma_desc<W>(do_hi + off);
    wgmma_ss_n64(dp, av, bo, kd > 0);
    wgmma_ss_n64(dp, av, gmma_desc<W>(do_lo + off), 1);
    if constexpr (kF32)
      wgmma_ss_n64(dp, gmma_desc<W>(v_lo + off), bo, 1);
  }
  wgmma_commit();
}

// One product of the f32 path's dkv_finish, from zero into t and waited
// for: a_hi.b_hi + a_lo.b_hi + a_hi.b_lo over the tile's four k16 steps
// (dV: P^T and dO, dK: dS^T and Q; A fragments as dkv_finish packs
// them), of the m64nW accumulator its first W / 2 (W <= 64) or column
// half `half` (W = 128).
template <int W>
__device__ __forceinline__ void dkv_tile_product(
    float (&t)[32], int half, const uint32_t (&ah)[4][4],
    const uint32_t (&al)[4][4], const unsigned char* bh,
    const unsigned char* bl) {
#pragma unroll
  for (int i = 0; i < 32; ++i) t[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    // 16 query rows further, in the column half's tile
    const int off = rows_off<W>(kk) + (W == 128 ? half * kRows * 128 : 0);
    if constexpr (W == 32) {
      auto& t16 = *reinterpret_cast<float(*)[16]>(&t[0]);
      wgmma_n32<1>(t16, ah[kk], gmma_desc<W>(bh + off), 1);
      wgmma_n32<1>(t16, al[kk], gmma_desc<W>(bh + off), 1);
      wgmma_n32<1>(t16, ah[kk], gmma_desc<W>(bl + off), 1);
    } else {
      wgmma_n64<1>(t, ah[kk], gmma_desc<W>(bh + off), 1);
      wgmma_n64<1>(t, al[kk], gmma_desc<W>(bh + off), 1);
      wgmma_n64<1>(t, ah[kk], gmma_desc<W>(bl + off), 1);
    }
  }
  wgmma_commit();
  wgmma_wait0();
  pin(t);
}

// dkv_finish: waits for dkv_issue's products, forms P^T and dS^T in
// registers (columns are queries: their stats from `meta`, lse at [0,
// 64), delta at [64, 128), dlse at [128, 192) when kDlse), packs them as
// the A fragments of the four k16 steps over the tile's queries, and
// runs dV += P^T.dO and dK += dS^T.Q (wgmma m64nWk16, W = kTileD<D>, A in
// registers, B the same Q and dO tiles read transposed); the products of
// the first two steps run while the last two are computed.  Returns with
// every product done.  `bits` as elem_bits<false> lays them out.
//
// The f32 path (kF32) sums each tile's products apart.  The tensor cores
// add into an f32 accumulator with truncation, not rounding, so a long
// chain of products into one accumulator drifts towards zero by about
// 2e-7 of its value a tile (H100, measured: kernel 4's dk against plain
// at 256 steps on one kv row, GQA group 7, 3,584 tiles: 7.0e-4 low on
// average, in f32 and bf16 alike; kernel 3's dq chain, 8 tiles a step,
// 1.0e-4 at 256 steps).  With kF32 each product of a tile starts from
// zero in the S^T registers (free once P^T and dS^T are packed) and is
// added into ak / av with FADD, which rounds to nearest: dk at 256 steps
// 7.0e-6.  The bf16 path keeps the chain: its drift lies far under
// bf16's own rounding of the inputs (2^-9), and the promoted tile costs
// it 40% at D = 64 (1 KB of spills at 168 registers, measured).
template <bool kFull, bool kF32, bool kDlse, int D>
__device__ __forceinline__ void dkv_finish(
    float (&ak)[kTileD<D> / 2], float (&av)[kTileD<D> / 2], float (&s)[32],
    float (&dp)[32],
    const unsigned char* qh, const unsigned char* ql,
    const unsigned char* do_hi, const unsigned char* do_lo,
    const float* meta, unsigned bits, float sl2, float scale, int lane) {
  const int t = lane & 3;
  wgmma_wait0();
  pin(s);
  pin(dp);
  uint32_t ph[4][4], pl[4][4], dh[4][4], dl[4][4];
  constexpr int W = kTileD<D>;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int j = 4 * half; j < 4 * half + 4; ++j) {
      const int col = 8 * j + 2 * t;
      float2 L = *reinterpret_cast<const float2*>(meta + col);
      L.x *= kLog2e;
      L.y *= kLog2e;
      const float2 De = *reinterpret_cast<const float2*>(meta + kRows + col);
      float2 Dl = make_float2(0.f, 0.f);
      if constexpr (kDlse)
        Dl = *reinterpret_cast<const float2*>(meta + 2 * kRows + col);
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        bool ok = true;
        if constexpr (!kFull) ok = (bits >> i) & 1u;
        const bool odd = e & 1;
        const float x = ok ? fmaf(s[i], sl2, -(odd ? L.y : L.x)) : -1e30f;
        p[e] = exp2_approx(x);
        float g = dp[i] - (odd ? De.y : De.x);
        if constexpr (kDlse) g += odd ? Dl.y : Dl.x;
        ds[e] = p[e] * (g * scale);
      }
      const int kk = j >> 1, r = (j & 1) * 2;
      split2(p[0], p[1], ph[kk][r], pl[kk][r]);
      split2(p[2], p[3], ph[kk][r + 1], pl[kk][r + 1]);
      split2(ds[0], ds[1], dh[kk][r], dl[kk][r]);
      split2(ds[2], ds[3], dh[kk][r + 1], dl[kk][r + 1]);
    }
    if constexpr (!kF32) {            // (the f32 path's products below)
      wgmma_fence();
#pragma unroll
      for (int kk = 2 * half; kk < 2 * half + 2; ++kk) {
        const int off = rows_off<W>(kk);        // 16 query rows further
        wgmma_nd<W, 1>(av, ph[kk], do_hi + off);
        wgmma_nd<W, 1>(av, ph[kk], do_lo + off);
        wgmma_nd<W, 1>(av, pl[kk], do_hi + off);
        wgmma_nd<W, 1>(ak, dh[kk], qh + off);
        wgmma_nd<W, 1>(ak, dl[kk], qh + off);
      }
    }
  }
  if constexpr (kF32) {
    // each product of the tile (both column halves at W = 128) from zero
    // in s, then into ak / av
#pragma unroll
    for (int h = 0; h < (W == 128 ? 2 : 1); ++h) {
      dkv_tile_product<W>(s, h, ph, pl, do_hi, do_lo);
#pragma unroll
      for (int i = 0; i < (W < 64 ? W / 2 : 32); ++i) av[32 * h + i] += s[i];
      dkv_tile_product<W>(s, h, dh, dl, qh, ql);
#pragma unroll
      for (int i = 0; i < (W < 64 ? W / 2 : 32); ++i) ak[32 * h + i] += s[i];
    }
  } else {
    wgmma_commit();
    wgmma_wait0();
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    pin(ph[kk]);
    pin(pl[kk]);
    pin(dh[kk]);
    pin(dl[kk]);
  }
  pin(av);
  pin(ak);
}

}  // namespace fcp_mma
