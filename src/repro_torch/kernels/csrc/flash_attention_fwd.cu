// Varlen flash-attention forward for Hopper (sm_90a), batched and strided:
// a tiled tensor-core variant and a split-KV decode variant.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention_fwd (_fwd_kernel :63, launched by pl.pallas_call at
// :126, masked by _mask_tile :52): normalized attention plus log-sum-exp
// over one (q, kv) range under (segment, position) masking; a fully
// masked row gives o = 0, lse = NEG_INF.  The port launches it on two
// paths: the per-step training executor (one launch per step index over
// the stacked workers: B 4, H 32, Sq = Sk = 512, D 64, bf16) and the
// context-parallel decode (Sq = 1; every decode slot and every sequence
// shard of the cache in one launch, the shards as extra batch rows).
// The wrapper picks the variant from Sq (kernels/flash_attention.py,
// fwd_variant); either computes any shape.
//
// (a) Tiled (tiled_kernel).  What bounds it on the H100 at the training
// block: 8.6e9 flop of S = Q.K^T and P.V on 4.2e7 bytes (bf16 q/k/v in,
// f32 o out), ~200 flop a byte, under the card's ~295: the bytes set the
// floor (0.013 ms), the operations close behind (0.009 ms at the bf16
// peak).  What holds this kernel is neither: it is the latency of each
// warp's chain S -> softmax -> P.V (PERF.md section 6).  One block of four
// warps owns 64 query rows of one (batch row, head) — 16 rows a warp as
// mma.sync fragments — and walks the 64-key tiles of its K/V range with
// the shared forward tile of attn_mma.cuh: Q loaded once into registers
// (hi and lo bf16 fragments for f32 q), K and V through a cp.async ring
// in padded rows (ldmatrix; .trans for V), the online softmax in f32
// registers, P re-packed from the S accumulators as the A fragment of
// P.V.  Each K/V tile is read once per 64 query rows.  Every tile's class is
// found at the start, before any K/V byte loads: skipped when no pair is
// valid, no per-element test when all are, otherwise validity bits from
// the tile's seg/pos, staged with it.  The latency is hidden by warps:
// 128 registers a thread let four blocks share an SM.  A ragged Sq or
// Sk is masked in the kernel.
//
// (b) Decode, split-KV (decode_kernel + merge_kernel).  At Sq = 1 the
// work is ~2 flop per cache byte, so the bytes bound it: reading the
// live part of the KV cache once (1.04e8 bytes, 0.031 ms, at the serve
// shape: 8 slots x 2 shards, 12,672 live keys, 32 heads).  One block owns
// one (batch row, kv head, split of 256 keys), so a long row spreads over
// many blocks.  It reads the cache in its own layout [B, S, KH, D]
// through strides, with no copy; it checks the split's four 64-key
// sub-tiles against the rows' (segment, position) ranges first, skipping
// a split that lies wholly past the row's length (and dead sub-tiles of
// a live one) before any byte loads; it copies K, then V, as 16-byte
// cp.async (8 lanes to a 64-wide bf16 row), so the scores start while V
// lands.  The H / KH query heads of a group (and all Sq rows) share that
// one read.  The math is f32 on the CUDA cores: at one query row there
// is nothing for the tensor cores.  Each split writes an unnormalized
// partial (acc, m, l) to a workspace the wrapper allocates; a second
// small launch merges the splits of each row in split order.  No atomics
// touch the data, so a second call gives the same bytes.
//
// Precision (both variants hold the f32 reference to 1e-4): the tiled
// variant multiplies on bf16 tensor cores with f32 accumulators; with
// bf16 q/k/v, Q.K^T is exact in the f32 sum, and P (an f32 value) is split
// into bf16 hi + lo (2 products); f32 q/k/v are split too (3 products).
// tests/test_torch_kernels.py::test_split_bf16_fwd_scheme_meets_tol
// emulates that arithmetic against the plain version.  The decode variant
// computes in f32 throughout.
//
// At D = 128 (b) keeps its layout; f32 rows of 512 bytes would need 256
// KB for a split's K and V, so there K and V share one buffer (kOneBuf):
// V loads once the scores are taken.  A key row is spread over a power of
// two of lanes, 16 bytes each, so a group of lanes stays inside a warp:
// at D = 80 (160 B in bf16, 320 B in f32) 16 and 32 lanes, of which 10
// and 20 hold a part of the row and the rest load nothing and add 0.
//
// ptxas -v (sm_90a; __launch_bounds__(128, 4) caps (a)'s bf16 builds of D
// <= 64 at 128 registers, the others at 255): printed by chip_smoke.py's
// build phase; PERF.md keeps the numbers of the last run (the bf16 D=64
// build spills a few dozen bytes there, D=128 none at 254).
//
// Layouts: q [B, H, Sq, D], k/v [B, KH, Sk, D] with any element strides
// (unit stride on D; the rows and the tensors 16-byte aligned);
// seg_q/pos_q [B, Sq] and seg_k/pos_k [B, Sk] with a batch stride (0 =
// shared by the batch) and unit stride within a row.  Outputs o [B, H,
// Sq, D] and lse [B, H, Sq], f32, contiguous.  Decode workspace: ws_o
// [B, H, Sq, n_split, D] and ws_ml [B, H, Sq, n_split, 2], f32.

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
// 128) at <= 255, as kernel 1
template <typename T, int D>
constexpr int kMinBlocks = kIsF32<T> || D > 64 ? 2 : 4;

struct Strides {
  long long qb, qh, qs;       // q
  long long kb, kh, ks;       // k and v
  long long sqb, skb;         // seg/pos batch strides
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ------------------------------------------------------------ (a) tiled

// bytes of one staged 64-row tile of T: bf16 padded (read by ldmatrix as
// it is), f32 dense (split into bf16 planes first)
template <typename T, int D>
constexpr int kStageBytes = kRows * (kIsF32<T> ? D : kLd<D>) * (int)sizeof(T);

template <int D>
constexpr int kPlaneBytes = kRows * kLd<D> * 2;

// the ring's two K and V slots, for f32 the hi / lo planes of both, each
// slot's seg/pos; the tile classes follow (nt bytes, set at launch)
template <typename T, int D>
constexpr int kTiledSmem = 4 * kStageBytes<T, D> +
                           (kIsF32<T> ? 4 * kPlaneBytes<D> : 0) +
                           2 * 2 * kRows * 4;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T, D>) tiled_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ seg_q,
    const int* __restrict__ pos_q, const int* __restrict__ seg_k,
    const int* __restrict__ pos_k, float* __restrict__ o,
    float* __restrict__ lse, int H, int KH, int Sq, int Sk, Strides st,
    float scale, int kind, int window, int chunk) {
  constexpr bool kF32 = kIsF32<T>;
  constexpr int LD = kLd<D>;
  constexpr int kStageLd = kF32 ? D : LD;
  constexpr int kPlane = kRows * LD;  // elements
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

  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3;
  // the last q tiles first: under a causal mask they see the most keys
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows, w0 = q0 + 16 * warp;
  const int ra = w0 + (lane >> 2), rb = ra + 8;
  const int* qsg = seg_q + b * st.sqb;
  const int* qps = pos_q + b * st.sqb;
  const int* ksg = seg_k + b * st.skb;
  const int* kps = pos_k + b * st.skb;
  const T* kb = k + b * st.kb + kh * st.kh;
  const T* vb = v + b * st.kb + kh * st.kh;
  const int sa = ra < Sq ? qsg[ra] : kPad, sb = rb < Sq ? qsg[rb] : kPad;
  const int pa = ra < Sq ? qps[ra] : 0, pb = rb < Sq ? qps[rb] : 0;

  AFrags<D / 16, kF32> qf;
  load_a<D>(qf, q + b * st.qb + h * st.qh, w0, Sq, lane, st.qs);
  FwdAcc<D> acc;
  fwd_init(acc);
  const float sl2 = scale * kLog2e;

  const int nt = (Sk + kRows - 1) / kRows;
  classify_tiles(
      cls, nt, tile_ranges(qsg, qps, q0, Sq, lane),
      [&](int j, const int*& sg, const int*& ps, int& r0, int& n) {
        sg = ksg;
        ps = kps;
        r0 = j * kRows;
        n = Sk;
      },
      kind, window, chunk, warp, lane);
  __syncthreads();
  auto load = [&](int j, int slot) {
    stage_tile<T, D>(stage(2 * slot), kStageLd, kb, j * kRows, Sk, tid,
                     st.ks);
    stage_tile<T, D>(stage(2 * slot + 1), kStageLd, vb, j * kRows, Sk, tid,
                     st.ks);
    stage_meta(meta + slot * 2 * kRows, meta + slot * 2 * kRows + kRows, ksg,
               kps, j * kRows, Sk, tid);
  };
  auto body = [&](int slot, int j) {
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
    if (cls[j] == kFull) {
      fwd_tile<true, kF32>(acc, qf, kt, ktl, vt, vtl, LD, ~0u, sl2, lane);
      return;
    }
    const int* sg = meta + slot * 2 * kRows;
    const unsigned bits =
        elem_bits<true>(sa, pa, sb, pb, sg, sg + kRows, 0,
                        min(kRows, Sk - j * kRows), t, kind, window, chunk);
    fwd_tile<false, kF32>(acc, qf, kt, ktl, vt, vtl, LD, bits, sl2, lane);
  };
  tile_pipe(cls, nt, load, body);

  float ls[2];
  fwd_finish(acc, ls);
  const size_t hq = ((size_t)b * H + h) * Sq;
  store_acc<float, D>(o + hq * D, acc.o, w0, Sq, lane);
  if (t == 0) {
    if (ra < Sq) lse[hq + ra] = ls[0];
    if (rb < Sq) lse[hq + rb] = ls[1];
  }
}

// ------------------------------------------------------------ (b) decode

constexpr int kSplit = 256;               // keys of one split
static_assert(kSplit == kWarps * kRows, "one 64-key sub-tile per warp");

// (segment, position) ranges over rows [0, n): tile_ranges over each
// 64-row tile in turn (`all` is not needed here)
__device__ __forceinline__ Ranges span_ranges(const int* seg, const int* pos,
                                              int n, int lane) {
  Ranges r{INT_MAX, INT_MIN, INT_MAX, INT_MIN, true};
  for (int r0 = 0; r0 < n; r0 += kRows) {
    const Ranges x = tile_ranges(seg, pos, r0, n, lane);
    r.smin = min(r.smin, x.smin);
    r.smax = max(r.smax, x.smax);
    r.pmin = min(r.pmin, x.pmin);
    r.pmax = max(r.pmax, x.pmax);
    r.all = r.all && x.all;
  }
  return r;
}

// K and V of a split share one buffer where two would not fit in shared
// memory (f32 rows of D = 128: 2 x 128 KB); V then loads once the scores
// are taken, and a chunk after the first loads K again
template <typename T, int D>
constexpr bool kOneBuf = (int)sizeof(T) * D > 256;

// K and V of a split, the scores of a chunk of RC query rows, the warps'
// partial sums, the rows' (m, l), the sub-tiles' liveness
template <typename T, int D, int RC>
constexpr int kDecodeSmem = (kOneBuf<T, D> ? 1 : 2) * kSplit * D *
                                (int)sizeof(T) +
                            RC * kSplit * 4 + kWarps * RC * D * 4 +
                            2 * RC * 4 + kWarps * 4;

// 16 bytes of a staged row as f32
__device__ __forceinline__ void load_vec(float (&x)[8], const bf16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load_vec(float (&x)[4], const float* p) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  x[0] = f.x;
  x[1] = f.y;
  x[2] = f.z;
  x[3] = f.w;
}

// the lanes of one key row: the power of two at or above its 16-byte
// pieces
__host__ __device__ constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

// One block per (split, kv head, batch row).  Its query rows are the
// group's heads times the Sq rows, r = member * Sq + i, taken RC at a
// time; a group of kLanes lanes owns one key of a pass, each of its first
// kUsed lanes 16 bytes of it.  Writes the unnormalized partial (acc, m,
// l) of every row for this split, l = 0 where the split holds no valid
// key.
template <typename T, int D, int RC>
__global__ void __launch_bounds__(kThreads) decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ seg_q,
    const int* __restrict__ pos_q, const int* __restrict__ seg_k,
    const int* __restrict__ pos_k, float* __restrict__ ws_o,
    float* __restrict__ ws_ml, int H, int KH, int Sq, int Sk, Strides st,
    float scale, int kind, int window, int chunk) {
  constexpr int kVec = 16 / (int)sizeof(T);    // elements of a 16-byte load
  constexpr int kUsed = D / kVec;              // 16-byte pieces of a key row
  constexpr int kLanes = pow2_at_least(kUsed);  // lanes of one key row
  constexpr int kGroups = kThreads / kLanes;   // keys of one pass
  static_assert(D % kVec == 0 && kLanes <= 32, "a key row in one warp");
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kOne = kOneBuf<T, D>;
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = kOne ? k_s : k_s + kSplit * D;
  float* s_s = reinterpret_cast<float*>(v_s + kSplit * D);   // [RC][kSplit]
  float* red = s_s + RC * kSplit;                 // [kWarps][RC][D]
  float* m_s = red + kWarps * RC * D;
  float* l_s = m_s + RC;
  int* live_s = reinterpret_cast<int*>(l_s + RC);  // [kWarps]

  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int ns = gridDim.x;
  const int group = H / KH, R = group * Sq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = split * kSplit;
  const int* qsg = seg_q + b * st.sqb;
  const int* qps = pos_q + b * st.sqb;
  const int* ksg = seg_k + b * st.skb;
  const int* kps = pos_k + b * st.skb;
  const T* kp = k + b * st.kb + kh * st.kh;
  const T* vp = v + b * st.kb + kh * st.kh;
  // output row (b, head, i) of block row r
  auto orow = [&](int r) {
    return ((size_t)b * H + kh * group + r / Sq) * Sq + r % Sq;
  };

  // warp w classifies sub-tile w against all query rows of the batch row
  const Ranges qr = span_ranges(qsg, qps, Sq, lane);
  const bool live = classify(qr, tile_ranges(ksg, kps, k0 + kRows * warp,
                                             Sk, lane),
                             kind, window, chunk) != kNone;
  if (lane == 0) live_s[warp] = live;
  if (!__syncthreads_or(live)) {      // nothing visible: no byte loads
    for (int r = tid; r < R; r += kThreads)
      ws_ml[(orow(r) * ns + split) * 2 + 1] = 0.f;
    return;
  }
  // the live sub-tiles' rows of K (half 0) or V (half 1) as one cp.async
  // group; rows past Sk are zero-filled
  auto stage = [&](int half) {
    const T* src = half ? vp : kp;
    T* dst = half ? v_s : k_s;
    for (int i = tid; i < kSplit * kUsed; i += kThreads) {
      const int r = i / kUsed, c = (i % kUsed) * kVec;
      if (!live_s[r / kRows]) continue;
      const bool in = k0 + r < Sk;
      cp_async16(dst + r * D + c, in ? src + (k0 + r) * st.ks + c : src,
                 in ? 16 : 0);
    }
    cp_async_commit();
  };
  stage(0);
  if constexpr (!kOne) stage(1);      // two groups: scores start while V lands

  const float sl2 = scale * kLog2e;
  const int gi = tid / kLanes, li = tid % kLanes;
  const bool holds = li < kUsed;      // this lane holds a part of a row
  for (int r0 = 0; r0 < R; r0 += RC) {
    if constexpr (kOne)
      if (r0 > 0) stage(0);           // V holds the buffer: K again
    const int nr = min(RC, R - r0);
    // this lane's kVec columns of the chunk's query rows, f32
    float qv[RC][kVec];
    int sq[RC], pq[RC];
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      sq[r] = kPad;
      pq[r] = 0;
#pragma unroll
      for (int e = 0; e < kVec; ++e) qv[r][e] = 0.f;
      if (r < nr) {
        const int row = r0 + r, i = row % Sq;
        const T* qrow = q + b * st.qb + (kh * group + row / Sq) * st.qh +
                        i * st.qs + li * kVec;
        if (holds) {
#pragma unroll
          for (int e = 0; e < kVec; ++e) qv[r][e] = to_f32(qrow[e]);
        }
        sq[r] = qsg[i];
        pq[r] = qps[i];
      }
    }
    if constexpr (kOne)               // K has landed
      cp_async_wait<0>();
    else
      cp_async_wait<1>();
    __syncthreads();
    // scores, in log2 units; -inf where masked or in a dead sub-tile
    for (int kk = gi; kk < kSplit; kk += kGroups) {
      if (!live_s[kk / kRows]) {      // uniform over the warp
        if (li == 0)
          for (int r = 0; r < nr; ++r) s_s[r * kSplit + kk] = neg_inf();
        continue;
      }
      float kv[kVec] = {};
      if (holds) load_vec(kv, k_s + kk * D + li * kVec);
      const int key = k0 + kk;
      const int sk = key < Sk ? ksg[key] : kPad;
      const int pk = key < Sk ? kps[key] : 0;
#pragma unroll
      for (int r = 0; r < RC; ++r) {
        if (r >= nr) break;
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) d = fmaf(qv[r][e], kv[e], d);
#pragma unroll
        for (int off = 1; off < kLanes; off <<= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        const bool ok = sk != kPad && sk == sq[r] &&
                        visible(kind, window, chunk, pq[r], pk);
        if (li == 0) s_s[r * kSplit + kk] = ok ? d * sl2 : neg_inf();
      }
    }
    __syncthreads();
    if constexpr (kOne) stage(1);      // K is read: V takes its place
    // per row (a warp each): m, p = 2^(x - m) in place, l
    for (int r = warp; r < nr; r += kWarps) {
      float x[kSplit / 32];
      float mx = neg_inf();
#pragma unroll
      for (int i = 0; i < kSplit / 32; ++i) {
        x[i] = s_s[r * kSplit + lane + 32 * i];
        mx = fmaxf(mx, x[i]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const bool any = mx != neg_inf();
      float l = 0.f;
#pragma unroll
      for (int i = 0; i < kSplit / 32; ++i) {
        const float p = any ? exp2_approx(x[i] - mx) : 0.f;
        s_s[r * kSplit + lane + 32 * i] = p;
        l += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        l += __shfl_xor_sync(0xffffffffu, l, off);
      if (lane == 0) {
        m_s[r] = mx;
        l_s[r] = l;
      }
    }
    cp_async_wait<0>();               // V has landed
    __syncthreads();
    // acc = P.V: this lane's kVec columns over its group's keys
    float acc[RC][kVec];
#pragma unroll
    for (int r = 0; r < RC; ++r)
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[r][e] = 0.f;
    for (int kk = gi; kk < kSplit; kk += kGroups) {
      if (!live_s[kk / kRows]) continue;
      float vv[kVec] = {};
      if (holds) load_vec(vv, v_s + kk * D + li * kVec);
#pragma unroll
      for (int r = 0; r < RC; ++r) {
        if (r >= nr) break;
        const float p = s_s[r * kSplit + kk];
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[r][e] = fmaf(p, vv[e], acc[r][e]);
      }
    }
    // over the groups of a warp (butterfly), then the warps in order
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      if (r >= nr) break;
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        float x = acc[r][e];
#pragma unroll
        for (int off = kLanes; off < 32; off <<= 1)
          x += __shfl_xor_sync(0xffffffffu, x, off);
        if (lane < kLanes && holds)
          red[(warp * RC + r) * D + li * kVec + e] = x;
      }
    }
    __syncthreads();
    for (int i = tid; i < nr * D; i += kThreads) {
      const int r = i / D, d = i % D;
      float x = red[r * D + d];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) x += red[(w * RC + r) * D + d];
      ws_o[(orow(r0 + r) * ns + split) * D + d] = x;
    }
    for (int r = tid; r < nr; r += kThreads) {
      ws_ml[(orow(r0 + r) * ns + split) * 2] = m_s[r];
      ws_ml[(orow(r0 + r) * ns + split) * 2 + 1] = l_s[r];
    }
    __syncthreads();                  // before the next chunk reuses them
  }
}

// One warp per output row: the splits' partials merged in split order,
// o = sum_s acc_s 2^(m_s - M) / L, lse = M ln 2 + ln L, L = sum_s l_s
// 2^(m_s - M); L = 0 (no valid key) gives o = 0, lse = NEG_INF.
template <int D>
__global__ void __launch_bounds__(kThreads) merge_kernel(
    const float* __restrict__ ws_o, const float* __restrict__ ws_ml,
    float* __restrict__ o, float* __restrict__ lse, int rows, int ns) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* ml = ws_ml + (size_t)row * ns * 2;
  float M = neg_inf();
  for (int s = 0; s < ns; ++s)
    if (ml[2 * s + 1] > 0.f) M = fmaxf(M, ml[2 * s]);
  constexpr int kC = (D + 31) / 32;   // this lane's columns lane + 32 c < D
  float L = 0.f, acc[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) acc[c] = 0.f;
  for (int s = 0; s < ns; ++s) {
    const float l = ml[2 * s + 1];
    if (!(l > 0.f)) continue;         // an empty split: acc_s is not read
    const float w = exp2_approx(ml[2 * s] - M);
    L = fmaf(l, w, L);
    const float* p = ws_o + ((size_t)row * ns + s) * D;
#pragma unroll
    for (int c = 0; c < kC; ++c)
      if (lane + 32 * c < D) acc[c] = fmaf(w, p[lane + 32 * c], acc[c]);
  }
  const bool live = L > 0.f;
#pragma unroll
  for (int c = 0; c < kC; ++c)
    if (lane + 32 * c < D)
      o[(size_t)row * D + lane + 32 * c] = live ? acc[c] / L : 0.f;
  if (lane == 0) lse[row] = live ? M * kLn2 + logf(L) : kNegInf;
}

// ------------------------------------------------------------ launches

struct Args {
  const void *q, *k, *v;
  const int *seg_q, *pos_q, *seg_k, *pos_k;
  float *o, *lse;
  int B, H, KH, Sq, Sk;
  Strides st;
  float scale;
  int kind, window, chunk;
  cudaStream_t stream;
};

// dynamic shared memory above 48 KB: raise the kernel's limit to `bytes`
// when a launch needs more than `sized`, the limit set so far
template <typename K>
cudaError_t size_smem(K* kernel, int bytes, int& sized) {
  if (bytes <= sized) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) sized = bytes;
  return e;
}

template <typename T, int D>
cudaError_t launch_tiled(const Args& a) {
  const int nt = (a.Sk + kRows - 1) / kRows;
  const int bytes = kTiledSmem<T, D> + (nt + 15) / 16 * 16;
  auto* kernel = tiled_kernel<T, D>;
  static int sized = 0;
  const cudaError_t e = size_smem(kernel, bytes, sized);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Sq + kRows - 1) / kRows, a.H, a.B);
  kernel<<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.seg_q, a.pos_q, a.seg_k, a.pos_k, a.o,
      a.lse, a.H, a.KH, a.Sq, a.Sk, a.st, a.scale, a.kind, a.window,
      a.chunk);
  return cudaGetLastError();
}

template <typename T, int D, int RC>
cudaError_t launch_decode(const Args& a, float* ws_o, float* ws_ml,
                          int ns) {
  constexpr int bytes = kDecodeSmem<T, D, RC>;
  auto* kernel = decode_kernel<T, D, RC>;
  static int sized = 0;
  cudaError_t e = size_smem(kernel, bytes, sized);
  if (e != cudaSuccess) return e;
  if (ns > 0) {                       // Sk = 0: the merge alone (empty rows)
    kernel<<<dim3(ns, a.KH, a.B), kThreads, bytes, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), a.seg_q, a.pos_q, a.seg_k, a.pos_k,
        ws_o, ws_ml, a.H, a.KH, a.Sq, a.Sk, a.st, a.scale, a.kind,
        a.window, a.chunk);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const int rows = a.B * a.H * a.Sq;
  merge_kernel<D><<<(rows + kWarps - 1) / kWarps, kThreads, 0, a.stream>>>(
      ws_o, ws_ml, a.o, a.lse, rows, ns);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t decode_rc(const Args& a, float* ws_o, float* ws_ml, int ns) {
  // one query row (Sq = 1, no group): no chunk loop to pay for
  if (a.Sq * (a.H / a.KH) == 1)
    return launch_decode<T, D, 1>(a, ws_o, ws_ml, ns);
  return launch_decode<T, D, 8>(a, ws_o, ws_ml, ns);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// 16-byte rows for cp.async: pointers and the k/v strides
bool rows_aligned(const Args& a, int elem) {
  const int per = 16 / elem;
  return aligned16(a.k) && aligned16(a.v) && a.st.kb % per == 0 &&
         a.st.kh % per == 0 && a.st.ks % per == 0;
}

Args make_args(const void* q, const void* k, const void* v,
               const void* seg_q, const void* pos_q, const void* seg_k,
               const void* pos_k, void* o, void* lse, int B, int H, int KH,
               int Sq, int Sk, long long q_sb, long long q_sh,
               long long q_ss, long long k_sb, long long k_sh,
               long long k_ss, long long segq_sb, long long segk_sb,
               float scale, int kind, int window, int chunk, void* stream) {
  return Args{q, k, v,
              static_cast<const int*>(seg_q), static_cast<const int*>(pos_q),
              static_cast<const int*>(seg_k), static_cast<const int*>(pos_k),
              static_cast<float*>(o), static_cast<float*>(lse), B, H, KH,
              Sq, Sk,
              Strides{q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, segq_sb, segk_sb},
              scale, kind, window, chunk, static_cast<cudaStream_t>(stream)};
}

}  // namespace

// FCP_ENTRY selects the entry point a translation unit defines: the build
// compiles this file once per entry (1, 2) and links both objects into
// one library, so the two halves of its instantiations compile at once;
// left undefined, both are defined.
#ifndef FCP_ENTRY
#define FCP_ENTRY 0
#endif

#if FCP_ENTRY != 2
// (a) tiled.  dtype: 0 = float32, 1 = bfloat16 (q, k and v share it); D is
// 16, 32, 64, 80 or 128.  Strides are in elements.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int fcp_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* seg_q,
    const void* pos_q, const void* seg_k, const void* pos_k, void* o,
    void* lse, int B, int H, int KH, int Sq, int Sk, int D, int dtype,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long segq_sb, long long segk_sb,
    float scale, int kind, int window, int chunk, void* stream) {
  if (B * H * Sq == 0) return 0;
  const Args a = make_args(q, k, v, seg_q, pos_q, seg_k, pos_k, o, lse, B,
                           H, KH, Sq, Sk, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                           segq_sb, segk_sb, scale, kind, window, chunk,
                           stream);
  if (!rows_aligned(a, dtype == 0 ? 4 : 2)) return cudaErrorMisalignedAddress;
  if (dtype == 0 && D == 16) return launch_tiled<float, 16>(a);
  if (dtype == 1 && D == 16) return launch_tiled<__nv_bfloat16, 16>(a);
  if (dtype == 0 && D == 32) return launch_tiled<float, 32>(a);
  if (dtype == 0 && D == 64) return launch_tiled<float, 64>(a);
  if (dtype == 1 && D == 32) return launch_tiled<__nv_bfloat16, 32>(a);
  if (dtype == 1 && D == 64) return launch_tiled<__nv_bfloat16, 64>(a);
  if (dtype == 0 && D == 80) return launch_tiled<float, 80>(a);
  if (dtype == 1 && D == 80) return launch_tiled<__nv_bfloat16, 80>(a);
  if (dtype == 0 && D == 128) return launch_tiled<float, 128>(a);
  if (dtype == 1 && D == 128) return launch_tiled<__nv_bfloat16, 128>(a);
  return cudaErrorInvalidValue;
}
#endif

#if FCP_ENTRY != 1

// (b) decode, split-KV: the same arguments, the workspace ws_o [B, H, Sq,
// n_split, D] and ws_ml [B, H, Sq, n_split, 2] (f32, contiguous) and
// n_split = ceil(Sk / 256).  Two launches (splits, merge); returns
// cudaGetLastError() after the last.
extern "C" int fcp_flash_attention_fwd_decode(
    const void* q, const void* k, const void* v, const void* seg_q,
    const void* pos_q, const void* seg_k, const void* pos_k, void* o,
    void* lse, void* ws_o, void* ws_ml, int B, int H, int KH, int Sq,
    int Sk, int D, int dtype, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long segq_sb, long long segk_sb, float scale, int kind,
    int window, int chunk, int n_split, void* stream) {
  if (B * H * Sq == 0) return 0;
  if (n_split != (Sk + kSplit - 1) / kSplit) return cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, seg_q, pos_q, seg_k, pos_k, o, lse, B,
                           H, KH, Sq, Sk, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                           segq_sb, segk_sb, scale, kind, window, chunk,
                           stream);
  if (!rows_aligned(a, dtype == 0 ? 4 : 2)) return cudaErrorMisalignedAddress;
  auto* wo = static_cast<float*>(ws_o);
  auto* wm = static_cast<float*>(ws_ml);
  if (dtype == 0 && D == 16) return decode_rc<float, 16>(a, wo, wm, n_split);
  if (dtype == 1 && D == 16)
    return decode_rc<__nv_bfloat16, 16>(a, wo, wm, n_split);
  if (dtype == 0 && D == 32) return decode_rc<float, 32>(a, wo, wm, n_split);
  if (dtype == 0 && D == 64) return decode_rc<float, 64>(a, wo, wm, n_split);
  if (dtype == 1 && D == 32)
    return decode_rc<__nv_bfloat16, 32>(a, wo, wm, n_split);
  if (dtype == 1 && D == 64)
    return decode_rc<__nv_bfloat16, 64>(a, wo, wm, n_split);
  if (dtype == 0 && D == 80) return decode_rc<float, 80>(a, wo, wm, n_split);
  if (dtype == 1 && D == 80)
    return decode_rc<__nv_bfloat16, 80>(a, wo, wm, n_split);
  if (dtype == 0 && D == 128) return decode_rc<float, 128>(a, wo, wm, n_split);
  if (dtype == 1 && D == 128)
    return decode_rc<__nv_bfloat16, 128>(a, wo, wm, n_split);
  return cudaErrorInvalidValue;
}
#endif
