"""Cost/performance model (paper §3.1, §3.3, §3.5).

Provides

* hardware profiles (TPU v5e target; paper's anonymized GPU-X / GPU-Y for
  reproducing the paper-side figures),
* the kernel-efficiency curve ``f(B)`` (paper Fig. 3): small blocks cannot
  saturate the matrix units,
* exact valid-pair counting for (q-block, kv-block) pairs under every
  :class:`~repro.masks.MaskSpec` family (causal / sliding-window /
  chunked / full) with packed varlen segments,
* the end-to-end analytic timing model ``T = max_i eta_i * Comp(w_i)``
  (§3.3), with toggles for each of the paper's ablation components
  (Table 2): block-level pipelining, congestion-free solver, bottom-up
  coalescer, transparent reshuffler.

The model is used (a) inside the distributor's load metric, (b) by the
benchmarks reproducing the paper's figures, and (c) by the planner to check
the §3.5 overlap condition (computation time >= communication time per
stage).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from ..masks import MaskSpec, coerce_mask
from ..runtime.wire import WIRE_BF16, WireFormat, coerce_wire
from .blocks import PAD_SEGMENT, Block, BlockedBatch


# --------------------------------------------------------------------------
# hardware profiles
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    name: str
    peak_flops: float          # dense bf16 FLOP/s per chip
    hbm_bandwidth: float       # bytes/s
    link_bandwidth: float      # bytes/s per chip interconnect (ICI / IB)
    efficiency_knee: float     # tokens at which attention MFU reaches 1-1/e
    vmem_bytes: float = 128 * 2 ** 20

    @property
    def comp_comm_ratio(self) -> float:
        """Paper Table 1 metric: bf16 throughput / network bandwidth."""
        return self.peak_flops / self.link_bandwidth

    def min_overlap_bandwidth(self, block_tokens: int, kv_tokens: int,
                              n_q_heads: int, n_kv_heads: int,
                              head_dim: int, bytes_per_el: int = 2) -> float:
        """Paper §3.5: bandwidth needed so comm(B) <= comp(B) (eta = 1).

        A transferred KV block of ``block_tokens`` is consumed by attention
        against ``kv_tokens`` worth of query work; larger blocks need *less*
        bandwidth because compute grows quadratically and traffic linearly.
        """
        comm_bytes = 2 * block_tokens * n_kv_heads * head_dim * bytes_per_el
        flops = 4.0 * block_tokens * kv_tokens * n_q_heads * head_dim
        eff = kernel_efficiency(block_tokens, self.efficiency_knee)
        comp_time = flops / (self.peak_flops * eff)
        return comm_bytes / comp_time


# TPU v5e (the build target; constants given by the task spec)
TPU_V5E = HardwareProfile(
    name="tpu-v5e", peak_flops=197e12, hbm_bandwidth=819e9,
    link_bandwidth=50e9, efficiency_knee=2048.0)

# Paper's anonymized GPUs.  GPU-X is an H100-class part; §3.5/§5 state a
# "50 GB/s ConnectX-7 InfiniBand" per-GPU link explicitly, which we use
# (Table 1's 5920 comp/comm ratio anonymizes an aggregate).  GPU-Y is a
# B200-class part; its Table-1 ratio 2500 implies a ~0.9 TB/s fabric
# (NVL-class), which we keep.
GPU_X = HardwareProfile(
    name="gpu-x", peak_flops=989e12, hbm_bandwidth=4.8e12,
    link_bandwidth=50e9, efficiency_knee=2048.0)
GPU_Y = HardwareProfile(
    name="gpu-y", peak_flops=2250e12, hbm_bandwidth=8e12,
    link_bandwidth=2250e12 / 2500, efficiency_knee=3072.0)

HARDWARE = {p.name: p for p in (TPU_V5E, GPU_X, GPU_Y)}


def kernel_efficiency(tokens: float, knee: float = 2048.0) -> float:
    """MFU of the attention kernel as a function of block granularity.

    Calibrated against paper Fig. 3: ~25% at 512 tokens, ~50% at 1.4K,
    saturating (>85%) beyond 4K.  ``f(t) = 1 - exp(-t/knee)``.
    """
    if tokens <= 0:
        return 1.0
    return 1.0 - math.exp(-float(tokens) / knee)


# --------------------------------------------------------------------------
# exact pair counting (packed varlen, all MaskSpec families)
# --------------------------------------------------------------------------

def _causal_pairs(a0: int, a1: int, b0: int, b1: int) -> int:
    """#{(p, q) : p in [a0,a1), q in [b0,b1), q <= p} for one document.

    ``p`` are query positions, ``q`` key positions (absolute within the
    document).
    """
    if a1 <= a0 or b1 <= b0:
        return 0
    # for each p, keys counted = clamp(p+1, b0, b1) - b0
    total = 0
    # region A: p in [max(a0,b0), min(a1,b1-1)) -> p+1-b0 keys
    lo_a, hi_a = max(a0, b0), min(a1, b1 - 1)
    if hi_a > lo_a:
        n = hi_a - lo_a
        total += n * (lo_a + 1 - b0) + n * (n - 1) // 2
    # region B: p in [max(a0,b1-1), a1) -> all b1-b0 keys
    lo_b = max(a0, b1 - 1)
    if a1 > lo_b:
        total += (a1 - lo_b) * (b1 - b0)
    return total


def _window_pairs(a0: int, a1: int, b0: int, b1: int, w: int) -> int:
    """Banded count #{q <= p and p - q < w}: causal minus the part the
    window cuts off (``q <= p - w`` is causal with queries shifted by w)."""
    return _causal_pairs(a0, a1, b0, b1) - _causal_pairs(a0 - w, a1 - w,
                                                         b0, b1)


def _chunk_pairs(a0: int, a1: int, b0: int, b1: int, c: int) -> int:
    """#{q <= p and p // c == q // c}: causal restricted per chunk."""
    lo_c = max(a0 // c, b0 // c)
    hi_c = min((a1 - 1) // c, (b1 - 1) // c)
    total = 0
    for cc in range(lo_c, hi_c + 1):
        lo, hi = cc * c, (cc + 1) * c
        total += _causal_pairs(max(a0, lo), min(a1, hi),
                               max(b0, lo), min(b1, hi))
    return total


def _segment_pairs(mask: MaskSpec, a0: int, a1: int, b0: int, b1: int
                   ) -> int:
    """Exact visible (query, key) pairs between two same-doc position
    ranges under ``mask``."""
    if mask.kind == "full":
        return max(0, a1 - a0) * max(0, b1 - b0)
    if mask.kind == "sliding_window":
        return _window_pairs(a0, a1, b0, b1, mask.window)
    if mask.kind == "chunked":
        return _chunk_pairs(a0, a1, b0, b1, mask.chunk)
    return _causal_pairs(a0, a1, b0, b1)


def pair_valid_tokens(qb: Block, kb: Block, mask=True) -> int:
    """Number of mask-visible (query, key) token pairs between two
    blocks (``mask``: MaskSpec or legacy ``causal: bool``)."""
    mask = coerce_mask(mask)
    total = 0
    for sa in qb.segments:
        if sa.seq_id == PAD_SEGMENT:
            continue
        for sb in kb.segments:
            if sb.seq_id != sa.seq_id:
                continue
            total += _segment_pairs(mask, sa.start, sa.end,
                                    sb.start, sb.end)
    return total


def pair_flops(qb: Block, kb: Block, n_q_heads: int, head_dim: int,
               mask=True, backward: bool = False) -> float:
    """Attention FLOPs of one (q-block, kv-block) pair.

    ``4 * pairs * H * D`` forward (QK^T and PV matmuls); backward is ~2.5x
    forward for flash-style kernels (dQ, dK, dV + recompute).
    """
    pairs = pair_valid_tokens(qb, kb, mask)
    f = 4.0 * pairs * n_q_heads * head_dim
    return f * 2.5 if backward else f


def block_q_flops(batch: BlockedBatch, deps: Sequence[Sequence[int]],
                  n_q_heads: int, head_dim: int, mask=True
                  ) -> np.ndarray:
    """Total attention FLOPs attributed to each block's *queries*.

    This is the compute cost ``c_i`` fed to Algorithm 1: the work performed
    wherever block i's queries are placed.  Vectorized closed form
    (§Perf planner-latency iteration): the number of keys a query at
    in-document position p sees is ``p+1`` (causal), ``min(p+1, W)``
    (sliding window), ``p % C + 1`` (chunked), or the document length
    (full), so a block's cost is ``4·H·Dh·Σ keys(p)`` over its real
    tokens.  Equal to the per-pair sum (property tested against
    :func:`block_q_flops_pairwise`).
    """
    mask = coerce_mask(mask)
    seg = batch.seg_ids
    pos = batch.positions
    live = seg >= 0
    if mask.kind == "full":
        lens = np.zeros(max(len(batch.seqlens), 1), dtype=np.float64)
        lens[:len(batch.seqlens)] = batch.seqlens
        per_tok = np.where(live, lens[np.clip(seg, 0, None)], 0.0)
    else:
        keys = pos.astype(np.float64) + 1.0
        if mask.kind == "sliding_window":
            keys = np.minimum(keys, float(mask.window))
        elif mask.kind == "chunked":
            keys = (pos % mask.chunk).astype(np.float64) + 1.0
        per_tok = np.where(live, keys, 0.0)
    per_block = per_tok.reshape(batch.n_blocks, batch.block_size).sum(1)
    return 4.0 * n_q_heads * head_dim * per_block


def block_q_flops_pairwise(batch: BlockedBatch,
                           deps: Sequence[Sequence[int]],
                           n_q_heads: int, head_dim: int,
                           mask=True) -> np.ndarray:
    """Reference implementation: explicit per-(q,kv)-block pair sums."""
    out = np.zeros(batch.n_blocks, dtype=np.float64)
    for i, dep in enumerate(deps):
        qb = batch.blocks[i]
        out[i] = sum(
            pair_flops(qb, batch.blocks[j], n_q_heads, head_dim, mask)
            for j in dep)
    return out


def block_memory(batch: BlockedBatch) -> np.ndarray:
    """Memory cost ``m_i`` per block (resident tokens; Q/K/V/O scale with
    it).  Padding counts — it occupies buffer space."""
    return np.full(batch.n_blocks, batch.block_size, dtype=np.float64)


def doc_valid_pairs(L: int, mask=True) -> int:
    """Exact mask-visible (q, k) pairs of one length-``L`` document."""
    mask = coerce_mask(mask)
    if mask.kind == "full":
        return L * L
    if mask.kind == "sliding_window":
        w = mask.window
        if L <= w:
            return L * (L + 1) // 2
        return w * (w + 1) // 2 + (L - w) * w
    if mask.kind == "chunked":
        c = mask.chunk
        r = L % c
        return (L // c) * (c * (c + 1) // 2) + r * (r + 1) // 2
    return L * (L + 1) // 2


def total_attention_flops(batch: BlockedBatch, n_q_heads: int,
                          head_dim: int, mask=True) -> float:
    """Model FLOPs of attention over the batch (mask-aware, for MFU)."""
    total = 0
    for L in batch.seqlens:
        total += doc_valid_pairs(int(L), mask)
    return 4.0 * total * n_q_heads * head_dim


# --------------------------------------------------------------------------
# wire-bytes accounting (quantized wire formats, runtime/wire.py)
# --------------------------------------------------------------------------
#
# The planner prices communication in WIRE BYTES, not block counts: a
# block shipped bf16 costs half a block shipped f32, and int8 a quarter
# (plus a per-(row, head) f32 scale side-band).  These helpers are the
# single source of those numbers; the coalescer pad cap, the
# ``locality="auto"`` decision and the distributor's locality tolerance
# all scale by :func:`wire_comm_scale`.  ``in_bytes`` is the itemsize
# of the compute dtype the payloads would ship unencoded (2 under bf16
# training, where the bf16 wire is a no-op and int8 halves traffic —
# the pricing must follow the real bytes, not assume f32 compute).

def kv_wire_block_bytes(wire: WireFormat, block_size: int,
                        n_kv_heads: int, head_dim: int,
                        in_bytes: float = 4.0) -> float:
    """Wire bytes of one K+V block (the coalesced-round payload unit:
    2 * n_kv_heads scale groups of block_size * head_dim values)."""
    wire = coerce_wire(wire)
    return 2 * n_kv_heads * wire.group_bytes(block_size * head_dim,
                                             in_bytes)


def qkv_wire_block_bytes(wire: WireFormat, block_size: int, n_q_heads: int,
                         n_kv_heads: int, head_dim: int,
                         in_bytes: float = 4.0) -> float:
    """Wire bytes of one reshuffle payload block (Q, K and V rows)."""
    wire = coerce_wire(wire)
    return ((n_q_heads + 2 * n_kv_heads)
            * wire.group_bytes(block_size * head_dim, in_bytes))


def o_wire_block_bytes(wire: WireFormat, block_size: int, n_q_heads: int,
                       head_dim: int, in_bytes: float = 4.0) -> float:
    """Wire bytes of one restored output block."""
    wire = coerce_wire(wire)
    return n_q_heads * wire.group_bytes(block_size * head_dim, in_bytes)


def wire_comm_scale(wire: WireFormat, block_size: int = 4096,
                    head_dim: int = 128,
                    in_bytes: float = 4.0) -> float:
    """Relative per-block wire cost vs the unencoded payload (<= 1),
    used to weigh comm terms in the planning heuristics."""
    return coerce_wire(wire).comm_scale(block_size * head_dim, in_bytes)


def wire_pad_cap(wire: WireFormat, base_cap: float,
                 max_cap: float = 3.0, in_bytes: float = 4.0,
                 block_size: int = 4096, head_dim: int = 128) -> float:
    """Bytes-aware coalescer pad cap.

    The pad cap bounds how much trash padding a merged ppermute group
    may ship relative to its real payload; the *benefit* of merging
    (per-message launch amortization) is format-independent while the
    *cost* (padded bytes) scales with the wire format, so a cheaper wire
    affords proportionally more padding for the same byte overhead:
    ``1 + (base - 1) / comm_scale``, clamped to ``max_cap`` so int8
    cannot justify unbounded trash rows.  The passthrough wire returns
    ``base_cap`` unchanged.
    """
    scale = wire_comm_scale(wire, block_size, head_dim, in_bytes=in_bytes)
    return min(max_cap, 1.0 + (base_cap - 1.0) / max(scale, 1e-9))


def spec_wire_bytes(spec, n_q_heads: int, n_kv_heads: int, head_dim: int,
                    wire: WireFormat | None = None,
                    in_bytes: float = 4.0) -> dict[str, float]:
    """Per-phase wire bytes a schedule actually ships, including trash
    padding: each ppermute group moves ``len(perm) * rows`` payload rows
    regardless of how many carry real blocks.

    Returns ``{"reshuffle", "rounds", "restore", "total"}`` — the
    benchmark's comm-bytes breakdown (deterministic host accounting, so
    wire-format wins are attributable and CI-gateable).
    """
    wire = coerce_wire(spec.wire if wire is None else wire)
    bs = spec.block_size

    def rows(rounds) -> int:
        return sum(len(g.perm) * g.rows for r in rounds for g in r.groups)

    resh = rows(spec.resh_rounds)
    out = {
        "reshuffle": resh * qkv_wire_block_bytes(
            wire, bs, n_q_heads, n_kv_heads, head_dim, in_bytes),
        "rounds": rows(spec.comm_rounds) * kv_wire_block_bytes(
            wire, bs, n_kv_heads, head_dim, in_bytes),
        "restore": resh * o_wire_block_bytes(
            wire, bs, n_q_heads, head_dim, in_bytes),
    }
    out["total"] = sum(out.values())
    return out


# --------------------------------------------------------------------------
# analytic execution-time model (paper §3.3 + ablation components)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SimFlags:
    """Which FCP runtime components are enabled (paper Table 2)."""
    pipelining: bool = True        # #1 block-level pipeline (overlap)
    congestion_free: bool = True   # #2 matching-based comm ordering
    coalesce: int = 16             # #3 bottom-up coalescer degree
    overlap_reshuffle: bool = True  # #4 transparent reshuffler overlap
    msg_overhead_s: float = 3e-5   # per-message launch cost (NCCL p2p /
    #                                ppermute issue); coalescing amortizes


@dataclasses.dataclass
class SimResult:
    time: float                    # end-to-end attention-module time (s)
    per_worker_compute: np.ndarray
    per_worker_comm: np.ndarray
    mfu: float                     # model-flops utilisation across cluster
    compute_imbalance: float
    comm_imbalance: float


def imbalance(loads: np.ndarray) -> float:
    """(max - mean) / max, as defined in §6.2."""
    mx = float(np.max(loads))
    if mx <= 0:
        return 0.0
    return (mx - float(np.mean(loads))) / mx


def simulate_attention_module(
        batch: BlockedBatch,
        assignment: np.ndarray,            # owner[block]
        deps: Sequence[Sequence[int]],
        n_workers: int,
        hw: HardwareProfile,
        n_q_heads: int, n_kv_heads: int, head_dim: int,
        mask=True,
        flags: SimFlags = SimFlags(),
        reshuffle_moved_blocks: int | None = None,
        backward: bool = False,
        seed: int = 0,
        wire: WireFormat = WIRE_BF16,
) -> SimResult:
    """Analytic time of the attention module for a scheduled batch.

    Implements ``T = max_i eta_i * Comp(w_i)`` (§3.3) with component
    toggles: without pipelining comm adds to compute; without the
    congestion-free solver the comm time of a worker is inflated by the
    expected serialization of random ordering (hot senders); the coalescer
    sets the kernel-efficiency granularity; the reshuffler toggle charges
    the layout all-to-all as exposed time.
    """
    mask = coerce_mask(mask)
    wire = coerce_wire(wire)
    rng = np.random.default_rng(seed)
    bs = batch.block_size
    # comm terms are WIRE BYTES (default bf16, the paper's transport
    # precision — the legacy constant), not block counts
    kv_block_bytes = kv_wire_block_bytes(wire, bs, n_kv_heads, head_dim)

    comp = np.zeros(n_workers)
    comm_in = np.zeros(n_workers)
    comm_out = np.zeros(n_workers)
    # per (dst, src) transferred blocks (deduped: one copy per dst)
    transfers: dict[tuple[int, int], int] = {}
    bwd = 2.5 if backward else 1.0

    eff_tokens = min(bs * max(1, flags.coalesce), 8 * bs)
    eff = kernel_efficiency(eff_tokens if flags.coalesce else bs,
                            hw.efficiency_knee)
    for i, dep in enumerate(deps):
        w = int(assignment[i])
        qb = batch.blocks[i]
        seen_remote: set[int] = set()
        for j in dep:
            f = pair_flops(qb, batch.blocks[j], n_q_heads, head_dim, mask)
            comp[w] += bwd * f / (hw.peak_flops * eff)
            src = int(assignment[j])
            if src != w and j not in seen_remote:
                seen_remote.add(j)
                key = (w, src)
                transfers[key] = transfers.get(key, 0) + 1
    per_msg = flags.msg_overhead_s / max(1, flags.coalesce)
    for (dst, src), nblk in transfers.items():
        comm_in[dst] += nblk * (kv_block_bytes / hw.link_bandwidth
                                + per_msg)
        comm_out[src] += nblk * (kv_block_bytes / hw.link_bandwidth
                                 + per_msg)

    comm = np.maximum(comm_in, comm_out)
    if not flags.congestion_free:
        # random pull ordering: expected slowdown from sender hot spots.
        # Model: each round, receivers pick senders independently; a sender
        # chosen by k receivers serializes k transfers. Expected max load
        # over senders with m in-flight pulls ~ balls-in-bins factor.
        indeg = np.zeros(n_workers)
        for (dst, src), nblk in transfers.items():
            indeg[src] += nblk
        active = indeg[indeg > 0]
        if active.size:
            m = float(np.mean(active))
            # balls-into-bins expected max ≈ m + sqrt(2 m ln N)
            factor = (m + math.sqrt(2.0 * m * math.log(max(n_workers, 2)))) / m
            comm = comm * factor

    if reshuffle_moved_blocks is None:
        # blocks that change workers between stream layout and assignment
        slots = max(1, batch.n_blocks // n_workers)
        stream_owner = np.minimum(np.arange(batch.n_blocks) // slots,
                                  n_workers - 1)
        reshuffle_moved_blocks = int(np.sum(stream_owner != assignment))
    resh_bytes = reshuffle_moved_blocks * qkv_wire_block_bytes(
        wire, bs, n_q_heads, n_kv_heads, head_dim)
    resh_time_total = resh_bytes / (hw.link_bandwidth * max(n_workers, 1))

    if flags.pipelining:
        per_worker = np.maximum(comp, comm)
    else:
        per_worker = comp + comm
    t = float(np.max(per_worker)) if per_worker.size else 0.0
    if flags.overlap_reshuffle:
        # overlapped with local pair compute; only the non-hidden part shows
        local_comp = float(np.min(comp)) if comp.size else 0.0
        t += max(0.0, resh_time_total - local_comp)
    else:
        t += resh_time_total

    useful = bwd * total_attention_flops(batch, n_q_heads, head_dim, mask)
    mfu = useful / (n_workers * hw.peak_flops * t) if t > 0 else 0.0
    return SimResult(time=t, per_worker_compute=comp, per_worker_comm=comm,
                     mfu=mfu, compute_imbalance=imbalance(comp),
                     comm_imbalance=imbalance(comm_in + comm_out))
