"""Baseline CP scheduling policies (paper §3.4, §6.1, Appendix A.3).

All baselines are expressed as *assignment policies over the same uniform
block structure* so they run through the identical planner/executor path
("executable mode"), and additionally as paper-faithful analytic models
("analysis mode") for the figures where their true sharding function G
differs (ring attention's 2N tiny shards per sequence).

* ``assign_ring``      — balance-optimized: Zig-Zag deal of blocks
  (RingAttention, Liu et al. 2023).
* ``assign_bytescale`` — efficiency-optimized: sequences get worker ranges
  proportional to context length; ring/zig-zag within each range
  (ByteScale HDP-balanced, Ge et al. 2025).
* ``assign_wlb``       — oracle switch between the two (WLB-LLM, Wang et
  al. 2025b; the paper's own reimplementation replaces the online
  estimator with an oracle, A.3).
* ``assign_magi``      — compute-only balance, communication-oblivious
  (MagiAttention-like, Zewei & Yunpeng 2025).
* ``assign_fcp``       — the paper's contribution: Algorithm 1 (in
  ``distributor.py``; re-exported here for uniform benchmarking).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from . import cost_model as cm
from . import distributor as dist
from .blocks import BlockedBatch, zigzag_order


def _blocks_of_seqs(batch: BlockedBatch) -> dict[int, list[int]]:
    out: dict[int, list[int]] = {}
    for b in batch.blocks:
        for s in b.segments:
            if s.seq_id < 0:
                continue
            out.setdefault(s.seq_id, [])
            if not out[s.seq_id] or out[s.seq_id][-1] != b.bid:
                out[s.seq_id].append(b.bid)
    return out


def assign_ring(batch: BlockedBatch, n_workers: int) -> np.ndarray:
    """Zig-Zag deal of blocks in stream order (uniform sharding)."""
    return zigzag_order(batch.n_blocks, n_workers)


def assign_bytescale(batch: BlockedBatch, n_workers: int,
                     tokens_per_worker: int) -> np.ndarray:
    """Length-proportional worker ranges, zig-zag within range.

    A sequence of length ``k * tokens_per_worker`` receives ~k workers
    (HDP-balanced).  Capacity (``slots`` blocks per worker) is enforced by
    falling back to the least-loaded worker with room.
    """
    slots = batch.n_blocks // n_workers
    seq_blocks = _blocks_of_seqs(batch)
    cap = np.full(n_workers, slots, dtype=np.int64)
    owner = np.full(batch.n_blocks, -1, dtype=np.int32)
    # longest sequences first, each claiming a contiguous worker window
    order = sorted(seq_blocks, key=lambda s: -len(seq_blocks[s]))
    ptr = 0
    loads = np.zeros(n_workers, dtype=np.int64)
    for sid in order:
        blks = [b for b in seq_blocks[sid] if owner[b] < 0]
        if not blks:
            continue
        k = max(1, min(n_workers,
                       round(len(seq_blocks[sid]) * batch.block_size
                             / tokens_per_worker)))
        window = [(ptr + i) % n_workers for i in range(k)]
        ptr = (ptr + k) % n_workers
        zz = zigzag_order(len(blks), k)
        for idx, b in enumerate(blks):
            w = window[int(zz[idx])]
            if cap[w] <= 0:                      # spill to least loaded
                cands = np.where(cap > 0)[0]
                w = int(cands[np.argmin(loads[cands])])
            owner[b] = w
            cap[w] -= 1
            loads[w] += 1
    # any untouched (pad) blocks
    for b in range(batch.n_blocks):
        if owner[b] < 0:
            cands = np.where(cap > 0)[0]
            w = int(cands[np.argmin(loads[cands])])
            owner[b] = w
            cap[w] -= 1
            loads[w] += 1
    return owner


def assign_magi(batch: BlockedBatch, deps: Sequence[Sequence[int]],
                n_workers: int, n_q_heads: int, head_dim: int,
                mask=True) -> np.ndarray:
    """Compute-balanced only (alpha=0): ignores communication placement."""
    costs = cm.block_q_flops(batch, deps, n_q_heads, head_dim, mask)
    mems = cm.block_memory(batch)
    res = dist.assign_blocks(costs, mems, n_workers,
                             mem_limit=float(np.sum(mems)) / n_workers,
                             alpha=0.0, beta=1.0, delta=0.0,
                             locality_hint=None)
    return res.owner


def assign_fcp(batch: BlockedBatch, deps: Sequence[Sequence[int]],
               n_workers: int, n_q_heads: int, head_dim: int,
               mask=True, locality: bool = True,
               speeds: np.ndarray | None = None) -> np.ndarray:
    costs = cm.block_q_flops(batch, deps, n_q_heads, head_dim, mask)
    mems = cm.block_memory(batch)
    slots = batch.n_blocks // n_workers
    stream_owner = (np.arange(batch.n_blocks) // slots).astype(np.int32)
    res = dist.assign_blocks(
        costs, mems, n_workers,
        mem_limit=float(slots * batch.block_size), delta=0.0,
        speeds=speeds, locality_hint=stream_owner if locality else None)
    return res.owner


def assign_wlb(batch: BlockedBatch, deps: Sequence[Sequence[int]],
               n_workers: int, tokens_per_worker: int,
               hw: cm.HardwareProfile, n_q_heads: int, n_kv_heads: int,
               head_dim: int, mask=True) -> np.ndarray:
    """Oracle switch (A.3): simulate both baselines, keep the faster."""
    cands = {
        "ring": assign_ring(batch, n_workers),
        "bytescale": assign_bytescale(batch, n_workers, tokens_per_worker),
    }
    best, best_t = None, float("inf")
    for name, a in cands.items():
        r = cm.simulate_attention_module(
            batch, a, deps, n_workers, hw, n_q_heads, n_kv_heads, head_dim,
            mask=mask)
        if r.time < best_t:
            best, best_t = a, r.time
    return best


# --------------------------------------------------------------------------
# analysis mode: paper-faithful ring G (2N shards per sequence)
# --------------------------------------------------------------------------

def ring_analysis_loads(seqlens: Sequence[int], n_workers: int,
                        hw: cm.HardwareProfile, n_q_heads: int,
                        head_dim: int) -> np.ndarray:
    """Per-worker compute *time* under true ring attention: every sequence
    split into 2N shards (zig-zag), kernel efficiency evaluated at the tiny
    shard size (this is where ring loses, §3.4)."""
    t = np.zeros(n_workers)
    for L in seqlens:
        shard = max(1, L // (2 * n_workers))
        # zig-zag pairs shard i with 2N-1-i: each worker computes an equal
        # (L/2N)·(L+1)/2-ish share; efficiency evaluated at shard size
        flops_per_worker = 4.0 * (L * (L + 1) / 2) * n_q_heads * head_dim \
            / n_workers
        eff = cm.kernel_efficiency(shard, hw.efficiency_knee)
        t += flops_per_worker / (hw.peak_flops * eff)
    return t
