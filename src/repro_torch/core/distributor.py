"""Workload-aware block distributor (paper §4.1 + Appendix A.1).

Implements Algorithm 1: a Longest-Processing-Time (LPT) variant that
greedily assigns each block to the least-loaded worker, where load is a
weighted max of normalized memory and compute, subject to a per-worker
memory cap ``M * (1 + delta)``.

Beyond the paper we add two production concerns:

* **speed-aware assignment** (straggler mitigation): per-worker relative
  speeds divide the compute term, so chronically slow workers receive
  proportionally less work;
* **locality tie-breaking**: among (nearly) equally loaded workers prefer
  the block's current owner in the stream layout, minimizing reshuffle
  traffic (recorded as a beyond-paper optimization in EXPERIMENTS.md).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class AssignmentResult:
    owner: np.ndarray          # [n_blocks] int32 worker id
    worker_mem: np.ndarray     # [n_workers] tokens assigned
    worker_comp: np.ndarray    # [n_workers] compute cost assigned
    relaxed: bool              # memory cap had to be violated


def assign_blocks(
        compute: np.ndarray,           # c_i per block
        memory: np.ndarray,            # m_i per block (tokens)
        n_workers: int,
        mem_limit: float | None = None,
        *,
        alpha: float = 1.0,
        beta: float = 1.0,
        delta: float = 0.0,
        speeds: np.ndarray | None = None,
        locality_hint: np.ndarray | None = None,
        locality_tol: float = 0.05,
        comm_scale: float = 1.0,
) -> AssignmentResult:
    """Algorithm 1: greedy load-balanced assignment.

    ``locality_hint[i]`` (optional) is the worker that already holds block
    ``i`` in the incoming layout; it wins ties within ``locality_tol`` of
    the best load.

    ``comm_scale`` is the wire-bytes cost of communication relative to
    the f32 wire (``cost_model.wire_comm_scale``): locality swaps trade
    balance for reshuffle *bytes*, so a cheaper wire shrinks the load
    drift the refinement may spend per byte saved — at ``comm_scale=1``
    (f32) the objective is unchanged.
    """
    compute = np.asarray(compute, dtype=np.float64)
    memory = np.asarray(memory, dtype=np.float64)
    k = compute.shape[0]
    if speeds is None:
        speeds = np.ones(n_workers)
    speeds = np.asarray(speeds, dtype=np.float64)
    if speeds.shape != (n_workers,):
        raise ValueError(
            f"speeds has shape {speeds.shape}, expected ({n_workers},) — "
            f"resize the tracker/monitor after an elastic event")
    # a zero/negative speed (a dead worker in a stale measurement) would
    # send that worker's load to inf and starve it while every schedule
    # table still routes blocks through it — losing a worker is an
    # elastic replan on the survivors, never a speed of 0
    speeds = np.clip(speeds, 1e-3, None)
    if mem_limit is None:
        mem_limit = float(np.sum(memory)) / n_workers
    cap = mem_limit * (1.0 + delta)

    m_hat = max(float(np.sum(memory)) / n_workers, 1e-12)
    c_hat = max(float(np.sum(compute)) / n_workers, 1e-12)

    # line 2: sort desc by max(m_i/m_hat, c_i/c_hat)
    keys = np.maximum(memory / m_hat, compute / c_hat)
    order = np.argsort(-keys, kind="stable")

    w_mem = np.zeros(n_workers)
    w_comp = np.zeros(n_workers)
    owner = np.zeros(k, dtype=np.int32)
    relaxed = False

    for i in order:
        mi, ci = memory[i], compute[i]
        load = np.maximum(alpha * (w_mem + mi) / m_hat,
                          beta * ((w_comp + ci) / speeds) / c_hat)
        eligible = (w_mem + mi) <= cap
        if not eligible.any():
            relaxed = True               # every worker at cap: least-mem
            w = int(np.argmin(w_mem))
        else:
            masked = np.where(eligible, load, np.inf)
            w = int(np.argmin(masked))
        owner[i] = w
        w_mem[w] += mi
        w_comp[w] += ci

    if locality_hint is not None:
        owner = refine_locality(owner, compute, locality_hint,
                                tol=locality_tol * float(comm_scale)
                                * float(np.sum(compute)) / n_workers)
        w_mem = np.bincount(owner, weights=memory, minlength=n_workers)
        w_comp = np.bincount(owner, weights=compute, minlength=n_workers)

    return AssignmentResult(owner=owner, worker_mem=w_mem,
                            worker_comp=w_comp, relaxed=relaxed)


def refine_locality(owner: np.ndarray, compute: np.ndarray,
                    hint: np.ndarray, tol: float) -> np.ndarray:
    """Post-LPT locality refinement (beyond-paper optimization).

    Swap pairs of blocks between workers when the swap moves >= one block
    onto its current (stream-layout) owner and the cost difference is
    <= ``tol`` — per-worker loads drift at most ``tol`` per swap chain,
    preserving LPT's balance while eliminating reshuffle traffic (exact
    for uniform workloads: the assignment becomes the identity).  Memory
    is invariant (blocks have equal size).
    """
    owner = owner.copy()
    n_workers = int(owner.max()) + 1 if owner.size else 0
    # candidate pools: blocks currently NOT on their hinted worker,
    # grouped by current worker, sorted by cost for bisection
    import bisect
    pools: list[list[tuple[float, int]]] = [[] for _ in range(n_workers)]
    for b in range(owner.size):
        if owner[b] != hint[b]:
            pools[owner[b]].append((float(compute[b]), int(b)))
    for p in pools:
        p.sort()
    # cumulative signed load drift per worker: bounded by tol overall,
    # not per swap, so refinement cannot erode LPT's balance
    drift = np.zeros(n_workers)
    settled: set[int] = set()       # blocks that reached their hint

    def _candidates(h: int, cb: float):
        """Nearest-cost valid pool entries (lazily dropping stale ones —
        entries whose block has since moved off ``h`` or settled)."""
        pool = pools[h]
        j = bisect.bisect_left(pool, (cb, -1))
        for k in (j, j - 1, j + 1, j - 2):
            while 0 <= k < len(pool):
                cb2, b2 = pool[k]
                if int(owner[b2]) != h or b2 in settled:
                    pool.pop(k)          # stale: remove and re-examine
                    continue
                yield k, cb2, b2
                break

    def try_settle(b: int) -> int | None:
        """Swap ``b`` onto its hinted worker; returns displaced block."""
        h, w = int(hint[b]), int(owner[b])
        if h >= n_workers or h == w:
            return None
        cb = float(compute[b])
        best = None
        for _, cb2, b2 in _candidates(h, cb):
            if b2 == b:
                continue
            if best is None or abs(cb2 - cb) < abs(best[0] - cb):
                best = (cb2, b2)
        if best is None:
            return None
        cb2, b2 = best
        dc = cb - cb2
        if not (abs(drift[h] + dc) <= tol and abs(drift[w] - dc) <= tol):
            return None
        # re-locate (lazy pops above may have shifted indices)
        k = bisect.bisect_left(pools[h], (cb2, b2))
        assert pools[h][k] == (cb2, b2)
        pools[h].pop(k)
        owner[b], owner[b2] = h, w
        drift[h] += dc
        drift[w] -= dc
        settled.add(b)
        if int(hint[b2]) != w:
            bisect.insort(pools[w], (float(compute[b2]), b2))
        else:
            settled.add(b2)
        return int(b2)

    for b in np.argsort(-compute):              # big blocks first
        b = int(b)
        # follow displacement chains so 3-cycles resolve too
        hops = 0
        while (b is not None and b not in settled
               and owner[b] != hint[b] and hops < 8):
            b = try_settle(b)
            hops += 1
    return owner
