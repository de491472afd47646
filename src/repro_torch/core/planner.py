"""Congestion-free communication planner (paper §4.2 + Appendix A.2).

Block placement is arbitrary, so KV transfers form a bipartite *multigraph*
with N send nodes and N receive nodes.  A congestion-free sub-stage is a
*matching* (every worker sends <= 1 and receives <= 1 block; Lemma 1) and
the minimum number of sub-stages equals the maximum degree Delta (Lemma 2 +
König/Hall construction): we Delta-regularize the multigraph with dummy
edges and repeatedly extract perfect matchings.

On TPU each matching **is a partial device permutation**, i.e. exactly one
``jax.lax.ppermute`` — the torus routes permutations without the hotspot
the paper worries about for all-to-all traffic (DESIGN.md §2).

The *bottom-up coalescer* merges ``C`` consecutive matchings into one round
(each worker then moves <= C blocks per round, still hotspot-free), and the
live-range allocator colors received blocks into a minimal receive buffer.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Any, Hashable, Sequence

import numpy as np

Edge = tuple[int, int, Any]          # (src worker, dst worker, payload)


# --------------------------------------------------------------------------
# perfect matching on a bipartite (multi)graph — Kuhn's algorithm
# --------------------------------------------------------------------------

def _kuhn_perfect(adj: list[dict[int, int]], n: int,
                  warm: list[int] | None = None) -> list[int]:
    """Perfect matching over ``adj[s] = {dst: multiplicity>0}``.

    ``warm`` (dst -> src from the previous round) seeds the matching with
    edges that still have multiplicity — on Delta-regular multigraphs
    most survive, so only a few augmenting paths run per round (the
    planner-latency optimization measured in EXPERIMENTS.md §Perf).
    """
    match_src = [-1] * n   # dst -> src
    match_dst = [-1] * n   # src -> dst
    if warm is not None:
        for d, s in enumerate(warm):
            if s >= 0 and match_dst[s] < 0 and adj[s].get(d, 0) > 0:
                match_src[d] = s
                match_dst[s] = d

    def try_augment(root: int, visited: list[bool]) -> bool:
        # iterative DFS over alternating paths (explicit stack: augmenting
        # runs on the plan-ahead background thread, so no recursion-limit
        # fiddling — that would be cross-thread global state)
        path = [root]                       # srcs on the current path
        nbrs = {root: iter(adj[root])}      # src -> remaining neighbors
        via: dict[int, int] = {}            # src -> dst it was reached via
        while path:
            src = path[-1]
            for d in nbrs[src]:
                if visited[d]:
                    continue
                visited[d] = True
                nxt = match_src[d]
                if nxt < 0:
                    # free dst: flip matches along the alternating path
                    while True:
                        match_src[d] = src
                        match_dst[src] = d
                        if src == root:
                            return True
                        d = via[src]        # dst that pulled src onto
                        path.pop()          # the path; rematch it to
                        src = path[-1]      # src's predecessor
                via[nxt] = d
                nbrs[nxt] = iter(adj[nxt])
                path.append(nxt)
                break
            else:
                path.pop()
        return False

    for s in range(n):
        if match_dst[s] < 0:
            if not try_augment(s, [False] * n):
                raise RuntimeError(
                    "no perfect matching; multigraph not regular")
    return match_src


# --------------------------------------------------------------------------
# Delta-regularization + decomposition (Appendix A.2)
# --------------------------------------------------------------------------

def decompose_matchings(edges: Sequence[Edge], n_workers: int
                        ) -> list[list[Edge]]:
    """Partition ``edges`` into ``Delta`` matchings (congestion-free rounds).

    Dummy edges added for regularization are dropped from the output.
    Payload order per (src, dst) is FIFO.
    """
    if not edges:
        return []
    counts: dict[tuple[int, int], int] = defaultdict(int)
    payloads: dict[tuple[int, int], list[Any]] = defaultdict(list)
    out_deg = np.zeros(n_workers, dtype=np.int64)
    in_deg = np.zeros(n_workers, dtype=np.int64)
    for s, d, p in edges:
        counts[(s, d)] += 1
        payloads[(s, d)].append(p)
        out_deg[s] += 1
        in_deg[d] += 1
    delta = int(max(out_deg.max(), in_deg.max()))

    # greedily add dummy multi-edges until Delta-regular
    dummy: dict[tuple[int, int], int] = defaultdict(int)
    s_deficit = [(int(delta - out_deg[i]), i) for i in range(n_workers)]
    d_deficit = [(int(delta - in_deg[i]), i) for i in range(n_workers)]
    s_list = [i for c, i in s_deficit for _ in range(c)]
    d_list = [i for c, i in d_deficit for _ in range(c)]
    assert len(s_list) == len(d_list)
    for s, d in zip(s_list, d_list):
        dummy[(s, d)] += 1

    adj: list[dict[int, int]] = [defaultdict(int)
                                 for _ in range(n_workers)]
    for (s, d), c in counts.items():
        adj[s][d] += c
    for (s, d), c in dummy.items():
        adj[s][d] += c

    matchings: list[list[Edge]] = []
    warm: list[int] | None = None
    for _ in range(delta):
        match_src = _kuhn_perfect(adj, n_workers, warm=warm)
        round_edges: list[Edge] = []
        for d in range(n_workers):
            s = match_src[d]
            assert s >= 0
            adj[s][d] -= 1
            if adj[s][d] == 0:
                del adj[s][d]
            if counts.get((s, d), 0) > 0:        # real edge preferred
                counts[(s, d)] -= 1
                round_edges.append((s, d, payloads[(s, d)].pop(0)))
            else:
                dummy[(s, d)] -= 1
        matchings.append(round_edges)
        warm = match_src
    assert all(c == 0 for c in counts.values()), "real edges left over"
    return matchings


def verify_matchings(matchings: Sequence[Sequence[Edge]],
                     edges: Sequence[Edge], n_workers: int) -> None:
    """Check the decomposition: every round is a matching, all edges kept."""
    flat = []
    for m in matchings:
        srcs = [e[0] for e in m]
        dsts = [e[1] for e in m]
        assert len(set(srcs)) == len(srcs), "worker sends >1 block in round"
        assert len(set(dsts)) == len(dsts), "worker recvs >1 block in round"
        flat.extend(m)
    assert sorted(map(repr, flat)) == sorted(map(repr, edges)), \
        "decomposition lost or duplicated edges"
    out_deg = np.zeros(n_workers, dtype=np.int64)
    in_deg = np.zeros(n_workers, dtype=np.int64)
    for s, d, _ in edges:
        out_deg[s] += 1
        in_deg[d] += 1
    delta = int(max(out_deg.max(), in_deg.max(), 0))
    assert len(matchings) == delta, (len(matchings), delta)


def coalesce_matchings(matchings: Sequence[list[Edge]], degree: int
                       ) -> list[list[list[Edge]]]:
    """Bottom-up coalescer (§4.2): group ``degree`` consecutive matchings.

    Each coalesced round lets every worker send/recv up to ``degree`` blocks
    — still hotspot-free because each sub-matching is a permutation.
    """
    if degree <= 1:
        return [[m] for m in matchings]
    return [list(matchings[i:i + degree])
            for i in range(0, len(matchings), degree)]


# wire-padding bound for group merging: a group may ship at most this
# factor of its real payload (row height x pair count vs real blocks)
COALESCE_PAD_CAP = 1.5

CoalescedEdge = tuple[int, int, int, int, Any]  # (row, lane, src, dst, pay)


def group_coalesced_round(window: Sequence[Sequence[Edge]],
                          pad_cap: float = COALESCE_PAD_CAP
                          ) -> list[tuple[tuple[tuple[int, int], ...], int,
                                          list[CoalescedEdge]]]:
    """Merge a coalesced round's edges into collective *groups* (§4.2).

    A group is a set of whole (src, dst) *pairs* whose distinct pairs form
    a partial permutation — the group ships as ONE ``lax.ppermute`` whose
    payload stacks ``rows`` KV blocks, where ``rows`` is the largest
    per-pair block count in the group.  Each sender packs its pair's
    blocks into rows ``0..m-1`` (FIFO by sub-matching lane) and pads the
    rest with trash, so a window's pulls that concentrate on few worker
    pairs — long-document traffic — collapse from ``C`` collective
    launches into one tall one: this is what amortizes per-message
    latency.  Row packing makes the merge insensitive to *which* lanes a
    pair occupies; padding only comes from height variance between a
    group's pairs, and a merge is rejected when it would inflate the
    group's wire payload (``rows x n_pairs``) beyond ``pad_cap`` times
    its real block count.  Spread-out traffic (all multiplicities 1)
    therefore degrades to height-1 groups with zero padding.

    Pairs are placed heaviest-first so long runs seed the groups.
    Returns ``[(perm, rows, edges), ...]`` with ``perm`` the merged
    partial permutation (sorted distinct pairs) and ``edges`` the
    ``(row, lane, src, dst, payload)`` records assigned to the group.
    """
    by_pair: dict[tuple[int, int], list[tuple[int, Any]]] = defaultdict(list)
    for lane, m in enumerate(window):
        for s, d, p in m:
            by_pair[(int(s), int(d))].append((lane, p))

    groups: list[dict] = []
    for (s, d), occ in sorted(by_pair.items(),
                              key=lambda kv: (-len(kv[1]), kv[0])):
        m = len(occ)
        placed = False
        for g in groups:
            if g["out"].get(s, d) != d or g["in"].get(d, s) != s:
                continue
            rows = max(g["rows"], m)
            n_pairs = len(g["pairs"]) + 1
            if rows * n_pairs > pad_cap * (g["real"] + m):
                continue                            # padding guard
            g["out"][s] = d
            g["in"][d] = s
            g["rows"] = rows
            g["pairs"].add((s, d))
            g["real"] += m
            g["edges"].extend((row, lane, s, d, p)
                              for row, (lane, p) in enumerate(occ))
            placed = True
            break
        if not placed:
            groups.append({"out": {s: d}, "in": {d: s},
                           "rows": m, "pairs": {(s, d)}, "real": m,
                           "edges": [(row, lane, s, d, p)
                                     for row, (lane, p) in enumerate(occ)]})
    if len(groups) > len(window):
        # merging lost to the identity decomposition (very spread traffic
        # plus unlucky first-fit coloring): one group per sub-matching is
        # never worse than the uncoalesced schedule
        return [(tuple(sorted((int(s), int(d)) for s, d, _ in m)), 1,
                 [(0, lane, int(s), int(d), p) for s, d, p in m])
                for lane, m in enumerate(window)]
    return [(tuple(sorted(g["pairs"])), g["rows"], g["edges"])
            for g in groups]


# --------------------------------------------------------------------------
# communication-edge construction
# --------------------------------------------------------------------------

def build_comm_edges(assignment: np.ndarray,
                     deps: Sequence[Sequence[int]]) -> list[Edge]:
    """KV-transfer edges ``(owner(j) -> owner(i), block j)``, deduplicated
    per destination (a worker pulls each remote block once, §4.2)."""
    edges: list[Edge] = []
    seen: set[tuple[int, int]] = set()      # (dst, block)
    for i, dep in enumerate(deps):
        dst = int(assignment[i])
        for j in dep:
            src = int(assignment[j])
            if src == dst:
                continue
            key = (dst, int(j))
            if key in seen:
                continue
            seen.add(key)
            edges.append((src, dst, int(j)))
    return edges


def build_reshuffle_edges(stream_owner: np.ndarray,
                          assignment: np.ndarray) -> list[Edge]:
    """Block moves between the user (stream) layout and the schedule layout
    (transparent reshuffler, §4.3)."""
    edges: list[Edge] = []
    for b, (u, w) in enumerate(zip(stream_owner, assignment)):
        if int(u) != int(w):
            edges.append((int(u), int(w), int(b)))
    return edges


# --------------------------------------------------------------------------
# receive-buffer live-range allocation
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SlotAllocation:
    slot_of_arrival: dict[tuple[int, Hashable], int]  # (worker, blk) -> slot
    n_slots: int                                   # buffer depth needed


def allocate_recv_slots(
        arrivals: dict[tuple[int, int], Sequence[Hashable]],
        last_use: dict[tuple[int, Hashable], int],     # (worker,blk)->run
        n_rounds: int, n_workers: int, *,
        overlap: bool = False) -> SlotAllocation:
    """Greedy interval coloring of received blocks into buffer slots.

    ``arrivals`` maps ``(worker, round)`` to the blocks delivered that
    round — a coalesced round delivers up to ``C`` of them.  A block
    arriving at round ``r`` is live until the run of its last consumer;
    slots are reused afterwards.  Keeps the receive buffer at
    max-concurrent-live depth instead of one-slot-per-arrival.

    ``overlap`` is the double-buffering (buffer-parity) liveness rule
    for the software-pipelined executor: round ``r``'s send is issued
    *before* run ``r``'s compute, so its commit may land while run ``r``
    still reads the buffer.  Two changes vs the serial rule:

    * **strict expiry** — a slot frees at round ``r`` only if its
      occupant's last consuming run is ``< r`` (serial allows ``<= r``,
      because run ``r`` finishes before round ``r`` commits);
    * **parity pools** — a slot first allocated at round ``r`` carries
      parity ``r % 2`` and is only ever reused by arrivals of the same
      parity.  Consecutive rounds therefore commit into disjoint slot
      sets (the two halves of a double buffer), which is what lets the
      executor keep round ``r+1`` in flight during run ``r`` without
      the in-flight payload racing a pending consumer.
    """
    slot_of: dict[tuple[int, Hashable], int] = {}
    n_slots = 0
    for w in range(n_workers):
        free: dict[int, list[int]] = {0: [], 1: []}   # parity -> slots
        allocated = 0
        active: list[tuple[int, int, int]] = []  # (expiry run, slot, par)
        for r in range(n_rounds):
            blks = arrivals.get((w, r), ())
            if not blks:
                continue
            # expire slots whose last use is before this round commits
            par = r % 2 if overlap else 0
            still = []
            for exp, slot, p in active:
                done = exp < r if overlap else exp <= r
                if done:
                    free[p].append(slot)
                else:
                    still.append((exp, slot, p))
            active = still
            for blk in blks:
                if free[par]:
                    slot = free[par].pop()
                else:
                    slot = allocated
                    allocated += 1
                exp = last_use.get((w, blk), r + 1)
                active.append((exp, slot, par))
                slot_of[(w, blk)] = slot
        n_slots = max(n_slots, allocated)
    return SlotAllocation(slot_of_arrival=slot_of, n_slots=n_slots)
