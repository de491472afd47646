"""End-to-end FCP schedule construction (paper Fig. 6 pipeline).

``make_schedule`` runs: sharding policy ``G`` (stream → fixed blocks) →
block distributor (Algorithm 1) → communication planner (matching
decomposition) → per-worker compute-step scheduling → receive-buffer
coloring, and emits an :class:`ExecPlan`:

* ``StaticSpec`` — a frozen, hashable description (matching permutations,
  round/step counts, buffer depths).  It is a *static* jit argument: each
  distinct schedule signature compiles once (DESIGN.md §2).
* ``PlanArrays`` — int32 numpy tables ``[n_workers, ...]`` that are sharded
  over the CP axis at run time (per-worker slot indices, step tables,
  token metadata).  Per-batch variation lives here without recompiling.

The executor (``core/executor.py``) interprets the plan inside
``shard_map``.  Matchings are grouped by the §4.2 bottom-up coalescer
into rounds of up to ``C`` sub-matchings; each round ships as few
``lax.ppermute`` collectives as the round's pair structure allows (one,
when traffic is pair-concentrated), each carrying a stacked multi-block
payload.

Compute steps are grouped into **runs** (``StaticSpec.run_starts``): run
``r`` holds the steps executed between the arrival commits of rounds
``r-1`` and ``r``, so the fused executor issues one attention launch per
run.  Steps are q-slot-sorted within a run (forward accumulator
residency); the ``bwd_*`` tables hold the same steps kv-slot-sorted
(backward dk/dv residency).
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Sequence

import numpy as np

from ..masks import MaskSpec, coerce_mask
from ..runtime.wire import WIRE_F32, WireFormat, coerce_wire
from . import blocks as blockslib
from . import cost_model as cm
from . import distributor as dist
from . import planner as plannerlib
from .blocks import PAD_SEGMENT, BlockedBatch

Perm = tuple[tuple[int, int], ...]


@dataclasses.dataclass(frozen=True)
class CommGroup:
    """One ``lax.ppermute`` of a coalesced round.

    ``perm`` is the merged partial permutation (the group's distinct
    (src, dst) pairs); its payload stacks ``rows`` KV blocks per edge —
    each sender packs its blocks for its (single) destination into the
    leading rows and trash-pads the rest.
    """
    perm: Perm
    rows: int


@dataclasses.dataclass(frozen=True)
class CommRound:
    """A coalesced communication round: <= C sub-matchings, merged into
    ppermute groups (§4.2 bottom-up coalescer)."""
    groups: tuple[CommGroup, ...]

    @property
    def n_rows(self) -> int:
        """Total payload rows of the round (plan-table row axis)."""
        return sum(g.rows for g in self.groups)


@dataclasses.dataclass(frozen=True)
class StaticSpec:
    """Hashable jit-static schedule description."""
    n_workers: int
    block_size: int
    slots: int                  # schedule-layout blocks per worker
    ext_slots: int              # receive-buffer depth (after coloring)
    coalesce: int               # bottom-up coalescer degree C (>= 1)
    n_matchings: int            # Delta: congestion-free KV matchings
    n_rounds: int               # coalesced KV rounds = ceil(Delta / C)
    n_steps: int                # step-table width (sum of run widths)
    n_resh_rounds: int          # coalesced reshuffle rounds
    comm_rounds: tuple[CommRound, ...]
    resh_rounds: tuple[CommRound, ...]
    mask: MaskSpec
    # fused-run grouping: run r holds the compute steps executed between
    # the arrival commits of rounds r-1 and r — one fused kernel launch
    # per run.  ``run_starts`` (len n_runs+1) offsets into the step
    # tables; runs may be empty.  Run r < n_rounds overlaps round r's
    # ppermute; the tail run consumes the last arrivals.
    run_starts: tuple[int, ...] = (0, 0)
    # wire format of every ppermute payload (reshuffle / rounds /
    # restore; runtime/wire.py).  Part of the spec: the executor's
    # encode/decode graph differs per format, so schedules — and hence
    # jit cache entries and plan-cache keys — never cross formats.
    wire: WireFormat = WIRE_F32
    # buffer-parity bit of the software-pipelined executor: when set,
    # round r+1's sends are issued before run r's compute and receive
    # slots are double-buffered (planner.allocate_recv_slots parity
    # pools, strict expiry).  Part of the spec — the allocator's slot
    # tables, the verifier's liveness rule and the executor's loop
    # structure all differ, so plans/jit entries never cross modes.
    overlap: bool = False

    @property
    def n_runs(self) -> int:
        """Fused kernel launches per worker (<= n_rounds + 1)."""
        return len(self.run_starts) - 1

    @property
    def kv_trash(self) -> int:         # extended-kv trash slot index
        return self.slots + self.ext_slots

    @property
    def q_trash(self) -> int:          # schedule-layout trash slot index
        return self.slots

    @property
    def n_comm_launches(self) -> int:
        """ppermute collectives on the KV hot path (vs Delta uncoalesced)."""
        return sum(len(r.groups) for r in self.comm_rounds)

    @property
    def comm_rows(self) -> int:
        """Payload-row axis of the KV send/recv tables (widest round)."""
        return max(1, max((r.n_rows for r in self.comm_rounds), default=1))

    @property
    def resh_rows(self) -> int:
        """Payload-row axis of the reshuffle/restore tables."""
        return max(1, max((r.n_rows for r in self.resh_rounds), default=1))

    @property
    def table_dims(self) -> tuple:
        """Every static array dimension of the executor's jit signature
        (plan-table shapes — including the round axes of the comm and
        reshuffle tables — plus run widths).  Schedules sharing these
        dims and the comm structure compile once; the amortized-planning
        length buckets (core/plan_cache.py) keep this set small."""
        return (self.n_steps, self.n_rounds, self.comm_rows,
                self.n_resh_rounds, self.resh_rows, self.slots,
                self.ext_slots, self.run_starts)

    @property
    def n_resh_launches(self) -> int:
        return sum(len(r.groups) for r in self.resh_rounds)


@dataclasses.dataclass
class PlanArrays:
    """Per-worker runtime tables ``[n_workers, ...]`` int32, plus
    *replicated* per-block metadata (``blk_*``: [n_blocks+1, bs], shared
    by all workers — avoids the O(N·T·bs) copies of a per-step layout;
    the +1 row is the all-PAD trash block).

    Communication tables are *row*-indexed: a coalesced round's groups
    ship stacked payloads, and the row axis ``S`` concatenates every
    group's rows (a round's groups own static, disjoint row ranges).
    Rows a worker does not participate in point at trash slots."""
    send_slot: np.ndarray        # [N, R', S] local kv slot per payload row
    #                              (trash when the worker idles in it)
    recv_slot: np.ndarray        # [N, R', S] ext-buffer index per row
    step_q: np.ndarray           # [N, T]  q slot (q_trash = noop)
    step_kv: np.ndarray          # [N, T]  extended kv index (kv_trash=noop)
    step_kv_blk: np.ndarray      # [N, T]  block id consumed (mask lookup)
    # backward orderings of the same runs, sorted by kv slot so the fused
    # dk/dv kernel visits each extended-buffer row contiguously
    bwd_q: np.ndarray            # [N, T]  q slot, kv-sorted within runs
    bwd_kv: np.ndarray           # [N, T]  extended kv index, kv-sorted
    bwd_kv_blk: np.ndarray       # [N, T]  block id, kv-sorted
    sched_blk: np.ndarray        # [N, slots+1] block id per schedule slot
    blk_seg: np.ndarray          # [n_blocks+1, bs] REPLICATED
    blk_pos: np.ndarray          # [n_blocks+1, bs] REPLICATED
    resh_send_slot: np.ndarray   # [N, R2', S2] user slot to send per row
    resh_dst_slot: np.ndarray    # [N, R2', S2] schedule slot to write
    resh_local_src: np.ndarray   # [N, slots] user slot or -1
    restore_send_slot: np.ndarray  # [N, R2', S2] schedule slot of o to send
    restore_dst_slot: np.ndarray   # [N, R2', S2] user slot to write
    restore_local_src: np.ndarray  # [N, slots] schedule slot or -1


@dataclasses.dataclass
class Schedule:
    """Full host-side schedule + provenance for analysis/benchmarks."""
    batch: BlockedBatch
    assignment: np.ndarray                  # owner[block]
    deps: list[list[int]]
    spec: StaticSpec
    arrays: PlanArrays
    comm_edges: list[plannerlib.Edge]
    resh_edges: list[plannerlib.Edge]
    comm_matchings: list[list[plannerlib.Edge]]
    comm_windows: list[list[list[plannerlib.Edge]]]   # coalesced rounds
    comm_groupings: list[list[tuple]]   # per round: (perm, rows, edges)
    resh_groupings: list[list[tuple]]
    stream_owner: np.ndarray
    slot_of_block: np.ndarray               # [n_blocks] schedule slot
    pairs_per_worker: np.ndarray
    # bookkeeping, not part of the plan: device-table memo
    # (core/executor.schedule_tables) and whether this schedule already
    # passed static verification (analysis/verifier; lets PlanCache
    # insert-time verification skip straight to the key check)
    _device_tables: dict | None = dataclasses.field(
        default=None, repr=False, compare=False)
    _verified: bool = dataclasses.field(
        default=False, repr=False, compare=False)

    def signature(self) -> tuple:
        """Bucketing key: plans with equal signatures share a compilation."""
        return (self.spec,)


def _coalesced_rounds(matchings: list[list[plannerlib.Edge]], degree: int,
                      pad_cap: float = plannerlib.COALESCE_PAD_CAP
                      ) -> tuple[list[list[list[plannerlib.Edge]]],
                                 list[list[tuple]],
                                 tuple[CommRound, ...]]:
    """Window ``matchings`` into coalesced rounds of <= ``degree`` and
    partition each window's edges into ppermute groups (``pad_cap``
    bounds group padding — bytes-aware, see ``cost_model.wire_pad_cap``).

    Returns ``(windows, groupings, rounds)``: ``groupings[r]`` is the
    planner's per-round group list (with edge assignments, used to build
    the plan tables); ``rounds`` is the static executor view.
    """
    windows = plannerlib.coalesce_matchings(matchings, degree)
    groupings = [plannerlib.group_coalesced_round(win, pad_cap=pad_cap)
                 for win in windows]
    rounds = tuple(
        CommRound(groups=tuple(
            CommGroup(perm=perm, rows=rows)
            for perm, rows, _ in grouping))
        for grouping in groupings)
    return windows, groupings, rounds


def make_schedule(
        seqlens: Sequence[int],
        n_workers: int,
        tokens_per_worker: int,
        block_size: int,
        *,
        n_q_heads: int = 8,
        n_kv_heads: int = 8,
        head_dim: int = 128,
        mask=True,                              # MaskSpec | legacy causal
        coalesce: int = 1,                      # §4.2 bottom-up coalescer C
        assignment: np.ndarray | None = None,   # override (baseline policies)
        speeds: np.ndarray | None = None,
        locality: bool | str = "auto",
        alpha: float = 1.0,
        beta: float = 1.0,
        wire: WireFormat | str = WIRE_F32,      # ppermute wire format
        in_dtype_bytes: float = 4.0,            # compute-dtype itemsize
        overlap: bool = False,                  # double-buffered rounds
        verify: bool | None = None,             # static plan verification
) -> Schedule:
    mask = coerce_mask(mask)
    wire = coerce_wire(wire)
    # relative wire cost of a shipped value vs the UNENCODED payload
    # (``in_dtype_bytes`` = itemsize of the q/k/v compute dtype — 2
    # under bf16 training, where the bf16 wire saves nothing): weighs
    # every comm-vs-balance tradeoff below in real bytes
    comm_scale = cm.wire_comm_scale(wire, block_size, head_dim,
                                    in_bytes=in_dtype_bytes)
    if tokens_per_worker % block_size != 0:
        raise ValueError("tokens_per_worker must be a multiple of block_size")
    if locality == "auto":
        # locality refinement wins when the dependency horizon fits
        # within a worker (kills reshuffle+KV traffic) but concentrates
        # KV pulls into per-worker hotspots on heavy long-tailed batches
        # (measured: fig11 N=256 MFU 0.49 -> 0.36).  The horizon is the
        # longest document under causal/full masks, but the *mask* caps
        # it for windowed/chunked families: their deps are stream-local
        # (O(W) / O(C) neighbors) and their per-block costs near-uniform,
        # so stream placement prunes comm without hurting balance.
        horizon = max(seqlens, default=0)
        if mask.kind == "sliding_window":
            horizon = min(horizon, mask.window)
        elif mask.kind == "chunked":
            horizon = min(horizon, mask.chunk)
        # bytes-aware: what locality prunes is comm *bytes*, so a
        # cheaper wire shrinks its upside while the imbalance risk is
        # unchanged — the horizon must fit a proportionally smaller
        # budget before stream placement beats balance-first (f32
        # reproduces the legacy horizon <= tokens_per_worker rule)
        locality = horizon <= tokens_per_worker * comm_scale
    slots = tokens_per_worker // block_size
    n_tokens = n_workers * tokens_per_worker
    batch = blockslib.shard_stream(seqlens, block_size, n_tokens)
    deps = blockslib.kv_dependencies(batch, mask)
    n_blocks = batch.n_blocks
    assert n_blocks == n_workers * slots
    stream_owner = (np.arange(n_blocks) // slots).astype(np.int32)

    if assignment is None:
        costs = cm.block_q_flops(batch, deps, n_q_heads, head_dim, mask)
        mems = cm.block_memory(batch)
        res = dist.assign_blocks(
            costs, mems, n_workers, mem_limit=float(tokens_per_worker),
            alpha=alpha, beta=beta, delta=0.0, speeds=speeds,
            locality_hint=stream_owner if locality else None,
            comm_scale=comm_scale)
        assignment = res.owner
    assignment = np.asarray(assignment, dtype=np.int32)

    # schedule-layout slot of each block (stable by bid within a worker)
    slot_of = np.full(n_blocks, -1, dtype=np.int32)
    for w in range(n_workers):
        mine = np.where(assignment == w)[0]
        if len(mine) > slots:
            raise ValueError(
                f"worker {w} assigned {len(mine)} blocks > {slots} slots")
        for s, b in enumerate(sorted(mine)):
            slot_of[b] = s

    # ---- communication plan ------------------------------------------------
    coalesce = max(1, int(coalesce))
    # same geometry as comm_scale above: the coalescer and the locality
    # decision must price the wire identically
    pad_cap = cm.wire_pad_cap(wire, plannerlib.COALESCE_PAD_CAP,
                              in_bytes=in_dtype_bytes,
                              block_size=block_size, head_dim=head_dim)
    comm_edges = plannerlib.build_comm_edges(assignment, deps)
    matchings = plannerlib.decompose_matchings(comm_edges, n_workers)
    n_matchings = len(matchings)
    # bottom-up coalescer (§4.2): C consecutive matchings -> one round
    windows, comm_groupings, comm_rounds = _coalesced_rounds(
        matchings, coalesce, pad_cap)
    n_rounds = len(windows)
    # arrival (coalesced) round of each remote block at each worker, and
    # the per-round arrival lists the receive-buffer allocator colors
    arrival: dict[tuple[int, int], int] = {}
    arrivals_by_round: dict[tuple[int, int], list[int]] = defaultdict(list)
    for r, win in enumerate(windows):
        for m in win:
            for s, d, j in m:
                arrival[(d, int(j))] = r
                arrivals_by_round[(d, r)].append(int(j))

    # ---- per-worker pair scheduling ----------------------------------------
    # pairs[w] = list of (q_slot, kv_block, is_local)
    pairs: list[list[tuple[int, int, bool]]] = [[] for _ in range(n_workers)]
    for i, dep in enumerate(deps):
        w = int(assignment[i])
        for j in dep:
            pairs[w].append((int(slot_of[i]), int(j),
                             int(assignment[j]) == w))
    pairs_per_worker = np.array([len(p) for p in pairs], dtype=np.int64)

    # run-grouped placement: run r holds the steps executed between the
    # commits of rounds r-1 and r (one fused kernel launch per run).  A
    # pair consuming the arrival of round r goes to run r + 1 — earliest
    # legal, keeping receive-buffer live ranges short; local pairs fill
    # each worker's runs evenly so the shared (static) run widths stay
    # close to every worker's own pair count.
    n_runs = n_rounds + 1
    run_sched: list[list[list[tuple[int, int, bool]]]] = []
    for w in range(n_workers):
        runs: list[list[tuple[int, int, bool]]] = [[] for _ in range(n_runs)]
        for p in sorted((p for p in pairs[w] if not p[2]),
                        key=lambda p: arrival[(w, p[1])]):
            runs[arrival[(w, p[1])] + 1].append(p)
        run_sched.append(runs)
    # run widths are static and shared across workers (the step tables
    # pad every worker to the widest profile), so local pairs first fill
    # the slack under the current global widths — runs where another
    # worker's remote bursts already set the height — and only then grow
    # the globally-smallest run.  This keeps padding (trash steps, which
    # cost real compute) near zero instead of letting each worker
    # flatten its own profile obliviously.  Residual padding remains at
    # low C (many short runs pin remote pairs to their earliest run;
    # measured ~18% extra table width at C=1, ~0 at the default C=16) —
    # the price of minimal receive-buffer live ranges.
    lens = [max((len(run_sched[w][r]) for w in range(n_workers)), default=0)
            for r in range(n_runs)]
    for w in range(n_workers):
        runs = run_sched[w]
        for p in (p for p in pairs[w] if p[2]):
            slack = [(lens[r] - len(runs[r]), -r) for r in range(n_runs)]
            r = max(range(n_runs), key=lambda r_: slack[r_])
            if slack[r][0] <= 0:
                r = min(range(n_runs), key=lambda r_: (len(runs[r_]), r_))
            runs[r].append(p)
            lens[r] = max(lens[r], len(runs[r]))
    run_starts = tuple(int(x) for x in np.cumsum([0] + lens))
    n_steps = run_starts[-1]

    # ---- receive-buffer coloring -------------------------------------------
    last_use: dict[tuple[int, int], int] = {}
    for w, runs in enumerate(run_sched):
        for r, run in enumerate(runs):
            for qs, j, is_local in run:
                if not is_local:
                    last_use[(w, j)] = max(last_use.get((w, j), 0), r)
    alloc = plannerlib.allocate_recv_slots(
        dict(arrivals_by_round), last_use, n_rounds, n_workers,
        overlap=bool(overlap))
    ext = max(alloc.n_slots, 1 if n_rounds else 0)

    # ---- reshuffle plan ----------------------------------------------------
    resh_edges = plannerlib.build_reshuffle_edges(stream_owner, assignment)
    resh_matchings = plannerlib.decompose_matchings(resh_edges, n_workers)
    resh_windows, resh_groupings, resh_rounds = _coalesced_rounds(
        resh_matchings, coalesce, pad_cap)
    n_resh = len(resh_windows)

    spec = StaticSpec(
        n_workers=n_workers, block_size=block_size, slots=slots,
        ext_slots=ext, coalesce=coalesce, n_matchings=n_matchings,
        n_rounds=n_rounds, n_steps=n_steps, n_resh_rounds=n_resh,
        comm_rounds=comm_rounds, resh_rounds=resh_rounds, mask=mask,
        run_starts=run_starts, wire=wire, overlap=bool(overlap))

    arrays = _build_arrays(batch, spec, assignment, stream_owner, slot_of,
                           comm_groupings, resh_groupings, run_sched,
                           alloc)
    sched = Schedule(batch=batch, assignment=assignment, deps=deps,
                     spec=spec, arrays=arrays, comm_edges=comm_edges,
                     resh_edges=resh_edges, comm_matchings=matchings,
                     comm_windows=windows, comm_groupings=comm_groupings,
                     resh_groupings=resh_groupings,
                     stream_owner=stream_owner, slot_of_block=slot_of,
                     pairs_per_worker=pairs_per_worker)
    # static plan verification (analysis/verifier): ``verify=None``
    # follows the process default — on under tests/REPRO_VERIFY_PLANS,
    # off on hot paths (and plan-cache *hits* never come through here).
    # Imported lazily: the verifier depends on this module.
    from ..analysis import verifier as _verifier
    if _verifier.should_verify(verify):
        _verifier.check_schedule(
            sched, n_q_heads=n_q_heads, n_kv_heads=n_kv_heads,
            head_dim=head_dim, in_dtype_bytes=in_dtype_bytes)
        sched._verified = True
    return sched


def _block_meta(batch: BlockedBatch, bid: int
                ) -> tuple[np.ndarray, np.ndarray]:
    bs = batch.block_size
    lo = bid * bs
    return (batch.seg_ids[lo:lo + bs], batch.positions[lo:lo + bs])


def _build_arrays(batch: BlockedBatch, spec: StaticSpec,
                  assignment: np.ndarray, stream_owner: np.ndarray,
                  slot_of: np.ndarray,
                  comm_groupings: list[list[tuple]],
                  resh_groupings: list[list[tuple]],
                  run_sched: list[list[list[tuple[int, int, bool]]]],
                  alloc: plannerlib.SlotAllocation) -> PlanArrays:
    N, R, T = spec.n_workers, spec.n_rounds, spec.n_steps
    R2, bs, slots = spec.n_resh_rounds, spec.block_size, spec.slots
    kv_trash, q_trash = spec.kv_trash, spec.q_trash
    # payload-row axis: concatenation of each round's group rows, padded
    # to the widest round
    n_rows, n_rows2 = spec.comm_rows, spec.resh_rows

    send_slot = np.full((N, max(R, 1), n_rows), kv_trash, dtype=np.int32)
    recv_slot = np.full((N, max(R, 1), n_rows), kv_trash, dtype=np.int32)
    for r, grouping in enumerate(comm_groupings):
        off = 0
        for perm, rows, edges in grouping:
            for row, lane, s, d, j in edges:
                send_slot[s, r, off + row] = slot_of[j]
                recv_slot[d, r, off + row] = \
                    slots + alloc.slot_of_arrival[(d, j)]
            off += rows

    n_blocks = batch.n_blocks
    step_q = np.full((N, max(T, 1)), q_trash, dtype=np.int32)
    step_kv = np.full((N, max(T, 1)), kv_trash, dtype=np.int32)
    step_kv_blk = np.full((N, max(T, 1)), n_blocks, dtype=np.int32)
    bwd_q = np.full((N, max(T, 1)), q_trash, dtype=np.int32)
    bwd_kv = np.full((N, max(T, 1)), kv_trash, dtype=np.int32)
    bwd_kv_blk = np.full((N, max(T, 1)), n_blocks, dtype=np.int32)
    for w, runs in enumerate(run_sched):
        def ext_idx(j, is_local):
            return (int(slot_of[j]) if is_local
                    else slots + alloc.slot_of_arrival[(w, j)])
        for r, run in enumerate(runs):
            base = spec.run_starts[r]
            # forward order: q-slot-major so the fused kernel's online-
            # softmax accumulator stays resident across the q slot's
            # whole KV sweep; backward order: kv-block-major so dk/dv
            # visit each extended-buffer row contiguously (within one
            # run a receive slot holds exactly one block, so block id
            # and extended slot group identically).  Secondary/primary
            # keys are BLOCK ids, not slot indices: slot numbering
            # depends on the receive-buffer allocation (which the
            # overlap parity bit changes), and keying the merge order
            # on it would make serial and overlap plans accumulate the
            # same partials in different orders — bitwise-breaking the
            # overlap-transparency contract (docs/overlap.md).
            fwd = sorted(run, key=lambda p: (p[0], p[1]))
            bwd = sorted(run, key=lambda p: (p[1], p[0]))
            for i, (qs, j, is_local) in enumerate(fwd):
                step_q[w, base + i] = qs
                step_kv[w, base + i] = ext_idx(j, is_local)
                step_kv_blk[w, base + i] = j
            for i, (qs, j, is_local) in enumerate(bwd):
                bwd_q[w, base + i] = qs
                bwd_kv[w, base + i] = ext_idx(j, is_local)
                bwd_kv_blk[w, base + i] = j

    # replicated per-block mask metadata (+ trash row of PADs)
    blk_seg = np.concatenate(
        [batch.seg_ids.reshape(n_blocks, bs),
         np.full((1, bs), PAD_SEGMENT, np.int32)]).astype(np.int32)
    blk_pos = np.concatenate(
        [batch.positions.reshape(n_blocks, bs),
         np.zeros((1, bs), np.int32)]).astype(np.int32)
    sched_blk = np.full((N, slots + 1), n_blocks, dtype=np.int32)
    for b in range(n_blocks):
        sched_blk[int(assignment[b]), int(slot_of[b])] = b

    # trash defaults: sends gather the senders' trash rows (user layout
    # row `slots`, accumulator row q_trash), writes land on trash rows
    resh_send = np.full((N, max(R2, 1), n_rows2), slots, dtype=np.int32)
    resh_dst = np.full((N, max(R2, 1), n_rows2), q_trash, dtype=np.int32)
    rest_send = np.full((N, max(R2, 1), n_rows2), q_trash, dtype=np.int32)
    rest_dst = np.full((N, max(R2, 1), n_rows2), slots, dtype=np.int32)
    for r, grouping in enumerate(resh_groupings):
        off = 0
        for perm, rows, edges in grouping:
            for row, lane, u, w, b in edges:
                resh_send[u, r, off + row] = b % slots   # sender user slot
                resh_dst[w, r, off + row] = slot_of[b]   # receiver slot
                # restore: o moves back w -> u through the same group's
                # reversed permutation (still a partial permutation)
                rest_send[w, r, off + row] = slot_of[b]
                rest_dst[u, r, off + row] = b % slots
            off += rows

    resh_local = np.full((N, slots), -1, dtype=np.int32)
    rest_local = np.full((N, slots), -1, dtype=np.int32)
    for b in range(batch.n_blocks):
        u, w = int(stream_owner[b]), int(assignment[b])
        if u == w:
            resh_local[w, slot_of[b]] = b % slots
            rest_local[u, b % slots] = slot_of[b]

    return PlanArrays(
        send_slot=send_slot, recv_slot=recv_slot, step_q=step_q,
        step_kv=step_kv, step_kv_blk=step_kv_blk,
        bwd_q=bwd_q, bwd_kv=bwd_kv, bwd_kv_blk=bwd_kv_blk,
        sched_blk=sched_blk, blk_seg=blk_seg, blk_pos=blk_pos,
        resh_send_slot=resh_send, resh_dst_slot=resh_dst,
        resh_local_src=resh_local, restore_send_slot=rest_send,
        restore_dst_slot=rest_dst, restore_local_src=rest_local)
