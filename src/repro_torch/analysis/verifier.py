"""Static plan-integrity verifier (pure host-side, numpy only).

Every :class:`~repro.core.schedule.Schedule` the planner emits is a
claim: "executing these tables computes exactly the mask-visible
(q-block, kv-block) pairs, with every remote KV arriving before use and
every output restored to where the user put its queries".  Five PRs of
planner features (coalescing, run-grouped fused tables, mask pruning,
bucketed caching, wire formats) make that claim non-obvious, so this
module re-derives it from first principles: a host simulation of the
executor's data movement (reshuffle -> rounds/runs -> restore) over the
plan tables, checked against an independently recomputed dependency set.

Invariant catalogue (the names appear in :attr:`Violation.invariant` and
are what the mutation-kill suite asserts on):

* ``coverage`` -- every (q-block, kv-block) pair of
  ``blocks.kv_dependencies(batch, spec.mask)`` is computed exactly once
  across all workers; no pair outside that set is computed.
* ``arrival-before-use`` -- a remote KV consumed in run ``r`` was
  committed by round ``r-1`` or earlier into the extended-buffer slot
  the step table reads (the executor commits round ``r`` *after* run
  ``r``'s compute, so consumers sit in runs ``> r``).
* ``recv-slot-liveness`` -- no arrival commit overwrites a receive slot
  whose current occupant still has pending consumers.  Under the
  overlap pipeline (``StaticSpec.overlap``) the rule tightens by one
  run: round ``r``'s send is issued before run ``r``'s compute, so its
  commit may land while run ``r`` still reads the buffer — an occupant
  last used in run ``r`` counts as live (the buffer-parity allocation
  in ``planner.allocate_recv_slots`` exists to satisfy exactly this).
* ``round-validity`` -- each coalesced round is structurally valid:
  every group's pair set is a partial permutation, per-worker real
  sends/receives are bounded by the round's sub-matching window, the
  group count respects the identity fallback, each remote block is
  delivered at most once per worker and only where it has a consumer,
  and group padding stays under the bytes-aware wire pad cap.
* ``table-well-formedness`` -- forward runs are (q-slot, kv-block)
  sorted, backward runs are (kv-block, q-slot) sorted permutations of
  the same steps (block-keyed so the merge order is identical under
  serial and overlap slot allocations), trash conventions hold,
  ``sched_blk`` is a bijection consistent with the assignment, the
  reshuffle tables reach the schedule layout exactly and the restore
  tables return every output block to its user slot.
* ``byte-accounting`` -- ``cost_model.spec_wire_bytes`` equals the wire
  bytes the tables actually imply under ``spec.wire``: each group's
  static row height is the max real rows of its pairs (trash padding
  included, no over- or under-priced payloads).
* ``spec-key-consistency`` -- the ``plan_key`` under which a schedule
  was cached agrees with the schedule's ``StaticSpec`` knobs
  (``mask``, ``wire``, ``coalesce``, layout geometry).

Wiring (see README "Plan verification & lints"): ``make_schedule`` and
:class:`~repro.core.plan_cache.PlanCache` take ``verify=`` debug flags
(default off in hot paths, on under tests via ``tests/conftest.py`` or
``REPRO_VERIFY_PLANS=1``; cache *hits* never re-verify),
``runtime/elastic.py`` and ``launch/dryrun.py`` verify by default, and
``python -m repro.verify`` runs single plans or the randomized fuzz
harness as its own CI job.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..core import blocks as blockslib
from ..core import cost_model as cm
from ..core import planner as plannerlib
from ..core.schedule import Schedule

INVARIANTS: tuple[str, ...] = (
    "coverage",
    "arrival-before-use",
    "recv-slot-liveness",
    "round-validity",
    "table-well-formedness",
    "byte-accounting",
    "spec-key-consistency",
)

# simulated payload / buffer sentinels (never valid block ids)
_TRASH = -2        # sender gathered a trash row
_GARBAGE = -3      # buffer content of unknown provenance


@dataclasses.dataclass(frozen=True)
class Violation:
    """One invariant violation with (table, worker, round, row)
    provenance; ``round`` doubles as the run index for step tables."""
    invariant: str
    message: str
    table: str | None = None
    worker: int | None = None
    round: int | None = None
    row: int | None = None

    def __str__(self) -> str:
        where = ", ".join(
            f"{k}={v}" for k, v in (("table", self.table),
                                    ("worker", self.worker),
                                    ("round", self.round),
                                    ("row", self.row))
            if v is not None)
        loc = f" ({where})" if where else ""
        return f"[{self.invariant}] {self.message}{loc}"


class PlanVerificationError(AssertionError):
    """A schedule failed static verification."""

    def __init__(self, violations: list[Violation], limit: int = 25):
        self.violations = violations
        shown = [str(x) for x in violations[:limit]]
        if len(violations) > limit:
            shown.append(f"... and {len(violations) - limit} more")
        super().__init__(
            f"{len(violations)} plan-invariant violation(s):\n  "
            + "\n  ".join(shown))


# --------------------------------------------------------------------------
# default-verify switch (tests / env opt-in; hot paths stay free)
# --------------------------------------------------------------------------

_default_verify = os.environ.get("REPRO_VERIFY_PLANS", "") not in (
    "", "0", "false", "no")


def set_default_verify(on: bool) -> bool:
    """Set the process-wide default for ``verify=None`` call sites
    (``make_schedule`` / ``PlanCache``).  Returns the previous value."""
    global _default_verify
    prev = _default_verify
    _default_verify = bool(on)
    return prev


def default_verify() -> bool:
    return _default_verify


def should_verify(flag: bool | None) -> bool:
    """Resolve a tri-state ``verify`` argument (None -> process
    default, set by tests/env; hot paths pass nothing and pay nothing
    unless opted in)."""
    return _default_verify if flag is None else bool(flag)


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

def verify_schedule(sched: Schedule, *, n_q_heads: int = 8,
                    n_kv_heads: int = 8, head_dim: int = 128,
                    in_dtype_bytes: float = 4.0,
                    key: tuple | None = None) -> list[Violation]:
    """Run the full invariant catalogue; returns all violations found
    (empty list == the plan is well-formed).

    The head geometry and compute itemsize must match what the plan was
    built with — they price the byte-accounting and pad-cap checks.
    ``key`` (optional) additionally runs the spec/plan-key consistency
    check against the cache key the schedule was stored under.
    """
    v: list[Violation] = []
    if _check_shapes(sched, v):
        _check_layout(sched, v)
        _check_steps(sched, v)
        _simulate_rounds(sched, v)
        _check_round_validity(sched, v, head_dim, in_dtype_bytes)
        _check_reshuffle(sched, v)
        _check_restore(sched, v)
        _check_bytes(sched, v, n_q_heads, n_kv_heads, head_dim,
                     in_dtype_bytes)
    if key is not None:
        verify_plan_key(key, sched, v)
    return v


def check_schedule(sched: Schedule, *, n_q_heads: int = 8,
                   n_kv_heads: int = 8, head_dim: int = 128,
                   in_dtype_bytes: float = 4.0,
                   key: tuple | None = None) -> Schedule:
    """:func:`verify_schedule` that raises :class:`PlanVerificationError`
    on any violation; returns the schedule for call-through chaining."""
    violations = verify_schedule(
        sched, n_q_heads=n_q_heads, n_kv_heads=n_kv_heads,
        head_dim=head_dim, in_dtype_bytes=in_dtype_bytes, key=key)
    if violations:
        raise PlanVerificationError(violations)
    return sched


# plan_key positional layout (core/plan_cache.plan_key); the reflection
# lint in analysis/lints.py keeps this aligned with the key builder
_KEY_SEQLENS, _KEY_WORKERS, _KEY_TPW, _KEY_BLOCK = 0, 1, 2, 3
_KEY_MASK, _KEY_WIRE, _KEY_COALESCE = 4, 5, 6
_KEY_OVERLAP = 12
_KEY_LEN = 13


def plan_key_shaped(key: object) -> bool:
    """Whether ``key`` has the :func:`repro.core.plan_cache.plan_key`
    tuple layout (callers may cache under foreign keys; those skip the
    spec/key consistency check)."""
    return (isinstance(key, tuple) and len(key) == _KEY_LEN
            and isinstance(key[_KEY_SEQLENS], tuple)
            and isinstance(key[_KEY_MASK], tuple)
            and isinstance(key[_KEY_WIRE], tuple))


def verify_plan_key(key: tuple, sched: Schedule,
                    out: list[Violation] | None = None) -> list[Violation]:
    """``spec-key-consistency``: the cache key a schedule is stored
    under must agree with the spec that will be reused on a hit."""
    v: list[Violation] = [] if out is None else out
    if not plan_key_shaped(key):
        return v
    spec = sched.spec

    def bad(what: str, want: object, got: object) -> None:
        v.append(Violation(
            "spec-key-consistency",
            f"plan_key {what} is {got!r} but the cached spec says "
            f"{want!r}", table="plan_key"))

    if key[_KEY_WORKERS] != spec.n_workers:
        bad("n_workers", spec.n_workers, key[_KEY_WORKERS])
    if key[_KEY_BLOCK] != spec.block_size:
        bad("block_size", spec.block_size, key[_KEY_BLOCK])
    if key[_KEY_TPW] != spec.slots * spec.block_size:
        bad("tokens_per_worker", spec.slots * spec.block_size,
            key[_KEY_TPW])
    if key[_KEY_MASK] != spec.mask.key():
        bad("mask", spec.mask.key(), key[_KEY_MASK])
    wire_key = spec.wire.key()
    if tuple(key[_KEY_WIRE][:len(wire_key)]) != wire_key:
        bad("wire", wire_key, key[_KEY_WIRE])
    if key[_KEY_COALESCE] != spec.coalesce:
        bad("coalesce", spec.coalesce, key[_KEY_COALESCE])
    if bool(key[_KEY_OVERLAP]) != spec.overlap:
        bad("overlap", spec.overlap, key[_KEY_OVERLAP])
    batch_lens = tuple(int(x) for x in sched.batch.seqlens)
    if tuple(key[_KEY_SEQLENS]) != batch_lens:
        bad("seqlens", batch_lens, tuple(key[_KEY_SEQLENS]))
    return v


# --------------------------------------------------------------------------
# structural checks
# --------------------------------------------------------------------------

def _check_shapes(sched: Schedule, v: list[Violation]) -> bool:
    """Spec-internal consistency + table shapes.  Returns False when the
    tables cannot be indexed safely (remaining checks are skipped)."""
    spec, a = sched.spec, sched.arrays
    N, slots = spec.n_workers, spec.slots
    T = max(spec.n_steps, 1)
    R = max(spec.n_rounds, 1)
    R2 = max(spec.n_resh_rounds, 1)

    def wf(msg: str, table: str | None = None) -> None:
        v.append(Violation("table-well-formedness", msg, table=table))

    if spec.n_runs != spec.n_rounds + 1:
        wf(f"n_runs {spec.n_runs} != n_rounds {spec.n_rounds} + 1",
           "run_starts")
    rs = spec.run_starts
    runs_ok = (rs[0] == 0 and rs[-1] == spec.n_steps
               and all(a_ <= b for a_, b in zip(rs, rs[1:])))
    if not runs_ok:
        wf(f"run_starts {rs} is not a monotone cover of "
           f"[0, {spec.n_steps}]", "run_starts")
    if len(spec.comm_rounds) != spec.n_rounds:
        wf(f"{len(spec.comm_rounds)} comm_rounds != n_rounds "
           f"{spec.n_rounds}", "comm_rounds")
    if len(spec.resh_rounds) != spec.n_resh_rounds:
        wf(f"{len(spec.resh_rounds)} resh_rounds != n_resh_rounds "
           f"{spec.n_resh_rounds}", "resh_rounds")
    want_rounds = (0 if spec.n_matchings == 0
                   else -(-spec.n_matchings // max(spec.coalesce, 1)))
    if spec.n_rounds != want_rounds:
        v.append(Violation(
            "round-validity",
            f"n_rounds {spec.n_rounds} != ceil(n_matchings "
            f"{spec.n_matchings} / coalesce {spec.coalesce})"))
    if sched.batch.n_blocks != N * slots:
        wf(f"{sched.batch.n_blocks} blocks != n_workers {N} x slots "
           f"{slots}")
    if sched.batch.block_size != spec.block_size:
        wf(f"batch block_size {sched.batch.block_size} != spec "
           f"{spec.block_size}")

    nb = sched.batch.n_blocks
    bs = spec.block_size
    want_shapes = {
        "send_slot": (N, R, spec.comm_rows),
        "recv_slot": (N, R, spec.comm_rows),
        "step_q": (N, T), "step_kv": (N, T), "step_kv_blk": (N, T),
        "bwd_q": (N, T), "bwd_kv": (N, T), "bwd_kv_blk": (N, T),
        "sched_blk": (N, slots + 1),
        "blk_seg": (nb + 1, bs), "blk_pos": (nb + 1, bs),
        "resh_send_slot": (N, R2, spec.resh_rows),
        "resh_dst_slot": (N, R2, spec.resh_rows),
        "resh_local_src": (N, slots),
        "restore_send_slot": (N, R2, spec.resh_rows),
        "restore_dst_slot": (N, R2, spec.resh_rows),
        "restore_local_src": (N, slots),
    }
    shapes_ok = True
    for name, want in want_shapes.items():
        got = tuple(getattr(a, name).shape)
        if got != want:
            wf(f"shape {got} != expected {want}", name)
            shapes_ok = False
    return shapes_ok and runs_ok


def _check_layout(sched: Schedule, v: list[Violation]) -> None:
    """``sched_blk`` must be a bijection blocks <-> (worker, slot) that
    matches the assignment/slot provenance the planner recorded."""
    spec, a = sched.spec, sched.arrays
    nb = sched.batch.n_blocks
    placed = np.full(nb, -1, dtype=np.int64)
    for w in range(spec.n_workers):
        for s in range(spec.slots):
            b = int(a.sched_blk[w, s])
            if b == nb:
                continue
            if not 0 <= b < nb:
                v.append(Violation(
                    "table-well-formedness",
                    f"slot holds invalid block id {b}",
                    table="sched_blk", worker=w, row=s))
                continue
            if placed[b] >= 0:
                v.append(Violation(
                    "table-well-formedness",
                    f"block {b} placed twice in the schedule layout",
                    table="sched_blk", worker=w, row=s))
            placed[b] = w
            if int(sched.assignment[b]) != w:
                v.append(Violation(
                    "table-well-formedness",
                    f"block {b} in worker {w}'s layout but assigned to "
                    f"worker {int(sched.assignment[b])}",
                    table="sched_blk", worker=w, row=s))
        if int(a.sched_blk[w, spec.slots]) != nb:
            v.append(Violation(
                "table-well-formedness",
                "trash column must hold the trash block id",
                table="sched_blk", worker=w, row=spec.slots))
    for b in range(nb):
        if placed[b] < 0:
            v.append(Violation(
                "table-well-formedness",
                f"block {b} missing from the schedule layout",
                table="sched_blk"))


def _check_steps(sched: Schedule, v: list[Violation]) -> None:
    """Step-table conventions: fwd runs (q-slot, kv-block) sorted, bwd
    runs (kv-block, q-slot) sorted, bwd a permutation of fwd per run,
    trash steps whole."""
    spec, a = sched.spec, sched.arrays
    q_trash, kv_trash = spec.q_trash, spec.kv_trash
    nb = sched.batch.n_blocks
    for w in range(spec.n_workers):
        for r in range(spec.n_runs):
            lo, hi = spec.run_starts[r], spec.run_starts[r + 1]
            fwd = [(int(a.step_q[w, t]), int(a.step_kv[w, t]),
                    int(a.step_kv_blk[w, t])) for t in range(lo, hi)]
            bwd = [(int(a.bwd_q[w, t]), int(a.bwd_kv[w, t]),
                    int(a.bwd_kv_blk[w, t])) for t in range(lo, hi)]
            for i, (qs, kv, blk) in enumerate(fwd):
                trash = (qs == q_trash, kv == kv_trash, blk == nb)
                if any(trash) and not all(trash):
                    v.append(Violation(
                        "table-well-formedness",
                        f"half-trash step (q={qs}, kv={kv}, blk={blk})",
                        table="step_q", worker=w, round=r, row=lo + i))
            # canonical orders key on BLOCK ids, not buffer slot
            # indices: slot numbering depends on the receive-slot
            # allocation (serial vs overlap parity), and a
            # slot-keyed merge order would make the two modes
            # accumulate partials differently — breaking the bitwise
            # overlap-transparency contract (docs/overlap.md)
            if any((fwd[i][0], fwd[i][2]) > (fwd[i + 1][0], fwd[i + 1][2])
                   for i in range(len(fwd) - 1)):
                v.append(Violation(
                    "table-well-formedness",
                    "forward run is not (q-slot, kv-block) sorted",
                    table="step_q", worker=w, round=r))
            if any((bwd[i][2], bwd[i][0]) > (bwd[i + 1][2], bwd[i + 1][0])
                   for i in range(len(bwd) - 1)):
                v.append(Violation(
                    "table-well-formedness",
                    "backward run is not (kv-block, q-slot) sorted",
                    table="bwd_kv", worker=w, round=r))
            if sorted(fwd) != sorted(bwd):
                v.append(Violation(
                    "table-well-formedness",
                    "backward run is not a permutation of the forward "
                    "run", table="bwd_q", worker=w, round=r))


# --------------------------------------------------------------------------
# the core simulation: rounds, runs, arrivals, coverage
# --------------------------------------------------------------------------

def _round_row_ranges(rnd) -> list[tuple[int, int, object]]:
    """[(row_lo, row_hi, group), ...] — groups own disjoint static row
    ranges, concatenated in group order."""
    out = []
    off = 0
    for g in rnd.groups:
        out.append((off, off + g.rows, g))
        off += g.rows
    return out


def _simulate_rounds(sched: Schedule, v: list[Violation]) -> None:
    """Walk the executor's round/run interleave on the host.

    Order per round ``r`` (mirrors ``core/executor._fcp_local``): the
    ppermute of round ``r`` is issued (payloads gathered from the static
    schedule-layout KV), run ``r`` computes, then round ``r``'s arrivals
    commit into the extended buffer.  So run ``r`` sees exactly the
    commits of rounds ``< r``, and an occupant whose last consumer is in
    run ``r`` is dead by the time round ``r`` commits over it.
    """
    spec, a = sched.spec, sched.arrays
    N, slots, ext = spec.n_workers, spec.slots, spec.ext_slots
    q_trash, kv_trash = spec.q_trash, spec.kv_trash
    nb = sched.batch.n_blocks

    deps = blockslib.kv_dependencies(sched.batch, spec.mask)
    expected = {(i, j) for i, dep in enumerate(deps) for j in dep}

    # last run consuming each remote arrival (w, blk) — liveness bound
    last_use: dict[tuple[int, int], int] = {}
    # and whether (w, blk) is consumed remotely at all — arrival demand
    for w in range(N):
        for r in range(spec.n_runs):
            for t in range(spec.run_starts[r], spec.run_starts[r + 1]):
                kv = int(a.step_kv[w, t])
                if slots <= kv < kv_trash:
                    last_use[(w, int(a.step_kv_blk[w, t]))] = r

    buffers = [[_GARBAGE] * ext for _ in range(N)]
    committed: list[dict[int, int]] = [dict() for _ in range(N)]
    seen: dict[tuple[int, int], int] = {}

    for rr in range(spec.n_runs):
        # ---- compute run rr against the current buffer state ----
        for w in range(N):
            for t in range(spec.run_starts[rr], spec.run_starts[rr + 1]):
                qs = int(a.step_q[w, t])
                kv = int(a.step_kv[w, t])
                blk = int(a.step_kv_blk[w, t])
                if qs == q_trash:
                    continue
                if not 0 <= qs < slots or not 0 <= blk < nb:
                    v.append(Violation(
                        "table-well-formedness",
                        f"step reads q slot {qs} / block {blk} out of "
                        f"range", table="step_q", worker=w, round=rr,
                        row=t))
                    continue
                qblk = int(a.sched_blk[w, qs])
                if qblk == nb:
                    v.append(Violation(
                        "table-well-formedness",
                        f"real step reads empty q slot {qs}",
                        table="step_q", worker=w, round=rr, row=t))
                    continue
                if kv < slots:                       # local KV
                    have = int(a.sched_blk[w, kv])
                    if have != blk:
                        v.append(Violation(
                            "table-well-formedness",
                            f"local step expects block {blk} but slot "
                            f"{kv} holds {have}", table="step_kv",
                            worker=w, round=rr, row=t))
                elif kv < kv_trash:                  # remote KV
                    have = buffers[w][kv - slots]
                    if have != blk:
                        inv = ("recv-slot-liveness"
                               if committed[w].get(blk) == kv - slots
                               else "arrival-before-use")
                        msg = ("was overwritten before its last use"
                               if inv == "recv-slot-liveness" else
                               "has not been committed to that slot by "
                               f"round {rr - 1}")
                        v.append(Violation(
                            inv,
                            f"run {rr} consumes block {blk} from recv "
                            f"slot {kv - slots}, which {msg}",
                            table="step_kv", worker=w, round=rr, row=t))
                else:
                    v.append(Violation(
                        "table-well-formedness",
                        f"real step reads trash kv index {kv}",
                        table="step_kv", worker=w, round=rr, row=t))
                pair = (qblk, blk)
                if pair in seen:
                    v.append(Violation(
                        "coverage",
                        f"pair (q-block {qblk}, kv-block {blk}) computed "
                        f"more than once (first on worker {seen[pair]})",
                        table="step_q", worker=w, round=rr, row=t))
                elif pair not in expected:
                    v.append(Violation(
                        "coverage",
                        f"pair (q-block {qblk}, kv-block {blk}) is not "
                        f"mask-visible under {spec.mask}",
                        table="step_q", worker=w, round=rr, row=t))
                seen.setdefault(pair, w)

        # ---- commit round rr's arrivals ----
        if rr >= spec.n_rounds:
            continue
        for lo, hi, g in _round_row_ranges(spec.comm_rounds[rr]):
            if hi > a.send_slot.shape[2]:
                continue                   # priced by _check_bytes
            for (s, d) in g.perm:
                for row in range(lo, hi):
                    ss = int(a.send_slot[s, rr, row])
                    dd = int(a.recv_slot[d, rr, row])
                    if ss == kv_trash:
                        blk = _TRASH
                    elif 0 <= ss < slots:
                        blk = int(a.sched_blk[s, ss])
                        if blk == nb:
                            blk = _TRASH
                    else:
                        v.append(Violation(
                            "table-well-formedness",
                            f"send gathers invalid slot {ss}",
                            table="send_slot", worker=s, round=rr,
                            row=row))
                        blk = _GARBAGE
                    if dd == kv_trash:
                        if blk >= 0:
                            v.append(Violation(
                                "arrival-before-use",
                                f"block {blk} shipped by worker {s} is "
                                f"dropped (receive row points at "
                                f"trash)", table="recv_slot", worker=d,
                                round=rr, row=row))
                        continue
                    if not slots <= dd < kv_trash:
                        v.append(Violation(
                            "table-well-formedness",
                            f"receive row writes invalid slot {dd}",
                            table="recv_slot", worker=d, round=rr,
                            row=row))
                        continue
                    e = dd - slots
                    occ = buffers[d][e]
                    # serial loop: run rr finishes before round rr
                    # commits, so an occupant last used in run rr is
                    # dead.  overlap (double-buffered) loop: round rr's
                    # send was issued BEFORE run rr's compute, so its
                    # commit may land while run rr still reads the
                    # buffer — an occupant last used in run rr is live.
                    bound = rr - 1 if spec.overlap else rr
                    if occ >= 0 and last_use.get((d, occ), -1) > bound:
                        v.append(Violation(
                            "recv-slot-liveness",
                            f"commit of round {rr} overwrites recv slot "
                            f"{e} while block {occ} (last used in run "
                            f"{last_use[(d, occ)]}) is still live"
                            + (" under the overlap pipeline"
                               if spec.overlap else ""),
                            table="recv_slot", worker=d, round=rr,
                            row=row))
                    if blk >= 0:
                        if blk in committed[d]:
                            v.append(Violation(
                                "round-validity",
                                f"block {blk} delivered to worker {d} "
                                f"more than once", table="recv_slot",
                                worker=d, round=rr, row=row))
                        elif (d, blk) not in last_use:
                            v.append(Violation(
                                "round-validity",
                                f"block {blk} delivered to worker {d} "
                                f"but never consumed there",
                                table="recv_slot", worker=d, round=rr,
                                row=row))
                        committed[d][blk] = e
                    buffers[d][e] = blk

    for (i, j) in sorted(expected - set(seen)):
        v.append(Violation(
            "coverage",
            f"pair (q-block {i}, kv-block {j}) is mask-visible but "
            f"never computed", table="step_q"))


def _check_round_validity(sched: Schedule, v: list[Violation],
                          head_dim: int, in_dtype_bytes: float) -> None:
    """Partial permutations, bounded per-worker traffic, identity
    fallback, pad cap — per coalesced round."""
    spec, a = sched.spec, sched.arrays
    kv_trash = spec.kv_trash
    pad_cap = cm.wire_pad_cap(
        spec.wire, plannerlib.COALESCE_PAD_CAP,
        in_bytes=in_dtype_bytes, block_size=spec.block_size,
        head_dim=head_dim)
    for r, rnd in enumerate(spec.comm_rounds):
        # sub-matching window of this round (identity-fallback bound)
        wlen = spec.coalesce
        if r == spec.n_rounds - 1 and spec.n_matchings:
            wlen = spec.n_matchings - spec.coalesce * (spec.n_rounds - 1)
        if len(rnd.groups) > max(wlen, 1):
            v.append(Violation(
                "round-validity",
                f"{len(rnd.groups)} groups exceed the round's "
                f"{wlen}-matching window (identity fallback bound)",
                round=r))
        sends = np.zeros(spec.n_workers, dtype=np.int64)
        recvs = np.zeros(spec.n_workers, dtype=np.int64)
        for lo, hi, g in _round_row_ranges(rnd):
            srcs = [s for s, _ in g.perm]
            dsts = [d for _, d in g.perm]
            if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
                v.append(Violation(
                    "round-validity",
                    f"group perm {g.perm} is not a partial permutation",
                    round=r))
                continue
            if hi > a.send_slot.shape[2]:
                continue                   # priced by _check_bytes
            real = 0
            for (s, d) in g.perm:
                m = sum(int(a.send_slot[s, r, row]) != kv_trash
                        for row in range(lo, hi))
                sends[s] += m
                recvs[d] += m
                real += m
            if real and g.rows * len(g.perm) > pad_cap * real + 1e-9:
                v.append(Violation(
                    "round-validity",
                    f"group ships {g.rows * len(g.perm)} rows for "
                    f"{real} real blocks, exceeding the pad cap "
                    f"{pad_cap:.3g}", round=r))
        wlen = max(wlen, 1)
        for w in range(spec.n_workers):
            if sends[w] > wlen or recvs[w] > wlen:
                v.append(Violation(
                    "round-validity",
                    f"worker moves {int(sends[w])} sends / "
                    f"{int(recvs[w])} recvs in a {wlen}-matching round",
                    worker=w, round=r))


# --------------------------------------------------------------------------
# reshuffle / restore completeness
# --------------------------------------------------------------------------

def _check_reshuffle(sched: Schedule, v: list[Violation]) -> None:
    """Replaying the reshuffle tables from the user (stream) layout must
    land every block at its schedule slot, exactly once."""
    spec, a = sched.spec, sched.arrays
    N, slots = spec.n_workers, spec.slots
    nb = sched.batch.n_blocks
    sim = np.full((N, slots), _GARBAGE, dtype=np.int64)
    for w in range(N):
        for s in range(slots):
            src = int(a.resh_local_src[w, s])
            if src >= 0:
                sim[w, s] = w * slots + src
    for r, rnd in enumerate(spec.resh_rounds):
        for lo, hi, g in _round_row_ranges(rnd):
            if hi > a.resh_send_slot.shape[2]:
                continue
            for (u, w) in g.perm:
                for row in range(lo, hi):
                    ss = int(a.resh_send_slot[u, r, row])
                    dd = int(a.resh_dst_slot[w, r, row])
                    blk = u * slots + ss if 0 <= ss < slots else _TRASH
                    if dd >= slots:
                        if blk >= 0:
                            v.append(Violation(
                                "table-well-formedness",
                                f"reshuffled block {blk} is dropped",
                                table="resh_dst_slot", worker=w,
                                round=r, row=row))
                        continue
                    if blk < 0:
                        v.append(Violation(
                            "table-well-formedness",
                            "trash written into a live schedule slot",
                            table="resh_dst_slot", worker=w, round=r,
                            row=row))
                        sim[w, dd] = _GARBAGE
                        continue
                    if sim[w, dd] != _GARBAGE:
                        v.append(Violation(
                            "table-well-formedness",
                            f"schedule slot {dd} written twice by the "
                            f"reshuffle", table="resh_dst_slot",
                            worker=w, round=r, row=row))
                    sim[w, dd] = blk
    for w in range(N):
        for s in range(slots):
            want = int(a.sched_blk[w, s])
            if want == nb:
                continue
            if int(sim[w, s]) != want:
                v.append(Violation(
                    "table-well-formedness",
                    f"reshuffle leaves {int(sim[w, s])} in a slot that "
                    f"must hold block {want}", table="resh_dst_slot",
                    worker=w, row=s))


def _check_restore(sched: Schedule, v: list[Violation]) -> None:
    """Replaying the restore tables (reversed group permutations) from
    the schedule layout must return every output block to its user
    slot — restore completeness back to the original layout."""
    spec, a = sched.spec, sched.arrays
    N, slots = spec.n_workers, spec.slots
    nb = sched.batch.n_blocks
    sim = np.full((N, slots), _GARBAGE, dtype=np.int64)
    for u in range(N):
        for s in range(slots):
            src = int(a.restore_local_src[u, s])
            if src >= 0:
                blk = int(a.sched_blk[u, src]) if src < slots else nb
                sim[u, s] = blk if blk != nb else _TRASH
    for r, rnd in enumerate(spec.resh_rounds):
        for lo, hi, g in _round_row_ranges(rnd):
            if hi > a.restore_send_slot.shape[2]:
                continue
            # o ships back through the group's REVERSED permutation
            for (u, w) in g.perm:
                for row in range(lo, hi):
                    ss = int(a.restore_send_slot[w, r, row])
                    dd = int(a.restore_dst_slot[u, r, row])
                    if 0 <= ss < slots:
                        blk = int(a.sched_blk[w, ss])
                        if blk == nb:
                            blk = _TRASH
                    else:
                        blk = _TRASH
                    if dd >= slots:
                        if blk >= 0:
                            v.append(Violation(
                                "table-well-formedness",
                                f"restored block {blk} is dropped",
                                table="restore_dst_slot", worker=u,
                                round=r, row=row))
                        continue
                    if blk < 0:
                        v.append(Violation(
                            "table-well-formedness",
                            "trash restored into a live user slot",
                            table="restore_dst_slot", worker=u,
                            round=r, row=row))
                        sim[u, dd] = _GARBAGE
                        continue
                    if sim[u, dd] != _GARBAGE:
                        v.append(Violation(
                            "table-well-formedness",
                            f"user slot {dd} written twice by the "
                            f"restore", table="restore_dst_slot",
                            worker=u, round=r, row=row))
                    sim[u, dd] = blk
    for u in range(N):
        for s in range(slots):
            if int(sim[u, s]) != u * slots + s:
                v.append(Violation(
                    "table-well-formedness",
                    f"restore leaves {int(sim[u, s])} in user slot that "
                    f"must hold block {u * slots + s}",
                    table="restore_dst_slot", worker=u, row=s))


# --------------------------------------------------------------------------
# byte accounting
# --------------------------------------------------------------------------

def _table_rows(send: np.ndarray, trash: int, r: int, lo: int, hi: int,
                perm, v: list[Violation], invariant: str, table: str,
                rnd_idx: int, gi: int) -> int:
    """Max real payload rows over a group's pairs, per the send table —
    the row height the group *needs*; flags all-trash pairs."""
    need = 0
    for (s, _d) in perm:
        m = sum(int(send[s, r, row]) != trash for row in range(lo, hi))
        if m == 0:
            v.append(Violation(
                invariant,
                f"pair {s}->{_d} of group {gi} ships only trash rows",
                table=table, worker=s, round=rnd_idx))
        need = max(need, m)
    return need


def _check_bytes(sched: Schedule, v: list[Violation], n_q_heads: int,
                 n_kv_heads: int, head_dim: int,
                 in_dtype_bytes: float) -> None:
    """``spec_wire_bytes`` must equal the bytes the tables imply: each
    group's priced row height is the max real rows among its pairs."""
    spec, a = sched.spec, sched.arrays
    bs = spec.block_size
    implied = {"reshuffle": 0.0, "rounds": 0.0, "restore": 0.0}

    for r, rnd in enumerate(spec.comm_rounds):
        for gi, (lo, hi, g) in enumerate(_round_row_ranges(rnd)):
            if hi > a.send_slot.shape[2]:
                v.append(Violation(
                    "byte-accounting",
                    f"round prices {rnd.n_rows} payload rows but the "
                    f"tables hold {a.send_slot.shape[2]}",
                    table="send_slot", round=r))
                break
            need = _table_rows(a.send_slot, spec.kv_trash, r, lo, hi,
                               g.perm, v, "byte-accounting",
                               "send_slot", r, gi)
            if need != g.rows:
                v.append(Violation(
                    "byte-accounting",
                    f"group {gi} prices {g.rows} rows per pair but the "
                    f"send table implies {need}", table="send_slot",
                    round=r))
            implied["rounds"] += (
                len(g.perm) * need
                * cm.kv_wire_block_bytes(spec.wire, bs, n_kv_heads,
                                         head_dim, in_dtype_bytes))

    for r, rnd in enumerate(spec.resh_rounds):
        for gi, (lo, hi, g) in enumerate(_round_row_ranges(rnd)):
            if hi > a.resh_send_slot.shape[2]:
                v.append(Violation(
                    "byte-accounting",
                    f"reshuffle round prices {rnd.n_rows} rows but the "
                    f"tables hold {a.resh_send_slot.shape[2]}",
                    table="resh_send_slot", round=r))
                break
            need = _table_rows(a.resh_send_slot, spec.slots, r, lo, hi,
                               g.perm, v, "byte-accounting",
                               "resh_send_slot", r, gi)
            if need != g.rows:
                v.append(Violation(
                    "byte-accounting",
                    f"reshuffle group {gi} prices {g.rows} rows but the "
                    f"tables imply {need}", table="resh_send_slot",
                    round=r))
            # restore reuses the group structure with reversed perms:
            # its real row count must match the reshuffle's
            rperm = tuple((w, u) for u, w in g.perm)
            rneed = _table_rows(a.restore_send_slot, spec.q_trash, r,
                                lo, hi, rperm, v, "byte-accounting",
                                "restore_send_slot", r, gi)
            if rneed != need:
                v.append(Violation(
                    "byte-accounting",
                    f"restore ships {rneed} real rows where the "
                    f"reshuffle shipped {need}",
                    table="restore_send_slot", round=r))
            implied["reshuffle"] += (
                len(g.perm) * need
                * cm.qkv_wire_block_bytes(spec.wire, bs, n_q_heads,
                                          n_kv_heads, head_dim,
                                          in_dtype_bytes))
            implied["restore"] += (
                len(g.perm) * need
                * cm.o_wire_block_bytes(spec.wire, bs, n_q_heads,
                                        head_dim, in_dtype_bytes))

    priced = cm.spec_wire_bytes(spec, n_q_heads, n_kv_heads, head_dim,
                                in_bytes=in_dtype_bytes)
    for phase in ("reshuffle", "rounds", "restore"):
        if abs(priced[phase] - implied[phase]) > 0.5:
            v.append(Violation(
                "byte-accounting",
                f"spec_wire_bytes[{phase!r}] = {priced[phase]:.0f} but "
                f"the tables imply {implied[phase]:.0f} bytes"))
