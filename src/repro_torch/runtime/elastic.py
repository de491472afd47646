"""Elastic scaling: re-plan FCP schedules and re-mesh when the healthy
worker count changes.

Model/optimizer state is worker-count independent (weights shard by
NamedSharding over whatever mesh exists), so elasticity reduces to:

1. rebuild the mesh over the surviving chips,
2. re-run the block distributor + communication planner for the new CP
   size (LPT is input-size agnostic),
3. rebuild the loader's frame geometry (frames = CP size) and continue
   from the last committed checkpoint.

``replan`` performs (2); models that interleave mask families carry one
schedule per distinct :class:`~repro.masks.MaskSpec`, and
``replan_groups`` rebuilds *all* of them for the new worker count so an
elastic event never silently collapses the per-layer-group scheduling to
one mask.  The elastic restart example/test drives the full (1)-(3)
loop, shrinking 4 -> 2 workers mid-run and growing back.

The fault-tolerance loop lives here too (it is the other half of the
same story — elasticity is what you do *after* surviving the fault):

* ``resumable_train``: wraps a step function with periodic async
  checkpoints and auto-resume from the newest committed checkpoint; an
  injected/real failure mid-run (or mid-save — only COMMIT-marked
  checkpoints are trusted) resumes bit-exactly.
* ``StragglerTracker``: per-worker step-time EWMA -> relative speed
  estimates.  Speeds feed Algorithm 1 (``distributor.assign_blocks``'s
  ``speeds``) via ``replan(..., speeds=...)``, so a chronically slow
  worker is assigned proportionally fewer blocks — FCP's load balancing
  *is* the straggler mitigation, it just needs the measured speeds.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from ..checkpoint.manager import CheckpointManager
from ..configs.base import ParallelConfig
from ..core import plan_cache as pc
from ..core.schedule import Schedule, make_schedule
from ..masks import MaskSpec, coerce_mask
from .wire import coerce_wire

# replanned schedules keep the configured coalescing by default — an
# elastic resize must not silently drop the launch amortization
_DEFAULT_COALESCE = ParallelConfig().coalesce


def _resolve_knobs(coalesce, wire, in_dtype_bytes, overlap,
                   pcfg: ParallelConfig | None):
    """Uniform knob precedence shared by ``replan`` and ``replan_key``:
    explicit argument wins, otherwise ``pcfg`` supplies it, otherwise
    the repo default."""
    if pcfg is not None:
        if coalesce is None:
            coalesce = pcfg.coalesce
        if wire is None:
            wire = pcfg.comm_dtype
        if in_dtype_bytes is None:
            in_dtype_bytes = pcfg.in_dtype_bytes
        if overlap is None:
            overlap = pcfg.overlap
    if coalesce is None:
        coalesce = _DEFAULT_COALESCE
    if in_dtype_bytes is None:
        in_dtype_bytes = ParallelConfig().in_dtype_bytes
    if overlap is None:
        overlap = ParallelConfig().overlap
    return coalesce, coerce_wire(wire), in_dtype_bytes, bool(overlap)


def replan_tpw(seqlens: Sequence[int], new_n_workers: int,
               block_size: int) -> int:
    """The frame geometry ``replan`` derives: tokens_per_worker grows or
    shrinks so ``new_n_workers`` frames still cover the global token
    budget (rounded up to whole blocks)."""
    total = int(sum(seqlens))
    return -(-total // (new_n_workers * block_size)) * block_size


def pod_survivor_seqlens(seqlens: Sequence[int], base_pods: int,
                         pods: int) -> list[int]:
    """The per-pod composition a ``pods``-pod survivor fleet sees of a
    stream pinned to ``base_pods`` pods.

    The pinned loader emits ``base_pods`` sub-streams per step, each
    with the *same* composition ``seqlens`` (distinct tokens).  A
    survivor fleet regroups them: each surviving pod absorbs
    ``base_pods // pods`` whole sub-streams back-to-back, so its
    composition is ``seqlens`` repeated that many times — documents
    stay intact and in global order (``reshape_pod_frames`` moves the
    tokens the same way).  ``pods`` must divide ``base_pods``: a
    non-divisor fleet could not give every pod the same composition,
    and FCP schedule tables replicate across the pod axis, so every pod
    must run the *same* schedule (the supervised driver demotes a
    non-divisor survivor count to the largest divisor, idling the
    remainder — see ``docs/elasticity.md``)."""
    base_pods, pods = int(base_pods), int(pods)
    if base_pods < 1 or pods < 1:
        raise ValueError(f"degenerate pod counts {base_pods} -> {pods}")
    if base_pods % pods:
        raise ValueError(
            f"survivor pod count {pods} must divide the pinned pod "
            f"count {base_pods} (every pod must see the same "
            f"composition; demote to a divisor fleet instead)")
    return list(seqlens) * (base_pods // pods)


def replan_key(seqlens: Sequence[int], new_n_workers: int,
               block_size: int, *, mask=True, coalesce: int | None = None,
               wire=None, in_dtype_bytes: float | None = None,
               overlap: bool | None = None,
               speeds=None, pcfg: ParallelConfig | None = None,
               pods: int = 1, base_pods: int | None = None) -> tuple:
    """The exact plan-cache key ``replan`` stores under.

    Exposed so supervised drivers can *prefetch* survivor-set replans
    (plan-ahead) and assert cache re-hits under the same keys ``replan``
    will use when the fault actually lands — key-construction drift
    between the two would silently turn every recovery into a cold
    plan.  ``pods``/``base_pods`` view ``seqlens`` (one pod's pinned
    composition) through a shrunken pod dimension, exactly as ``replan``
    does; at full strength (``pods == base_pods``) the key is byte-
    identical to the pre-shrink key, so a re-grown pod fleet re-hits
    its pre-shrink plans."""
    mask = coerce_mask(mask)
    coalesce, wire, in_dtype_bytes, overlap = _resolve_knobs(
        coalesce, wire, in_dtype_bytes, overlap, pcfg)
    seqlens = pod_survivor_seqlens(
        seqlens, pods if base_pods is None else base_pods, pods)
    tpw = replan_tpw(seqlens, new_n_workers, block_size)
    return pc.plan_key(seqlens, new_n_workers, tpw, block_size,
                       mask=mask, coalesce=coalesce, wire=wire,
                       in_dtype_bytes=in_dtype_bytes, overlap=overlap,
                       speeds=speeds)


def replan(seqlens: Sequence[int], new_n_workers: int, block_size: int,
           *, n_q_heads: int, n_kv_heads: int, head_dim: int,
           mask=True, coalesce: int | None = None,
           wire=None, in_dtype_bytes: float | None = None,
           overlap: bool | None = None,
           speeds: np.ndarray | None = None,
           pcfg: ParallelConfig | None = None,
           cache: pc.PlanCache | None = None,
           verify: bool | None = True,
           pods: int = 1, base_pods: int | None = None) -> Schedule:
    """Rebuild the FCP schedule for a new worker count.

    tokens_per_worker grows/shrinks to keep the global token budget; the
    caller re-shards the batch into the new frame geometry.

    ``pods``/``base_pods`` extend the resize to the *pod* dimension:
    ``seqlens`` is one pod's composition of a stream pinned to
    ``base_pods`` pods, and the schedule is built for the composition
    each of the ``pods`` surviving pods absorbs
    (:func:`pod_survivor_seqlens` — whole sub-streams concatenate, so
    ``pods`` must divide ``base_pods``).  At ``pods == base_pods`` this
    is exactly the per-pod schedule of the full fleet, under the same
    cache key, so regrowing the pod dimension re-hits pre-shrink plans.

    ``pcfg`` (when given) carries the planning knobs across the resize —
    coalescing survives here, and the amortized-planning settings
    (``plan_buckets``, ``plan_cache_size``, ``plan_ahead``) ride along
    for the caller's rebuilt loader + plan-ahead pipeline, so an elastic
    event doesn't silently fall back to per-batch cold planning.  The
    in-flight batch keeps its *existing* (already canonical, if the
    loader bucketed it) ``seqlens`` — re-bucketing mid-flight would
    desync the schedule from the generated data.  ``cache`` lets the
    caller keep a live :class:`PlanCache` across the resize; the new
    worker count changes every key, so old entries never collide, and a
    re-grown fleet re-hits its pre-shrink plans.  ``mask`` (a
    :class:`~repro.masks.MaskSpec` or legacy causal bool) is part of the
    plan-cache key, so schedules of different mask families never mix.
    ``wire`` (or ``pcfg.comm_dtype``) is preserved the same way: a
    resize must not silently fall back to the f32 wire, and plans of
    different wire formats never share a cache entry.  ``overlap`` (or
    ``pcfg.overlap``) — the double-buffered-rounds parity bit — rides
    the same way: a resize must keep the executor's pipelining mode,
    and serial/overlap plans allocate receive slots differently so they
    never share a cache entry.  For every knob the precedence is
    uniform: an explicit argument wins, otherwise ``pcfg`` supplies it,
    otherwise the repo default.

    Replans are statically verified by default (``verify=True`` —
    :mod:`repro.analysis.verifier`): an elastic resize happens once per
    fault, not per step, and a bad replan silently corrupts attention
    for the rest of the run.  Pass ``verify=False`` (or ``None`` for
    the process default) to opt out.
    """
    mask = coerce_mask(mask)
    coalesce, wire, in_dtype_bytes, overlap = _resolve_knobs(
        coalesce, wire, in_dtype_bytes, overlap, pcfg)
    seqlens = pod_survivor_seqlens(
        seqlens, pods if base_pods is None else base_pods, pods)
    tpw = replan_tpw(seqlens, new_n_workers, block_size)

    def build() -> Schedule:
        return make_schedule(seqlens, new_n_workers, tpw, block_size,
                             n_q_heads=n_q_heads, n_kv_heads=n_kv_heads,
                             head_dim=head_dim, mask=mask,
                             coalesce=coalesce, wire=wire,
                             in_dtype_bytes=in_dtype_bytes,
                             overlap=overlap, speeds=speeds,
                             verify=verify)

    if cache is None:
        return build()
    key = pc.plan_key(seqlens, new_n_workers, tpw, block_size,
                      mask=mask, coalesce=coalesce, wire=wire,
                      in_dtype_bytes=in_dtype_bytes, overlap=overlap,
                      speeds=speeds)
    return cache.get_or_build(key, build)


def replan_groups(seqlens: Sequence[int], new_n_workers: int,
                  block_size: int, masks: Sequence, *, n_q_heads: int,
                  n_kv_heads: int, head_dim: int,
                  coalesce: int | None = None,
                  wire=None, in_dtype_bytes: float | None = None,
                  overlap: bool | None = None,
                  speeds: np.ndarray | None = None,
                  pcfg: ParallelConfig | None = None,
                  cache: pc.PlanCache | None = None,
                  verify: bool | None = True,
                  pods: int = 1, base_pods: int | None = None
                  ) -> dict[MaskSpec, Schedule]:
    """Rebuild one schedule per *distinct* mask for the new worker count.

    ``masks`` is the model's per-layer mask sequence (or any iterable of
    MaskSpecs / legacy bools); duplicates collapse, order of first
    appearance is preserved.  Returns ``{mask_spec: schedule}`` — the
    caller re-routes each layer's attention fn through its mask's
    schedule, so an elastic resize preserves every layer group.
    ``pods``/``base_pods`` ride through to :func:`replan` so a pod-
    dimension resize rebuilds every mask group too.
    """
    out: dict[MaskSpec, Schedule] = {}
    for m in masks:
        m = coerce_mask(m)
        if m in out:
            continue
        out[m] = replan(seqlens, new_n_workers, block_size,
                        n_q_heads=n_q_heads, n_kv_heads=n_kv_heads,
                        head_dim=head_dim, mask=m, coalesce=coalesce,
                        wire=wire, in_dtype_bytes=in_dtype_bytes,
                        overlap=overlap, speeds=speeds, pcfg=pcfg,
                        cache=cache, verify=verify, pods=pods,
                        base_pods=base_pods)
    return out


# --------------------------------------------------------------------------
# fault tolerance (absorbed from the retired runtime/fault_tolerance.py)
# --------------------------------------------------------------------------

class InjectedFailure(RuntimeError):
    """Raised by tests/drills to simulate a node preemption.

    ``worker``/``step``/``round`` (all optional) identify the simulated
    loss for supervised drivers: the failure strikes worker ``worker``
    during step ``step`` at coalesced ppermute round ``round`` — i.e.
    *mid-step*, so that step never commits and recovery must replan on
    the survivors, restore the newest committed checkpoint, and replay
    the data stream.  ``pod`` instead marks a *pod-scoped* loss: every
    worker in that pod goes silent at once (the whole DCN-attached
    failure domain), and recovery shrinks the fleet's pod dimension
    rather than its worker dimension."""

    def __init__(self, *args, worker: int | None = None,
                 step: int | None = None, round: int | None = None,
                 pod: int | None = None):
        if not args:
            who = (f"pod={pod}" if pod is not None
                   else f"worker={worker}")
            args = (f"injected failure ({who}, step={step}, "
                    f"round={round})",)
        super().__init__(*args)
        self.worker = worker
        self.step = step
        self.round = round
        self.pod = pod


@dataclasses.dataclass
class StragglerTracker:
    n_workers: int
    ewma: float = 0.3
    _times: np.ndarray | None = None

    def observe(self, per_worker_step_time: np.ndarray) -> None:
        t = np.asarray(per_worker_step_time, dtype=np.float64)
        if t.shape != (self.n_workers,):
            raise ValueError(
                f"observed {t.shape} step times for {self.n_workers} "
                f"workers — call resize() after an elastic event")
        if self._times is None:
            self._times = t.copy()
        else:
            self._times = (1 - self.ewma) * self._times + self.ewma * t

    def resize(self, survivor_ids: Sequence[int],
               burnin: bool = False) -> None:
        """Remap EWMA state onto a new worker set.

        Elastic shrink (every survivor id is a current worker): the
        survivors keep their speed history under their *new* ids —
        survivor order defines the renumbering, matching how the
        supervised driver renumbers mesh slots.  Growth / replacement
        (any id outside the current range): fresh workers have no
        history, and a partial carry-over would misattribute speeds, so
        the EWMA resets and re-converges.

        ``burnin=True`` discards the EWMA outright even on a clean
        shrink — a *recalibration burn-in* after a topology change:
        speeds read 1.0 until fresh step timings re-converge, because
        a resize moves collective boundaries (pod axis, DCN paths) and
        stale per-worker EWMAs would misattribute the new costs."""
        ids = [int(i) for i in survivor_ids]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate worker ids in {ids}")
        shrink = (not burnin and self._times is not None
                  and all(0 <= i < self.n_workers for i in ids))
        self._times = self._times[ids] if shrink else None
        self.n_workers = len(ids)

    def speeds(self) -> np.ndarray:
        """Relative speeds normalized to max 1.0 (slow worker < 1)."""
        if self._times is None:
            return np.ones(self.n_workers)
        s = self._times.min() / np.maximum(self._times, 1e-9)
        return s

    def has_straggler(self, threshold: float = 0.8) -> bool:
        return bool((self.speeds() < threshold).any())


def resumable_train(step_fn, init_state, *, manager: CheckpointManager,
                    total_steps: int, checkpoint_every: int = 50,
                    fail_at: int | None = None, blocking_ckpt: bool = False,
                    on_step=None):
    """Run ``state = step_fn(state, step)`` for ``total_steps``, resuming
    from the newest committed checkpoint if one exists.

    ``fail_at`` raises :class:`InjectedFailure` *before* executing that
    step (tests restart the loop to prove recovery).  Returns the final
    state."""
    start = 0
    state = init_state
    latest = manager.latest_step()
    if latest is not None:
        state, extra = manager.restore(init_state)
        start = int(extra["step"]) + 1
    for step in range(start, total_steps):
        if fail_at is not None and step == fail_at:
            manager.wait()
            raise InjectedFailure(f"injected failure at step {step}")
        state = step_fn(state, step)
        if on_step is not None:
            on_step(step, state)
        if (step + 1) % checkpoint_every == 0 or step == total_steps - 1:
            manager.save(step, state, blocking=blocking_ckpt)
    manager.wait()
    return state


def reshape_frames(arr: np.ndarray, new_n_workers: int,
                   tokens_per_worker: int | None = None, *,
                   n_valid: int | None = None,
                   fill=0) -> np.ndarray:
    """[F, T, ...] -> [F', T', ...] for the new worker count (same global
    token stream, possibly re-padded).

    ``tokens_per_worker`` pins the new frame length (default: the
    smallest that fits every old token).  ``n_valid`` marks how many
    leading tokens of the flattened stream are real content — the rest
    is padding the new geometry may *drop* (a shrunk budget from
    ``replan_tpw`` is smaller than the old physical frames) and
    re-grow with ``fill``.  ``fill`` matters per field: segment ids pad
    with -1 (PAD_SEGMENT — zero would alias a real document), token /
    loss-mask fields with 0."""
    f, t = arr.shape[:2]
    total = f * t
    if n_valid is None:
        n_valid = total
    if not 0 <= n_valid <= total:
        raise ValueError(f"n_valid={n_valid} outside [0, {total}]")
    if tokens_per_worker is None:
        tokens_per_worker = -(-n_valid // new_n_workers)
    new_total = new_n_workers * tokens_per_worker
    if new_total < n_valid:
        raise ValueError(
            f"{new_n_workers}x{tokens_per_worker} frames hold {new_total} "
            f"tokens < {n_valid} valid tokens")
    flat = arr.reshape((total,) + arr.shape[2:])[:n_valid]
    pad = new_total - n_valid
    if pad:
        flat = np.concatenate(
            [flat, np.full((pad,) + flat.shape[1:], fill, flat.dtype)])
    return flat.reshape(
        (new_n_workers, tokens_per_worker) + arr.shape[2:])


def reshape_pod_frames(arr: np.ndarray, old_pods: int, new_pods: int,
                       new_workers: int,
                       tokens_per_worker: int | None = None, *,
                       n_valid: int | None = None,
                       fill=0) -> np.ndarray:
    """Re-view a pod-major frame stack for a shrunken (or regrown) pod
    dimension.

    The loader pins its geometry at launch: ``[old_pods * w0, T, ...]``
    pod-major frames, every pod carrying the same *composition* over
    distinct tokens.  After a pod loss, each surviving pod adopts the
    token sub-streams of ``old_pods // new_pods`` pinned pods
    back-to-back (so the global stream is preserved bit-for-bit and a
    regrow replays identically).  ``new_pods`` must divide ``old_pods``
    — a non-divisor fleet cannot give every pod the same composition,
    mirroring :func:`pod_survivor_seqlens`.

    ``n_valid`` counts the leading real tokens *per pinned pod* (default:
    the whole frame); padding between sub-streams is dropped and
    re-grown with ``fill`` at each surviving pod's tail, exactly like
    :func:`reshape_frames` (which this reduces to when both pod counts
    are 1)."""
    old_pods = int(old_pods)
    new_pods = int(new_pods)
    if old_pods < 1 or new_pods < 1:
        raise ValueError(
            f"pod counts must be >= 1, got {old_pods} -> {new_pods}")
    if old_pods % new_pods:
        raise ValueError(
            f"surviving pod count {new_pods} must divide the pinned pod "
            f"count {old_pods} (every pod must see the same composition; "
            f"demote to a divisor fleet instead)")
    f, t = arr.shape[:2]
    if f % old_pods:
        raise ValueError(
            f"{f} frames do not split over {old_pods} pinned pods")
    w0 = f // old_pods
    per = old_pods // new_pods
    pod_total = w0 * t
    if n_valid is None:
        n_valid = pod_total
    if not 0 <= n_valid <= pod_total:
        raise ValueError(f"n_valid={n_valid} outside [0, {pod_total}]")
    # [old_pods, w0*t, ...] -> strip per-pod padding -> regroup survivors
    sub = arr.reshape((old_pods, pod_total) + arr.shape[2:])
    valid = sub[:, :n_valid]
    groups = valid.reshape((new_pods, per * n_valid) + arr.shape[2:])
    if tokens_per_worker is None:
        tokens_per_worker = -(-per * n_valid // new_workers)
    new_total = new_workers * tokens_per_worker
    if new_total < per * n_valid:
        raise ValueError(
            f"{new_workers}x{tokens_per_worker} frames hold {new_total} "
            f"tokens < {per * n_valid} valid tokens per surviving pod")
    pad = new_total - per * n_valid
    if pad:
        groups = np.concatenate(
            [groups,
             np.full((new_pods, pad) + arr.shape[2:], fill, arr.dtype)],
            axis=1)
    return groups.reshape(
        (new_pods * new_workers, tokens_per_worker) + arr.shape[2:])
