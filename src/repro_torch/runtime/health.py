"""Runtime health telemetry: measurement -> placement -> recovery.

The missing loop around the speed-aware distributor.  The executor's
host loop already produces a device-sync'd wall clock per step for free
(it blocks on the loss anyway — :func:`repro.core.executor.timed_call`);
this module turns those timings into *decisions*:

* **straggler demotion** — per-worker step times feed the existing
  :class:`~repro.runtime.elastic.StragglerTracker` EWMA; when a worker
  stays below ``straggler_threshold`` relative speed for
  ``health_window`` consecutive steps (hysteresis), the monitor latches
  a *quantized* speed vector for ``elastic.replan(speeds=...)`` so the
  slow worker is assigned proportionally fewer blocks.  Latching +
  quantization + a ``demote_cooldown`` rate limit mean oscillating
  measurements cannot thrash the plan cache: the planning speeds only
  change on demote/promote events, never per step.
* **failure detection** — heartbeats (refreshed by every observation)
  with a ``step_timeout``; a silent worker raises :class:`WorkerLoss`,
  which the supervised train loop (:mod:`repro.launch.train`) converts
  into survivor-set replan + checkpoint restore + data-stream replay.

Pure host-side numpy — nothing here runs under jit, so the healthy path
costs nothing on device: no extra syncs, no recompiles (the latched
speeds are ``None`` while healthy, producing plan-cache keys identical
to a monitor-less run).

Multi-pod fleets add a *topology* layer (``docs/elasticity.md``):
heartbeats and step timings are attributed to ``(pod, worker)``
coordinates via :class:`FleetTopology`.  Correlated silence — every
worker of one pod late at once — escalates to :class:`PodLoss` (the
whole DCN-attached failure domain is gone; demoting its workers one by
one would thrash), while partial silence stays a :class:`WorkerLoss`.
Every topology change (:meth:`HealthMonitor.resize`) starts a
*recalibration burn-in*: speeds reset to 1.0 and re-measure for
``health_window`` steps — EWMAs measured on the old topology say
nothing about contention on the new one, so they are never trusted
through a resize.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np

from ..configs.base import ParallelConfig
from .elastic import StragglerTracker


class WorkerLoss(RuntimeError):
    """A worker was declared dead (heartbeat timeout or injected)."""

    def __init__(self, worker: int, step: int,
                 reason: str = "heartbeat timeout"):
        super().__init__(
            f"worker {worker} lost at step {step} ({reason})")
        self.worker = int(worker)
        self.step = int(step)
        self.reason = reason


class PodLoss(RuntimeError):
    """A whole pod was declared dead (correlated worker silence).

    One failure domain under ``dp_axis``: a lost DCN link, rack power,
    or host takes every CP worker of the pod down *together*.  The
    supervised driver handles this by shrinking the pod dimension (the
    survivors keep training on the pinned stream) rather than demoting
    the pod's workers one by one."""

    def __init__(self, pod: int, step: int,
                 reason: str = "correlated heartbeat loss"):
        super().__init__(f"pod {pod} lost at step {step} ({reason})")
        self.pod = int(pod)
        self.step = int(step)
        self.reason = reason


@dataclasses.dataclass(frozen=True)
class FleetTopology:
    """The ``(pods, workers)`` shape health telemetry is attributed to.

    Flat worker ids (what the tracker and heartbeats index) are
    pod-major: worker ``w`` of pod ``p`` is flat id ``p * workers + w``
    — the same ordering the supervised driver's pod-major batch frames
    and mesh axes use, so a flat id maps straight onto a mesh slot."""
    pods: int = 1
    workers: int = 1                   # CP workers per pod

    def __post_init__(self):
        if self.pods < 1 or self.workers < 1:
            raise ValueError(
                f"degenerate topology {self.pods}x{self.workers}")

    @property
    def n_total(self) -> int:
        return self.pods * self.workers

    def coord(self, flat: int) -> tuple[int, int]:
        """flat id -> (pod, worker)."""
        return divmod(int(flat), self.workers)

    def flat(self, pod: int, worker: int) -> int:
        return int(pod) * self.workers + int(worker)

    def pod_members(self, pod: int) -> tuple[int, ...]:
        return tuple(range(int(pod) * self.workers,
                           (int(pod) + 1) * self.workers))


@dataclasses.dataclass(frozen=True)
class HealthEvent:
    """One demotion/promotion/failure decision, for logs and drills."""
    kind: str                          # "demote" | "promote" | "fail"
    step: int
    workers: tuple[int, ...]           # affected worker ids (flat)
    speeds: tuple[float, ...] | None = None   # latched planning speeds
    detail: str = ""
    pod: int | None = None             # set when a whole pod is affected


def per_worker_times(step_time: float, n_workers: int,
                     skew: Sequence[float] | None = None) -> np.ndarray:
    """Expand one wall-clock step time into per-worker observations.

    Under SPMD jit every worker's step wall clock *is* the same number
    (the slowest worker gates the collective), so the honest attribution
    needs a skew source: a real deployment uses per-host monotonic
    clocks around its local dispatch; the sim drills inject ``skew``
    (relative per-worker slowdown factors) to model a degraded chip.
    """
    t = np.full(int(n_workers), float(step_time))
    if skew is not None:
        s = np.asarray(skew, dtype=np.float64)
        if s.shape != (int(n_workers),):
            raise ValueError(
                f"skew has shape {s.shape}, expected ({n_workers},)")
        t = t * s
    return t


class HealthMonitor:
    """Closed-loop worker health: EWMA speeds, hysteresis, heartbeats.

    The monitor never *acts* — it observes, decides, and exposes the
    decision; the supervised train loop owns meshes and checkpoints.
    Contract with the planner: :meth:`planning_speeds` is ``None``
    whenever the fleet is healthy (same plan keys as a speedless run)
    and only changes value on a logged demote/promote event.
    """

    def __init__(self, n_workers: int, *, window: int = 8,
                 threshold: float = 0.8, step_timeout: float = 60.0,
                 cooldown: int = 16, quantum: float = 0.05,
                 ewma: float = 0.3,
                 topology: FleetTopology | None = None,
                 clock: Callable[[], float] = time.monotonic):
        if not 0 < threshold <= 1:
            raise ValueError(f"threshold {threshold} outside (0, 1]")
        self.n_workers = int(n_workers)
        self.topology = topology or FleetTopology(1, self.n_workers)
        if self.topology.n_total != self.n_workers:
            raise ValueError(
                f"topology {self.topology.pods}x{self.topology.workers} "
                f"does not cover {self.n_workers} workers")
        self.window = max(int(window), 1)
        self.threshold = float(threshold)
        self.step_timeout = float(step_timeout)
        self.cooldown = max(int(cooldown), 0)
        self.quantum = float(quantum)
        self._clock = clock
        self.tracker = StragglerTracker(self.n_workers, ewma=ewma)
        self._heartbeat = np.full(self.n_workers, clock(), np.float64)
        self._slow_streak = 0
        self._healthy_streak = 0
        self._latched: tuple[float, ...] | None = None
        self._last_event_step = -(1 << 30)
        self._burnin = 0                   # post-resize recalibration
        self.events: list[HealthEvent] = []

    @classmethod
    def from_pcfg(cls, n_workers: int, pcfg: ParallelConfig,
                  clock: Callable[[], float] = time.monotonic,
                  topology: FleetTopology | None = None
                  ) -> "HealthMonitor":
        return cls(n_workers, window=pcfg.health_window,
                   threshold=pcfg.straggler_threshold,
                   step_timeout=pcfg.step_timeout,
                   cooldown=pcfg.demote_cooldown, topology=topology,
                   clock=clock)

    # -- telemetry in ------------------------------------------------------

    def observe(self, step: int, per_worker_step_time,
                alive: Sequence[int] | None = None) -> None:
        """Record one step's per-worker wall-clock times.

        Every reported worker's heartbeat refreshes (``alive`` narrows
        that to a subset when a transport only heard from some).  The
        straggler hysteresis streaks advance here — one observation per
        step, so ``window`` is in *steps*."""
        t = np.asarray(per_worker_step_time, dtype=np.float64)
        if t.shape != (self.n_workers,):
            raise ValueError(
                f"observed {t.shape} times for {self.n_workers} workers")
        self.tracker.observe(t)
        now = self._clock()
        if alive is None:
            self._heartbeat[:] = now
        else:
            self._heartbeat[list(alive)] = now
        if self.tracker.has_straggler(self.threshold):
            self._slow_streak += 1
            self._healthy_streak = 0
        else:
            self._slow_streak = 0
            self._healthy_streak += 1
        if self._burnin > 0:
            self._burnin -= 1

    def heartbeat(self, worker: int, now: float | None = None) -> None:
        """Out-of-band liveness signal (e.g. a ping between steps)."""
        self._heartbeat[int(worker)] = (
            self._clock() if now is None else now)

    # -- failure detection -------------------------------------------------

    def failed_workers(self, now: float | None = None) -> list[int]:
        now = self._clock() if now is None else now
        late = now - self._heartbeat > self.step_timeout
        return [int(i) for i in np.nonzero(late)[0]]

    def check(self, step: int, now: float | None = None) -> None:
        """Raise :class:`PodLoss`/:class:`WorkerLoss` on timed-out
        heartbeats.

        Escalation is topology-aware: if *every* worker of one pod is
        late at once (correlated silence — the failure domain itself is
        gone, not one chip in it), the loss is pod-scoped; any partial
        silence stays worker-scoped."""
        failed = self.failed_workers(now)
        if not failed:
            return
        t = self.topology
        if t.pods > 1:
            down = set(failed)
            for p in range(t.pods):
                members = t.pod_members(p)
                if all(w in down for w in members):
                    self.events.append(HealthEvent(
                        "fail", int(step), members, pod=p,
                        detail=f"pod {p} fully silent for > "
                               f"{self.step_timeout}s"))
                    raise PodLoss(p, step)
        self.events.append(HealthEvent(
            "fail", int(step), tuple(failed),
            detail=f"no heartbeat for > {self.step_timeout}s"))
        raise WorkerLoss(failed[0], step)

    def note_failure(self, step: int, worker: int | None = None,
                     detail: str = "", pod: int | None = None) -> None:
        """Log an externally-detected loss (e.g. an InjectedFailure);
        ``pod`` marks a pod-scoped loss (all its workers affected)."""
        if pod is not None:
            self.events.append(HealthEvent(
                "fail", int(step), self.topology.pod_members(pod),
                pod=int(pod), detail=detail))
            return
        self.events.append(HealthEvent(
            "fail", int(step), (int(worker or 0),), detail=detail))

    # -- closed-loop demotion ----------------------------------------------

    def _quantize(self, speeds: np.ndarray) -> tuple[float, ...]:
        """Snap measured speeds to the planning grid: healthy workers
        (>= threshold) pin to exactly 1.0 so measurement noise among
        them can't mint new plan keys; stragglers round to ``quantum``
        steps (floored at one quantum — a zero speed would starve the
        worker instead of demoting it)."""
        out = []
        for s in np.asarray(speeds, dtype=np.float64):
            if s >= self.threshold:
                out.append(1.0)
            else:
                q = round(float(s) / self.quantum) * self.quantum
                out.append(round(max(q, self.quantum), 6))
        return tuple(out)

    def _slot_speeds(self) -> np.ndarray:
        """Measured speeds collapsed onto the per-pod worker slots the
        *schedule* knows about.  Every pod runs the same schedule
        (tables replicate over the pod axis), so slot ``w``'s planning
        speed is gated by its slowest instance across pods — the
        collective waits for that one anyway."""
        s = self.tracker.speeds()
        t = self.topology
        if t.pods == 1:
            return s
        return s.reshape(t.pods, t.workers).min(axis=0)

    def maybe_replan(self, step: int) -> HealthEvent | None:
        """Hysteresis + rate limit: returns a demote/promote event when
        the latched planning speeds should change, else ``None``.

        Demote: the straggler streak filled the window and the quantized
        speeds differ from the current latch.  Promote: a full window of
        healthy observations while a latch is active.  Both respect
        ``cooldown`` steps since the last event, so an oscillating
        worker flips the plan at a bounded rate (and the plan cache
        keeps both plans — flips re-hit, they don't rebuild).

        During a post-resize burn-in (:meth:`resize`) this always
        returns ``None``: the fresh EWMAs need ``window`` observations
        on the *new* topology before they are trusted to replan."""
        if self._burnin > 0:
            return None
        if step - self._last_event_step < self.cooldown:
            return None
        if self._slow_streak >= self.window:
            q = self._quantize(self._slot_speeds())
            if min(q) >= 1.0 or q == self._latched:
                return None
            self._latched = q
            self._last_event_step = int(step)
            slow = tuple(i for i, s in enumerate(q) if s < 1.0)
            ev = HealthEvent("demote", int(step), slow, q,
                             detail=f"slow for {self._slow_streak} steps")
            self.events.append(ev)
            return ev
        if self._latched is not None and self._healthy_streak >= self.window:
            ev = HealthEvent(
                "promote", int(step),
                tuple(i for i, s in enumerate(self._latched) if s < 1.0),
                None, detail=f"healthy for {self._healthy_streak} steps")
            self._latched = None
            self._last_event_step = int(step)
            self.events.append(ev)
            return ev
        return None

    def planning_speeds(self) -> tuple[float, ...] | None:
        """The latched speed vector for ``elastic.replan(speeds=...)``.

        ``None`` while healthy — byte-identical plan-cache keys to a
        run without a monitor, so the healthy path costs nothing."""
        return self._latched

    # -- elasticity --------------------------------------------------------

    @property
    def in_burnin(self) -> bool:
        """True while the post-resize recalibration window is open."""
        return self._burnin > 0

    def resize(self, survivor_ids: Sequence[int] | None = None, *,
               topology: FleetTopology | None = None) -> None:
        """Re-key all state onto the new fleet and start a
        *recalibration burn-in*.

        Either a survivor id list (legacy single-pod worker loss — the
        survivors' renumbering matches the driver's mesh-slot
        renumbering) or an explicit ``topology`` (any pod/worker
        resize).  Both are topology changes, so speeds reset to 1.0 and
        re-measure for ``window`` steps instead of trusting EWMAs
        measured on the old topology (``maybe_replan`` holds off until
        the burn-in drains); streaks and the speed latch reset — the
        new fleet must re-earn a demotion — and every survivor's
        heartbeat restarts fresh."""
        if (survivor_ids is None) == (topology is None):
            raise ValueError(
                "resize takes exactly one of survivor_ids / topology")
        if topology is not None:
            self.topology = topology
            self.tracker.resize(range(topology.n_total), burnin=True)
        else:
            self.tracker.resize(survivor_ids, burnin=True)
            self.topology = FleetTopology(1, self.tracker.n_workers)
        self.n_workers = self.tracker.n_workers
        self._heartbeat = np.full(self.n_workers, self._clock(),
                                  np.float64)
        self._slow_streak = 0
        self._healthy_streak = 0
        self._latched = None
        self._burnin = self.window
