"""Fault drills for the :class:`~repro_torch.launch.train.Supervisor` on
stacked workers: the kill and straggler drills of the reference's
``tests/multidevice/run_fault_drill.py``, held to its limits.

* **kill drill** — a worker dies mid-step (``InjectedFailure``).  The
  supervisor replans on the survivors, restores the newest committed
  checkpoint, replays the deterministic stream and loses at most
  ``checkpoint_every`` steps; the post-recovery losses and gradient
  norms match an *uninterrupted* survivor-fleet run restored from the
  same checkpoint to ``REPLAY_TOL`` normalized.
* **straggler drill** — one worker reports ``factor``-times-slow step
  times.  The monitor demotes it within the hysteresis window plus the
  cooldown, the latched speeds reach the block distributor (the slow
  worker's modeled compute drops below what uniform placement hands
  it), and the demoted plan key misses once, then hits.
* **pod drill** — pod 1 of a multi-pod fleet dies mid-step
  (pod-scoped ``InjectedFailure``).  The supervisor shrinks the pod
  dimension, resets the error-feedback residuals, restores and replays
  (at most ``checkpoint_every`` steps lost) while the prewarm thread
  verifies the survivor schedules, re-warms the full-fleet plans and
  stages the restored checkpoint; the rejoin re-hits the pre-shrink
  plan keys with no plan miss and no step program built after it (its
  pre-shrink programs replay), and
  the survivor and post-rejoin losses and gradient norms match an
  uninterrupted run restored from the same checkpoint to
  ``REPLAY_TOL`` normalized.

The kill drill also covers a worker loss on a multi-pod fleet (the
worker's slot leaves every pod) when ``make_sup`` builds one.

Each drill takes ``make_sup(checkpoint_dir, **kw) -> Supervisor`` (the
caller fixes model, widths, device and loader), raises
``AssertionError`` on a breach and returns what it measured.

**Across ranks** ``make_sup`` builds a ranked Supervisor (its
``dist_backend``) and every rank of the group runs the drill.  A rank
left idle by the loss holds the limits on what it ran (the recovery's
record, the steps before the loss and after a rejoin); the survivor
fleet's steps are held on the ranks that ran them.  The reference run
starts on the same survivor ranks (``start_members``), so its fleet
splits its frames as the recovered one does.  The world group's rank 0
makes the reference's directory, between barriers.  Each drill returns
this rank's records (and its parameters' digest), so a caller can check
that the ranks agree.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import shutil

import numpy as np

from ..checkpoint import checkpointer
from ..core import cost_model as cm
from ..optimizer import adamw
from ..runtime import elastic
from ..runtime import wire as wirelib

REPLAY_TOL = 1e-6        # post-recovery loss / gnorm, normalized


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _on_members(rec: dict) -> dict:
    """The reference run's starting group: the recovery's survivor ranks
    (nothing on stacked workers)."""
    return ({"start_members": tuple(rec["members"])} if "members" in rec
            else {})


def _rank_view(sup) -> dict:
    """This rank's place and records, for a caller to set the ranks side
    by side."""
    return {"rank": sup.world.rank, "members": list(sup.members),
            "records": [dataclasses.asdict(r) for r in sup.history],
            "param_digest": wirelib.digest(
                adamw.tree_leaves(sup.state.params)).hex()}


def kill_drill(make_sup, tmp: pathlib.Path, *, total: int, fail_step: int,
               fail_worker: int, fail_round: int, every: int) -> dict:
    d = pathlib.Path(tmp) / "primary"
    sup = make_sup(d)
    n0 = sup.n
    fail = elastic.InjectedFailure(worker=fail_worker, step=fail_step,
                                   round=fail_round)
    sup.run(total, fail=fail)
    _check(len(sup.recoveries) == 1, f"recoveries {sup.recoveries}")
    rec = sup.recoveries[0]
    _check(rec["failed_step"] == fail_step and rec["worker"] == fail_worker
           and rec["n_workers"] == n0 - 1, f"recovery {rec}")
    # bounded step loss: the newest committed checkpoint is at most
    # checkpoint_every steps behind the failed step
    _check(0 <= rec["steps_lost"] <= every,
           f"lost {rec['steps_lost']} steps > {every}")
    fails = [e for e in sup.monitor.events if e.kind == "fail"]
    _check(bool(fails) and fails[0].workers == (fail_worker,),
           f"fail events {fails}")
    by_fleet: dict = {}
    for r in sup.history:
        by_fleet.setdefault(r.n_workers, []).append(r.step)
    # a rank the loss left idle ran no survivor step
    active = sup.ranks is not None
    _check(by_fleet[n0][-1] == fail_step - 1
           and (by_fleet[n0 - 1][-1] == total - 1 if active
                else n0 - 1 not in by_fleet), f"steps {by_fleet}")

    # reference: an UNINTERRUPTED survivor run restored from the same
    # checkpoint the recovery used (hard-linked: restores only read it)
    d2 = pathlib.Path(tmp) / "reference"
    src = d / f"step_{rec['resume_step'] - 1}"
    if sup.world.rank == 0:
        d2.mkdir(parents=True)
        if src.exists():
            shutil.copytree(src, d2 / src.name, copy_function=os.link)
    wirelib.barrier(sup.world)
    ref = _replay_only(make_sup(d2, start_fleet=n0 - 1, **_on_members(rec)))
    ref.run(total)
    want = {r.step: r for r in ref.history}
    got = {r.step: r for r in sup.history if r.n_workers == n0 - 1}
    _check(sorted(got) == sorted(want) and (bool(got) or not active),
           f"{sorted(got)} vs {sorted(want)}")
    diffs = _replay_diffs(got, want) or [0.0]
    _check(max(diffs) <= REPLAY_TOL,
           f"replay diff {max(diffs):.3e} > {REPLAY_TOL}")
    return {"steps_lost": rec["steps_lost"],
            "resume_step": rec["resume_step"], "n_workers": rec["n_workers"],
            "recovery_wall_s": rec["wall_s"], "replay_max_diff": max(diffs),
            "steps_compared": len(got),
            "step_ms": [r.ms for r in sup.history], **_rank_view(sup)}


def modeled_worker_loads(sched, n_q_heads: int, head_dim: int,
                         speeds=None) -> np.ndarray:
    """Per-worker modeled compute time of one schedule: cost-model block
    FLOPs summed by owner, divided by the worker's speed."""
    costs = cm.block_q_flops(sched.batch, sched.deps, n_q_heads, head_dim,
                             sched.spec.mask)
    loads = np.bincount(sched.assignment, weights=costs,
                        minlength=sched.spec.n_workers).astype(float)
    if speeds is not None:
        loads = loads / np.asarray(speeds, float)
    return loads


def straggler_drill(make_sup, *, total: int, window: int, cooldown: int,
                    worker: int = 3, factor: float = 2.0) -> dict:
    sup = make_sup(None)
    n = sup.n
    sup.run(total, skew={worker: factor})
    demotes = [e for e in sup.monitor.events if e.kind == "demote"]
    _check(bool(demotes), f"{factor}x-slow worker was never demoted")
    first = demotes[0]
    # demoted within the hysteresis window (+ cooldown slack for the
    # quantized latch settling)
    _check(first.step < window + cooldown and worker in first.workers,
           f"first demotion {first}")
    speeds = sup.monitor.planning_speeds()
    _check(speeds is not None and speeds[worker] <= 0.6,
           f"latched speeds {speeds}")

    # the latched speeds reached assign_blocks: the slow worker's
    # modeled compute drops well below what uniform placement gives it
    sched = next(iter(sup.last_scheds.values()))
    nh, _, hd = sup._heads
    uniform = elastic.replan(
        sched.batch.seqlens, n, sup.pcfg.block_size, n_q_heads=nh,
        n_kv_heads=sup._heads[1], head_dim=hd, mask=sched.spec.mask,
        pcfg=sup.pcfg, verify=False)
    loads = modeled_worker_loads(sched, nh, hd)
    loads_uni = modeled_worker_loads(uniform, nh, hd)
    _check(loads[worker] < 0.9 * loads_uni[worker],
           f"loads {loads} vs uniform {loads_uni}")
    real = np.ones(n)
    real[worker] = 1.0 / factor
    t_uni, t_dem = (loads_uni / real).max(), (loads / real).max()
    _check(t_dem < t_uni, f"modeled step {t_dem} !< uniform {t_uni}")

    # plan-cache discipline: latched speeds mint one new key per
    # (composition, speed latch) — they miss once, then re-hit
    s = sup.plan_cache.stats
    n_comps = len({tuple(c) for c in sup.loader.compositions})
    n_latches = 1 + len(demotes)
    _check(s.misses <= n_comps * n_latches * len(sup.group_masks)
           and s.hits + s.misses >= total
           and s.hits >= total - s.misses, f"plan cache {s.to_dict()}")
    return {"demoted_at": first.step, "speeds": list(speeds),
            "slow_worker_load_vs_uniform": loads[worker] / loads_uni[worker],
            "modeled_step_ratio": t_dem / t_uni,
            "plan_cache": s.to_dict(),
            "events": [dataclasses.asdict(e) for e in sup.monitor.events],
            "step_ms": [r.ms for r in sup.history], **_rank_view(sup)}


def _replay_only(sup):
    """A reference run only replays: no file would read its saves."""
    sup.pcfg = dataclasses.replace(sup.pcfg, checkpoint_every=0)
    return sup


def _replay_diffs(got: dict, want: dict) -> list[float]:
    diffs = []
    for k in got:
        diffs.append(abs(got[k].loss - want[k].loss)
                     / max(abs(want[k].loss), 1e-9))
        diffs.append(abs(got[k].gnorm - want[k].gnorm)
                     / max(abs(want[k].gnorm), 1e-9))
    return diffs


def pod_drill(make_sup, tmp: pathlib.Path, *, total: int, fail_step: int,
              fail_round: int, rejoin_step: int, every: int) -> dict:
    """Pod 1 dies at ``fail_step`` and rejoins at ``rejoin_step``, held
    to the limits of the reference runner's pod drill.  The reference run
    restores from the checkpoint the prewarm thread staged, so the
    primary's checkpoints may be pruned as usual."""
    d = pathlib.Path(tmp) / "pod_primary"
    sup = make_sup(d)
    p0, n = sup.p0, sup.n0
    fail = elastic.InjectedFailure(pod=1, step=fail_step, round=fail_round)
    sup.run(total, fail=fail, rejoin_step=rejoin_step)

    # shrink: a pod-scoped recovery within the checkpoint budget
    _check(len(sup.recoveries) == 1, f"recoveries {sup.recoveries}")
    rec = sup.recoveries[0]
    _check(rec["failed_step"] == fail_step and rec.get("pod") == 1
           and "worker" not in rec, f"recovery {rec}")
    _check(rec["pods"] == max(q for q in range(1, p0) if p0 % q == 0)
           and rec["n_workers"] == n, f"recovery {rec}")
    _check(0 <= rec["steps_lost"] <= every,
           f"lost {rec['steps_lost']} steps > {every}")
    # EF residuals reset over the survivors, never reused
    _check(bool(rec.get("ef_reset")), f"no EF reset in {rec}")
    fails = [e for e in sup.monitor.events if e.kind == "fail"]
    _check(bool(fails) and fails[0].pod == 1
           and set(fails[0].workers) == set(range(n, 2 * n)),
           f"fail events {fails} (pod 1's flat slots)")

    # overlapping recovery: the prewarm thread did its three jobs
    _check(len(sup.rejoins) == 1, f"rejoins {sup.rejoins}")
    rj = sup.rejoins[0]
    _check(rj["step"] == rejoin_step and rj["pods"] == p0, f"rejoin {rj}")
    pw = rj["prewarm"]
    _check("error" not in pw and pw["survivor_schedules_verified"] >= 1
           and pw["violations"] == 0 and pw["plans_prefetched"] >= 1,
           f"prewarm {pw}")
    _check(pw["staged_step"] == rec["resume_step"] - 1,
           f"staged {pw['staged_step']} != {rec['resume_step'] - 1}")

    # rejoin: the pre-shrink plans re-hit; no plan miss and no step
    # program built after it
    s = sup.plan_cache.stats
    _check(rj["plan_keys_cached"] is True
           and s.misses == rj["plan_misses_before"]
           and len(sup.compiled_at) == rj["compiles_before"]
           and sup.builds() == rj["builds_before"],
           f"after rejoin: {s.to_dict()} {sup.compiled_at} {rj}")
    # the key contract: at full strength replan_key is the pre-shrink key
    key = elastic.replan_key(
        sup.loader.composition(rejoin_step)[1], n, sup.pcfg.block_size,
        mask=sup.group_masks[0], pcfg=sup.pcfg, pods=p0, base_pods=p0)
    _check(key in sup.plan_cache, "regrow key missing from the plan cache")

    # equivalence: the survivor and post-rejoin steps against an
    # uninterrupted run restored from the same checkpoint: the staged
    # copy, written once the primary's directory has freed its disk (a
    # staged copy that differed from the checkpoint would show here)
    staged = sup._staged
    _check(staged is not None and staged["step"] == pw["staged_step"],
           "no staged checkpoint")
    d2 = pathlib.Path(tmp) / "pod_reference"
    wirelib.barrier(sup.world)
    if sup.world.rank == 0:
        shutil.rmtree(d, ignore_errors=True)
        checkpointer.save(d2 / f"step_{staged['step']}", staged["tree"],
                          staged["extra"])
    wirelib.barrier(sup.world)
    sup._staged = None
    ref = _replay_only(make_sup(d2, start_fleet=(1, n), **_on_members(rec)))
    ref.run(total, rejoin_step=rejoin_step)
    want = {(r.step, r.pods): r for r in ref.history}
    got = {(r.step, r.pods): r for r in sup.history
           if (r.step, r.pods) in want}
    _check(sorted(got) == sorted(want), f"{sorted(got)} vs {sorted(want)}")
    _check(any(p == p0 for _, p in got), "no post-rejoin step compared")
    diffs = _replay_diffs(got, want)
    _check(max(diffs) <= REPLAY_TOL,
           f"replay diff {max(diffs):.3e} > {REPLAY_TOL}")
    return {"steps_lost": rec["steps_lost"],
            "resume_step": rec["resume_step"],
            "recovery_wall_s": rec["wall_s"], "rejoin_ms": rj["rejoin_ms"],
            "prewarm": pw, "replay_max_diff": max(diffs),
            "rejoin": {"compiles_before": rj["compiles_before"],
                       "compiles_after": len(sup.compiled_at),
                       "builds_before": rj["builds_before"],
                       "builds_after": sup.builds(),
                       "plan_misses_before": rj["plan_misses_before"],
                       "plan_misses_after": s.misses,
                       **{k: rj[k] for k in ("broadcast_src",
                                             "broadcast_bytes",
                                             "broadcast_priced",
                                             "broadcast_s") if k in rj}},
            "steps_compared": len(got),
            "post_rejoin_steps": sum(p == p0 for _, p in got),
            "fleet_steps": [(r.step, r.pods, r.n_workers)
                            for r in sup.history],
            "step_ms": [r.ms for r in sup.history], **_rank_view(sup)}
