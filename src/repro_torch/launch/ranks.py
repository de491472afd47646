"""The training and serving CLIs across ranks, checked: the training
runs under each executor impl, the first step's gradients against one
process's, serving runs of each cache layout, and the Supervisor's
fault drills.

Run it under ``torchrun`` from the repository root, with the training
CLI's arguments for a ranked run (``launch/train.py``)::

    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 2 -m repro_torch.launch.ranks --out DIR \\
        --runs fused_xla:3,xla:1 --grad-layers 2 -- --arch stablelm_1_6b \\
        --smoke --mesh 4x1 --dist real_world --block-size 64 \\
        --tokens-per-worker 256 --device cpu --dist-backend gloo \\
        --no-supervised

Each rank joins the process group once (so the trainers below share it),
then:

* runs the training CLI (:func:`train.main`) once for each ``impl:steps``
  of ``--runs``, with ``--attn-impl impl --steps steps``, and writes the
  trainer's report (``Trainer.report``: the kernels' launch counters and
  the wire's statistics counted from 0 before the run, the peak memory
  from its start, the wall of :func:`train.main`, its trainer's
  construction included) to ``DIR/<impl>/rank<r>.json``;
* with ``--grad-layers N``, builds the CLI's plain trainer at N layers
  with f32 weights, takes the stream's first batch and computes its
  share of the loss and of every parameter's gradient through each impl
  of ``--runs``, summed over the ranks (:func:`first_step`).  Rank 0
  then builds the same trainer without a process group (every frame
  stacked on its device, the same seed: the same weights and batch),
  computes the whole batch's loss and gradients there, and writes per
  impl both losses and the worst leaf's error (``max |ranked - stacked|
  / max |stacked|``) to ``DIR/grads.json``.  The AdamW moments are
  dropped first: no step is taken;
* runs the serve CLI (``launch/serve.py``) once for each ``--serve
  "KIND:REQUESTS ARGS"`` (ARGS the serve CLI's own, in one string), with
  ``--kind KIND --requests REQUESTS``: its warmup and its stream, with
  the kernels' launch counters, the wire's statistics and the peak from
  0 before it; each rank writes the report (``launch/serve.serve``: the
  tokens of every request, the programs built after warmup, the rank's
  bytes measured and priced; ``wall_s`` the stream's, ``run_wall_s``
  the loop's construction, warmup and stream) to
  ``DIR/serve_<KIND>/rank<r>.json`` and
  the last-token logits of each prefill batch's rows it holds and of the
  stream's first decode step (``ServingLoop.record``) to
  ``rank<r>_logits.pt`` beside it.

* runs the Supervisor's drills (``launch/drills.py``) once for each
  ``KIND@MESH:STEPS`` of ``--drills`` (``kill`` or ``pod``, the drill's
  ``--mesh`` and its total steps), every rank holding the drill's limits
  on a ranked Supervisor of the training CLI's model, widths, device and
  backend, with ``--drill-args`` (the CLI's own arguments, one string: a
  drill's depth, dtype and ``--checkpoint-every``) appended: worker 1
  (``kill``) or pod 1 (``pod``) dies at step ``FAIL_STEP`` (round
  ``FAIL_ROUND``), and the pod returns at ``REJOIN_STEP``; the pod drill
  trains with error-feedback compression, as the reference runner's
  does.  Each rank writes the
  drill's result (its records, recoveries, rejoin, parameters' digest)
  with the kernels' launch counters, the wire's statistics, the
  drill's seconds and the peak memory to ``DIR/drill_<KIND>/rank<r>.json``;
  the checkpoints go under ``DIR/drill_<KIND>/ckpt`` and are deleted
  after.

Every run shares the one process group, so one ``torchrun`` takes them
all (a torchrun per run cost the card's smoke about 100 s of start-up).
Serving alone (``--runs ''``, no ARGS after ``--``) takes the group's
backend and device from the first ``--serve``'s arguments.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import hashlib
import json
import os
import shlex
import shutil
import time

import torch

from .. import resolve_device
from ..kernels import flash_attention as fa
from ..optimizer import adamw
from ..runtime import wire as wirelib
from . import drills
from . import serve as S
from . import train as T
from .mesh import parse_mesh


def first_step(tr, impl: str) -> tuple[torch.Tensor, list]:
    """The loss and gradient leaves of ``tr``'s next batch through the
    executor impl ``impl``: on a ranked trainer its share of the frames,
    summed over the ranks; on a stacked one the whole batch.  Takes the
    batch and gives the loader its step back, so each call sees the same
    batch."""
    b = tr.loader.next()
    tr.loader.state.step -= 1
    batch = T.batch_arrays(b, tr.cfg, tr.device, frames=tr.frames)
    scheds = {m: T.build_schedule(tr.cfg, tr.pcfg, b.seqlens, tr.n_cp,
                                  tr.tpw, mask=m) for m in tr.group_masks}
    attn = T.attention_closures(tr.cfg, tr.pcfg, tr.layer_masks,
                                tr.group_masks, scheds, tr.device, impl,
                                tr.pods, tr.ranks)
    loss, grads = T.value_and_grad(tr.model, tr.pcfg, attn)(
        tr.state.params, batch)
    out = wirelib.all_sum([loss] + adamw.tree_leaves(grads), tr.ranks)
    return out[0], out[1:]


def leaf_error(a: list, b: list) -> float:
    """The worst leaf's ``max |a - b| / max |b|``."""
    return max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
               for x, y in zip(a, b))


def _fresh(device: torch.device) -> None:
    """Counters and the peak from 0, the last run's memory given back."""
    gc.collect()
    for f in fa.COUNTED:
        f.launches = 0
    wirelib.reset_wire_stats()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def grad_check(train_argv: list, impls: list, n_layers: int) -> dict | None:
    """The gradient check of the module docstring; its result on rank
    0, None on the others."""
    targs = T.parse_args(train_argv + [
        "--override", f"n_layers={n_layers}",
        "--override", "param_dtype=float32", "--no-supervised"])
    tr = T.trainer_from_args(targs)
    tr.state.opt = None
    try:
        ranked = {impl: first_step(tr, impl) for impl in impls}
    finally:
        tr.close()
    if tr.ranks.rank != 0:
        return None
    stacked = T.Trainer(tr.cfg, tr.pcfg, tr.tcfg, parse_mesh(targs.mesh),
                        tokens_per_worker=targs.tokens_per_worker,
                        dist=targs.dist, device=tr.device)
    stacked.state.opt = None
    out = {"n_layers": n_layers}
    try:
        for impl in impls:
            loss, grads = first_step(stacked, impl)
            r_loss, r_grads = ranked[impl]
            out[impl] = {"loss_ranked": float(r_loss), "loss": float(loss),
                         "max_leaf_err": leaf_error(r_grads, grads),
                         "finite": all(bool(torch.isfinite(g).all())
                                       for g in r_grads)}
    finally:
        stacked.close()
    return out


def serve_run(spec: str, out: str, device: torch.device) -> None:
    """One ``--serve`` run (module docstring)."""
    head, *argv = shlex.split(spec)
    kind, requests = head.split(":")
    args = S.parse_args(argv + ["--kind", kind, "--requests", requests])
    _fresh(device)
    t0 = time.perf_counter()
    loop, _ = S.loop_from_args(args)
    report = S.serve(loop, args, record=True)
    report.update(
        run_wall_s=time.perf_counter() - t0, device=str(device),
        launches={f.__name__: f.launches for f in fa.COUNTED},
        wire=wirelib.wire_stats(),
        plan_keys=sorted(hashlib.sha256(repr(k).encode()).hexdigest()[:16]
                         for k in loop.plan_cache.keys()),
        peak_mem_gib=(torch.cuda.max_memory_allocated(device) / 2**30
                      if device.type == "cuda" else None))
    run_dir = os.path.join(out, f"serve_{kind}")
    os.makedirs(run_dir, exist_ok=True)
    r = loop.ranks.rank
    with open(os.path.join(run_dir, f"rank{r}.json"), "w") as f:
        json.dump(report, f)
    torch.save(loop.record, os.path.join(run_dir, f"rank{r}_logits.pt"))
    wirelib.barrier(loop.ranks)


# the drills' loss strikes mid-step at step 3, in round 2, and the pod
# drill's pod returns at step 5 (the stacked drills' steps on the card)
FAIL_STEP, FAIL_ROUND, REJOIN_STEP = 3, 2, 5


def drill_run(spec: str, train_argv: list, drill_args: str, out: str,
              device: torch.device, ranks: wirelib.Ranks) -> None:
    """One ``--drills`` entry, ``KIND@MESH:STEPS`` (module docstring)."""
    kind, mesh_spec, steps = spec.replace("@", ":").split(":")
    if kind not in ("kill", "pod"):
        raise SystemExit(f"unknown drill {kind!r} (kill, pod)")
    total = int(steps)
    targs = T.parse_args(train_argv + shlex.split(drill_args)
                         + ["--mesh", mesh_spec])
    mesh = parse_mesh(targs.mesh)
    cfg, pcfg, tcfg = T.configs_from_args(targs)
    tcfg = dataclasses.replace(tcfg, total_steps=total,
                               grad_compression=kind == "pod")

    def make(ckpt_dir, **kw):
        return T.Supervisor(
            cfg, pcfg, tcfg, n_workers=mesh.shape["data"],
            tokens_per_worker=targs.tokens_per_worker, pods=mesh.pods,
            dist=targs.dist, checkpoint_dir=ckpt_dir, verbose=False,
            device=device, attn_impl=targs.attn_impl,
            dist_backend=targs.dist_backend, **kw)
    run_dir = os.path.join(out, f"drill_{kind}")
    root = os.path.join(run_dir, "ckpt")
    _fresh(device)
    t0 = time.perf_counter()
    if kind == "kill":
        res = drills.kill_drill(
            make, root, total=total, fail_step=FAIL_STEP, fail_worker=1,
            fail_round=FAIL_ROUND, every=pcfg.checkpoint_every)
    else:
        res = drills.pod_drill(
            make, root, total=total, fail_step=FAIL_STEP,
            fail_round=FAIL_ROUND, rejoin_step=REJOIN_STEP,
            every=pcfg.checkpoint_every)
    res.update(
        seconds=time.perf_counter() - t0, device=str(device), mesh=targs.mesh,
        launches={f.__name__: f.launches for f in fa.COUNTED},
        wire=wirelib.wire_stats(),
        peak_mem_gib=(torch.cuda.max_memory_allocated(device) / 2**30
                      if device.type == "cuda" else None))
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, f"rank{ranks.rank}.json"), "w") as f:
        json.dump(res, f, default=float)
    wirelib.barrier(ranks)
    if ranks.rank == 0:
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--runs", default="fused:3",
                   help="comma-separated impl:steps, one CLI run each")
    p.add_argument("--grad-layers", type=int, default=0,
                   help="the gradient check's depth (0: no check)")
    p.add_argument("--serve", action="append", default=[],
                   metavar="'KIND:REQUESTS ARGS'",
                   help="a serving run: its cache layout and request "
                        "count, then the serve CLI's arguments (one "
                        "string; repeatable)")
    p.add_argument("--drills", default="",
                   help="comma-separated KIND@MESH:STEPS: the "
                        "Supervisor's kill or pod drill on the training "
                        "CLI's settings, its --mesh and total steps")
    p.add_argument("--drill-args", default="",
                   help="the training CLI's arguments the drills add (one "
                        "string)")
    p.add_argument("train_argv", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    train_argv = [x for x in args.train_argv if x != "--"]
    runs = [run.split(":") for run in args.runs.split(",") if run]
    drill_specs = [d for d in args.drills.split(",") if d]
    if train_argv:
        targs = T.parse_args(train_argv)
    elif args.serve and not (runs or args.grad_layers or drill_specs):
        targs = S.parse_args(shlex.split(args.serve[0])[1:])
    else:
        raise SystemExit("the training runs need the training CLI's "
                         "arguments after --")
    env = wirelib.launch_env()
    if env is None:
        raise SystemExit("run it under torchrun (no process group)")
    device = resolve_device(T.ranked_device(targs.dist_backend,
                                            targs.device, env))
    ranks = wirelib.join(targs.dist_backend, device)
    try:
        for impl, steps in runs:
            _fresh(device)
            t0 = time.perf_counter()
            tr = T.main(train_argv + ["--attn-impl", impl, "--steps", steps])
            run_dir = os.path.join(args.out, impl)
            os.makedirs(run_dir, exist_ok=True)
            with open(os.path.join(run_dir, f"rank{ranks.rank}.json"),
                      "w") as f:
                json.dump(tr.report(time.perf_counter() - t0), f)
            del tr
        if args.grad_layers:
            _fresh(device)
            out = grad_check(train_argv, [impl for impl, _ in runs],
                             args.grad_layers)
            if out is not None:
                with open(os.path.join(args.out, "grads.json"), "w") as f:
                    json.dump(out, f)
        for spec in args.serve:
            serve_run(spec, args.out, device)
        for spec in drill_specs:
            drill_run(spec, train_argv, args.drill_args, args.out, device,
                      ranks)
    finally:
        wirelib.barrier(ranks)
        wirelib.leave()


if __name__ == "__main__":
    main()
