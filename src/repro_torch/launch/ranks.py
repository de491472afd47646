"""The training CLI across ranks, checked: its runs under each executor
impl, and its first step's gradients against one process's.

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
  dropped first: no step is taken.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import time

import torch

from .. import resolve_device
from ..kernels import flash_attention as fa
from ..optimizer import adamw
from ..runtime import wire as wirelib
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
        "--override", "param_dtype=float32"])
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


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--runs", default="fused:3",
                   help="comma-separated impl:steps, one CLI run each")
    p.add_argument("--grad-layers", type=int, default=0,
                   help="the gradient check's depth (0: no check)")
    p.add_argument("train_argv", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    train_argv = [x for x in args.train_argv if x != "--"]
    targs = T.parse_args(train_argv)
    env = wirelib.launch_env()
    if env is None:
        raise SystemExit("run it under torchrun (no process group)")
    device = resolve_device(T.ranked_device(targs.dist_backend,
                                            targs.device, env))
    ranks = wirelib.join(targs.dist_backend, device)
    runs = [run.split(":") for run in args.runs.split(",")]
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
    finally:
        wirelib.barrier(ranks)
        wirelib.leave()


if __name__ == "__main__":
    main()
