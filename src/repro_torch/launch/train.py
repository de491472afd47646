"""Training step assembly + CLI entry point on stacked workers (port of
``repro.launch.train``; the dense, MoE, SSM and hybrid families: the
hybrid's shared attention block takes one FCP closure, every invocation
on the same plan; the SSM family plans no attention).

``build_train_step`` wires: FCP schedule -> attention closure over the
stacked-worker executor -> model loss -> gradients (``torch.autograd``
over the parameter leaves, the port's ``value_and_grad``) -> optional
error-feedback bf16 compression -> AdamW.  PyTorch runs eagerly, so
there is no ``jit`` to cache: the loop caches the attention closure and
step function per plan key instead.

``--attn-impl`` takes the reference's four names (``core.executor``):
``fused`` (the default here: CUDA kernels 1, 3 and 4), ``pallas``
(kernels 2, 5 and 6), and ``fused_xla`` / ``xla`` (the same groupings
on the plain PyTorch versions).  Unlike the reference, the port runs
FCP on a one-worker mesh too, so on the card training always goes
through the kernels.

CLI:  PYTHONPATH=src python -m repro_torch.launch.train \\
          --arch stablelm_1_6b --mesh 4x1 --dist real_world \\
          --block-size 512 --tokens-per-worker 2048 --steps 3
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import time
import warnings
from typing import Callable

import numpy as np
import torch

from .. import resolve_device
from ..configs.base import (ModelConfig, ParallelConfig, TrainConfig,
                            apply_overrides, get_config, smoke_config)
from ..core import executor as ex
from ..core import plan_cache as pc
from ..core.schedule import Schedule, make_schedule
from ..data.loader import Batch, SyntheticLoader
from ..masks import MaskSpec, coerce_mask, parse_mask
from ..models import Model
from ..optimizer import adamw, schedules
from ..runtime import compression
from .mesh import StackedMesh


def make_fcp_attn_fn(sched: Schedule, device, pcfg: ParallelConfig,
                     impl: str = "fused") -> Callable:
    """``attn(q, k, v)`` over ``[F, T, H, D]`` frames through the FCP
    executor on stacked workers (frame = worker), with the executor impl
    ``impl``.  ``pcfg.attention_impl`` is not read: the copied
    ``ParallelConfig`` defaults it to the reference's ``"xla"``, and the
    port's default is the kernels."""
    tables = ex.schedule_tables(sched, device)
    cfg_exec = ex.ExecConfig(
        impl=impl,
        out_dtype="bfloat16" if pcfg.attn_out_bf16 else None)

    def attn(q, k, v):
        return ex.fcp_attention(q, k, v, tables, spec=sched.spec,
                                cfg=cfg_exec)
    return attn


def layer_mask_specs(cfg: ModelConfig, pcfg: ParallelConfig
                     ) -> tuple[MaskSpec, ...]:
    """Per-layer mask family: the model config's ``attn_mask_pattern``
    (cycled over the stack) when present, else the run-wide
    ``ParallelConfig.attn_mask`` for every layer."""
    n = max(cfg.n_layers, 1)
    if getattr(cfg, "attn_mask_pattern", ()):
        pat = [parse_mask(str(s)) for s in cfg.attn_mask_pattern]
        return tuple(pat[i % len(pat)] for i in range(n))
    return (coerce_mask(pcfg.attn_mask),) * n


def param_dtype_bytes(cfg: ModelConfig) -> int:
    """Itemsize of the compute dtype the executor's payloads ship in
    (q/k/v inherit ``param_dtype``): prices the wire in real bytes."""
    return getattr(torch, cfg.param_dtype).itemsize


def build_schedule(cfg: ModelConfig, pcfg: ParallelConfig, seqlens,
                   n_cp: int, tokens_per_worker: int,
                   speeds: np.ndarray | None = None,
                   mask=True, verify: bool | None = None) -> Schedule:
    tp = 1  # schedule is head-count agnostic (costs scale uniformly)
    nh, nkv = cfg.padded_heads(tp)
    return make_schedule(
        seqlens, n_cp, tokens_per_worker, pcfg.block_size,
        n_q_heads=max(nh, 1), n_kv_heads=max(nkv, 1),
        head_dim=max(cfg.head_dim, 1), mask=mask, speeds=speeds,
        coalesce=pcfg.coalesce, wire=pcfg.comm_dtype,
        in_dtype_bytes=pcfg.in_dtype_bytes, overlap=pcfg.overlap,
        locality={"auto": "auto", "on": True, "off": False}.get(
            str(pcfg.locality), pcfg.locality),
        verify=verify)


def schedule_plan_key(cfg: ModelConfig, pcfg: ParallelConfig, seqlens,
                      n_cp: int, tokens_per_worker: int,
                      speeds: np.ndarray | None = None,
                      mask=True) -> tuple:
    """Plan-cache key matching :func:`build_schedule`'s determinism."""
    nh, nkv = cfg.padded_heads(1)
    return pc.plan_key(
        seqlens, n_cp, tokens_per_worker, pcfg.block_size,
        mask=mask, coalesce=pcfg.coalesce, locality=pcfg.locality,
        speeds=speeds, wire=pcfg.comm_dtype,
        in_dtype_bytes=pcfg.in_dtype_bytes, overlap=pcfg.overlap,
        extra=(max(nh, 1), max(nkv, 1), max(cfg.head_dim, 1)))


@dataclasses.dataclass
class TrainState:
    params: dict
    opt: adamw.AdamWState
    residual: dict | None = None           # grad-compression feedback


def value_and_grad(model: Model, pcfg: ParallelConfig, attn_fn):
    """``fn(params, batch) -> (loss, grads)``: the model loss and its
    gradient for every parameter leaf (``torch.autograd.grad``; leaves
    that do not require grad yet are switched on)."""
    remat = pcfg.remat_policy if pcfg.remat else False

    def fn(params, batch):
        leaves = adamw.tree_leaves(params)
        for p in leaves:
            if not p.requires_grad:
                p.requires_grad_(True)
        loss = model.loss(params, batch, attn_fn, remat=remat,
                          chunked=pcfg.chunked_loss)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), adamw.tree_unflatten(params, list(grads))
    return fn


def build_train_step(model: Model, mesh, pcfg: ParallelConfig,
                     tcfg: TrainConfig, attn_fn: Callable | None):
    """``train_step(params, opt, residual, batch) -> (params, opt,
    residual, loss, gnorm)``; the parameters and moments are updated in
    place (``optimizer.adamw``).  ``mesh`` is kept for the reference's
    signature: on stacked workers nothing is sharded."""
    loss_and_grads = value_and_grad(model, pcfg, attn_fn)

    def train_step(params, opt, residual, batch):
        lr = schedules.warmup_cosine(
            opt.step, peak_lr=tcfg.lr, warmup_steps=tcfg.warmup_steps,
            total_steps=tcfg.total_steps)
        loss, grads = loss_and_grads(params, batch)
        if tcfg.grad_compression:
            # bf16 error-feedback compression (runtime/compression.py)
            grads, residual = compression.compress_grads(grads, residual)
            grads = compression.decompress_grads(grads)
        params, opt, gnorm = adamw.update(
            params, grads, opt, lr=lr, b1=tcfg.b1, b2=tcfg.b2,
            weight_decay=tcfg.weight_decay, grad_clip=tcfg.grad_clip)
        return params, opt, residual, loss, gnorm

    return train_step


def batch_arrays(b: Batch, cfg: ModelConfig, device="cuda") -> dict:
    """A loader batch as tensors on ``device``."""
    if cfg.frontend_dim:
        raise NotImplementedError(
            "the multimodal front end (frontend_dim) is not ported yet")
    return {
        "tokens": torch.from_numpy(np.asarray(b.tokens)).to(device),
        "labels": torch.from_numpy(np.asarray(b.labels)).to(device),
        "positions": torch.from_numpy(np.asarray(b.positions)).to(device),
        "loss_mask": torch.from_numpy(
            np.asarray(b.loss_mask, np.float32)).to(device),
    }


def route_layers(cfg: ModelConfig, layer_masks, group_masks, fn_of_mask):
    """One shared attention closure when the model is mask-uniform, else
    the per-layer sequence the model unrolls over (per-layer-group
    scheduling)."""
    if len(group_masks) == 1:
        return fn_of_mask(group_masks[0])
    if cfg.family not in ("dense", "moe", "audio", "vlm"):
        raise ValueError(
            f"per-layer attention-mask patterns are not supported for "
            f"family {cfg.family!r} (shared/absent attention)")
    by_mask = {m: fn_of_mask(m) for m in group_masks}
    return tuple(by_mask[m] for m in layer_masks)


@dataclasses.dataclass
class StepRecord:
    step: int
    loss: float
    gnorm: float
    ms: float                       # wall, the device synchronized


class Trainer:
    """The plain training loop of the CLI (the reference's ``main`` loop
    without the ``Supervisor``): a plan cache with plan-ahead (batch
    t+1 is planned on a host thread while t runs), one attention
    closure and step function per plan key, random weights from a
    seeded ``torch.Generator``.  ``attn_impl`` is the executor impl
    (default ``"fused"``: the kernels on the card)."""

    def __init__(self, cfg: ModelConfig, pcfg: ParallelConfig,
                 tcfg: TrainConfig, mesh: StackedMesh, *,
                 tokens_per_worker: int, dist: str, fresh: bool = False,
                 device="cuda", log_every: int = 1,
                 attn_impl: str = "fused"):
        self.device = resolve_device(device)
        self.attn_impl = ex.ExecConfig(impl=attn_impl).impl
        self.cfg, self.pcfg, self.tcfg, self.mesh = cfg, pcfg, tcfg, mesh
        self.n_cp = mesh.shape.get("data", 1)
        self.tpw = tokens_per_worker
        self.log_every = max(int(log_every), 1)
        self.model = Model(cfg, tp=mesh.shape.get("model", 1))
        self.loader = SyntheticLoader(
            dist=dist, n_frames=self.n_cp, tokens_per_worker=tokens_per_worker,
            vocab_size=cfg.vocab_size, seed=tcfg.seed,
            plan_buckets=pcfg.plan_buckets, bucket_min_len=pcfg.block_size,
            fresh=fresh)
        gen = torch.Generator(device=self.device).manual_seed(tcfg.seed)
        params = self.model.init(gen, self.device)
        for p in adamw.tree_leaves(params):
            p.requires_grad_(True)
        self.state = TrainState(
            params, adamw.init(params),
            compression.init_residuals(params) if tcfg.grad_compression
            else None)
        self.plan_cache = pc.PlanCache(pcfg.plan_cache_size)
        self.planner = pc.PlanAheadPlanner(self.plan_cache,
                                           enabled=pcfg.plan_ahead)
        # per-layer-group scheduling: one FCP schedule (and one plan-cache
        # key) per distinct mask family; layers route to their group's
        # attention closure
        self.layer_masks = layer_mask_specs(cfg, pcfg)
        self.group_masks = list(dict.fromkeys(self.layer_masks))
        self.step_cache: dict = {}
        self.history: list[StepRecord] = []

    def _plan_of(self, seqlens, mask):
        key = schedule_plan_key(self.cfg, self.pcfg, seqlens, self.n_cp,
                                self.tpw, mask=mask)
        build = functools.partial(build_schedule, self.cfg, self.pcfg,
                                  seqlens, self.n_cp, self.tpw, mask=mask)
        return key, build

    def step_fn(self, b: Batch, prefetch: bool = True):
        """The step function of batch ``b``'s plan (planned, or taken
        from the cache); prefetches the next batch's plan when
        ``prefetch``.  An attention-free model (SSM) plans nothing."""
        scheds: dict[MaskSpec, Schedule] = {}
        keys = []
        nxt = self.loader.peek_seqlens() if prefetch else None
        for m in self.group_masks if self.cfg.uses_attention else ():
            key_m, build_m = self._plan_of(b.seqlens, m)
            scheds[m] = self.planner.get(key_m, build_m)
            keys.append(key_m)
            if nxt is not None:
                self.planner.prefetch(*self._plan_of(nxt, m))
        key = tuple(keys)
        if key not in self.step_cache:
            attn = route_layers(
                self.cfg, self.layer_masks, self.group_masks,
                lambda m: make_fcp_attn_fn(scheds[m], self.device,
                                           self.pcfg, self.attn_impl)
            ) if self.cfg.uses_attention else None
            self.step_cache[key] = build_train_step(
                self.model, self.mesh, self.pcfg, self.tcfg, attn)
            while len(self.step_cache) > max(self.pcfg.plan_cache_size, 1):
                self.step_cache.pop(next(iter(self.step_cache)))
        return self.step_cache[key]

    def step(self) -> StepRecord:
        t = len(self.history)
        b = self.loader.next()
        batch = batch_arrays(b, self.cfg, self.device)
        fn = self.step_fn(b, prefetch=t + 1 < self.tcfg.total_steps)
        s = self.state
        t0 = time.perf_counter()
        s.params, s.opt, s.residual, loss, gnorm = fn(
            s.params, s.opt, s.residual, batch)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        rec = StepRecord(t, float(loss), float(gnorm),
                         (time.perf_counter() - t0) * 1e3)
        self.history.append(rec)
        if t % self.log_every == 0:
            print(f"step {t:5d}  loss {rec.loss:.4f}  gnorm "
                  f"{rec.gnorm:.3f}  {rec.ms:.1f} ms", flush=True)
        return rec

    def run(self, steps: int) -> list[StepRecord]:
        return [self.step() for _ in range(steps)]

    def close(self) -> None:
        self.planner.shutdown()


# flags kept for the reference CLI's parity that the port does not read:
# setting one to anything but its default warns
PARITY_ONLY_FLAGS = ("shape", "attn_block_q", "attn_block_k",
                     "attn_interpret", "checkpoint_every", "health_window",
                     "straggler_threshold", "step_timeout",
                     "demote_cooldown")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True,
                   help="a config of repro_torch/configs of a ported "
                        "family: dense (stablelm_1_6b, codeqwen1_5_7b, "
                        "llama3_70b, qwen1_5_32b/110b), MoE "
                        "(granite_moe_3b_a800m, moonshot_v1_16b_a3b), SSM "
                        "(mamba2_130m) or hybrid (zamba2_2_7b)")
    p.add_argument("--shape", default=None,
                   help="assigned shape cell (accepted for parity; the "
                        "loop does not read it and warns when it is set)")
    p.add_argument("--smoke", action="store_true",
                   help="use the reduced smoke config")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--mesh", default="1x1",
                   help="DxM (data x model) stacked mesh; a pod mesh PxDxM"
                        " is not ported and raises")
    p.add_argument("--dist", default="uniform",
                   choices=["uniform", "real_world", "less_long_tailed",
                            "bimodal"])
    p.add_argument("--block-size", type=int, default=1024)
    p.add_argument("--attn-impl", default="fused",
                   choices=["xla", "pallas", "fused", "fused_xla"],
                   help="executor attention: one launch per run (fused ="
                        " CUDA kernels 1/3/4, fused_xla = their plain"
                        " versions) or one per step index (pallas = CUDA"
                        " kernels 2/5/6, xla = plain versions)")
    p.add_argument("--attn-block-q", type=int, default=256,
                   help="accepted for parity (warns when set): the CUDA"
                        " kernels fix their own tiles")
    p.add_argument("--attn-block-k", type=int, default=256,
                   help="accepted for parity (warns when set): the CUDA"
                        " kernels fix their own tiles")
    p.add_argument("--attn-interpret", action="store_true",
                   help="accepted for parity (warns when set): Pallas"
                        " interpret mode has no counterpart (CPU tensors"
                        " take the plain versions)")
    p.add_argument("--attn-mask", default="causal",
                   help="run-wide attention-mask family: causal | full |"
                        " swa:4096 | chunked:8192")
    p.add_argument("--coalesce", type=int, default=16,
                   help="bottom-up coalescer degree C (1 = off)")
    p.add_argument("--comm-dtype", default="f32",
                   choices=["f32", "bf16", "int8"],
                   help="wire format of every FCP ship (forward and"
                        " backward)")
    p.add_argument("--overlap", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="software-pipelined executor rounds: not ported,"
                        " raises")
    p.add_argument("--layer-pipeline",
                   action=argparse.BooleanOptionalAction, default=False,
                   help="layer-pipelined reshuffle: not ported, raises")
    p.add_argument("--plan-buckets", type=int, default=0,
                   help="canonical length-bucket edges per doubling"
                        " (0 = raw lengths)")
    p.add_argument("--plan-cache-size", type=int, default=64,
                   help="LRU capacity of the schedule/plan cache")
    p.add_argument("--plan-ahead", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="plan batch t+1 on a host thread while t runs")
    p.add_argument("--fresh-stream", action="store_true",
                   help="sample a new composition every step")
    p.add_argument("--tokens-per-worker", type=int, default=8192)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--override", action="append", default=[])
    p.add_argument("--checkpoint-dir", default=None,
                   help="checkpointing: not ported, raises")
    p.add_argument("--checkpoint-every", type=int, default=10,
                   help="checkpoint cadence (accepted for parity; warns"
                        " when set)")
    p.add_argument("--supervised", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="the reference's fault-tolerant Supervisor loop"
                        " (its default): not ported yet, so the default"
                        " here is off and passing it raises (ROADMAP"
                        " Queue A item 4)")
    p.add_argument("--health-window", type=int, default=8,
                   help="Supervisor knob (accepted for parity; warns when"
                        " set)")
    p.add_argument("--straggler-threshold", type=float, default=0.8,
                   help="Supervisor knob (accepted for parity; warns when"
                        " set)")
    p.add_argument("--step-timeout", type=float, default=60.0,
                   help="Supervisor knob (accepted for parity; warns when"
                        " set)")
    p.add_argument("--demote-cooldown", type=int, default=16,
                   help="Supervisor knob (accepted for parity; warns when"
                        " set)")
    p.add_argument("--log-every", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch versions of the kernels)")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    return build_parser().parse_args(argv)


def trainer_from_args(args: argparse.Namespace) -> Trainer:
    """The CLI's :class:`Trainer` (raises for what is not ported, warns
    for a parity-only flag set to anything but its default)."""
    parser = build_parser()
    for name in PARITY_ONLY_FLAGS:
        if getattr(args, name) != parser.get_default(name):
            warnings.warn(f"--{name.replace('_', '-')} is accepted for the "
                          f"reference CLI's parity and has no effect here",
                          stacklevel=2)
    if args.supervised:
        raise NotImplementedError(
            "--supervised: the elastic Supervisor loop is not ported yet "
            "(ROADMAP Queue A item 4); the plain loop is the default")
    for flag, on in (("--layer-pipeline", args.layer_pipeline),
                     ("--overlap", args.overlap),
                     ("--checkpoint-dir", args.checkpoint_dir)):
        if on:
            raise NotImplementedError(f"{flag} is not ported yet "
                                      f"(ROADMAP Queue A)")
    dims = [int(x) for x in args.mesh.split("x")]
    if len(dims) == 3:
        raise NotImplementedError("pod meshes (PxDxM) are not ported yet")
    if len(dims) != 2:
        raise SystemExit("--mesh must be DxM")
    device = resolve_device(args.device)
    mesh = StackedMesh(tuple(dims), ("data", "model"))
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = apply_overrides(cfg, args.override)
    pcfg = ParallelConfig(block_size=args.block_size,
                          coalesce=args.coalesce,
                          attention_impl=args.attn_impl,
                          attn_block_q=args.attn_block_q,
                          attn_block_k=args.attn_block_k,
                          attn_interpret=args.attn_interpret,
                          attn_mask=args.attn_mask,
                          comm_dtype=args.comm_dtype,
                          in_dtype_bytes=param_dtype_bytes(cfg),
                          plan_buckets=args.plan_buckets,
                          plan_cache_size=args.plan_cache_size,
                          plan_ahead=args.plan_ahead,
                          checkpoint_every=args.checkpoint_every)
    tcfg = TrainConfig(lr=args.lr, warmup_steps=2, total_steps=args.steps)
    return Trainer(cfg, pcfg, tcfg, mesh,
                   tokens_per_worker=args.tokens_per_worker, dist=args.dist,
                   fresh=args.fresh_stream, device=device,
                   log_every=args.log_every, attn_impl=args.attn_impl)


def main(argv=None) -> Trainer:
    args = parse_args(argv)
    trainer = trainer_from_args(args)
    try:
        trainer.run(args.steps)
    finally:
        trainer.close()
    s = trainer.plan_cache.stats
    print(f"plan cache: {s.hits} hits / {s.misses} misses "
          f"(hit rate {s.hit_rate:.2f}), "
          f"{trainer.plan_cache.n_unique_specs} static specs, "
          f"{trainer.planner.prefetched_hits} plan-ahead builds consumed")
    print("done.")
    return trainer


if __name__ == "__main__":
    main()
