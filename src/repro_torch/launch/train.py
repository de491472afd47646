"""Training step assembly + CLI entry point on stacked workers (port of
``repro.launch.train``; the dense, MoE, SSM and hybrid families: the
hybrid's shared attention block takes one FCP closure, every invocation
on the same plan; the SSM family plans no attention).

``build_train_step`` wires: FCP schedule -> attention closure over the
stacked-worker executor -> model loss -> gradients (``torch.autograd``
over the parameter leaves, the port's ``value_and_grad``) -> optional
error-feedback bf16 compression -> AdamW.  PyTorch runs eagerly, so
there is no ``jit`` to cache: the loops cache the attention closure and
step function per plan key instead.

Two loops, routed as the reference routes them: FCP runs with more than
one CP worker and no model axis go through the fault-tolerant
:class:`Supervisor` (``--supervised``, on by default: health telemetry,
straggler demotion, worker-loss recovery from checkpoints), everything
else through the plain :class:`Trainer`.  Both take ``--overlap`` (the
double-buffered round loop), ``--layer-pipeline`` (the hidden state
moves once per layer group: :class:`PipelinedAttn`) and
``--checkpoint-dir`` (periodic saves, resume from the newest committed
step).  Pod meshes (PxDxM) are not ported (ROADMAP Queue A item 7).

``--attn-impl`` takes the reference's four names (``core.executor``):
``fused`` (the default here: CUDA kernels 1, 3 and 4), ``pallas``
(kernels 2, 5 and 6), and ``fused_xla`` / ``xla`` (the same groupings
on the plain PyTorch versions).  Unlike the reference, the port runs
FCP on a one-worker mesh too, so on the card training always goes
through the kernels.

CLI:  PYTHONPATH=src python -m repro_torch.launch.train \\
          --arch stablelm_1_6b --mesh 4x1 --dist real_world \\
          --block-size 512 --tokens-per-worker 2048 --attn-impl fused
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
from ..checkpoint.manager import CheckpointManager
from ..configs.base import (ModelConfig, ParallelConfig, TrainConfig,
                            apply_overrides, get_config, smoke_config)
from ..core import executor as ex
from ..core import plan_cache as pc
from ..core.schedule import Schedule, make_schedule
from ..data.loader import Batch, LoaderState, SyntheticLoader
from ..masks import MaskSpec, coerce_mask, parse_mask
from ..models import Model
from ..optimizer import adamw, schedules
from ..runtime import compression
from ..runtime import elastic
from ..runtime import health as health_mod
from .mesh import StackedMesh

POD_MESHES = ("pod meshes (PxDxM), the pod drill, overlapping recovery "
              "and rejoin are not ported yet (ROADMAP Queue A item 7)")


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


@dataclasses.dataclass
class PipelinedAttn:
    """One per-layer entry of the layer-pipelined reshuffle (consumed
    duck-typed by :func:`repro_torch.models.transformer.forward`).

    ``attn`` runs FCP attention with ``layout="sched"`` (no per-layer
    Q/K/V reshuffle or O restore); ``enter``/``exit`` — set only on the
    first/last layer of a same-mask layer group — move the hidden state
    (and rope positions) between the stream and schedule layouts via
    :func:`repro_torch.core.executor.fcp_reshuffle`."""
    attn: Callable
    enter: Callable | None = None
    exit: Callable | None = None


def make_pipelined_attn_fns(cfg: ModelConfig, pcfg: ParallelConfig,
                            layer_masks, scheds, device,
                            impl: str = "fused") -> tuple:
    """Per-layer :class:`PipelinedAttn` entries: the hidden state stays
    resident in the schedule layout across each run of consecutive
    same-mask layers and moves once per group boundary, so N layers pay
    one reshuffle + one restore instead of N of each.  Positions ride
    the move as one extra f32 channel (token positions are < 2**24, so
    the f32 wire carries them exactly).  Model-level transform only —
    schedules and plan keys are those of the non-pipelined run."""
    if cfg.family not in ("dense", "moe", "audio", "vlm"):
        raise ValueError(
            f"layer_pipeline is not supported for family "
            f"{cfg.family!r} (shared/absent attention)")
    cfg_exec = ex.ExecConfig(
        impl=impl, out_dtype="bfloat16" if pcfg.attn_out_bf16 else None)

    def group_fns(m):
        sched = scheds[m]
        tables, spec = ex.schedule_tables(sched, device), sched.spec

        def attn(q, k, v):
            return ex.fcp_attention(q, k, v, tables, spec=spec,
                                    cfg=cfg_exec, layout="sched")

        def enter(x, pos):
            xp = torch.cat([x.to(torch.float32),
                            pos.to(torch.float32)[..., None]], dim=-1)
            xp = ex.fcp_reshuffle(xp, tables, spec=spec)
            # exact round trips: bf16 values survive the f32 wire, and
            # integer positions recover via round
            return (xp[..., :-1].to(x.dtype),
                    torch.round(xp[..., -1]).to(pos.dtype))

        def exit_(x):
            y = ex.fcp_reshuffle(x.to(torch.float32), tables, spec=spec,
                                 reverse=True)
            return y.to(x.dtype)

        return attn, enter, exit_

    by_mask = {m: group_fns(m) for m in dict.fromkeys(layer_masks)}
    n = len(layer_masks)
    entries = []
    for i, m in enumerate(layer_masks):
        attn, enter, exit_ = by_mask[m]
        first = i == 0 or layer_masks[i - 1] != m
        last = i == n - 1 or layer_masks[i + 1] != m
        entries.append(PipelinedAttn(attn=attn,
                                     enter=enter if first else None,
                                     exit=exit_ if last else None))
    return tuple(entries)


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


def init_state(model: Model, tcfg: TrainConfig, device) -> TrainState:
    """Random weights from a ``torch.Generator`` seeded with
    ``tcfg.seed`` (a pure function of the seed: the checkpointless
    recovery draws them again), zero AdamW moments, and the
    error-feedback residuals when compression is on."""
    gen = torch.Generator(device=device).manual_seed(tcfg.seed)
    params = model.init(gen, device)
    for p in adamw.tree_leaves(params):
        p.requires_grad_(True)
    return TrainState(
        params, adamw.init(params),
        compression.init_residuals(params) if tcfg.grad_compression
        else None)


def restore_state(manager: CheckpointManager, state: TrainState,
                  loader: SyntheticLoader) -> int:
    """Copy the newest intact committed checkpoint into ``state`` (in
    place: the step closures hold no parameter) and rewind the loader
    with it; returns the step to resume at."""
    tree, extra = manager.restore({"params": state.params,
                                   "opt": state.opt})
    with torch.no_grad():
        for dst, src in zip(
                adamw.tree_leaves({"params": state.params,
                                   "m": state.opt.m, "v": state.opt.v}),
                adamw.tree_leaves({"params": tree["params"],
                                   "m": tree["opt"].m, "v": tree["opt"].v})):
            dst.copy_(src)
        state.opt.step.copy_(tree["opt"].step)
    loader.state = LoaderState.from_dict(extra["loader"])
    return int(extra["step"]) + 1


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
            "the multimodal front end (frontend_dim) is not ported yet "
            "(ROADMAP Queue A item 5)")
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


def attention_closures(cfg: ModelConfig, pcfg: ParallelConfig,
                       layer_masks, group_masks, scheds, device,
                       impl: str):
    """The attention argument of the model for a batch's plans: the
    layer-pipelined entries under ``pcfg.layer_pipeline``, else one FCP
    closure per mask group routed to its layers; None for an
    attention-free model."""
    if not cfg.uses_attention:
        return None
    if pcfg.layer_pipeline:
        return make_pipelined_attn_fns(cfg, pcfg, layer_masks, scheds,
                                       device, impl)
    return route_layers(
        cfg, layer_masks, group_masks,
        lambda m: make_fcp_attn_fn(scheds[m], device, pcfg, impl))


@dataclasses.dataclass
class StepRecord:
    """One committed step, for drills and benches to diff against."""
    step: int
    loss: float
    gnorm: float
    ms: float                       # wall, the device synchronized
    n_workers: int = 1


class Trainer:
    """The plain training loop of the CLI (the reference's ``main`` loop
    without the ``Supervisor``): a plan cache with plan-ahead (batch
    t+1 is planned on a host thread while t runs), one attention
    closure and step function per plan key, random weights from a
    seeded ``torch.Generator``.  ``attn_impl`` is the executor impl
    (default ``"fused"``: the kernels on the card).  With
    ``checkpoint_dir`` it saves ``{"params", "opt"}`` and the loader
    state every ``pcfg.checkpoint_every`` steps, and a new trainer on
    the same directory resumes from the newest committed step."""

    def __init__(self, cfg: ModelConfig, pcfg: ParallelConfig,
                 tcfg: TrainConfig, mesh: StackedMesh, *,
                 tokens_per_worker: int, dist: str, fresh: bool = False,
                 device="cuda", log_every: int = 1,
                 attn_impl: str = "fused", checkpoint_dir=None):
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
        self.state = init_state(self.model, tcfg, self.device)
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
        self.manager = (CheckpointManager(checkpoint_dir)
                        if checkpoint_dir else None)
        # the step the first record takes: a resumed run starts past the
        # newest committed checkpoint
        self.start = 0
        if self.manager is not None and self.manager.latest_step() is not None:
            self.start = restore_state(self.manager, self.state, self.loader)

    @property
    def next_step(self) -> int:
        return self.start + len(self.history)

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
            attn = attention_closures(self.cfg, self.pcfg, self.layer_masks,
                                      self.group_masks, scheds, self.device,
                                      self.attn_impl)
            self.step_cache[key] = build_train_step(
                self.model, self.mesh, self.pcfg, self.tcfg, attn)
            while len(self.step_cache) > max(self.pcfg.plan_cache_size, 1):
                self.step_cache.pop(next(iter(self.step_cache)))
        return self.step_cache[key]

    def step(self) -> StepRecord:
        t = self.next_step
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
                         (time.perf_counter() - t0) * 1e3, self.n_cp)
        self.history.append(rec)
        if t % self.log_every == 0:
            print(f"step {t:5d}  loss {rec.loss:.4f}  gnorm "
                  f"{rec.gnorm:.3f}  {rec.ms:.1f} ms", flush=True)
        every = max(int(self.pcfg.checkpoint_every), 1)
        if self.manager is not None and (t + 1) % every == 0:
            # the host copy now, the file IO on a thread
            self.manager.save(t, {"params": s.params, "opt": s.opt},
                              extra={"loader": self.loader.state.to_dict()},
                              blocking=False)
        return rec

    def run(self, total_steps: int) -> list[StepRecord]:
        """Train until ``total_steps`` steps are committed (a resumed
        run counts the checkpointed ones); returns this call's
        records."""
        return [self.step() for _ in range(total_steps - self.next_step)]

    def close(self) -> None:
        self.planner.shutdown()
        if self.manager is not None:
            self.manager.wait()


# --------------------------------------------------------------------------
# fault-tolerant supervised loop (runtime health closed loop)
# --------------------------------------------------------------------------

class Supervisor:
    """Fault-tolerant elastic FCP training loop for one pod (port of
    the reference's ``Supervisor``).

    Owns the train state, a *geometry-pinned* data loader, a
    :class:`~repro_torch.runtime.health.HealthMonitor`, a shared plan
    cache (+ plan-ahead thread) and an optional checkpoint manager, and
    closes the measurement -> placement -> recovery loop around the
    train step:

    * **healthy path** — the plain loop's work (plan cache, plan-ahead,
      a bounded step-closure cache) plus one device-synchronized wall
      clock per step (``executor.timed_call``).  The monitor's planning
      speeds stay ``None`` while healthy, so plan keys are those of a
      monitor-less run.
    * **straggler path** — when the monitor's hysteresis window fills,
      its latched quantized speeds flow into cache-backed
      ``elastic.replan(speeds=...)``; demote/promote events are
      rate-limited (``demote_cooldown``).
    * **loss path** — on :class:`~repro_torch.runtime.health.WorkerLoss`
      or :class:`~repro_torch.runtime.elastic.InjectedFailure` the
      stacked worker count shrinks to the survivors (``elastic.replan``
      on the survivor set), error-feedback residuals reset, the newest
      *intact* committed checkpoint restores, and the deterministic data
      stream replays — losing at most ``checkpoint_every`` steps.

    The loader is pinned to the original ``n_workers x
    tokens_per_worker`` geometry: the global token stream is a pure
    function of ``(seed, step)``, and survivor fleets view it through
    ``elastic.reshape_pod_frames``.  Without a checkpoint, recovery
    replays from step 0 with the initial weights drawn again from the
    seed (the reference holds a host copy of them).  Pods (``pods >
    1``, :class:`~repro_torch.runtime.health.PodLoss`, the regrow
    prewarm and rejoin) are not ported and raise."""

    def __init__(self, cfg: ModelConfig, pcfg: ParallelConfig,
                 tcfg: TrainConfig, *, n_workers: int,
                 tokens_per_worker: int, pods: int = 1,
                 dist: str = "uniform", uniform_len: int = 1024,
                 fresh: bool = False, checkpoint_dir=None,
                 checkpoint_keep: int = 3,
                 monitor: health_mod.HealthMonitor | None = None,
                 start_fleet=None, verbose: bool = True, device="cuda",
                 attn_impl: str = "fused"):
        if int(pods) != 1 or isinstance(start_fleet, tuple):
            raise NotImplementedError(POD_MESHES)
        self.device = resolve_device(device)
        self.attn_impl = ex.ExecConfig(impl=attn_impl).impl
        self.cfg, self.pcfg, self.tcfg = cfg, pcfg, tcfg
        self.n0 = int(n_workers)
        self.tpw0 = int(tokens_per_worker)
        # start_fleet: None = full strength, or a worker count
        self.n = self.n0 if start_fleet is None else int(start_fleet)
        self.verbose = verbose
        if not (cfg.uses_attention and cfg.n_layers):
            raise ValueError("Supervisor drives FCP attention models")
        self.model = Model(cfg, tp=1)
        self.loader = SyntheticLoader(
            dist=dist, n_frames=self.n0, tokens_per_worker=self.tpw0,
            vocab_size=cfg.vocab_size, seed=tcfg.seed,
            uniform_len=uniform_len, plan_buckets=pcfg.plan_buckets,
            bucket_min_len=pcfg.block_size, fresh=fresh)
        self.monitor = monitor or health_mod.HealthMonitor.from_pcfg(
            self.n, pcfg, topology=health_mod.FleetTopology(1, self.n))
        self.plan_cache = pc.PlanCache(pcfg.plan_cache_size)
        self.planner = pc.PlanAheadPlanner(self.plan_cache,
                                           enabled=pcfg.plan_ahead)
        # checkpoint_keep: GC window.  Drills that replay a recovery
        # against a pruned copy of the directory widen it so the
        # resume-step checkpoint survives to the end of the run.
        self.manager = (CheckpointManager(checkpoint_dir,
                                          keep_n=checkpoint_keep)
                        if checkpoint_dir else None)
        self.state = init_state(self.model, tcfg, self.device)
        self.layer_masks = layer_mask_specs(cfg, pcfg)
        self.group_masks = list(dict.fromkeys(self.layer_masks))
        nh, nkv = cfg.padded_heads(1)
        self._heads = (max(nh, 1), max(nkv, 1), max(cfg.head_dim, 1))
        self._step_cache: dict = {}
        self.compiled_at: list[int] = []     # steps that built a closure
        self.history: list[StepRecord] = []
        self.recoveries: list[dict] = []
        self.last_scheds: dict = {}

    # -- geometry ----------------------------------------------------------

    def _fleet_batch(self, b: Batch, n: int, tpw: int) -> Batch:
        """Re-view the pinned-geometry batch on ``n`` stacked workers:
        the same token stream, padding re-derived (segment ids pad with
        -1 so padding never aliases a document)."""
        n_valid = int(sum(b.seqlens))

        def rs(a, fill=0):
            return elastic.reshape_pod_frames(a, 1, 1, n, tpw,
                                              n_valid=n_valid, fill=fill)
        return Batch(tokens=rs(b.tokens), labels=rs(b.labels),
                     positions=rs(b.positions),
                     seg_ids=rs(b.seg_ids, fill=-1),
                     loss_mask=rs(b.loss_mask),
                     seqlens=list(b.seqlens),
                     composition_id=b.composition_id)

    # -- planning ----------------------------------------------------------

    def _group_key(self, seqlens, n: int, m, speeds) -> tuple:
        return elastic.replan_key(seqlens, n, self.pcfg.block_size,
                                  mask=m, speeds=speeds, pcfg=self.pcfg)

    def _group_build(self, seqlens, n: int, m, speeds):
        nh, nkv, hd = self._heads
        return functools.partial(
            elastic.replan, seqlens, n, self.pcfg.block_size,
            n_q_heads=nh, n_kv_heads=nkv, head_dim=hd, mask=m,
            speeds=None if speeds is None else np.asarray(speeds),
            pcfg=self.pcfg, verify=None)

    def _plan(self, seqlens, n: int, speeds):
        """One cache-backed survivor replan per distinct mask group,
        under the exact keys ``elastic.replan`` uses."""
        scheds: dict[MaskSpec, Schedule] = {}
        keys = []
        for m in self.group_masks:
            key = self._group_key(seqlens, n, m, speeds)
            scheds[m] = self.planner.get(
                key, self._group_build(seqlens, n, m, speeds))
            keys.append(key)
        return scheds, tuple(keys)

    def _prefetch(self, seqlens, n: int, speeds) -> None:
        for m in self.group_masks:
            self.planner.prefetch(self._group_key(seqlens, n, m, speeds),
                                  self._group_build(seqlens, n, m, speeds))

    def _step_fn(self, step: int, n: int, keys: tuple, scheds):
        ck = (n, keys)
        if ck not in self._step_cache:
            attn = attention_closures(self.cfg, self.pcfg, self.layer_masks,
                                      self.group_masks, scheds, self.device,
                                      self.attn_impl)
            self._step_cache[ck] = build_train_step(
                self.model, StackedMesh((n, 1)), self.pcfg, self.tcfg, attn)
            self.compiled_at.append(step)
            while len(self._step_cache) > max(self.pcfg.plan_cache_size, 1):
                self._step_cache.pop(next(iter(self._step_cache)))
        return self._step_cache[ck]

    # -- checkpointing -----------------------------------------------------

    def _save(self, step: int) -> None:
        if self.manager is None:
            return
        self.manager.save(
            step, {"params": self.state.params, "opt": self.state.opt},
            extra={"loader": self.loader.state.to_dict(),
                   "n_workers": self.n, "pods": 1},
            blocking=False)

    def _restore(self) -> int:
        """Roll state back to the newest committed checkpoint (or step 0,
        the seed's weights) and return the resume step.  The loader state
        rewinds with the weights, so the replayed stream is bit-identical
        to the first pass (pure in ``(seed, step)``).  Saves still in
        flight were issued before the failure and are the host's own file
        IO: they are waited for, so the newest of them counts."""
        if self.manager is not None:
            self.manager.wait()
            if self.manager.latest_step() is not None:
                return restore_state(self.manager, self.state, self.loader)
        fresh = init_state(self.model, self.tcfg, self.device)
        self.state.params, self.state.opt = fresh.params, fresh.opt
        self.loader.state = LoaderState(step=0, seed=self.tcfg.seed)
        return 0

    # -- the loop ----------------------------------------------------------

    def run(self, total_steps: int, *, fail=None, skew=None,
            rejoin_step: int | None = None) -> dict:
        """Train to ``total_steps``, surviving worker loss.

        ``fail`` (an :class:`~repro_torch.runtime.elastic.InjectedFailure`
        with ``worker=`` plus ``step``/``round`` set) kills that worker
        mid-step once; ``skew`` maps worker id -> slowdown factor for the
        telemetry (a stand-in for a degraded chip).  Auto-resumes from the
        newest intact committed checkpoint when one exists."""
        if rejoin_step is not None or (fail is not None
                                       and fail.pod is not None):
            raise NotImplementedError(POD_MESHES)
        step = 0
        if self.manager is not None and self.manager.latest_step() is not None:
            step = self._restore()
        while step < total_steps:
            try:
                step = self._run_steps(step, total_steps, fail, skew)
            except health_mod.PodLoss:
                raise NotImplementedError(POD_MESHES) from None
            except (health_mod.WorkerLoss, elastic.InjectedFailure) as e:
                t0 = time.perf_counter()
                at = int(getattr(e, "step", None) or step)
                lost = int(getattr(e, "worker", None) or 0) % self.n
                if isinstance(e, elastic.InjectedFailure):
                    self.monitor.note_failure(
                        at, lost, detail=f"injected at round {e.round}")
                survivors = [i for i in range(self.n) if i != lost]
                if not survivors:
                    raise
                self.monitor.resize(survivors)
                self.n = len(survivors)
                rec: dict = {"failed_step": at, "worker": lost}
                if self.state.residual is not None:
                    # EF residuals accumulate per-topology quantization
                    # error — never reuse them across a resize
                    self.state.residual = compression.init_residuals(
                        self.state.params)
                    rec["ef_reset"] = True
                resume = self._restore()
                rec.update(resume_step=resume, steps_lost=at - resume,
                           n_workers=self.n,
                           wall_s=time.perf_counter() - t0)
                self.recoveries.append(rec)
                if self.verbose:
                    print(f"[supervisor] lost worker {lost} ({e}); "
                          f"replanning on {self.n} survivors, resuming "
                          f"at step {resume}", flush=True)
                step = resume
                fail = None                  # consumed
        self.close()
        return self.summary()

    def _run_steps(self, start: int, total: int, fail, skew) -> int:
        for step in range(start, total):
            n = self.n
            skew_vec = None
            if skew:
                skew_vec = np.ones(n)
                for w, f in dict(skew).items():
                    if 0 <= int(w) < n:
                        skew_vec[int(w)] = float(f)
            b = self.loader.next()
            if (fail is not None and step == int(fail.step)
                    and int(fail.worker) < n):
                # mid-step: the batch was fetched and the round loop
                # "started" — the step never commits, and the loader
                # state is left advanced; recovery must rewind it from
                # the checkpoint (replay proof)
                raise fail
            speeds = self.monitor.planning_speeds()
            scheds, keys = self._plan(b.seqlens, n, speeds)
            tpw = elastic.replan_tpw(b.seqlens, n, self.pcfg.block_size)
            batch = batch_arrays(self._fleet_batch(b, n, tpw), self.cfg,
                                 self.device)
            fn = self._step_fn(step, n, keys, scheds)
            if step + 1 < total:
                self._prefetch(self.loader.peek_seqlens(), n, speeds)
            s = self.state
            out, dt = ex.timed_call(fn, s.params, s.opt, s.residual, batch)
            s.params, s.opt, s.residual, loss, gnorm = out
            self.monitor.observe(
                step, health_mod.per_worker_times(dt, n, skew_vec))
            ev = self.monitor.maybe_replan(step)
            if ev is not None and self.verbose:
                print(f"[supervisor] {ev.kind} workers {ev.workers} "
                      f"at step {step} (speeds {ev.speeds}): "
                      f"{ev.detail}", flush=True)
            self.monitor.check(step)
            self.history.append(StepRecord(step, float(loss), float(gnorm),
                                           dt * 1e3, n))
            self.last_scheds = scheds
            every = max(int(self.pcfg.checkpoint_every), 0)
            if every and (step + 1) % every == 0:
                self._save(step)
            if self.verbose:
                print(f"step {step:5d}  loss {float(loss):.4f}  "
                      f"gnorm {float(gnorm):.3f}  "
                      f"[{n}w {dt * 1e3:.0f}ms]", flush=True)
        return total

    def close(self) -> None:
        self.planner.shutdown()
        if self.manager is not None:
            self.manager.wait()

    def summary(self) -> dict:
        s = self.plan_cache.stats
        return {
            "steps": len(self.history),
            "n_workers": self.n,
            "recoveries": self.recoveries,
            "events": [dataclasses.asdict(e)
                       for e in self.monitor.events],
            "compiles": len(self.compiled_at),
            "plan_cache": s.to_dict(),
            "plan_ahead_hits": self.planner.prefetched_hits,
        }


# flags kept for the reference CLI's parity that the port does not read:
# setting one to anything but its default warns
PARITY_ONLY_FLAGS = ("shape", "attn_block_q", "attn_block_k",
                     "attn_interpret")


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
                        " is not ported and raises (ROADMAP Queue A item"
                        " 7)")
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
                   help="software-pipelined executor rounds: issue round"
                        " r+1's ships (on a side CUDA stream) before run"
                        " r's compute and land arrivals in double-buffered"
                        " receive slots")
    p.add_argument("--layer-pipeline",
                   action=argparse.BooleanOptionalAction, default=False,
                   help="keep the hidden state resident in the schedule"
                        " layout across each run of same-mask layers: one"
                        " reshuffle per layer-group boundary instead of"
                        " per-layer Q/K/V reshuffles + O restores")
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
                   help="save params, AdamW state and the loader state"
                        " here; a new run on the directory resumes from"
                        " the newest committed step")
    p.add_argument("--checkpoint-every", type=int, default=10,
                   help="periodic-checkpoint cadence in steps (bounds"
                        " the steps lost to a mid-step worker failure)")
    p.add_argument("--supervised", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="fault-tolerant supervised loop for FCP runs with"
                        " several CP workers and no model axis: health"
                        " telemetry, closed-loop straggler demotion,"
                        " checkpoint/replay recovery (--no-supervised"
                        " forces the plain loop)")
    p.add_argument("--health-window", type=int, default=8,
                   help="consecutive straggler observations before a"
                        " demotion replan fires (hysteresis)")
    p.add_argument("--straggler-threshold", type=float, default=0.8,
                   help="relative speed below which a worker is a"
                        " straggler")
    p.add_argument("--step-timeout", type=float, default=60.0,
                   help="heartbeat timeout (s) declaring a worker lost")
    p.add_argument("--demote-cooldown", type=int, default=16,
                   help="minimum steps between demote/promote replans"
                        " (rate-limits plan churn)")
    p.add_argument("--log-every", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch versions of the kernels)")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    return build_parser().parse_args(argv)


def trainer_from_args(args: argparse.Namespace) -> Trainer | Supervisor:
    """The CLI's loop, routed as the reference routes it: the
    :class:`Supervisor` for ``--supervised`` FCP runs with more than one
    CP worker and no model axis, else the plain :class:`Trainer`
    (raises for what is not ported, warns for a parity-only flag set to
    anything but its default)."""
    parser = build_parser()
    for name in PARITY_ONLY_FLAGS:
        if getattr(args, name) != parser.get_default(name):
            warnings.warn(f"--{name.replace('_', '-')} is accepted for the "
                          f"reference CLI's parity and has no effect here",
                          stacklevel=2)
    dims = [int(x) for x in args.mesh.split("x")]
    if len(dims) == 3:
        raise NotImplementedError(POD_MESHES)
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
                          overlap=args.overlap,
                          layer_pipeline=args.layer_pipeline,
                          plan_buckets=args.plan_buckets,
                          plan_cache_size=args.plan_cache_size,
                          plan_ahead=args.plan_ahead,
                          health_window=args.health_window,
                          straggler_threshold=args.straggler_threshold,
                          step_timeout=args.step_timeout,
                          demote_cooldown=args.demote_cooldown,
                          checkpoint_every=args.checkpoint_every)
    tcfg = TrainConfig(lr=args.lr, warmup_steps=2, total_steps=args.steps)
    n_cp, tp = mesh.shape["data"], mesh.shape["model"]
    if args.supervised and cfg.uses_attention and n_cp > 1 and tp == 1:
        return Supervisor(cfg, pcfg, tcfg, n_workers=n_cp,
                          tokens_per_worker=args.tokens_per_worker,
                          dist=args.dist, fresh=args.fresh_stream,
                          checkpoint_dir=args.checkpoint_dir, device=device,
                          attn_impl=args.attn_impl)
    return Trainer(cfg, pcfg, tcfg, mesh,
                   tokens_per_worker=args.tokens_per_worker, dist=args.dist,
                   fresh=args.fresh_stream, device=device,
                   log_every=args.log_every, attn_impl=args.attn_impl,
                   checkpoint_dir=args.checkpoint_dir)


def main(argv=None) -> Trainer | Supervisor:
    args = parse_args(argv)
    trainer = trainer_from_args(args)
    try:
        out = trainer.run(args.steps)
    finally:
        trainer.close()
    s = trainer.plan_cache.stats
    print(f"plan cache: {s.hits} hits / {s.misses} misses "
          f"(hit rate {s.hit_rate:.2f}), "
          f"{trainer.plan_cache.n_unique_specs} static specs, "
          f"{trainer.planner.prefetched_hits} plan-ahead builds consumed")
    if isinstance(trainer, Supervisor):
        print(f"health: {len(out['events'])} event(s), "
              f"{len(out['recoveries'])} recover(ies), "
              f"{out['compiles']} step closures built")
    print("done.")
    return trainer


if __name__ == "__main__":
    main()
