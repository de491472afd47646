"""Training step assembly + CLI entry point on stacked workers (port of
``repro.launch.train``; the dense, MoE, SSM and hybrid families: the
hybrid's shared attention block takes one FCP closure, every invocation
on the same plan; the SSM family plans no attention).

``build_train_step`` wires: FCP schedule -> attention closure over the
stacked-worker executor -> model loss -> gradients (``torch.autograd``
over the parameter leaves, the port's ``value_and_grad``) -> optional
error-feedback bf16 compression -> AdamW.  Where the reference jits the
step once per plan key (``jit_train_step``, its parameters, moments and
residuals donated), the loops wrap it once per plan key in a compiled
program (``runtime/graphs.Program`` over :func:`step_on`): on the card
one CUDA graph, captured at the key's first step and replayed at every
later one, reading and updating the train state in place (:func:`held`;
nothing may rebind those tensors).  Every step program of a loop shares
one graph pool (``graphs.Pool``): a step's loss and gnorm are read on
the host before the next step runs.

Two loops, routed as the reference routes them: FCP runs with more than
one CP worker and no model axis go through the fault-tolerant
:class:`Supervisor` (``--supervised``, on by default: health telemetry,
straggler demotion, worker- and pod-loss recovery from checkpoints,
overlapping recovery and rejoin), everything else through the plain
:class:`Trainer`.  Both take ``--overlap`` (the double-buffered round
loop), ``--layer-pipeline`` (the hidden state moves once per layer
group: :class:`PipelinedAttn`), ``--checkpoint-dir`` (periodic saves,
resume from the newest committed step) and pod meshes (``--mesh
PxDxM``: P pods of D stacked workers, every pod running the same
D-worker plan on its own frames, ``core.executor``).  The cross-pod
gradient reduction is the loss over all P·D frames; with
``TrainConfig.grad_compression`` its gradient tree takes the
error-feedback bf16 compression, as the reference's does.

**Across processes.**  Under ``torchrun`` (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``) both loops join a process group of R ranks
(``--dist-backend nccl``, the default, or ``gloo``) and rank r holds the
frames ``[r·F/R, (r+1)·F/R)`` of the mesh's F = P·D pod-major frames on
its own device (``--device cuda`` is ``cuda:LOCAL_RANK``;
:func:`check_ranked` names the starting layouts: R divides D, or each
rank holds an equal share of one pod, or whole pods).  Every
rank draws the same global batch and plans the same schedule; it
computes on its own frames (``core.executor`` ships the pairs that cross
ranks through ``runtime/wire``, never across pods), its loss is its
frames' summed token loss over the whole batch's token count, and the
step sums the loss and the gradients over the ranks in one flat bucket
before the compression and AdamW, as the reference's gradients arrive
reduced over its data axis (over every pod's frames: the pod mean).  The
weights and moments are replicated: every rank updates the same bytes
(``wire.agree`` checks the parameters at the start and each new plan
key).  The lowest rank prints the records and writes the checkpoints.
The :class:`Supervisor` across ranks shrinks its group to the survivors
after a loss (its docstring).  ``--overlap``, ``--layer-pipeline`` and
the non-dense families are refused across ranks (ROADMAP Queue A items
4.3, 4.4 and 4.6), and the steps run uncaptured (item 4.7).

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
import threading
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
from ..kernels import flash_attention as fa
from ..masks import MaskSpec, coerce_mask, parse_mask
from ..models import Model
from ..optimizer import adamw, schedules
from ..runtime import compression
from ..runtime import elastic
from ..runtime import graphs
from ..runtime import health as health_mod
from ..runtime import wire as wirelib
from .mesh import StackedMesh, parse_mesh


def make_fcp_attn_fn(sched: Schedule, device, pcfg: ParallelConfig,
                     impl: str = "fused", pods: int = 1,
                     ranks: wirelib.Ranks = wirelib.STACKED) -> Callable:
    """``attn(q, k, v)`` over ``[F, T, H, D]`` frames through the FCP
    executor on stacked workers (frame = worker; ``F = pods x`` the
    plan's workers, pod-major, or this rank's share of them under
    ``ranks``), with the executor impl ``impl``.
    ``pcfg.attention_impl`` is not read: the copied ``ParallelConfig``
    defaults it to the reference's ``"xla"``, and the port's default is
    the kernels."""
    tables = ex.schedule_tables(sched, device, pods, ranks)
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
                            impl: str = "fused", pods: int = 1) -> tuple:
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
        tables, spec = ex.schedule_tables(sched, device, pods), sched.spec

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


def held(state: TrainState) -> tuple:
    """The tensors a step program reads and updates in place (its
    ``held``): the parameters, the AdamW moments and step counter, the
    error-feedback residuals."""
    return (state.params, state.opt.m, state.opt.v, state.opt.step,
            state.residual)


def reset_state(state: TrainState, model: Model, tcfg: TrainConfig,
                device) -> None:
    """``init_state``'s weights and zero moments, written into ``state``'s
    tensors (the step programs hold them); the residuals are left as
    they are."""
    gen = torch.Generator(device=device).manual_seed(tcfg.seed)
    with torch.no_grad():
        for dst, src in zip(adamw.tree_leaves(state.params),
                            adamw.tree_leaves(model.init(gen, device))):
            dst.copy_(src)
        for t in adamw.tree_leaves({"m": state.opt.m, "v": state.opt.v}):
            t.zero_()
        state.opt.step.zero_()


def restore_state(manager: CheckpointManager, state: TrainState,
                  loader: SyntheticLoader) -> int:
    """Copy the newest intact committed checkpoint into ``state`` (in
    place: the step programs hold its tensors) and rewind the loader
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
    that do not require grad yet are switched on).  On a rank's frames
    both are this rank's share, to be summed over the ranks."""
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
    residual, loss, gnorm)``; the parameters, moments and residuals are
    updated in place (``optimizer.adamw``, ``compression.compress_grads``)
    and returned, the reference's donated buffers.
    On stacked workers nothing is sharded.  A ``mesh`` whose ``ranks``
    form a process group sums the loss and the gradients over the ranks
    (one flat bucket per dtype, in leaf order) before the compression and
    AdamW: the reference's gradients arrive reduced over the data axis,
    and every rank then clips by the same global norm."""
    loss_and_grads = value_and_grad(model, pcfg, attn_fn)
    ranks = getattr(mesh, "ranks", wirelib.STACKED)

    def train_step(params, opt, residual, batch):
        lr = schedules.warmup_cosine(
            opt.step, peak_lr=tcfg.lr, warmup_steps=tcfg.warmup_steps,
            total_steps=tcfg.total_steps)
        loss, grads = loss_and_grads(params, batch)
        if ranks.grouped:
            summed = wirelib.all_sum([loss] + adamw.tree_leaves(grads),
                                     ranks)
            loss, grads = summed[0], adamw.tree_unflatten(grads, summed[1:])
        if tcfg.grad_compression:
            # bf16 error-feedback compression (runtime/compression.py)
            grads, residual = compression.compress_grads(grads, residual)
            grads = compression.decompress_grads(grads)
        params, opt, gnorm = adamw.update(
            params, grads, opt, lr=lr, b1=tcfg.b1, b2=tcfg.b2,
            weight_decay=tcfg.weight_decay, grad_clip=tcfg.grad_clip)
        return params, opt, residual, loss, gnorm

    return train_step


def step_on(train_step, state: TrainState):
    """``train_step`` over ``state`` as ``fn(batch) -> (loss, gnorm)``,
    the function a step program wraps (the loops' ``_program``: the
    reference's ``jit_train_step``, called with ``held=held(state)``); it
    reads and updates ``state``'s tensors in place."""
    def fn(batch):
        out = train_step(state.params, state.opt, state.residual, batch)
        return out[3], out[4]
    return fn


def batch_arrays(b: Batch, cfg: ModelConfig, device="cuda",
                 rng: np.random.Generator | None = None,
                 frames: tuple[int, int] | None = None) -> dict:
    """A loader batch as tensors on ``device``.  A multimodal config
    (``frontend_dim``) gets the reference's front-end stub: the first
    ``min(256, T)`` positions of each frame are patches, drawn by numpy
    from ``rng`` (``default_rng(0)`` when none is given, as the reference
    draws them, so both packages see the same patches on every step),
    and carry no next-token loss.  ``frames=(lo, hi)`` keeps a rank's
    frames, and the whole batch's token count as ``loss_denom``
    (``Model.loss``)."""
    out = {
        "tokens": torch.from_numpy(np.asarray(b.tokens)).to(device),
        "labels": torch.from_numpy(np.asarray(b.labels)).to(device),
        "positions": torch.from_numpy(np.asarray(b.positions)).to(device),
        "loss_mask": torch.from_numpy(
            np.asarray(b.loss_mask, np.float32)).to(device),
    }
    if cfg.frontend_dim:
        f, t = b.tokens.shape
        rng = rng or np.random.default_rng(0)
        n_fe = min(256, t)
        fe = rng.normal(size=(f, n_fe, cfg.frontend_dim)) * 0.02
        mask = np.zeros((f, t), bool)
        mask[:, :n_fe] = True
        out["frontend_embeds"] = torch.from_numpy(
            fe.astype(np.float32)).to(device)
        out["frontend_mask"] = torch.from_numpy(mask).to(device)
        out["loss_mask"] = out["loss_mask"] * torch.from_numpy(
            1.0 - mask.astype(np.float32)).to(device)
    if frames is not None:
        lo, hi = frames
        denom = torch.clamp(torch.sum(out["loss_mask"]), min=1.0)
        out = {k: v[lo:hi] for k, v in out.items()}
        out["loss_denom"] = denom
    return out


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
                       impl: str, pods: int = 1,
                       ranks: wirelib.Ranks = wirelib.STACKED):
    """The attention argument of the model for a batch's plans (over
    ``pods`` pods of the plans' workers, or ``ranks``'s share of them):
    the layer-pipelined entries under ``pcfg.layer_pipeline``, else one
    FCP closure per mask group routed to its layers; None for an
    attention-free model."""
    if not cfg.uses_attention:
        return None
    if pcfg.layer_pipeline:
        return make_pipelined_attn_fns(cfg, pcfg, layer_masks, scheds,
                                       device, impl, pods)
    return route_layers(
        cfg, layer_masks, group_masks,
        lambda m: make_fcp_attn_fn(scheds[m], device, pcfg, impl, pods,
                                   ranks))


def refuse_ranked(what: str, item: str) -> None:
    """Refuse ``what`` across ranks, naming the ROADMAP Queue A item that
    will take it; nothing runs it stacked instead."""
    raise ValueError(f"{what} is not supported across ranks yet (ROADMAP "
                     f"Queue A: {item})")


def check_ranked(cfg: ModelConfig, pcfg: ParallelConfig, mesh_shape: dict,
                 size: int) -> None:
    """Raise, before the process group is joined, for a run the port
    does not take across ``size`` ranks: it takes either loop of a dense
    model on a mesh the ranks split evenly at the start.  On a ``DxM``
    mesh R divides D; on a pod mesh every rank's share lies inside one
    pod (R/P ranks a pod, R/P dividing D) or every rank holds whole pods
    (R dividing P).  Uneven shares appear only after a loss, in the
    Supervisor's survivor groups."""
    if pcfg.overlap:
        refuse_ranked("--overlap", "--overlap with asynchronous P2P")
    if pcfg.layer_pipeline:
        refuse_ranked("--layer-pipeline", "the layer pipeline")
    if cfg.family != "dense":
        refuse_ranked(f"a non-dense family ({cfg.family})",
                      "the MoE, SSM, hybrid and multimodal families")
    pods, data = mesh_shape.get("pod", 1), mesh_shape.get("data", 1)
    if "pod" not in mesh_shape:
        if data % size:
            raise ValueError(f"{size} ranks do not divide the data axis "
                             f"({data} CP workers)")
    elif not ((size % pods == 0 and data % (size // pods) == 0)
              or pods % size == 0):
        raise ValueError(
            f"{size} ranks cannot split a pod mesh of {pods} pods x {data} "
            f"workers: a rank holds whole pods (the ranks divide the pods) "
            f"or an equal share of one pod (the pods divide the ranks, and "
            f"the ranks of a pod divide its workers)")


@dataclasses.dataclass
class StepRecord:
    """One committed step, for drills and benches to diff against."""
    step: int
    loss: float
    gnorm: float
    ms: float                       # wall, the device synchronized (the
                                    # Supervisor's: its slowest rank's)
    n_workers: int = 1              # CP workers per pod
    pods: int = 1
    sent_bytes: int = 0             # this rank's bytes on the wire
    ship_s: float = 0.0             # host s in its ships across ranks
    reduce_s: float = 0.0           # host s in its sums over the ranks
    rank_ms: float | None = None    # the Supervisor's: this rank's own
                                    # wall, for reading only


class Trainer:
    """The plain training loop of the CLI (the reference's ``main`` loop
    without the ``Supervisor``): a plan cache with plan-ahead (batch
    t+1 is planned on a host thread while t runs), one attention
    closure and step program per plan key (``compiled_at`` lists the
    steps that built one), random weights from a seeded
    ``torch.Generator``.  On a pod mesh (``"pod"`` axis P) the
    loader emits P same-composition sub-streams and every pod runs the
    data axis's plan on its own frames.  ``attn_impl`` is the executor impl
    (default ``"fused"``: the kernels on the card).  With
    ``checkpoint_dir`` it saves ``{"params", "opt"}`` and the loader
    state every ``pcfg.checkpoint_every`` steps, and a new trainer on
    the same directory resumes from the newest committed step.

    With ``dist_backend`` the trainer joins ``torchrun``'s process group
    (``runtime/wire.join``) and holds its rank's frames of the data axis
    (module docstring); ``close`` leaves the group if the trainer joined
    it (a caller that joined first keeps it for its next trainer)."""

    def __init__(self, cfg: ModelConfig, pcfg: ParallelConfig,
                 tcfg: TrainConfig, mesh: StackedMesh, *,
                 tokens_per_worker: int, dist: str, fresh: bool = False,
                 device="cuda", log_every: int = 1,
                 attn_impl: str = "fused", checkpoint_dir=None,
                 dist_backend: str | None = None):
        self.device = resolve_device(device)
        self.attn_impl = ex.ExecConfig(impl=attn_impl).impl
        self.ranks = wirelib.STACKED
        self._leave = False
        if dist_backend is not None:
            env = wirelib.launch_env()
            check_ranked(cfg, pcfg, mesh.shape, env["size"] if env else 1)
            self._leave = not wirelib.in_group()
            self.ranks = wirelib.join(dist_backend, self.device)
            mesh = mesh.with_ranks(self.ranks)
        # a rank's frames of the batch (None: all of them, stacked)
        self.frames = mesh.frames if self.ranks.grouped else None
        self.cfg, self.pcfg, self.tcfg, self.mesh = cfg, pcfg, tcfg, mesh
        self.n_cp = mesh.shape.get("data", 1)
        self.pods = mesh.shape.get("pod", 1)
        self.tpw = tokens_per_worker
        self.log_every = max(int(log_every), 1)
        self.model = Model(cfg, tp=mesh.shape.get("model", 1))
        self.loader = SyntheticLoader(
            dist=dist, n_frames=self.n_cp, tokens_per_worker=tokens_per_worker,
            vocab_size=cfg.vocab_size, pods=self.pods, seed=tcfg.seed,
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
        self.compiled_at: list[int] = []     # steps that built a program
        self._pool = graphs.Pool(self.device)
        self.history: list[StepRecord] = []
        self.manager = (CheckpointManager(checkpoint_dir)
                        if checkpoint_dir else None)
        # the step the first record takes: a resumed run starts past the
        # newest committed checkpoint
        self.start = 0
        if self.manager is not None and self.manager.latest_step() is not None:
            self.start = restore_state(self.manager, self.state, self.loader)
        if self.ranks.grouped:
            # replicated weights: every rank starts from the same bytes
            wirelib.agree("parameters", wirelib.digest(
                adamw.tree_leaves(self.state.params)), self.ranks,
                self.device)

    @property
    def next_step(self) -> int:
        return self.start + len(self.history)

    def _plan_of(self, seqlens, mask):
        key = schedule_plan_key(self.cfg, self.pcfg, seqlens, self.n_cp,
                                self.tpw, mask=mask)
        build = functools.partial(build_schedule, self.cfg, self.pcfg,
                                  seqlens, self.n_cp, self.tpw, mask=mask)
        return key, build

    def _program(self, name: str, fn) -> graphs.Program:
        """A step program in the loop's graph pool.  Across ranks it runs
        its ``fn`` eagerly (one build per key all the same): gloo's ops
        cannot be captured in a CUDA graph, and a capture of NCCL's has
        not been verified on one card (ROADMAP Queue A: NCCL capture)."""
        return graphs.Program(name, fn, self.device, self._pool,
                              capture=not self.ranks.grouped)

    def step_fn(self, b: Batch, prefetch: bool = True) -> graphs.Program:
        """The step program of batch ``b``'s plan (planned and built, or
        taken from the cache; :func:`step_on`); prefetches the next
        batch's plan when ``prefetch``.  An attention-free model (SSM)
        plans nothing."""
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
            if self.ranks.grouped:
                wirelib.agree("plan key", repr(key).encode(), self.ranks,
                              self.device)
            attn = attention_closures(self.cfg, self.pcfg, self.layer_masks,
                                      self.group_masks, scheds, self.device,
                                      self.attn_impl, self.pods, self.ranks)
            self.step_cache[key] = self._program("train_step", step_on(
                build_train_step(self.model, self.mesh, self.pcfg, self.tcfg,
                                 attn), self.state))
            self.compiled_at.append(self.next_step)
            while len(self.step_cache) > max(self.pcfg.plan_cache_size, 1):
                self.step_cache.pop(next(iter(self.step_cache)))
        return self.step_cache[key]

    def eager_step_fn(self, b: Batch):
        """The eager step of batch ``b``'s plan, ``fn(batch) -> (loss,
        gnorm)`` on this loop's state (its program's ``fn``)."""
        return self.step_fn(b, prefetch=False).fn

    def step(self) -> StepRecord:
        t = self.next_step
        b = self.loader.next()
        batch = batch_arrays(b, self.cfg, self.device, frames=self.frames)
        fn = self.step_fn(b, prefetch=t + 1 < self.tcfg.total_steps)
        s = self.state
        w0 = wirelib.wire_stats()
        t0 = time.perf_counter()
        loss, gnorm = fn(batch, held=held(s))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        ms = (time.perf_counter() - t0) * 1e3
        w1 = wirelib.wire_stats()
        rec = StepRecord(t, float(loss), float(gnorm), ms, self.n_cp,
                         self.pods,
                         *(w1[k] - w0[k] for k in ("sent_bytes", "ship_s",
                                                   "reduce_s")))
        self.history.append(rec)
        if t % self.log_every == 0 and self.ranks.rank == 0:
            print(f"step {t:5d}  loss {rec.loss:.4f}  gnorm "
                  f"{rec.gnorm:.3f}  {rec.ms:.1f} ms", flush=True)
        every = max(int(self.pcfg.checkpoint_every), 1)
        if self.manager is not None and (t + 1) % every == 0:
            # every rank holds the same state: rank 0 writes it, once
            # every rank has finished the step
            wirelib.barrier(self.ranks)
            if self.ranks.rank == 0:
                # the host copy now, the file IO on a thread
                self.manager.save(
                    t, {"params": s.params, "opt": s.opt},
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
        if self.ranks.grouped:
            wirelib.barrier(self.ranks)
            if self._leave:
                wirelib.leave()

    def report(self, wall_s: float) -> dict:
        """This rank's run as a JSON-able dict: its records, the kernels'
        launch counters, its traffic on the wire and its device's peak
        memory (all still readable after :meth:`close`)."""
        cuda = self.device.type == "cuda"
        return {"rank": self.ranks.rank, "ranks": self.ranks.size,
                "backend": self.ranks.backend, "device": str(self.device),
                "frames": list(self.mesh.frames),
                "records": [dataclasses.asdict(r) for r in self.history],
                "compiled_at": list(self.compiled_at),
                "launches": {f.__name__: f.launches for f in fa.COUNTED},
                "wire": wirelib.wire_stats(), "wall_s": wall_s,
                "peak_mem_gib": (torch.cuda.max_memory_allocated(
                    self.device) / 2**30 if cuda else None)}


# --------------------------------------------------------------------------
# fault-tolerant supervised loop (runtime health closed loop)
# --------------------------------------------------------------------------

class Supervisor:
    """Fault-tolerant elastic FCP training loop (port of the reference's
    ``Supervisor``), on stacked workers: ``pods`` pods of ``n_workers``
    CP workers, frames pod-major on the leading tensor dim.

    Owns the train state, a *geometry-pinned* data loader, a
    :class:`~repro_torch.runtime.health.HealthMonitor`, a shared plan
    cache (+ plan-ahead thread) and an optional checkpoint manager, and
    closes the measurement -> placement -> recovery loop around the
    train step:

    * **healthy path** — the plain loop's work (plan cache, plan-ahead,
      a bounded step-program cache) plus one device-synchronized wall
      clock per step (``executor.timed_call``).  The monitor's planning
      speeds stay ``None`` while healthy, so plan keys are those of a
      monitor-less run.
    * **straggler path** — when the monitor's hysteresis window fills,
      its latched quantized speeds flow into cache-backed
      ``elastic.replan(speeds=...)``; demote/promote events are
      rate-limited (``demote_cooldown``).
    * **loss path** — on :class:`~repro_torch.runtime.health.WorkerLoss`,
      :class:`~repro_torch.runtime.health.PodLoss` or
      :class:`~repro_torch.runtime.elastic.InjectedFailure` the fleet
      shrinks to the survivors (``elastic.replan`` on the survivor set),
      error-feedback residuals reset, the newest *intact* committed
      checkpoint restores, and the deterministic data stream replays —
      losing at most ``checkpoint_every`` steps.  A worker loss on a
      multi-pod fleet takes that worker's slot from every pod (the pods
      run one schedule).  A *pod* loss shrinks the pod dimension to the
      largest divisor of the pinned pod count (a non-divisor remainder
      idles) and starts **overlapping recovery**: survivors train on
      while a host thread pre-warms the regrow path (survivor plans
      built and statically verified, the full-fleet plan keys re-warmed,
      the newest committed checkpoint staged in host memory), so a
      returning pod rejoins at a step boundary (``run(rejoin_step=)``).

    The loader is pinned to the original ``pods x n_workers x
    tokens_per_worker`` geometry: the global token stream is a pure
    function of ``(seed, step)``, and survivor fleets view it through
    ``elastic.reshape_pod_frames`` (each surviving pod adopts whole
    pinned-pod sub-streams).  Without a checkpoint, recovery replays
    from step 0 with the initial weights drawn again from the seed (the
    reference holds a host copy of them).

    **Across processes** (``dist_backend``, under ``torchrun``) the
    Supervisor joins the process group as :class:`Trainer` does and each
    rank holds its contiguous share of the current fleet's frames
    (``Ranks.share``), its batch sliced from ``_fleet_batch``'s view.

    * Each rank's step wall (``timed_call``) is all-reduced with ``max``
      over the current group, and that one number feeds every rank's
      monitor through ``per_worker_times``: every rank takes the same
      demote, promote and loss decisions at the same step.  A record
      keeps the rank's own wall beside it (``rank_ms``).  Every step
      the ranks agree on its plan key: their step-program caches may
      differ (an idle rank keeps what the survivors evicted), so no
      collective waits on one rank's cache miss.
    * The lowest rank of the current group writes the checkpoints, after
      a barrier, one save in flight.  Before a restore the writer's
      in-flight save commits and every member of the old group waits for
      it (a barrier); the members then read the same directory and
      ``wire.agree`` the restored parameters.
    * A loss shrinks the group to the ranks that still hold a worker of
      the survivor fleet (``wire.subgroup``), which re-split the
      survivor frames as evenly as floor division allows; the other
      ranks idle: they run no step and join no survivor collective,
      and wait at the world group's rejoin point (or at :meth:`close`).
      Every rank runs the pod loss's prewarm thread, so the returning
      ranks' plan keys are cached too.
    * At the rejoin the lowest surviving rank broadcasts the parameters,
      the AdamW state, the loader state and the monitor's last event
      step to the world (``wire.broadcast``: the port's form of the
      reference pulling the survivors' state to the host and re-sharding
      it onto the big mesh), and every rank agrees on the parameters'
      digest.

    Every loss handled across ranks is one that every rank learns at
    the same step: injected, or declared by the monitor from numbers all
    ranks share.  A process that really dies (a lost host, SIGKILL)
    would hang a collective; recovering from it needs torchrun's
    restarts (ROADMAP Queue A item 4.10).  Across ranks the steps run
    uncaptured (item 4.7)."""

    def __init__(self, cfg: ModelConfig, pcfg: ParallelConfig,
                 tcfg: TrainConfig, *, n_workers: int,
                 tokens_per_worker: int, pods: int = 1,
                 dist: str = "uniform", uniform_len: int = 1024,
                 fresh: bool = False, checkpoint_dir=None,
                 checkpoint_keep: int = 3,
                 monitor: health_mod.HealthMonitor | None = None,
                 start_fleet=None, verbose: bool = True, device="cuda",
                 attn_impl: str = "fused", dist_backend: str | None = None,
                 start_members=None):
        self.device = resolve_device(device)
        self.attn_impl = ex.ExecConfig(impl=attn_impl).impl
        self.cfg, self.pcfg, self.tcfg = cfg, pcfg, tcfg
        self.p0 = int(pods)
        self.n0 = int(n_workers)
        self.tpw0 = int(tokens_per_worker)
        # start_fleet: None = full strength, a (pods, workers) tuple, or a
        # bare worker count (single-pod callers)
        if start_fleet is None:
            self.pods, self.n = self.p0, self.n0
        elif isinstance(start_fleet, tuple):
            self.pods, self.n = int(start_fleet[0]), int(start_fleet[1])
        else:
            self.pods, self.n = self.p0, int(start_fleet)
        self.verbose = verbose
        if not (cfg.uses_attention and cfg.n_layers):
            raise ValueError("Supervisor drives FCP attention models")
        # the world group, and the current group: None on a rank that
        # holds no worker of the fleet (it idles); members: the current
        # group's global ranks, known on every rank
        self.world = self.ranks = wirelib.STACKED
        self.members: tuple = (0,)
        self._leave = self._closed = False
        if dist_backend is not None:
            env = wirelib.launch_env()
            check_ranked(cfg, pcfg, self._mesh(self.p0, self.n0).shape,
                         env["size"] if env else 1)
            self._leave = not wirelib.in_group()
            self.world = wirelib.join(dist_backend, self.device)
            self.members = tuple(sorted(
                start_members if start_members is not None
                else range(min(self.world.size, self.pods * self.n))))
            self.ranks = wirelib.subgroup(self.members, self.world)
        self.model = Model(cfg, tp=1)
        self.loader = SyntheticLoader(
            dist=dist, n_frames=self.n0, tokens_per_worker=self.tpw0,
            vocab_size=cfg.vocab_size, pods=self.p0, seed=tcfg.seed,
            uniform_len=uniform_len, plan_buckets=pcfg.plan_buckets,
            bucket_min_len=pcfg.block_size, fresh=fresh)
        self.monitor = monitor or health_mod.HealthMonitor.from_pcfg(
            self.pods * self.n, pcfg,
            topology=health_mod.FleetTopology(self.pods, self.n))
        self.plan_cache = pc.PlanCache(pcfg.plan_cache_size)
        self.planner = pc.PlanAheadPlanner(self.plan_cache,
                                           enabled=pcfg.plan_ahead)
        # checkpoint_keep: GC window.  Drills that replay a recovery
        # against a copy of the checkpoint it restored widen it so that
        # checkpoint survives to the end of the run.
        self.manager = (CheckpointManager(checkpoint_dir,
                                          keep_n=checkpoint_keep)
                        if checkpoint_dir else None)
        self.state = init_state(self.model, tcfg, self.device)
        self.layer_masks = layer_mask_specs(cfg, pcfg)
        self.group_masks = list(dict.fromkeys(self.layer_masks))
        nh, nkv = cfg.padded_heads(1)
        self._heads = (max(nh, 1), max(nkv, 1), max(cfg.head_dim, 1))
        self._step_cache: dict = {}
        self.compiled_at: list[int] = []     # steps that built a program
        self._pool = graphs.Pool(self.device)
        self.history: list[StepRecord] = []
        self.recoveries: list[dict] = []
        self.rejoins: list[dict] = []
        self.last_scheds: dict = {}
        self._prewarm = None                 # regrow-prewarm thread
        self._prewarm_info: dict | None = None
        self._staged: dict | None = None     # host-staged checkpoint
        if self.ranks is not None and self.ranks.grouped:
            # replicated weights: every member starts from the same bytes
            self._agree_params()

    # -- geometry ----------------------------------------------------------

    def _mesh(self, pods: int, n: int) -> StackedMesh:
        """The fleet's mesh over the current group (its frames split as
        evenly as floor division allows)."""
        shape = (n, 1) if self.p0 == 1 and pods == 1 else (pods, n, 1)
        # the pod axis stays even at pods == 1 for a multi-pod fleet, as
        # the reference keeps one mesh family across a shrink
        return StackedMesh(shape, ranks=self.ranks or wirelib.STACKED)

    def _frames(self, pods: int, n: int) -> tuple[int, int] | None:
        """This rank's frames of the fleet (None: stacked, all of them)."""
        return self.ranks.share(pods * n) if self.world.grouped else None

    def _fleet_batch(self, b: Batch, pods: int, n: int, tpw: int) -> Batch:
        """Re-view the pinned-geometry batch on the current fleet: the
        same token stream, each surviving pod adopting ``p0 // pods``
        pinned-pod sub-streams, padding re-derived (segment ids pad with
        -1 so padding never aliases a document)."""
        n_valid = int(sum(b.seqlens))

        def rs(a, fill=0):
            return elastic.reshape_pod_frames(a, self.p0, pods, n, tpw,
                                              n_valid=n_valid, fill=fill)
        return Batch(tokens=rs(b.tokens), labels=rs(b.labels),
                     positions=rs(b.positions),
                     seg_ids=rs(b.seg_ids, fill=-1),
                     loss_mask=rs(b.loss_mask),
                     seqlens=elastic.pod_survivor_seqlens(
                         b.seqlens, self.p0, pods),
                     composition_id=b.composition_id)

    def _lowest(self) -> bool:
        """Whether this rank is the current group's lowest (it prints)."""
        return self.ranks is not None and self.ranks.rank == 0

    # -- planning ----------------------------------------------------------

    def _group_key(self, seqlens, pods: int, n: int, m, speeds) -> tuple:
        return elastic.replan_key(seqlens, n, self.pcfg.block_size,
                                  mask=m, speeds=speeds, pcfg=self.pcfg,
                                  pods=pods, base_pods=self.p0)

    def _group_build(self, seqlens, pods: int, n: int, m, speeds):
        nh, nkv, hd = self._heads
        return functools.partial(
            elastic.replan, seqlens, n, self.pcfg.block_size,
            n_q_heads=nh, n_kv_heads=nkv, head_dim=hd, mask=m,
            speeds=None if speeds is None else np.asarray(speeds),
            pcfg=self.pcfg, verify=None, pods=pods, base_pods=self.p0)

    def _plan(self, seqlens, pods: int, n: int, speeds):
        """One cache-backed survivor replan per distinct mask group,
        under the exact keys ``elastic.replan`` uses — a regrown fleet
        re-hits its pre-shrink plans."""
        scheds: dict[MaskSpec, Schedule] = {}
        keys = []
        for m in self.group_masks:
            key = self._group_key(seqlens, pods, n, m, speeds)
            scheds[m] = self.planner.get(
                key, self._group_build(seqlens, pods, n, m, speeds))
            keys.append(key)
        return scheds, tuple(keys)

    def _prefetch(self, seqlens, pods: int, n: int, speeds) -> None:
        for m in self.group_masks:
            self.planner.prefetch(
                self._group_key(seqlens, pods, n, m, speeds),
                self._group_build(seqlens, pods, n, m, speeds))

    def _program(self, name: str, fn) -> graphs.Program:
        """A step program in the loop's graph pool (run eagerly across
        ranks, as :meth:`Trainer._program` says why)."""
        return graphs.Program(name, fn, self.device, self._pool,
                              capture=not self.world.grouped)

    def _step_fn(self, step: int, pods: int, n: int, keys: tuple,
                 scheds) -> graphs.Program:
        """The step program of ``(pods, n, keys)`` on the current group,
        built at its first step (``compiled_at``) and kept in a cache
        bounded by ``plan_cache_size``, as the reference keeps its jitted
        steps."""
        if self.world.grouped:
            # every step, not on a miss only: an idle rank keeps the
            # programs the survivors evict, so after a rejoin one rank
            # may hit where another misses, and a collective made on a
            # miss alone would meet the other rank's step
            wirelib.agree("plan key", repr(keys).encode(), self.ranks,
                          self.device)
        ck = (pods, n, keys, self.ranks)
        if ck not in self._step_cache:
            attn = attention_closures(self.cfg, self.pcfg, self.layer_masks,
                                      self.group_masks, scheds, self.device,
                                      self.attn_impl, pods, self.ranks)
            self._step_cache[ck] = self._program("train_step", step_on(
                build_train_step(self.model, self._mesh(pods, n), self.pcfg,
                                 self.tcfg, attn), self.state))
            self.compiled_at.append(step)
            while len(self._step_cache) > max(self.pcfg.plan_cache_size, 1):
                self._step_cache.pop(next(iter(self._step_cache)))
        return self._step_cache[ck]

    def builds(self) -> int:
        """Keys built by the cached step programs (one each: a plan key
        fixes the batch's shapes)."""
        return sum(p.builds for p in self._step_cache.values())

    # -- checkpointing -----------------------------------------------------

    def _save(self, step: int) -> None:
        """A non-blocking save by the group's lowest rank, once every
        member has finished the step, after the previous save has landed:
        each save in flight holds a host copy of the state and its own
        disk space (7.4 GB at StableLM's full width, 4 layers, f32), so
        at most one runs at a time."""
        if self.manager is None:
            return
        wirelib.barrier(self.ranks)
        if self.ranks.rank != 0:
            return
        self.manager.wait()
        self.manager.save(
            step, {"params": self.state.params, "opt": self.state.opt},
            extra={"loader": self.loader.state.to_dict(),
                   "n_workers": self.n, "pods": self.pods},
            blocking=False)

    def _restore(self) -> int:
        """Roll state back to the newest committed checkpoint (or step 0,
        the seed's weights) and return the resume step.  The loader state
        rewinds with the weights, so the replayed stream is bit-identical
        to the first pass (pure in ``(seed, step)``).  Saves still in
        flight were issued before the failure and are the host's own file
        IO: they are waited for, so the newest of them counts.  An idle
        rank only reads the step: its state arrives at the rejoin."""
        if self.manager is not None:
            self.manager.wait()
            last = self.manager.latest_step()
            if last is not None:
                if self.ranks is None:
                    return last + 1
                return restore_state(self.manager, self.state, self.loader)
        if self.ranks is None:
            return 0
        reset_state(self.state, self.model, self.tcfg, self.device)
        self.loader.state = LoaderState(step=0, seed=self.tcfg.seed)
        return 0

    def _agree_params(self) -> None:
        wirelib.agree("parameters", wirelib.digest(
            adamw.tree_leaves(self.state.params)), self.ranks, self.device)

    # -- the loop ----------------------------------------------------------

    def run(self, total_steps: int, *, fail=None, skew=None,
            rejoin_step: int | None = None) -> dict:
        """Train to ``total_steps``, surviving worker and pod loss.

        ``fail`` (an :class:`~repro_torch.runtime.elastic.InjectedFailure`
        with ``worker=`` or ``pod=`` plus ``step``/``round`` set) kills
        that worker, or that whole pod, mid-step once; ``skew`` maps flat
        worker id -> slowdown factor for the telemetry (a stand-in for a
        degraded chip); ``rejoin_step`` regrows a shrunken fleet to full
        strength at that step boundary (the lost pod returning).
        Auto-resumes from the newest intact committed checkpoint when one
        exists."""
        step = 0
        if self.manager is not None and self.manager.latest_step() is not None:
            step = self._restore()
            if self.ranks is not None and self.ranks.grouped:
                self._agree_params()
        while step < total_steps:
            if self.ranks is None:
                step = self._idle(step, total_steps, rejoin_step)
                continue
            try:
                step = self._run_steps(step, total_steps, fail, skew,
                                       rejoin_step)
            except (health_mod.WorkerLoss, health_mod.PodLoss,
                    elastic.InjectedFailure) as e:
                step = self._recover(e, step)
                fail = None                  # consumed
        self.close()
        return self.summary()

    def _survivors(self, pods: int, n: int, kept) -> tuple:
        """The global ranks of the current group whose share of the
        ``pods x n`` frames holds a frame of ``kept`` (those of the
        survivor fleet)."""
        m, f = self.members, pods * n
        bounds = [i * f // len(m) for i in range(len(m) + 1)]
        return tuple(g for i, g in enumerate(m)
                     if any(bounds[i] <= x < bounds[i + 1] for x in kept))

    def _recover(self, e: Exception, step: int) -> int:
        """Shrink the fleet past the loss ``e``, restore, and return the
        step to resume at."""
        t0 = time.perf_counter()
        at = int(getattr(e, "step", None) or step)
        pod = getattr(e, "pod", None)
        rec: dict = {"failed_step": at}
        pods, n = self.pods, self.n
        if pod is not None:
            if self.pods <= 1:
                raise e
            lost = int(pod) % self.pods
            # every surviving pod runs the same schedule over the same
            # pinned compositions: demote to the largest divisor fleet
            # and idle the remainder
            new_pods = max(d for d in range(1, self.pods)
                           if self.p0 % d == 0)
            kept_pods = [p for p in range(pods) if p != lost][:new_pods]
            kept = [p * n + w for p in kept_pods for w in range(n)]
            if isinstance(e, elastic.InjectedFailure):
                self.monitor.note_failure(
                    at, pod=lost, detail=f"injected at round {e.round}")
            self.monitor.resize(
                topology=health_mod.FleetTopology(new_pods, self.n))
            rec["pod"] = lost
            rec["idle_pods"] = (self.pods - 1) - new_pods
            self.pods = new_pods
            what = f"pod {lost}"
        else:
            lost = (int(getattr(e, "worker", None) or 0)
                    % (self.pods * self.n))
            if isinstance(e, elastic.InjectedFailure):
                self.monitor.note_failure(
                    at, lost, detail=f"injected at round {e.round}")
            if self.pods == 1:
                survivors = [i for i in range(self.n) if i != lost]
                if not survivors:
                    raise e
                self.monitor.resize(survivors)
                self.n = len(survivors)
                kept = survivors
            else:
                # multi-pod worker loss: the pods run one schedule, so
                # the lost worker's slot goes in every pod
                if self.n <= 1:
                    raise e
                self.monitor.resize(topology=health_mod.FleetTopology(
                    self.pods, self.n - 1))
                self.n -= 1
                kept = [f for f in range(pods * n) if f % n != lost % n]
            rec["worker"] = lost
            what = f"worker {lost}"
        if self.world.grouped:
            members = self._survivors(pods, n, kept)
            if len(members) > self.pods * self.n:
                raise ValueError(f"{len(members)} ranks for "
                                 f"{self.pods * self.n} survivor frames")
            # the writer finishes its in-flight save, and every member of
            # the old group waits for it, before the survivors form their
            # group and restore from the directory they share
            if self.manager is not None:
                self.manager.wait()
            wirelib.barrier(self.ranks)
            self.members = members
            self.ranks = wirelib.subgroup(members, self.ranks)
            rec["members"] = list(members)
        if self.state.residual is not None:
            # EF residuals accumulate per-topology quantization error —
            # never reuse them across a resize
            compression.reset_residuals(self.state.residual)
            rec["ef_reset"] = True
        resume = self._restore()
        if self.ranks is not None and self.ranks.grouped:
            self._agree_params()
        rec.update(resume_step=resume, steps_lost=at - resume,
                   pods=self.pods, n_workers=self.n,
                   wall_s=time.perf_counter() - t0)
        self.recoveries.append(rec)
        if pod is not None:
            # overlapping recovery: survivors train on while the regrow
            # path warms on a host thread (on the idle ranks too)
            self._start_prewarm(resume)
        if self.verbose and self._lowest():
            print(f"[supervisor] lost {what} ({e}); replanning on "
                  f"{self.pods}x{self.n} survivors, resuming at step "
                  f"{resume}", flush=True)
        return resume

    def _idle(self, step: int, total: int, rejoin_step) -> int:
        """An idle rank runs no step: it waits for the survivors at the
        world group's rejoin point and returns the step they rejoin at,
        or, with no rejoin before ``total``, goes on to :meth:`close`."""
        if rejoin_step is None or int(rejoin_step) >= total:
            return total
        return self._rejoin(max(step, int(rejoin_step)))

    def _run_steps(self, start: int, total: int, fail, skew,
                   rejoin_step=None) -> int:
        step = start
        while step < total:
            if (rejoin_step is not None and step >= int(rejoin_step)
                    and (self.pods, self.n) != (self.p0, self.n0)):
                step = self._rejoin(step)
            pods, n = self.pods, self.n
            nt = pods * n
            skew_vec = None
            if skew:
                skew_vec = np.ones(nt)
                for w, f in dict(skew).items():
                    if 0 <= int(w) < nt:
                        skew_vec[int(w)] = float(f)
            b = self.loader.next()
            if fail is not None and step == int(fail.step):
                hit = (int(fail.pod) < pods if fail.pod is not None
                       else int(fail.worker) < nt)
                if hit:
                    # mid-step: the batch was fetched and the round loop
                    # "started" — the step never commits, and the loader
                    # state is left advanced; recovery must rewind it
                    # from the checkpoint (replay proof)
                    raise fail
            speeds = self.monitor.planning_speeds()
            scheds, keys = self._plan(b.seqlens, pods, n, speeds)
            tpw = elastic.replan_tpw(
                elastic.pod_survivor_seqlens(b.seqlens, self.p0, pods),
                n, self.pcfg.block_size)
            batch = batch_arrays(self._fleet_batch(b, pods, n, tpw),
                                 self.cfg, self.device,
                                 frames=self._frames(pods, n))
            fn = self._step_fn(step, pods, n, keys, scheds)
            if step + 1 < total:
                self._prefetch(self.loader.peek_seqlens(), pods, n, speeds)
            w0 = wirelib.wire_stats()
            (loss, gnorm), own = ex.timed_call(
                functools.partial(fn, held=held(self.state)), batch)
            w1 = wirelib.wire_stats()
            # the fleet's step ends when its slowest rank's does: every
            # rank's monitor sees that one number
            dt = wirelib.all_max(own, self.ranks, self.device)
            self.monitor.observe(
                step, health_mod.per_worker_times(dt, nt, skew_vec))
            ev = self.monitor.maybe_replan(step)
            if ev is not None and self.verbose and self._lowest():
                print(f"[supervisor] {ev.kind} workers {ev.workers} "
                      f"at step {step} (speeds {ev.speeds}): "
                      f"{ev.detail}", flush=True)
            self.monitor.check(step)
            self.history.append(StepRecord(
                step, float(loss), float(gnorm), dt * 1e3, n, pods,
                *(w1[k] - w0[k] for k in ("sent_bytes", "ship_s",
                                          "reduce_s")), own * 1e3))
            self.last_scheds = scheds
            every = max(int(self.pcfg.checkpoint_every), 0)
            if every and (step + 1) % every == 0:
                self._save(step)
            if self.verbose and self._lowest():
                print(f"step {step:5d}  loss {float(loss):.4f}  "
                      f"gnorm {float(gnorm):.3f}  "
                      f"[{pods}x{n}w {dt * 1e3:.0f}ms]", flush=True)
            step += 1
        return total

    # -- overlapping recovery ----------------------------------------------

    def _start_prewarm(self, resume: int) -> None:
        """Start the regrow-prewarm thread after a pod loss (host work
        only: planning, verification and file reads, nothing on the
        card while the survivors' steps run)."""
        self._prewarm_info = {
            "plans_prefetched": 0, "survivor_schedules_verified": 0,
            "violations": 0, "staged_step": None}
        # pin the checkpoint to stage now (the newest committed step, the
        # one the recovery restored): survivor saves landing while the
        # thread runs must not move it
        stage = (self.manager.latest_step()
                 if self.manager is not None else None)
        self._prewarm = threading.Thread(
            target=self._prewarm_regrow,
            args=(resume, stage, self._prewarm_info), daemon=True)
        self._prewarm.start()

    def _prewarm_regrow(self, resume: int, stage: int | None,
                        info: dict) -> None:
        from ..analysis import verifier
        from ..checkpoint import checkpointer
        try:
            # the pinned stream's distinct upcoming compositions (pure in
            # (seed, step): safe to read from a thread)
            horizon = (max(2 * self.monitor.window, 4) if self.loader.fresh
                       else len(self.loader.compositions))
            seen: set = set()
            comps = []
            for k in range(horizon):
                cid, seqlens = self.loader.composition(resume + k)
                if cid not in seen:
                    seen.add(cid)
                    comps.append(seqlens)
            nh, nkv, hd = self._heads
            for seqlens in comps:
                for m in self.group_masks:
                    # the survivor plan: built (shared with the live loop
                    # through the cache) and statically verified
                    skey = self._group_key(seqlens, self.pods, self.n, m,
                                           None)
                    sched = self.plan_cache.get_or_build(
                        skey, self._group_build(seqlens, self.pods, self.n,
                                                m, None))
                    bad = verifier.verify_schedule(
                        sched, n_q_heads=nh, n_kv_heads=nkv, head_dim=hd,
                        in_dtype_bytes=float(self.pcfg.in_dtype_bytes))
                    info["survivor_schedules_verified"] += 1
                    info["violations"] += len(bad)
                    # the full-fleet plan the regrown fleet will ask for:
                    # at full strength replan_key is the pre-shrink key
                    fkey = self._group_key(seqlens, self.p0, self.n0, m,
                                           None)
                    if fkey not in self.plan_cache:
                        self.plan_cache.get_or_build(
                            fkey, self._group_build(seqlens, self.p0,
                                                    self.n0, m, None))
                    info["plans_prefetched"] += 1
            if self.manager is not None and stage is not None:
                # only the structure of ``like`` is read; leaves come
                # back as host tensors
                like = {"params": self.state.params, "opt": self.state.opt}
                path = self.manager.path(stage)
                self._staged = {"step": int(stage),
                                "tree": checkpointer.restore(path, like),
                                "extra": checkpointer.read_extra(path)}
                info["staged_step"] = int(stage)
        except Exception as exc:    # best effort: the rejoin goes cold
            info["error"] = repr(exc)

    def _rejoin(self, step: int) -> int:
        """Regrow the fleet to full strength at a step boundary: join the
        prewarm thread, reset the monitor's topology and the EF
        residuals, and record the rejoin's cost and whether the
        full-fleet plan keys were already cached; returns the step to go
        on at.  The reference pulls the survivors' state to the host and
        re-shards it onto the big mesh; stacked workers read the same
        tensors at any fleet size, so the state stays on the card and
        ``rejoin_ms`` measures the rest of the same span.  Across ranks
        the world group forms again here and the lowest surviving rank
        broadcasts the state to the returning ranks (class docstring):
        the record holds the broadcast's bytes and seconds."""
        t0 = time.perf_counter()
        if self._prewarm is not None:
            self._prewarm.join()
            self._prewarm = None
        m0 = self.plan_cache.stats.misses
        c0, b0 = len(self.compiled_at), self.builds()
        self.pods, self.n = self.p0, self.n0
        self.monitor.resize(
            topology=health_mod.FleetTopology(self.p0, self.n0))
        if self.state.residual is not None:
            compression.reset_residuals(self.state.residual)
        sent = {}
        if self.world.grouped:
            step, sent = self._regroup(step)
        keys_cached = all(
            self._group_key(self.loader.peek_seqlens(), self.p0, self.n0,
                            m, None) in self.plan_cache
            for m in self.group_masks)
        self.rejoins.append({
            "step": step, "pods": self.pods, "n_workers": self.n,
            "rejoin_ms": (time.perf_counter() - t0) * 1e3,
            "plan_keys_cached": keys_cached,
            "plan_misses_before": m0, "compiles_before": c0,
            "builds_before": b0,
            "prewarm": self._prewarm_info, **sent})
        if self.verbose and self._lowest():
            print(f"[supervisor] pod rejoin at step {step}: fleet back to "
                  f"{self.p0}x{self.n0} "
                  f"({'warm' if keys_cached else 'cold'} plans)",
                  flush=True)
        return step

    def _regroup(self, step: int) -> tuple[int, dict]:
        """The world group again: the lowest surviving rank's parameters,
        AdamW state, loader state, rejoin step and the monitor's last
        event step (its cooldown) broadcast to every rank, then the
        parameters agreed.  Returns the survivors' step and what the
        broadcast cost this rank."""
        src, st = self.members[0], self.state
        meta = torch.tensor([step, self.loader.state.step,
                             self.loader.state.seed,
                             self.monitor._last_event_step],
                            dtype=torch.int64, device=self.device)
        tensors = adamw.tree_leaves({"params": st.params, "m": st.opt.m,
                                     "v": st.opt.v}) + [st.opt.step, meta]
        wirelib.barrier(self.world)
        w0, t0 = wirelib.wire_stats(), time.perf_counter()
        wirelib.broadcast(tensors, src, self.world)
        seconds = time.perf_counter() - t0
        w1 = wirelib.wire_stats()
        step, lstep, seed, last_event = (int(x) for x in meta.tolist())
        self.loader.state = LoaderState(step=lstep, seed=seed)
        self.monitor._last_event_step = last_event
        self.members, self.ranks = tuple(range(self.world.size)), self.world
        self._agree_params()
        return step, {"broadcast_src": src,
                      "broadcast_bytes": w1["broadcast_bytes"]
                      - w0["broadcast_bytes"],
                      "broadcast_priced": wirelib.broadcast_bytes(
                          tensors, src, self.world),
                      "broadcast_s": seconds}

    def close(self) -> None:
        """Join the prewarm thread, stop the planner and land the last
        save; across ranks every rank then meets at the world group
        (idle ranks wait here), and the group is left if this loop
        joined it.  Runs once."""
        if self._closed:
            return
        self._closed = True
        if self._prewarm is not None:
            self._prewarm.join()
            self._prewarm = None
        self.planner.shutdown()
        if self.manager is not None:
            self.manager.wait()
        if self.world.grouped:
            wirelib.barrier(self.world)
            if self._leave:
                wirelib.leave()

    def summary(self) -> dict:
        s = self.plan_cache.stats
        return {
            "steps": len(self.history),
            "pods": self.pods,
            "n_workers": self.n,
            "recoveries": self.recoveries,
            "rejoins": self.rejoins,
            "events": [dataclasses.asdict(e)
                       for e in self.monitor.events],
            "compiles": len(self.compiled_at),
            "plan_cache": s.to_dict(),
            "plan_ahead_hits": self.planner.prefetched_hits,
        }

    def report(self, wall_s: float) -> dict:
        """This rank's run as a JSON-able dict (as :meth:`Trainer.report`),
        with its recoveries, rejoins and the members of its last group."""
        cuda = self.device.type == "cuda"
        return {"rank": self.world.rank, "ranks": self.world.size,
                "backend": self.world.backend, "device": str(self.device),
                "members": list(self.members),
                "frames": (list(self._frames(self.pods, self.n))
                           if self.ranks is not None and self.world.grouped
                           else None),
                "records": [dataclasses.asdict(r) for r in self.history],
                "compiled_at": list(self.compiled_at),
                "recoveries": self.recoveries, "rejoins": self.rejoins,
                "launches": {f.__name__: f.launches for f in fa.COUNTED},
                "wire": wirelib.wire_stats(), "wall_s": wall_s,
                "peak_mem_gib": (torch.cuda.max_memory_allocated(
                    self.device) / 2**30 if cuda else None)}


# flags kept for the reference CLI's parity that the port does not read:
# setting one to anything but its default warns
PARITY_ONLY_FLAGS = ("shape", "attn_block_q", "attn_block_k",
                     "attn_interpret")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True,
                   help="a config of repro_torch/configs: dense "
                        "(stablelm_1_6b, codeqwen1_5_7b, llama3_70b, "
                        "qwen1_5_32b/110b), MoE (granite_moe_3b_a800m, "
                        "moonshot_v1_16b_a3b), SSM (mamba2_130m), hybrid "
                        "(zamba2_2_7b), audio (musicgen_large) or "
                        "vision-language (internvl2_1b; both train behind "
                        "batch_arrays' front-end stub).  chip_smoke.py "
                        "trains all but codeqwen1_5_7b, qwen1_5_32b and "
                        "qwen1_5_110b on the card (most at a cut depth)")
    p.add_argument("--shape", default=None,
                   help="assigned shape cell (accepted for parity; the "
                        "loop does not read it and warns when it is set)")
    p.add_argument("--smoke", action="store_true",
                   help="use the reduced smoke config")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--mesh", default="1x1",
                   help="DxM (data x model) or PxDxM (pod x data x model)"
                        " stacked mesh: P pods of D CP workers, every pod"
                        " running the same D-worker plan")
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
    p.add_argument("--remat-policy", default="dots",
                   choices=["dots", "nothing"],
                   help="per-layer activation checkpointing: dots (the"
                        " reference's default) saves every product without"
                        " batch dimensions and recomputes the rest;"
                        " nothing recomputes the whole layer")
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
                        " several CP workers and no model axis (single- or"
                        " multi-pod): health telemetry, closed-loop"
                        " straggler demotion, pod-level failure domains"
                        " with overlapping recovery, checkpoint/replay"
                        " recovery (--no-supervised forces the plain"
                        " loop)")
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
                        "PyTorch versions of the kernels).  Under torchrun"
                        " cuda is cuda:LOCAL_RANK; two ranks share a card"
                        " only when given one (cuda:0), and only over"
                        " gloo")
    p.add_argument("--dist-backend", default="nccl",
                   choices=list(wirelib.BACKENDS),
                   help="the process group's backend under torchrun (either"
                        " loop of a dense model, its CP workers split over"
                        " the ranks); nothing falls back to another"
                        " backend")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    return build_parser().parse_args(argv)


def configs_from_args(args: argparse.Namespace) -> tuple:
    """The model, parallel and training configs of the CLI's
    arguments."""
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
                          remat_policy=args.remat_policy,
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
    return cfg, pcfg, tcfg


def trainer_from_args(args: argparse.Namespace) -> Trainer | Supervisor:
    """The CLI's loop, routed as the reference routes it: the
    :class:`Supervisor` for ``--supervised`` FCP runs with more than one
    CP worker and no model axis, else the plain :class:`Trainer` (warns
    for a parity-only flag set to anything but its default)."""
    parser = build_parser()
    for name in PARITY_ONLY_FLAGS:
        if getattr(args, name) != parser.get_default(name):
            warnings.warn(f"--{name.replace('_', '-')} is accepted for the "
                          f"reference CLI's parity and has no effect here",
                          stacklevel=2)
    mesh = parse_mesh(args.mesh)
    env = wirelib.launch_env()
    dev_spec = args.device
    if env is not None:
        dev_spec = ranked_device(args.dist_backend, args.device, env)
    device = resolve_device(dev_spec)
    cfg, pcfg, tcfg = configs_from_args(args)
    n_cp, tp = mesh.shape["data"], mesh.shape["model"]
    supervised = (args.supervised and cfg.uses_attention and n_cp > 1
                  and tp == 1)
    # under torchrun both loops join the process group
    backend = args.dist_backend if env is not None else None
    if supervised:
        return Supervisor(cfg, pcfg, tcfg, n_workers=n_cp,
                          tokens_per_worker=args.tokens_per_worker,
                          pods=mesh.pods, dist=args.dist,
                          fresh=args.fresh_stream,
                          checkpoint_dir=args.checkpoint_dir, device=device,
                          attn_impl=args.attn_impl, dist_backend=backend)
    return Trainer(cfg, pcfg, tcfg, mesh,
                   tokens_per_worker=args.tokens_per_worker, dist=args.dist,
                   fresh=args.fresh_stream, device=device,
                   log_every=args.log_every, attn_impl=args.attn_impl,
                   checkpoint_dir=args.checkpoint_dir, dist_backend=backend)


def ranked_device(backend: str, device: str, env: dict) -> str:
    """The device of this rank under ``torchrun``: ``cuda`` is
    ``cuda:LOCAL_RANK``.  NCCL takes one card per rank: two local ranks on
    one named card, or on the CPU, are refused (nothing falls back to
    gloo)."""
    dev = torch.device(device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("NCCL needs a CUDA device per rank; use "
                         "--dist-backend gloo for ranks on the CPU")
    if backend == "nccl" and dev.index is not None and env["local_size"] > 1:
        raise ValueError(
            f"NCCL cannot run two ranks on one device ({device} for all "
            f"{env['local_size']} local ranks): give each rank its own card"
            f" (--device cuda is cuda:LOCAL_RANK) or use --dist-backend "
            f"gloo")
    if dev.type == "cuda" and dev.index is None:
        return f"cuda:{env['local_rank']}"
    return device


def main(argv=None) -> Trainer | Supervisor:
    args = parse_args(argv)
    trainer = trainer_from_args(args)
    try:
        out = trainer.run(args.steps)
    finally:
        trainer.close()
    if trainer.ranks is None or trainer.ranks.rank != 0:
        return trainer                  # the lowest rank prints
    s = trainer.plan_cache.stats
    print(f"plan cache: {s.hits} hits / {s.misses} misses "
          f"(hit rate {s.hit_rate:.2f}), "
          f"{trainer.plan_cache.n_unique_specs} static specs, "
          f"{trainer.planner.prefetched_hits} plan-ahead builds consumed")
    if isinstance(trainer, Supervisor):
        print(f"health: {len(out['events'])} event(s), "
              f"{len(out['recoveries'])} recover(ies), "
              f"{out['compiles']} compiles")
    else:
        print(f"step programs: {len(trainer.compiled_at)} compiles")
    print("done.")
    return trainer


if __name__ == "__main__":
    main()
