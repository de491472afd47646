"""FCP attention executor on stacked workers (port of ``repro.core.executor``).

Runs a host-built :class:`~repro_torch.core.schedule.Schedule` on one
device: the plan's N context-parallel workers sit on a leading tensor
dimension, and every ppermute of the reference becomes
:func:`repro_torch.runtime.wire.ship` (an index copy through the
schedule's wire format, differentiable like the reference's).

* **transparent reshuffle** — (q, k, v) blocks move from the stream
  layout to the schedule layout through the plan's reshuffle rounds (and
  ``o`` moves back through the restore rounds);
* **software-pipelined rounds** — the round loop has two modes.
  Serial (``spec.overlap`` off): per coalesced round ``r`` ship the
  round's KV stacks, compute run ``r``, then commit the arrivals into
  the colored receive slots (consumers of round ``r`` sit in runs
  ``> r``).  Overlap (``spec.overlap`` on, the double-buffered pipeline
  of paper §5): round ``r+1``'s sends are issued *before* run ``r``'s
  compute, gathered from a frozen snapshot of the local KV slots (sends
  only ever read local slots or the zero trash row), and land in the
  parity-allocated receive slots, so a commit never races a run's
  reads.  Each of the round's ships is started (``runtime/wire.start``:
  encoded, staged and posted) before run ``r`` and landed
  (``wire.finish``) at the commit after it, so across ranks round
  ``r+1``'s bytes move while run ``r`` computes.  On the card a round's
  gather, wire encode, staging and decode run on a side CUDA stream: it
  waits on an event recorded when the snapshot is ready, round ``r+1``
  is posted once run ``r`` is queued on the main stream, and the main
  stream waits on the landed round's event before the commit.  Under
  autograd each backward op runs on its forward op's stream, so the
  backward ships (blocking, ``wire``'s ``_Ship``) ride the side stream
  too;
* **compute runs** — ``ExecConfig.impl`` takes the reference's four
  ``attention_impl`` names:

  - ``fused``: ONE ``fused_run_attention`` call per run covering all N
    workers — CUDA kernel 1 forward, kernels 3 and 4 backward;
  - ``pallas``: per step index, ONE batched ``block_attention`` over the
    N workers' (q slot, kv slot) pairs plus ``merge_partials`` into the
    accumulators — kernel 2 forward, kernels 5 and 6 backward;
  - ``fused_xla`` / ``xla``: the same two groupings on the plain
    PyTorch versions, on any device (the yardsticks the kernels are
    held against).

  On CPU tensors the kernel impls take the plain versions too.

The executor is differentiable.  Its writes are in place only while no
gradient is needed (serving): the reshuffle scatters into ``qs``/``ks``/
``vs``, the fused runs on the accumulators, the arrival commits into
``kxt``/``vxt`` and the restore scatter into ``o_u``.  Under autograd
every one of them is out of place (``index_put``, and the fused run
returns fresh accumulators): a run saves the ``kxt``/``vxt`` it read for
its backward, and the receive slots are live-range colored, so a later
round's commit reuses a slot an earlier run read — an in-place commit
would both fail autograd's version check and be wrong.  Both modes give
the same bytes (``tests/test_torch_train.py``).

Also provides ``cp_decode_attention`` / ``cp_cache_update``: decode
against a KV cache whose sequence dim is split into shards; the
per-shard partials merge with a plain reduction over the shard dim (the
reference's pmax/psum).  With the shards split over ranks (``ranks=``)
each rank attends its own and the partials are gathered across ranks
(``runtime/wire.gather``) before the same reduction.

For the layer-pipelined reshuffle, ``fcp_attention(...,
layout="sched")`` takes q/k/v already in the schedule layout and returns
o in it (no per-layer Q/K/V reshuffle or O restore), while
:func:`fcp_reshuffle` moves any per-token tensor (the hidden state)
between the layouts once per layer group.

**Pod meshes.**  ``schedule_tables(sched, device, pods=P)`` folds P pods
into the stacked worker axis: every per-worker table is tiled P times
(frame ``p * n + w`` is worker ``w`` of pod ``p``) and every ship's
permutation is offset by ``p * n`` (:func:`pod_perm`), so each pod runs
the same n-worker schedule on its own frames, ships never cross a pod,
and one launch of each kernel still covers every frame.  The replicated
block metadata (``blk_seg``/``blk_pos``) is shared: every pod packs the
same composition.

**Ranks.**  ``schedule_tables(sched, device, pods, ranks=r)`` in a
process group of R ranks returns this rank's rows of every per-worker
table (its contiguous share of the pods x workers frames,
``Ranks.share``: equal shares at the start, uneven ones after a worker
loss) and all of the replicated ones: the reference's ``P(cp_axis)``
against ``P()`` split.  A pod's ships never leave its frames, so a rank
holding whole pods ships only inside itself.  :func:`fcp_attention` then runs
on the rank's frames with local indices everywhere, and hands each ship
the plan's global pairs (``runtime/wire.ship`` moves the pairs that
cross ranks through ``torch.distributed``).  The same holds for the
overlap loop (its ships started and landed across ranks), the schedule
layout (its inputs already on the rank's frames, no restore) and
:func:`fcp_reshuffle`, on equal shares and on a survivor group's uneven
ones.  ``runtime.wire.rank_wire_bytes`` prices what a rank sends in one
call (``layout="sched"``: the rounds alone) and
``wire.reshuffle_wire_bytes`` what it sends in one
:func:`fcp_reshuffle`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time

import numpy as np
import torch

from ..kernels import ops
from ..kernels.flash_attention import run_segments
from ..kernels.ref import NEG_INF
from ..runtime import wire as wirelib
from .schedule import PlanArrays, Schedule, StaticSpec

# impl -> (grouping, kernels.ops impl)
_IMPLS = {"fused": ("fused", "kernel"), "pallas": ("step", "kernel"),
          "fused_xla": ("fused", "plain"), "xla": ("step", "plain")}


@dataclasses.dataclass(frozen=True)
class ExecConfig:
    # "fused" / "pallas": the hand-written CUDA kernels (their plain
    # versions on CPU tensors), one launch per run / per step index;
    # "fused_xla" / "xla": the same groupings on the plain PyTorch
    # versions on any device
    impl: str = "fused"
    out_dtype: str | None = None    # e.g. "bfloat16": halve restore bytes

    def __post_init__(self):
        if self.impl not in _IMPLS:
            raise ValueError(f"unknown executor impl {self.impl!r} "
                             f"(expected one of {tuple(_IMPLS)})")

    @property
    def fused(self) -> bool:
        """One launch per run (else one per step index)."""
        return _IMPLS[self.impl][0] == "fused"

    @property
    def kernel_impl(self) -> str:
        """The ``kernels.ops`` impl this executor impl runs."""
        return _IMPLS[self.impl][1]


def plan_tables(arrays: PlanArrays, device) -> dict[str, torch.Tensor]:
    """numpy plan tables → device tensors (leading dim = CP workers)."""
    return {f.name: torch.from_numpy(getattr(arrays, f.name)).to(device)
            for f in dataclasses.fields(arrays)}


# PlanArrays' replicated tables (every other one is per worker)
_SHARED = ("blk_seg", "blk_pos")


@functools.lru_cache(maxsize=4096)
def pod_perm(perm: tuple, n: int, pods: int) -> tuple:
    """A ship's partial permutation over one pod's ``n`` workers, as
    ``pods`` disjoint copies over the stacked pod-major frames."""
    return tuple((s + p * n, d + p * n) for p in range(pods)
                 for s, d in perm)


def schedule_tables(sched: Schedule, device, pods: int = 1,
                    ranks: wirelib.Ranks = wirelib.STACKED) -> dict:
    """Device tables for :func:`fcp_attention`, memoized on the schedule
    (per device, pod count and rank split): plan-cache hits return the
    same ``Schedule``, so repeated batches reuse the uploaded tables.
    ``pods`` > 1 tiles every per-worker table over the pods; ``ranks`` in
    a process group keeps this rank's frames of them (module docstring).

    Beyond the raw :class:`PlanArrays`, the memo holds what the kernels
    read per run, sliced contiguous once: the run's step tables and the
    kv mask metadata of each step, in the forward (q-slot-sorted) order
    and in the backward (kv-row-sorted) order, the segment tables over
    both (one ``(lo, hi)`` step range per distinct q slot / kv row;
    trash steps get none, so they never touch a real slot), and the
    per-step-index tables of the ``pallas``/``xla`` impls."""
    device = torch.device(device)
    pods = int(pods)
    if pods < 1:
        raise ValueError(f"pods must be >= 1, got {pods}")
    memo = sched._device_tables
    if memo is None:
        memo = sched._device_tables = {}
    spec, arr = sched.spec, sched.arrays
    frames = ranks.share(spec.n_workers * pods)
    key = (str(device), pods, ranks)
    if key in memo:
        return memo[key]
    if pods > 1:
        arr = dataclasses.replace(arr, **{
            f.name: np.tile(getattr(arr, f.name),
                            (pods,) + (1,) * (getattr(arr, f.name).ndim - 1))
            for f in dataclasses.fields(arr) if f.name not in _SHARED})
    if frames != (0, spec.n_workers * pods):
        arr = dataclasses.replace(arr, **{
            f.name: getattr(arr, f.name)[frames[0]:frames[1]]
            for f in dataclasses.fields(arr) if f.name not in _SHARED})
    t = plan_tables(arr, device)
    N = frames[1] - frames[0]
    wk = torch.arange(N, device=device)
    t["q_seg"] = t["blk_seg"][t["sched_blk"].long()]      # [N, SL, bs]
    t["q_pos"] = t["blk_pos"][t["sched_blk"].long()]

    def segs(keys, skip):
        lo, hi = run_segments(keys, skip_slot=skip)
        return torch.from_numpy(lo).to(device), torch.from_numpy(hi).to(device)

    runs = []
    for r in range(spec.n_runs):
        lo, hi = spec.run_starts[r], spec.run_starts[r + 1]
        if hi == lo:
            runs.append(None)
            continue
        blk = t["step_kv_blk"][:, lo:hi].long()
        blk_b = t["bwd_kv_blk"][:, lo:hi].long()
        run = {
            "step_q": t["step_q"][:, lo:hi].contiguous(),
            "step_kv": t["step_kv"][:, lo:hi].contiguous(),
            "q_seg": t["q_seg"], "q_pos": t["q_pos"],
            "k_seg": t["blk_seg"][blk], "k_pos": t["blk_pos"][blk],
            "segments": segs(arr.step_q[:, lo:hi], spec.q_trash),
            "bwd_q": t["bwd_q"][:, lo:hi].contiguous(),
            "bwd_kv": t["bwd_kv"][:, lo:hi].contiguous(),
            "k_seg_b": t["blk_seg"][blk_b], "k_pos_b": t["blk_pos"][blk_b],
            "kv_segments": segs(arr.bwd_kv[:, lo:hi], spec.kv_trash),
        }
        # per step index: the N workers' (q slot, kv row) pair and its
        # mask metadata, for one batched block_attention
        run["steps"] = [
            (run["step_q"][:, i].long(), run["step_kv"][:, i].long(),
             t["q_seg"][wk, run["step_q"][:, i].long()],
             t["q_pos"][wk, run["step_q"][:, i].long()],
             run["k_seg"][:, i].contiguous(),
             run["k_pos"][:, i].contiguous()) for i in range(hi - lo)]
        runs.append(run)
    t["runs"] = runs
    t["workers"] = wk[:, None]
    t["pods"] = pods
    t["ranks"], t["frames"] = ranks, frames
    memo[key] = t
    return t


def _check_frames(n_frames: int, tpw: int, spec: StaticSpec, tables: dict,
                  what: str) -> int:
    """The pod count of ``n_frames`` stacked frames against the plan's
    workers, the tables' pods and the frames this rank holds."""
    pods, (lo, hi), ranks = tables["pods"], tables["frames"], tables["ranks"]
    if n_frames != hi - lo or tpw != spec.slots * spec.block_size:
        held = (f", frames {lo}-{hi - 1} on rank {ranks.rank} of "
                f"{ranks.size}" if ranks.grouped else "")
        raise ValueError(
            f"{what} does not match the plan ({pods} pod(s) x "
            f"{spec.n_workers} workers x {spec.slots * spec.block_size} "
            f"tokens{held})")
    return pods


def _gather_rows(buf: torch.Tensor, idx: torch.Tensor,
                 workers: torch.Tensor) -> torch.Tensor:
    """Per worker ``buf[w, idx[w]]`` (``[N, k, ...]``); ``idx == -1`` →
    zeros."""
    safe = idx.clamp(0, buf.shape[1] - 1).long()
    out = buf[workers, safe]
    keep = (idx >= 0).reshape(idx.shape + (1,) * (out.ndim - 2))
    return torch.where(keep, out, 0)


def _with_trash(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, x.new_zeros((x.shape[0], 1) + x.shape[2:])], dim=1)


def _put(buf: torch.Tensor, idx: tuple, val: torch.Tensor,
         inplace: bool) -> torch.Tensor:
    """``buf[idx] = val``: in place, or out of place under autograd."""
    if inplace:
        buf[idx] = val
        return buf
    return buf.index_put(idx, val.to(buf.dtype))


@functools.lru_cache(maxsize=None)
def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """The overlap loop's side stream, one per device for the process:
    the caching allocator hands a freed block back only to its own
    stream, so a new stream per call would strand each call's ship
    buffers in a step program's graph pool."""
    return torch.cuda.Stream(device)


def fcp_attention(q, k, v, tables: dict, *, spec: StaticSpec,
                  cfg: ExecConfig = ExecConfig(),
                  layout: str = "stream") -> torch.Tensor:
    """FCP attention over N stacked workers (``N = pods x n`` frames of
    an n-worker plan, pod-major, with ``tables`` built for those pods).

    q: ``[N, tpw, HQ, D]``; k/v: ``[N, tpw, KH, D]`` in the stream
    layout (frame ``w`` is worker ``w``'s share of the packed stream).
    Returns o (f32, or ``cfg.out_dtype``) in the same layout — the
    caller never sees the schedule layout (§4.3).  ``layout="sched"`` is
    the layer-pipelined contract: q/k/v arrive (and o returns) in the
    schedule layout, the caller having moved the hidden state with
    :func:`fcp_reshuffle`.  Differentiable in q, k and v.
    """
    if layout not in ("stream", "sched"):
        raise ValueError(f"unknown layout {layout!r}")
    bs, slots, ext = spec.block_size, spec.slots, spec.ext_slots
    N, tpw, hq, d = q.shape
    kh = k.shape[2]
    pods = _check_frames(N, tpw, spec, tables, f"q {tuple(q.shape)}")
    n = spec.n_workers
    fmt = spec.wire
    t = tables
    wk = t["workers"]
    ranks = t["ranks"]
    # in-place writes only when no gradient flows (module docstring)
    inplace = not (torch.is_grad_enabled()
                   and (q.requires_grad or k.requires_grad
                        or v.requires_grad))

    def ship(payload, perm, start=False):
        # global pairs; this rank's frames (the tables' local rows)
        return (wirelib.start if start else wirelib.ship)(
            payload, pod_perm(perm, n, pods), fmt, ranks, n * pods)

    # stream layout -> [N, slots, heads, bs, d] (head-leading kernel layout)
    def frame(x, h):
        return x.reshape(N, slots, bs, h, d).permute(0, 1, 3, 2, 4)

    q_u, k_u, v_u = frame(q, hq), frame(k, kh), frame(v, kh)

    # ---- transparent reshuffle: stream layout -> schedule layout ----------
    if layout == "sched":
        # layer-pipelined path: the inputs are already schedule-resident
        qs, ks, vs = _with_trash(q_u), _with_trash(k_u), _with_trash(v_u)
    else:
        src = t["resh_local_src"]
        qs = _with_trash(_gather_rows(q_u, src, wk))
        ks = _with_trash(_gather_rows(k_u, src, wk))
        vs = _with_trash(_gather_rows(v_u, src, wk))
        if spec.n_resh_rounds:
            # senders gather through a trash row: idle lanes ship zeros
            q_ut, k_ut, v_ut = (_with_trash(q_u), _with_trash(k_u),
                                _with_trash(v_u))
        for r in range(spec.n_resh_rounds):
            snd = t["resh_send_slot"][:, r]            # [N, S2] payload rows
            dst = t["resh_dst_slot"][:, r]
            off = 0
            for g in spec.resh_rounds[r].groups:
                idx = snd[:, off:off + g.rows]
                payload = torch.cat([_gather_rows(q_ut, idx, wk),
                                     _gather_rows(k_ut, idx, wk),
                                     _gather_rows(v_ut, idx, wk)], dim=2)
                recv = ship(payload, g.perm)
                # one scatter per group (idle rows land on the trash row)
                at = (wk, dst[:, off:off + g.rows].long())
                qs = _put(qs, at, recv[:, :, :hq], inplace)
                ks = _put(ks, at, recv[:, :, hq:hq + kh], inplace)
                vs = _put(vs, at, recv[:, :, hq + kh:], inplace)
                off += g.rows

    # ---- extended KV buffer (local slots + colored receive slots + trash) -
    zpad = ks.new_zeros((N, ext + 1, kh, bs, d))
    kxt = torch.cat([ks[:, :slots], zpad], dim=1)
    vxt = torch.cat([vs[:, :slots], zpad], dim=1)
    acc_o = torch.zeros((N, slots + 1, hq, bs, d), dtype=torch.float32,
                        device=q.device)
    acc_lse = torch.full((N, slots + 1, hq, bs), NEG_INF,
                         dtype=torch.float32, device=q.device)

    overlap = spec.overlap and spec.n_rounds > 0
    main = side = None
    if overlap:
        # immutable send sources: send rows only name LOCAL slots (<
        # slots) or the trash row, never the receive region the commits
        # write, so payloads gathered from this snapshot are the bytes
        # the serial loop gathers from kxt/vxt
        ksrc = torch.cat([ks[:, :slots], zpad[:, :1]], dim=1)
        vsrc = torch.cat([vs[:, :slots], zpad[:, :1]], dim=1)
        if q.is_cuda:
            main = torch.cuda.current_stream(q.device)
            side = _side_stream(q.device)
            ready = torch.cuda.Event()
            ready.record(main)
            side.wait_event(ready)
            ksrc.record_stream(side)
            vsrc.record_stream(side)

    def on_side():
        return (torch.cuda.stream(side) if side is not None
                else contextlib.nullcontext())

    def issue(r):
        # one ship per group; each moves a stack of up to C KV blocks.
        # Returns [(row offset, group, arrival), ...]: under overlap the
        # arrival is a started ship (wire.start), landed at the commit
        snd = t["send_slot"][:, r]                     # [N, S] payload rows
        out, off = [], 0
        with on_side():
            for g in spec.comm_rounds[r].groups:
                idx = snd[:, off:off + g.rows]
                if overlap:
                    # the trash index (slots + ext) -> the snapshot's zero
                    # row; -1 padding stays -1 (zeros via _gather_rows)
                    idx = idx.clamp(max=slots)
                    payload = torch.cat([_gather_rows(ksrc, idx, wk),
                                         _gather_rows(vsrc, idx, wk)], dim=2)
                else:
                    payload = torch.cat([_gather_rows(kxt, idx, wk),
                                         _gather_rows(vxt, idx, wk)], dim=2)
                out.append((off, g, ship(payload, g.perm, start=overlap)))
                off += g.rows
        return out

    def land(arrived):
        # the started ships of a round, landed (on the side stream), and
        # the event the main stream waits on before the commit
        if not overlap:
            return arrived, None
        ev = None
        with on_side():
            arrived = [(off, g, wirelib.finish(h)) for off, g, h in arrived]
            if side is not None:
                for _, _, recv in arrived:
                    recv.record_stream(main)
                ev = torch.cuda.Event()
                ev.record(side)
        return arrived, ev

    # run r computes between the ship and the arrival commit of round r:
    # consumers of round r's blocks sit in runs > r (§4.2).  Overlap
    # runs one round ahead: round 0 is started in a prologue, iteration r
    # starts round r+1 BEFORE run r's compute (its gathers, encode and
    # staging queued on the side stream), posts it once run r is queued
    # on the main stream, and lands round r after: round r+1 is posted
    # before round r lands, on every rank alike (wire.start)
    pending = issue(0) if overlap else []
    for _, _, h in pending:
        h.post()
    for r in range(spec.n_runs):
        if overlap:
            arrivals = pending if r < spec.n_rounds else []
            pending = issue(r + 1) if r + 1 < spec.n_rounds else []
        else:
            arrivals = issue(r) if r < spec.n_rounds else []
        run = t["runs"][r]
        if run is not None and cfg.fused:
            # ONE launch for the whole run, all workers: step tables drive
            # the KV gathers
            acc_o, acc_lse = ops.fused_run_attention(
                qs, kxt, vxt, acc_o, acc_lse, run, mask=spec.mask,
                impl=cfg.kernel_impl)
        elif run is not None:
            # per step index: one batched launch over the N workers' pairs
            w = wk[:, 0]
            for sq, skv, q_seg, q_pos, k_seg, k_pos in run["steps"]:
                o_p, lse_p = ops.block_attention(
                    qs[w, sq], kxt[w, skv], vxt[w, skv], q_seg, q_pos,
                    k_seg, k_pos, mask=spec.mask, impl=cfg.kernel_impl)
                o_new, l_new = ops.merge_partials(
                    acc_o[w, sq], acc_lse[w, sq], o_p, lse_p)
                acc_o = _put(acc_o, (w, sq), o_new, inplace)
                acc_lse = _put(acc_lse, (w, sq), l_new, inplace)
        if overlap:
            for _, _, h in pending:
                h.post()
        arrived, ev = land(arrivals)
        if ev is not None:
            main.wait_event(ev)
        dst = t["recv_slot"][:, r] if arrived else None
        for off, g, recv in arrived:
            at = (wk, dst[:, off:off + g.rows].long())
            kxt = _put(kxt, at, recv[:, :, :kh], inplace)
            vxt = _put(vxt, at, recv[:, :, kh:], inplace)

    # ---- restore: schedule layout -> stream layout -------------------------
    if cfg.out_dtype is not None:
        # cast before the restore ships: halves restore traffic
        acc_o = acc_o.to(getattr(torch, cfg.out_dtype))
    if layout == "sched":
        # the caller keeps consuming the schedule layout: no restore
        return acc_o[:, :slots].permute(0, 1, 3, 2, 4).reshape(N, tpw, hq, d)
    o_u = _with_trash(_gather_rows(acc_o, t["restore_local_src"], wk))
    for r in range(spec.n_resh_rounds):
        snd = t["restore_send_slot"][:, r]
        dst = t["restore_dst_slot"][:, r]
        off = 0
        for g in spec.resh_rounds[r].groups:
            # reversed partial permutation is a partial permutation
            perm = tuple((d_, s_) for s_, d_ in g.perm)
            recv = ship(_gather_rows(acc_o, snd[:, off:off + g.rows], wk),
                        perm)
            o_u = _put(o_u, (wk, dst[:, off:off + g.rows].long()), recv,
                       inplace)
            off += g.rows
    return o_u[:, :slots].permute(0, 1, 3, 2, 4).reshape(N, tpw, hq, d)


def fcp_reshuffle(x: torch.Tensor, tables: dict, *, spec: StaticSpec,
                  reverse: bool = False) -> torch.Tensor:
    """Move a per-token tensor between the stream and schedule layouts.

    x: ``[N, tpw, C]``, N = pods x the plan's workers (any channel
    count: the hidden state, or the hidden state with the rope
    positions as one extra f32 channel).
    Uses the schedule's reshuffle plan (``reverse=False``: stream ->
    schedule) or its restore plan (``reverse=True``: schedule ->
    stream), the hidden state riding as one fat head, always on the f32
    wire (exact).  This is the layer-pipelined reshuffle primitive:
    move the hidden state once at a layer-group boundary, then run the
    group's layers with :func:`fcp_attention` ``layout="sched"``.
    Differentiable: the backward is the reversed move."""
    bs, slots = spec.block_size, spec.slots
    N, tpw, C = x.shape
    pods = _check_frames(N, tpw, spec, tables, f"x {tuple(x.shape)}")
    t, wk, n = tables, tables["workers"], spec.n_workers
    inplace = not (torch.is_grad_enabled() and x.requires_grad)
    xf = x.reshape(N, slots, 1, bs, C)
    xt = _with_trash(xf)
    # mirrors fcp_attention: forward gathers local rows from the stream
    # frame; restore gathers from the trash-extended schedule frame
    # (restore_local_src may name the q-trash row)
    pre = "restore" if reverse else "resh"
    ys = _with_trash(_gather_rows(xt if reverse else xf,
                                  t[f"{pre}_local_src"], wk))
    for r in range(spec.n_resh_rounds):
        snd = t[f"{pre}_send_slot"][:, r]
        dst = t[f"{pre}_dst_slot"][:, r]
        off = 0
        for g in spec.resh_rounds[r].groups:
            perm = (tuple((d_, s_) for s_, d_ in g.perm) if reverse
                    else g.perm)
            recv = wirelib.ship(_gather_rows(xt, snd[:, off:off + g.rows],
                                             wk),
                                pod_perm(perm, n, pods), wirelib.WIRE_F32,
                                t["ranks"], n * pods)
            ys = _put(ys, (wk, dst[:, off:off + g.rows].long()), recv,
                      inplace)
            off += g.rows
    return ys[:, :slots, 0].reshape(N, tpw, C)


def timed_call(fn, *args):
    """``out, seconds = timed_call(fn, *args)``: wall clock of ``fn``
    including the device work it queued (synchronizes the card)."""
    t0 = time.perf_counter()
    out = fn(*args)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


# --------------------------------------------------------------------------
# context-parallel decode (KV cache split into sequence shards)
# --------------------------------------------------------------------------

def cp_decode_attention(q, k_cache, v_cache, lengths, *, n_shards: int = 1,
                        cfg: ExecConfig = ExecConfig(),
                        ranks: wirelib.Ranks = wirelib.STACKED
                        ) -> torch.Tensor:
    """One-token decode against a cache split into ``n_shards`` sequence
    shards.  q: ``[B, HQ, D]``; k/v_cache: ``[B, S, KH, D]``; lengths:
    ``[B]`` valid cache lengths.  Returns o ``[B, HQ, D]`` f32.

    Each shard attends over its own S range (one kernel launch covers
    every (slot, shard) pair as a batch row); the per-shard partials
    merge with a flash reduction over the shard dim — the reference's
    pmax/psum across the sequence axes.

    ``ranks`` is the process group the sequence shards are split over
    (``--kind long``: the cache's sequence over the data and model axes,
    the data axis over the ranks): the cache is then this rank's
    ``n_shards / R`` shards, positions ``[r·S, (r+1)·S)`` of the whole,
    and the partials of every rank are gathered (``wire.gather``) and
    merged in shard order on each, so every rank ends with the same
    bytes.  A batch split over the ranks (``--kind decode``) needs no
    group here: each rank passes its own slots."""
    B, S, KH, D = k_cache.shape
    if n_shards % ranks.size:
        raise ValueError(f"{ranks.size} ranks do not divide {n_shards} "
                         f"cache shards")
    n_loc = n_shards // ranks.size
    if S % n_loc:
        raise ValueError(f"cache length {S} not divisible into "
                         f"{n_loc} shards")
    shard_len = S // n_loc
    # The cache is read in its own layout through strides: [B*n, KH,
    # shard_len, D] below is a view, not a copy.  The reference's
    # kb.transpose(1, 0, 2) (src/repro/core/executor.py:487) is free
    # under XLA, but in eager PyTorch a transposed copy would move the
    # whole cache once per layer per token.
    kc = k_cache.view(B * n_loc, shard_len, KH, D).transpose(1, 2)
    vc = v_cache.view(B * n_loc, shard_len, KH, D).transpose(1, 2)
    pos_k = torch.arange(S, dtype=torch.int32, device=q.device)
    if ranks.rank:
        pos_k = pos_k + ranks.rank * S          # this rank's positions
    seg_k = torch.where(pos_k[None] < lengths[:, None], 0, -1)
    seg_k = seg_k.to(torch.int32).view(B * n_loc, shard_len)
    pos_k = pos_k.view(n_loc, shard_len).repeat(B, 1)
    zero = torch.zeros((1,), dtype=torch.int32, device=q.device)
    qq = q[:, None].expand(B, n_loc, *q.shape[1:])
    qq = qq.reshape(B * n_loc, q.shape[1], 1, D)
    o, lse = ops.block_attention(qq, kc, vc, zero, zero, seg_k, pos_k,
                                 mask=False, impl=cfg.kernel_impl)
    o = o.view(B, n_loc, -1, D)
    lse = lse.view(B, n_loc, -1)
    if ranks.grouped:
        # every rank's shards, in shard order: [B, n_shards, HQ, D + 1]
        part = wirelib.gather(torch.cat([o, lse[..., None]], dim=-1),
                              ranks, dim=1)
        o, lse = part[..., :D], part[..., D]
    # flash merge across sequence shards (numerically exact)
    m = lse.amax(dim=1, keepdim=True)
    w = torch.exp(lse - m)
    num = (o * w[..., None]).sum(dim=1)
    den = w.sum(dim=1)
    return num / torch.clamp(den, min=1e-37)[..., None]


def cp_cache_update(cache, new, pos,
                    ranks: wirelib.Ranks = wirelib.STACKED):
    """Write one token per row into a ``[B, S, KH, D]`` cache, **in
    place** (and return it).  new: ``[B, KH, D]``; pos: ``[B]``.

    On stacked shards the reference's per-shard masked write collapses
    into one masked row write: the row at ``pos`` takes ``new`` when
    ``0 <= pos < S`` and keeps its bytes otherwise (an overrun drops
    the write, as no shard owns it).  With the sequence split over
    ``ranks`` (``cp_decode_attention``) the cache holds positions
    ``[r·S, (r+1)·S)`` and only the rank that owns ``pos`` writes, at
    ``pos - r·S``; a position past the last rank's is dropped the same
    way."""
    B, S = cache.shape[:2]
    if ranks.rank:
        pos = pos - ranks.rank * S
    rows = torch.arange(B, device=cache.device)
    lp = pos.clamp(0, S - 1).long()
    in_range = ((pos >= 0) & (pos < S))[:, None, None]
    cache[rows, lp] = torch.where(in_range, new.to(cache.dtype),
                                  cache[rows, lp])
    return cache
