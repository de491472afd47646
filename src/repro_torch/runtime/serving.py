"""Continuous-batching FCP serving loop on stacked workers (port of
``repro.runtime.serving``).

* :class:`RequestQueue` — bounded admission-controlled queue; a request
  that cannot fit the decode cache is rejected up front with the
  required length.
* **Bucketed FCP prefill** — prompts prefill in uniform batches of
  ``budget / E`` sequences padded to one bucket edge ``E``; every batch
  of a bucket re-hits the same plan-cache key, so a mixed-length stream
  plans once per bucket.  As in the reference, FCP prefills only when
  ``prefill_impl="fcp"``, the model has attention and the prefill
  frames (``pod x data``) are more than one; otherwise the **dense
  escape hatch** prefills: ``models.registry.dense_attn_fn`` over the
  bucket's packed segment ids and positions (plain PyTorch, as the
  reference's runs no Pallas kernel).  On a pod mesh FCP prefill falls
  back to dense with a ``RuntimeWarning``, or raises under
  ``ServeConfig.strict_prefill``.
* **Exactness per family** — attention families pad *up* to the edge:
  the ragged last-index gather is exact under the causal mask, and a
  prompt longer than the budget chunks down.  Recurrent families (SSM,
  hybrid) always chunk *down* (the state must not scan padding), and a
  prompt below the smallest edge skips prefill ("fresh": its slot's
  cache rows are zeroed).  A chunked prompt's tail teacher-forces
  through the decode loop on the device.
* :class:`ServingLoop` — slot-based continuous batching against the
  sequence-sharded cache.  Per-slot state (next token, position,
  tail, generated tokens) lives in device tensors updated in place;
  the host mirrors completion counters and reads a slot's tokens only
  when its request finishes — no per-token host sync.
* **Compiled programs** — as the reference jits its steps, the loop
  runs each through a :class:`~repro_torch.runtime.graphs.Program`: on
  the card one CUDA graph per program and static shape, captured at its
  first call (warmup) and replayed after it.  ``loop_step`` (the decode
  step and the slot-state update), ``prefill_{E}`` per bucket edge,
  ``insert_{E}`` (a prefill row's cache write and slot state, its slot,
  row and request scalars device inputs) and ``fresh_insert``;
  ``compile_counts()`` counts their builds, and ``warmup()`` returns
  them as the baseline the stream must not grow (zero recompiles after
  warmup).  The eager methods stay callable: ``_loop_step``,
  ``prefill_fn(E, impl)``, ``_insert_rows`` and ``_fresh_rows``.
* :class:`LatencyStats` — per-request queue/prefill/decode p50/p99 and
  sustained tokens/sec, on ``time.perf_counter``.

**Across processes.**  On a mesh whose ranks form a process group
(``StackedMesh.with_ranks``; ``launch/serve.py`` under ``torchrun``)
every rank runs the same host loop — the same queue, buckets, slot
choices and plan keys, since the host mirrors every slot's counters
deterministically — and holds only its share (:class:`RankLayout`): its
frames of each packed prefill batch, and of the decode cache and state
the rows ``launch/serve.cache_share`` gives it (its slots under
``decode``; every slot, and its range of the sequence, under ``long``,
where each decode step merges the ranks' partials).  A batch's insert
moves each prompt's cache rows and its first token from the ranks that
computed them to the ranks that hold the slot (``wire.move`` over
:func:`insert_tables`, priced by :func:`insert_wire_bytes`); a finished
slot's tokens are moved from its owner to every rank.  The weights are
checked alike at the start (``wire.agree`` on a digest) and each new
bucket's plan key when it is built.  Every program runs uncaptured
(``graphs.Program(capture=False)``: gloo's ops cannot be captured, and
NCCL capture is ROADMAP Queue A item 4.7) with the same builds and
compile counts as stacked.  ``ParallelConfig.overlap`` runs the
prefill's round loop with its ships started before a run and landed
after it (``core.executor``); decode has no rounds.
``report()["ranks"]`` holds the rank's bytes (measured and priced) and
host seconds in the prefill ships (and of those, blocked landing them),
the inserts' moves and the decode merges.
"""

from __future__ import annotations

import dataclasses
import functools
import time
import warnings
from collections import deque
from typing import Sequence

import numpy as np
import torch

from .. import resolve_device
from ..configs.base import ParallelConfig, ServeConfig
from ..core import plan_cache as pc
from ..launch import serve as servelib
from ..launch.mesh import stacked_frames
from ..models import Model
from ..models.registry import RECURRENT, dense_attn_fn
from ..optimizer.adamw import tree_leaves
from . import graphs
from . import wire as wirelib


class QueueFull(RuntimeError):
    """Admission control: the request queue is at ``queue_depth``."""


# --------------------------------------------------------------------------
# requests + latency accounting
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # int32 [prompt_len]
    max_new: int
    bucket: int                     # prefill bucket edge E (0 = no chunk)
    mode: str                       # "pad" | "chunk" | "fresh"
    submit_t: float = 0.0
    queue_ms: float = 0.0
    prefill_ms: float = 0.0         # wall of the prefill batch it rode
    insert_t: float = 0.0
    finish_t: float = 0.0
    decode_ms: float = 0.0
    total_ms: float = 0.0
    tokens: np.ndarray | None = None

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def tail_tokens(self) -> int:
        """Prompt tokens teacher-forced through the decode loop (0 for
        the pad-up path: the whole prompt rides the one prefill call)."""
        return self.prompt_len - self.bucket if self.mode != "pad" else 0


def _pct(xs: Sequence[float]) -> dict:
    if not xs:
        return {"p50": 0.0, "p99": 0.0, "mean": 0.0}
    a = np.asarray(xs, np.float64)
    return {"p50": float(np.percentile(a, 50)),
            "p99": float(np.percentile(a, 99)),
            "mean": float(a.mean())}


class LatencyStats:
    """Per-request latency accounting (``time.perf_counter`` ms)."""

    def __init__(self):
        self.finished: list[Request] = []

    def add(self, req: Request) -> None:
        self.finished.append(req)

    def summary(self) -> dict:
        rs = self.finished
        return {
            "requests": len(rs),
            "generated_tokens": int(sum(r.max_new for r in rs)),
            "tail_tokens": int(sum(r.tail_tokens for r in rs)),
            "queue_ms": _pct([r.queue_ms for r in rs]),
            "prefill_ms": _pct([r.prefill_ms for r in rs]),
            "decode_ms": _pct([r.decode_ms for r in rs]),
            "total_ms": _pct([r.total_ms for r in rs]),
        }


class RequestQueue:
    """Bounded FIFO with up-front cache-overrun validation."""

    def __init__(self, scfg: ServeConfig):
        self.scfg = scfg
        self._q: deque[Request] = deque()
        self._next_rid = 0

    def __len__(self) -> int:
        return len(self._q)

    def validate(self, prompt_len: int, max_new: int, bucket: int,
                 mode: str) -> None:
        scfg = self.scfg
        if prompt_len < 1:
            raise ValueError("empty prompt")
        if not 1 <= max_new <= scfg.max_new_tokens:
            raise ValueError(
                f"max_new {max_new} outside [1, {scfg.max_new_tokens}] "
                f"(ServeConfig.max_new_tokens caps the generation "
                f"buffer)")
        # the decode loop writes positions [start, prompt_len + max_new)
        # and the pad-up prefill writes [0, bucket); past cache_len the
        # masked cache write would drop silently, so reject here
        need = max(bucket if mode == "pad" else 0, prompt_len + max_new)
        if need > scfg.cache_len:
            raise ValueError(
                f"request overruns the decode cache: prompt_len="
                f"{prompt_len} + max_new={max_new} (prefill bucket "
                f"{bucket}) requires cache_len >= {need}, got "
                f"{scfg.cache_len}; raise --cache-len or shorten the "
                f"request")

    def submit(self, prompt: np.ndarray, max_new: int, bucket: int,
               mode: str, now: float) -> Request:
        self.validate(int(prompt.shape[0]), max_new, bucket, mode)
        if len(self._q) >= self.scfg.queue_depth:
            raise QueueFull(
                f"queue at depth {self.scfg.queue_depth}; retry later")
        req = Request(rid=self._next_rid, prompt=prompt, max_new=max_new,
                      bucket=bucket, mode=mode, submit_t=now)
        self._next_rid += 1
        self._q.append(req)
        return req

    def peek(self) -> Request | None:
        return self._q[0] if self._q else None

    def pop_batch(self, limit: int) -> list[Request]:
        """Up to ``limit`` requests sharing the head request's bucket and
        fresh-ness (FIFO within the bucket)."""
        if not self._q or limit < 1:
            return []
        head = self._q[0]
        out, keep = [], deque()
        for r in self._q:
            if len(out) < limit and (r.bucket, r.mode == "fresh") == \
                    (head.bucket, head.mode == "fresh"):
                out.append(r)
            else:
                keep.append(r)
        self._q = keep
        return out


# --------------------------------------------------------------------------
# slot bookkeeping (host mirror of the device counters)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class _SlotMeta:
    req: Request
    tail_len: int                   # teacher-forced steps before gen
    gen0: int                       # tokens already produced at insert
    steps: int = 0                  # decode steps since insert

    @property
    def generated(self) -> int:
        # mirrors the device: gen_idx advances iff the tail is exhausted
        return self.gen0 + max(0, self.steps - self.tail_len)

    @property
    def done(self) -> bool:
        return self.generated >= self.req.max_new


# --------------------------------------------------------------------------
# across ranks: who holds what, the insert's moves and their prices
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RankLayout:
    """How a loop's work splits over ``size`` ranks: each holds
    ``tokens`` of a packed prefill batch (its frames; rank r the range
    from ``r * tokens``), and of the decode cache ``slots`` slots and
    ``positions`` positions of each (``launch/serve.cache_share``: under
    ``decode`` the slots are split and every rank holds every position,
    under ``long`` every rank holds every slot and the positions are
    split)."""

    size: int
    kind: str
    tokens: int
    slots: int
    positions: int

    def owners(self, slot: int) -> tuple:
        """The ranks that hold ``slot``'s state."""
        if self.kind == "long":
            return tuple(range(self.size))
        return (slot // self.slots,)

    def local_slot(self, slot: int, rank: int) -> int:
        return slot if self.kind == "long" else slot - rank * self.slots


def insert_tables(lay: RankLayout, E: int, slots, last) -> tuple:
    """The ``wire.move`` tables of one prefill batch's insert (the same on
    every rank): ``(kv, first)``.  Row i of the batch (stream tokens
    ``[i·E, (i+1)·E)``) fills positions ``[0, E)`` of slot ``slots[i]``;
    ``kv`` moves those rows from the ranks that computed them into the
    rows ``local slot · positions + local position`` of the ranks that
    hold them (a ``[L, slots · positions, KH, D]`` view of the cache).
    ``first`` moves row i's first generated token (its argmax, on the
    rank that holds the row's last token ``i·E + last[i]``) into every
    owner's ``local slot``."""
    kv, first = [], []
    T, P = lay.tokens, lay.positions
    for i, slot in enumerate(slots):
        p = 0
        while p < E:
            t = i * E + p
            src = t // T
            n = min(E - p, (src + 1) * T - t)
            if lay.kind == "long":
                dst = p // P
                n = min(n, (dst + 1) * P - p)
                row = slot * P + p - dst * P
            else:
                dst = slot // lay.slots
                row = lay.local_slot(slot, dst) * P + p
            kv.append((src, dst, t - src * T, row, n))
            p += n
        holder = (i * E + int(last[i])) // T
        first += [(holder, o, i, lay.local_slot(slot, o), 1)
                  for o in lay.owners(slot)]
    return kv, first


def insert_wire_bytes(lay: RankLayout, rank: int, E: int, slots, last,
                      kv_row_bytes: int) -> int:
    """The bytes ``rank`` sends in one batch's insert, counted from the
    layout alone (not from :func:`insert_tables`): of each row's stream
    tokens it holds, those whose cache rows another rank holds
    (``kv_row_bytes`` a token: k and v over the layers), and 4 bytes (an
    int32 token) to every other owner of a slot whose row's last token it
    holds."""
    T, P = lay.tokens, lay.positions
    lo, hi = rank * T, (rank + 1) * T
    sent = 0
    for i, slot in enumerate(slots):
        a, b = max(i * E, lo), min((i + 1) * E, hi)
        if a < b:
            if lay.kind == "long":
                pa, pb = a - i * E, b - i * E
                mine = max(0, min(pb, (rank + 1) * P) - max(pa, rank * P))
                sent += (pb - pa - mine) * kv_row_bytes
            elif rank not in lay.owners(slot):
                sent += (b - a) * kv_row_bytes
        if lo <= i * E + int(last[i]) < hi:
            sent += 4 * sum(o != rank for o in lay.owners(slot))
    return sent


def merge_wire_bytes(lay: RankLayout, n_layers: int, n_heads: int,
                     head_dim: int, n_shards: int) -> int:
    """The bytes a rank sends in one decode step's merges: under ``long``
    every layer gathers each rank's f32 partials ``[slots, n_shards / R,
    heads, head_dim + 1]`` (o and lse); under ``decode`` nothing."""
    if lay.kind != "long" or lay.size == 1:
        return 0
    share = lay.slots * (n_shards // lay.size) * n_heads * (head_dim + 1) * 4
    return n_layers * share * (lay.size - 1)


# --------------------------------------------------------------------------
# the serving loop
# --------------------------------------------------------------------------

class ServingLoop:
    """Continuous-batching serving driver (see module docstring).

    ``device`` defaults to ``"cuda"`` and raises when no card is
    present; FCP prefill and decode run the CUDA kernels (their plain
    versions on the CPU), the dense prefill plain PyTorch.
    ``attn_impl`` is the executor impl of both (``"fused_xla"`` runs the
    plain versions on the card, to hold the kernels against them).
    ``run(prompts)`` drives an offline stream end to end;
    ``submit``/``_refill``/``_dispatch_step`` are the building blocks an
    online server would call.  Every step runs through a compiled
    program (module docstring), a CUDA graph whenever ``device`` is
    CUDA.
    """

    def __init__(self, model: Model, params, mesh,
                 pcfg: ParallelConfig, scfg: ServeConfig, *,
                 plan_cache: pc.PlanCache | None = None,
                 device="cuda", attn_impl: str = "fused"):
        self.device = resolve_device(device)
        self.attn_impl = attn_impl
        self.model, self.mesh = model, mesh
        self.pcfg, self.scfg = pcfg, scfg
        cfg = model.cfg
        axis_sizes = dict(mesh.shape)
        self.ranks = getattr(mesh, "ranks", wirelib.STACKED)
        if self.ranks.grouped:
            servelib.check_ranked(cfg, scfg, axis_sizes, self.ranks.size)
        # prefill frames stack over the same axes as training batches
        self.n_cp = stacked_frames(mesh)
        self.tpw = int(scfg.prefill_tokens_per_worker)
        self.budget = self.n_cp * self.tpw
        self._uses_fcp = (scfg.prefill_impl == "fcp"
                          and cfg.uses_attention and self.n_cp > 1)
        if self._uses_fcp and axis_sizes.get("pod", 1) > 1:
            if scfg.strict_prefill:
                raise ValueError(
                    "FCP prefill runs on 2-axis (data, model) meshes "
                    "and ServeConfig.strict_prefill is set; pass "
                    "prefill_impl='dense' on pod meshes")
            warnings.warn(
                "FCP prefill does not support pod meshes yet; falling "
                "back to prefill_impl='dense' (set "
                "ServeConfig.strict_prefill=True to fail instead)",
                RuntimeWarning, stacklevel=2)
            self._uses_fcp = False
        if self._uses_fcp and self.tpw % pcfg.block_size:
            raise ValueError(
                f"prefill_tokens_per_worker {self.tpw} must be a "
                f"multiple of block_size {pcfg.block_size} for FCP "
                f"prefill")
        if scfg.prefill_impl not in ("fcp", "dense"):
            raise ValueError(f"unknown prefill_impl "
                             f"{scfg.prefill_impl!r}")
        self.edges = pc.prefill_bucket_edges(scfg.bucket_min, self.budget)
        self.queue = RequestQueue(scfg)
        self.plan_cache = plan_cache or pc.PlanCache(pcfg.plan_cache_size)
        nh, nkv = cfg.padded_heads(1)
        self._heads = (max(nh, 1), max(nkv, 1), max(cfg.head_dim, 1))
        self._gen_cap = int(scfg.max_new_tokens)
        self._tail_cap = int(scfg.cache_len)

        # ---- decode side -------------------------------------------------
        B = int(scfg.decode_slots)
        self._decode_step, batch_axis, _ = servelib.build_decode_step(
            model, mesh, scfg.kind, attn_impl)
        if batch_axis in axis_sizes and B % axis_sizes[batch_axis]:
            raise ValueError(
                f"decode_slots {B} must be a multiple of the "
                f"{batch_axis!r} mesh axis ({axis_sizes[batch_axis]})")
        self.params = params
        # this rank's slots and cache positions (all of both, stacked)
        self.share = servelib.cache_share(mesh, scfg.kind, B,
                                          scfg.cache_len)
        (s0, s1), (p0, p1) = self.share
        self.cache = model.init_cache(s1 - s0, p1 - p0, self.device)
        self.state = self._init_state(s1 - s0)
        self._slots: list[_SlotMeta | None] = [None] * B
        # across ranks: the RankLayout and this rank's stream tokens
        self.layout = self._tokens = None
        if self.ranks.grouped:
            f0, f1 = mesh.frames
            self.layout = RankLayout(self.ranks.size, scfg.kind,
                                     (f1 - f0) * self.tpw, s1 - s0, p1 - p0)
            self._tokens = (f0 * self.tpw, f1 * self.tpw)
            # each insert's first generated token, moved to the slot's
            # owners
            self._first = torch.zeros((s1 - s0,), dtype=torch.int32,
                                      device=self.device)
            # replicated weights: every rank starts from the same bytes
            wirelib.agree("parameters", wirelib.digest(
                tree_leaves(params)), self.ranks, self.device)
        self._prefill_fns: dict = {}        # (E, impl) -> prefill step
        self._scheds: dict = {}             # E -> its last batch's plan
        self._programs: dict = {}           # name -> graphs.Program
        self._pool = None                   # prefill + insert graph pool
        self.last_logits = None             # decode logits (tests)
        # a list: each prefill batch's held last-token logits and the
        # first decode step's after each reset_counters() go there
        # (on the host; for checks against another loop)
        self.record: list | None = None
        self.reset_counters()

    # -- counters / introspection -----------------------------------------

    def reset_counters(self) -> None:
        self.stats = LatencyStats()
        self.plan_cache.stats = pc.PlanCacheStats()
        self.prefill_batches = 0
        self.prefill_rows = 0
        self.prefill_rows_real = 0
        self.decode_steps = 0
        # across ranks: this rank's bytes (measured and priced) and host
        # seconds in the prefill ships (and blocked landing them), the
        # inserts' moves, the decode merges and the fetches of finished
        # tokens
        self.wire = {k: 0 for k in (
            "prefill_ship_bytes", "prefill_ship_bytes_priced",
            "insert_bytes", "insert_bytes_priced", "merge_bytes",
            "merge_bytes_priced", "fetch_bytes")}
        self.wire.update(prefill_ship_s=0.0, prefill_ship_wait_s=0.0,
                         insert_s=0.0, merge_s=0.0)

    def compile_counts(self) -> dict[str, int]:
        """Programs built per program (the reference's per-jitted-function
        compile counts): after ``warmup`` every entry must stay put (zero
        recompiles over the stream)."""
        out = {"loop_step": 0, "fresh_insert": 0}
        out.update({name: p.builds for name, p in self._programs.items()})
        return out

    def _program(self, name: str, fn) -> graphs.Program:
        """The program ``name`` (made at its first use around ``fn``).
        The decode program keeps a graph memory pool of its own; the
        prefill and insert programs share one (``graphs`` pool rule: a
        prefill's outputs are inserted before another of them runs).
        Across ranks a program runs its ``fn`` uncaptured (one build per
        key all the same): gloo's ops cannot be captured in a CUDA graph,
        and a capture of NCCL's is ROADMAP Queue A item 4.7."""
        prog = self._programs.get(name)
        if prog is None:
            pool = None
            capture = not self.ranks.grouped
            if capture and self.device.type == "cuda" and \
                    name != "loop_step":
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                pool = self._pool
            prog = self._programs[name] = graphs.Program(
                name, fn, self.device, pool, capture=capture)
        return prog

    def n_active(self) -> int:
        return sum(m is not None for m in self._slots)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- admission ---------------------------------------------------------

    def bucket_of(self, prompt_len: int) -> tuple[int, str]:
        """(bucket edge E, mode).  Attention families pad UP to the
        smallest covering edge (exact under the causal mask; one prefill
        call, no tail); a prompt beyond the budget chunks DOWN to the
        largest edge and teacher-forces the remainder through the decode
        loop.  Recurrent families always chunk down to the largest edge
        at or below the prompt; a prompt below the smallest edge skips
        prefill (``(0, "fresh")``)."""
        L = int(prompt_len)
        if self.model.cfg.family not in RECURRENT:
            for e in self.edges:
                if L <= e:
                    return e, "pad"
            return self.edges[-1], "chunk"
        down = max((e for e in self.edges if e <= L), default=0)
        return (down, "chunk") if down else (0, "fresh")

    def submit(self, prompt, max_new: int | None = None) -> Request:
        prompt = np.asarray(prompt, np.int32).ravel()
        max_new = int(max_new if max_new is not None
                      else self.scfg.max_new_tokens)
        bucket, mode = self.bucket_of(prompt.shape[0])
        return self.queue.submit(prompt, max_new, bucket, mode,
                                 now=time.perf_counter())

    # -- device state ------------------------------------------------------

    def _init_state(self, B: int) -> dict:
        def z(*s):
            return torch.zeros(s, dtype=torch.int32, device=self.device)
        return {
            "tok": z(B), "pos": z(B),
            "active": torch.zeros((B,), dtype=torch.bool,
                                  device=self.device),
            "tail_buf": z(B, self._tail_cap),
            "tail_idx": z(B), "tail_len": z(B),
            "gen_buf": z(B, self._gen_cap),
            "gen_idx": z(B),
            "max_new": torch.ones((B,), dtype=torch.int32,
                                  device=self.device),
        }

    def _loop_step(self) -> torch.Tensor:
        """One decode step for every slot; the state updates in place."""
        st = self.state
        nxt, logits, self.cache = self._decode_step(
            self.params, st["tok"], st["pos"], self.cache)
        b = torch.arange(st["tok"].shape[0], device=self.device)
        act = st["active"]
        in_tail = st["tail_idx"] < st["tail_len"]
        ti = st["tail_idx"].clamp(max=self._tail_cap - 1).long()
        gi = st["gen_idx"].clamp(max=self._gen_cap - 1).long()
        # a slot in its tail feeds the next prompt token and drops the
        # prediction; past the tail the prediction is the next generated
        # token and feeds back as the next input
        new_tok = torch.where(in_tail, st["tail_buf"][b, ti], nxt)
        record = act & ~in_tail
        st["gen_buf"][b, gi] = torch.where(record, nxt, st["gen_buf"][b, gi])
        st["gen_idx"] += record.to(torch.int32)
        st["tok"].copy_(torch.where(act, new_tok, st["tok"]))
        st["pos"] += act.to(torch.int32)
        st["tail_idx"] += (act & in_tail).to(torch.int32)
        # self-freezing: a finished slot stops moving entirely
        st["active"] &= st["gen_idx"] < st["max_new"]
        return logits

    def _insert_args(self, row: int, slot: int, pos0: int, first_tail: int,
                     has_tail: bool, tail_row: np.ndarray, tail_len: int,
                     max_new: int, own: bool | None = None) -> torch.Tensor:
        """One insert's arguments as one int32 vector (the reference's
        traced scalars; ``_unpack`` reads it on the device), pinned on the
        card, so the program's copy does not wait on the device.  Across
        ranks ``slot`` is the local slot and ``own`` (whether this rank
        holds it) ends the vector."""
        a = np.concatenate([np.array(
            [row, slot, pos0, first_tail, int(has_tail), tail_len,
             max_new], np.int32), tail_row.astype(np.int32),
            np.array([int(own)] if own is not None else [], np.int32)])
        t = torch.from_numpy(a)
        return t.pin_memory() if self.device.type == "cuda" else t

    @staticmethod
    def _unpack(args: torch.Tensor) -> tuple:
        """(row, slot, pos0, first tail token, has_tail, tail_len,
        max_new), each ``[1]``, and the tail row of ``_insert_args``."""
        return tuple(args[i:i + 1] for i in range(7)) + (args[7:],)

    def _write_slot(self, args: torch.Tensor, first: torch.Tensor,
                    own: torch.Tensor | None = None) -> None:
        """The slot state of one insert, from its argument vector and the
        first generated token ``first`` (``[1]``): a slot with a tail
        feeds its first tail token and has generated nothing; one without
        feeds ``first``, already generated.  With ``own`` (``[1]`` bool,
        across ranks) a rank that does not hold the slot keeps its
        bytes."""
        st = self.state
        _, slot, pos0, tail0, has_tail, tail_len, max_new, tail_row = \
            self._unpack(args)
        slot, has_tail = slot.long(), has_tail.bool()
        gen0 = torch.where(has_tail, 0, 1).to(torch.int32)
        gen_row = torch.zeros_like(st["gen_buf"][:1])
        gen_row[:, 0] = torch.where(has_tail, 0, first)

        def put(name, value):
            if own is not None:
                old = st[name].index_select(0, slot)
                value = torch.where(own.view((1,) * old.ndim), value, old)
            st[name].index_copy_(0, slot, value)
        put("tok", torch.where(has_tail, tail0, first))
        put("pos", pos0)
        put("active", gen0 < max_new)
        put("tail_buf", tail_row[None])
        if own is None:
            st["tail_idx"].index_fill_(0, slot, 0)
        else:
            put("tail_idx", torch.zeros_like(tail_len))
        put("tail_len", tail_len)
        put("gen_buf", gen_row)
        put("gen_idx", gen0)
        put("max_new", max_new)

    def _insert_rows(self, pcache: dict, plogits: torch.Tensor,
                     args: torch.Tensor) -> None:
        """The eager insert (program ``insert_{E}``): the prefill row
        ``row`` into slot ``slot`` — k/v ``[G, E, KH, D]`` fill the slot's
        first E positions, an SSM state or conv tail its whole row — and
        its slot state; the first generated token is the argmax of the
        row's prefill logits, taken on the device."""
        row, slot = (x.long() for x in self._unpack(args)[:2])
        for k, c in self.cache.items():
            src = pcache[k].index_select(1, row).to(c.dtype)
            c[:, :, :src.shape[2]].index_copy_(1, slot, src)
        first = torch.argmax(plogits.index_select(0, row),
                             dim=-1).to(torch.int32)
        self._write_slot(args, first)

    def _insert_moved(self, args: torch.Tensor) -> None:
        """The eager insert across ranks (program ``insert_{E}``): the
        slot state of one request, on every rank, from its argument
        vector (``own`` last) and its first generated token, which the
        batch's ``wire.move`` left in ``_first`` (its cache rows too).  A
        rank that does not hold the slot writes nothing."""
        own = args[-1:].bool()
        slot = args[1:2].long()
        self._write_slot(args[:-1], self._first.index_select(0, slot), own)

    def _fresh_rows(self, args: torch.Tensor) -> None:
        """The eager fresh insert (program ``fresh_insert``): the slot's
        cache rows are zeroed and the whole prompt teacher-forces from
        position 0 (its arguments name the first token as the first tail
        token, with ``has_tail`` set, so no generated token is read)."""
        slot = self._unpack(args)[1].long()
        for c in self.cache.values():
            c.index_fill_(1, slot, 0)
        self._write_slot(args, torch.zeros_like(slot, dtype=torch.int32))

    # -- prefill -----------------------------------------------------------

    def _plan_key(self, E: int):
        pcfg = self.pcfg
        return pc.prefill_plan_key(
            E, self.budget, self.n_cp, pcfg.block_size, mask=True,
            coalesce=pcfg.coalesce, locality=pcfg.locality,
            wire=pcfg.comm_dtype, in_dtype_bytes=pcfg.in_dtype_bytes,
            overlap=pcfg.overlap, extra=self._heads)

    def _schedule_for(self, E: int):
        """Plan-cache-backed FCP schedule for bucket ``E`` — looked up
        on every prefill batch, so the cache stats prove the reuse."""
        comp = list(pc.prefill_composition(E, self.budget))
        return self.plan_cache.get_or_build(
            self._plan_key(E), lambda: servelib.build_schedule(
                self.model.cfg, self.pcfg, comp, self.n_cp, self.tpw,
                mask=True))

    @property
    def prefill_impl(self) -> str:
        """``"fcp"`` or ``"dense"``: the prefill this loop runs."""
        return "fcp" if self._uses_fcp else "dense"

    def prefill_fn(self, E: int, impl: str | None = None):
        """The prefill step of bucket ``E`` (built once per bucket and
        impl): ``fn(params, batch, last_idx)``.  ``impl`` is the FCP
        executor's (default the loop's ``attn_impl``; ``"fused_xla"``
        holds the kernels against their plain versions; the dense
        prefill reads none).  Recurrent families prefill chunks, whose
        last token is the row's last, so their step does not read
        ``last_idx``; the SSM family plans no attention."""
        impl = impl or self.attn_impl
        cfg = self.model.cfg
        Pn = self.budget // E
        sched = self._schedule_for(E) if self._uses_fcp else None
        self._scheds[E] = sched
        if (E, impl) in self._prefill_fns:
            return self._prefill_fns[(E, impl)]
        if self.ranks.grouped:
            # every rank plans the bucket alike (the Trainer's check)
            wirelib.agree("plan key", repr(self._plan_key(E)).encode(),
                          self.ranks, self.device)
        if sched is not None:
            attn = servelib.make_fcp_attn_fn(sched, self.device, self.pcfg,
                                             impl, ranks=self.ranks)
        elif cfg.uses_attention:
            # the dense escape hatch: one segment per packed sequence
            shape = (self.n_cp, self.tpw)
            seq = torch.arange(Pn, dtype=torch.int32,
                               device=self.device).repeat_interleave(E)
            posf = torch.arange(E, dtype=torch.int32,
                                device=self.device).repeat(Pn)
            attn = dense_attn_fn(seq.reshape(shape), posf.reshape(shape),
                                 mask=True)
        else:
            attn = None
        ragged = cfg.family not in RECURRENT
        step = servelib.build_prefill_step(
            self.model, attn, batch_size=Pn, seq_len=E, ragged=ragged,
            tokens=self._tokens)
        fn = step if ragged else (
            lambda params, batch, last_idx=None: step(params, batch))
        self._prefill_fns[(E, impl)] = fn
        return fn

    def _last_index(self, E: int, reqs: list[Request]) -> np.ndarray:
        """Each row's last prompt token in the bucket (0 on filler rows)."""
        last = np.zeros((self.budget // E,), np.int32)
        for i, r in enumerate(reqs):
            last[i] = r.prompt_len - 1 if r.mode == "pad" else E - 1
        return last

    def assemble(self, E: int, reqs: list[Request]):
        """(batch, last_idx) device tensors of one prefill batch: the
        whole packed stream, or across ranks this rank's frames of it
        (``last_idx`` names every row)."""
        Pn = self.budget // E
        toks = np.zeros((Pn, E), np.int32)
        for i, r in enumerate(reqs):
            L = r.prompt_len
            if r.mode == "pad":
                toks[i, :L] = r.prompt
            else:                          # chunk: first E tokens
                toks[i] = r.prompt[:E]
        posf = np.tile(np.arange(E, dtype=np.int32), Pn)
        shape = (self.n_cp, self.tpw)      # stream is sequence-major
        toks, posf = toks.reshape(shape), posf.reshape(shape)
        if self.ranks.grouped:
            f0, f1 = self.mesh.frames
            toks, posf = toks[f0:f1], posf[f0:f1]
        dev = self.device
        batch = {"tokens": torch.from_numpy(toks).to(dev),
                 "positions": torch.from_numpy(posf).to(dev)}
        return batch, torch.from_numpy(self._last_index(E, reqs)).to(dev)

    def _tail_arrays(self, req: Request, E: int):
        """(pos0, first_tail, has_tail, tail_row, tail_len) host-side."""
        L = req.prompt_len
        tail_row = np.zeros((self._tail_cap,), np.int32)
        if req.mode == "pad":
            return L, 0, False, tail_row, 0
        has_tail = L > E
        first_tail = int(req.prompt[E]) if has_tail else 0
        tail = req.prompt[E + 1:L]
        tail_row[:tail.shape[0]] = tail
        return E, first_tail, has_tail, tail_row, int(tail.shape[0])

    def _fresh_insert(self, reqs: list[Request], free: list[int]) -> None:
        """Below the smallest edge (recurrent families): no prefill; the
        slot's cache rows are zeroed and the whole prompt teacher-forces
        from position 0."""
        now = time.perf_counter()
        prog = self._program("fresh_insert", self._fresh_rows)
        for req, slot in zip(reqs, free):
            tail_row = np.zeros((self._tail_cap,), np.int32)
            tail = req.prompt[1:]
            tail_row[:tail.shape[0]] = tail
            prog(self._insert_args(0, slot, 0, int(req.prompt[0]), True,
                                   tail_row, int(tail.shape[0]),
                                   req.max_new),
                 held=(self.state, self.cache))
            req.queue_ms = (now - req.submit_t) * 1e3
            req.insert_t = now
            self._slots[slot] = _SlotMeta(req, tail_len=int(tail.shape[0]),
                                          gen0=0)

    def _prefill_and_insert(self, reqs: list[Request],
                            free: list[int]) -> None:
        if reqs[0].mode == "fresh":
            return self._fresh_insert(reqs, free)
        E = reqs[0].bucket
        # prefill_fn looks the bucket's plan up on every batch (the cache
        # stats prove the reuse); the program replays its first capture
        prefill = self._program(f"prefill_{E}", functools.partial(
            self.prefill_fn(E), self.params))
        batch, last = self.assemble(E, reqs)
        w0 = wirelib.wire_stats()
        t0 = time.perf_counter()
        plogits, pcache = prefill(batch, last, held=self.params)
        self._sync()                       # one sync per BATCH (timing)
        dt_ms = (time.perf_counter() - t0) * 1e3
        self.prefill_batches += 1
        self.prefill_rows += self.budget // E
        self.prefill_rows_real += len(reqs)
        if self.ranks.grouped:
            self._count_ships(E, w0)
            self._move_rows(E, reqs, free, plogits, pcache)
            insert = self._program(f"insert_{E}", self._insert_moved)
            held = (self.state, self._first)
        else:
            insert = self._program(f"insert_{E}", functools.partial(
                self._insert_rows, pcache, plogits))
            held = (self.state, self.cache, pcache, plogits)
        if self.record is not None:
            self._record_prefill(E, reqs, plogits)
        for i, (req, slot) in enumerate(zip(reqs, free)):
            pos0, ft, ht, tail_row, tl = self._tail_arrays(req, E)
            if self.ranks.grouped:
                s0, s1 = self.share[0]
                own = s0 <= slot < s1
                args = self._insert_args(i, slot - s0 if own else 0, pos0,
                                         ft, ht, tail_row, tl, req.max_new,
                                         own)
            else:
                # first generated token: argmax of the prefill's
                # last-token logits — computed on the device, never
                # synced to the host
                args = self._insert_args(i, slot, pos0, ft, ht, tail_row,
                                         tl, req.max_new)
            insert(args, held=held)
            req.queue_ms = (t0 - req.submit_t) * 1e3
            req.prefill_ms = dt_ms
            req.insert_t = time.perf_counter()
            self._slots[slot] = _SlotMeta(req, tail_len=tl,
                                          gen0=0 if ht else 1)

    # -- across ranks --------------------------------------------------------

    def _kv_row_bytes(self) -> int:
        """Bytes of one cache token: k and v over the layers."""
        k = self.cache["k"]
        return 2 * k.shape[0] * k[0, 0, 0].numel() * k.element_size()

    def _count_ships(self, E: int, w0: dict) -> None:
        """A ranked prefill's ship bytes and seconds, beside their price
        (``wire.rank_wire_bytes``: the forward over every layer)."""
        w1 = wirelib.wire_stats()
        cfg, w = self.model.cfg, self.wire
        w["prefill_ship_bytes"] += w1["sent_bytes"] - w0["sent_bytes"]
        w["prefill_ship_s"] += w1["ship_s"] - w0["ship_s"]
        w["prefill_ship_wait_s"] += w1["ship_wait_s"] - w0["ship_wait_s"]
        nh, nkv, dh = self._heads
        fwd, _ = wirelib.rank_wire_bytes(
            self._scheds[E].spec, self.ranks, nh, nkv, dh,
            self.pcfg.in_dtype_bytes, 2 if self.pcfg.attn_out_bf16 else 4)
        w["prefill_ship_bytes_priced"] += int(cfg.n_layers * fwd)

    def _move_rows(self, E: int, reqs: list[Request], free: list[int],
                   plogits: torch.Tensor, pcache: dict) -> None:
        """One ranked batch's insert moves (``wire.move`` over
        :func:`insert_tables`): each row's cache rows from the ranks that
        computed them into the ranks that hold its slot's, and its first
        generated token (the argmax of its last-token logits, on the rank
        that holds that token) into ``_first`` on every owner."""
        last = self._last_index(E, reqs)
        kv, first = insert_tables(self.layout, E, free, last)
        w0 = wirelib.wire_stats()
        tok = torch.argmax(plogits, dim=-1).to(torch.int32)
        names = ("k", "v")
        lyr = self.cache["k"].shape[0]
        dst = [self.cache[n].view(lyr, -1, *self.cache[n].shape[3:])
               for n in names]
        wirelib.move([pcache[n] for n in names], dst, kv, self.ranks, dim=1)
        wirelib.move(tok, self._first, first, self.ranks)
        w1 = wirelib.wire_stats()
        w = self.wire
        w["insert_bytes"] += w1["move_bytes"] - w0["move_bytes"]
        w["insert_s"] += w1["move_s"] - w0["move_s"]
        w["insert_bytes_priced"] += insert_wire_bytes(
            self.layout, self.ranks.rank, E, free, last,
            self._kv_row_bytes())

    def _record_prefill(self, E: int, reqs: list[Request],
                        plogits: torch.Tensor) -> None:
        """``record`` the batch's last-token logits this rank holds."""
        last = self._last_index(E, reqs)
        t0, t1 = self._tokens or (0, self.budget)
        rows = [i for i in range(len(reqs)) if t0 <= i * E + last[i] < t1]
        self.record.append({
            "phase": "prefill", "E": E,
            "rids": [reqs[i].rid for i in rows],
            "logits": plogits[rows].float().cpu()})

    def _fetch_tokens(self, slots: list[int]) -> np.ndarray:
        """``[B, max_new_tokens]`` on the host holding the generated
        tokens of ``slots`` (across ranks moved from their owners into
        every rank; the other rows zero)."""
        st = self.state["gen_buf"]
        if not self.ranks.grouped:
            return st.cpu().numpy()
        lay = self.layout
        out = torch.zeros((len(self._slots), self._gen_cap),
                          dtype=st.dtype, device=self.device)
        table = []
        for s in slots:
            src = lay.owners(s)
            for d in range(lay.size):
                o = d if d in src else src[0]
                table.append((o, d, lay.local_slot(s, o), s, 1))
        w0 = wirelib.wire_stats()["move_bytes"]
        wirelib.move(st, out, table, self.ranks)
        self.wire["fetch_bytes"] += wirelib.wire_stats()["move_bytes"] - w0
        return out.cpu().numpy()

    # -- scheduling rounds -------------------------------------------------

    def _refill(self) -> None:
        free = [i for i, m in enumerate(self._slots) if m is None]
        while free and len(self.queue):
            head = self.queue.peek()
            cap = len(free)
            if head.mode != "fresh":       # one prefill batch has
                cap = min(cap, self.budget // head.bucket)  # P rows
            reqs = self.queue.pop_batch(limit=cap)
            if not reqs:
                break
            take, free = free[:len(reqs)], free[len(reqs):]
            self._prefill_and_insert(reqs, take)

    def _dispatch_step(self) -> None:
        w0 = wirelib.wire_stats()
        self.last_logits = self._program("loop_step", self._loop_step)(
            held=(self.params, self.state, self.cache))
        if self.ranks.grouped:
            w1, w = wirelib.wire_stats(), self.wire
            w["merge_bytes"] += w1["merge_bytes"] - w0["merge_bytes"]
            w["merge_s"] += w1["merge_s"] - w0["merge_s"]
            cfg = self.model.cfg
            w["merge_bytes_priced"] += merge_wire_bytes(
                self.layout, cfg.n_layers, self._heads[0], self._heads[2],
                self.mesh.shape.get("data", 1) * self.mesh.shape.get(
                    "model", 1))
        if self.record is not None and self.decode_steps == 0:
            s0, s1 = self.share[0]
            held = [s for s, m in enumerate(self._slots)
                    if m is not None and not m.done and s0 <= s < s1]
            self.record.append({
                "phase": "decode", "slots": held,
                "logits": self.last_logits[[s - s0 for s in held]]
                .float().cpu()})
        self.decode_steps += 1
        for m in self._slots:
            if m is not None and not m.done:
                m.steps += 1

    def _collect_finished(self) -> list[Request]:
        done = []
        if not any(m is not None and m.done for m in self._slots):
            return done
        # one transfer for every completion in this round — the only
        # device->host sync in the decode loop
        gen = self._fetch_tokens([s for s, m in enumerate(self._slots)
                                  if m is not None and m.done])
        for slot, m in enumerate(self._slots):
            if m is None or not m.done:
                continue
            req = m.req
            req.tokens = gen[slot, :req.max_new].copy()
            req.finish_t = time.perf_counter()
            req.decode_ms = (req.finish_t - req.insert_t) * 1e3
            req.total_ms = (req.finish_t - req.submit_t) * 1e3
            self.stats.add(req)
            done.append(req)
            self._slots[slot] = None
        return done

    # -- driver ------------------------------------------------------------

    def warmup(self) -> dict[str, int]:
        """Build every steady-state program up front — one filler request
        per admissible prefill bucket (plus the below-minimum "fresh"
        path of recurrent families), with enough generation to run the
        decode loop — so kernels are built, every bucket is planned and
        every program captured before the measured stream; then reset
        the counters.  Returns the compile-count baseline: over the
        measured stream every count must stay put (zero recompiles after
        warmup)."""
        mn = min(2, self.scfg.max_new_tokens)
        prompts = []
        for e in self.edges:
            L = min(e, self.scfg.cache_len - mn)
            if L >= 1 and self.bucket_of(L)[0] == e:
                prompts.append(np.ones((L,), np.int32))
        if self.model.cfg.family in RECURRENT and self.edges[0] > 1:
            prompts.append(np.ones((1,), np.int32))   # fresh path
        self.run(prompts, max_new=mn)
        base = self.compile_counts()
        self.reset_counters()
        return base

    def run(self, prompts: Sequence, max_new: int | None = None) -> dict:
        """Serve an offline stream of prompts end to end and return the
        report.  Admission respects ``queue_depth``; free slots refill
        every scheduling round; the loop ends when every request has
        finished."""
        pending = deque(prompts)
        t_run = time.perf_counter()
        while pending or len(self.queue) or self.n_active():
            while pending and len(self.queue) < self.scfg.queue_depth:
                self.submit(pending.popleft(), max_new)
            self._refill()
            self._collect_finished()
            if any(m is not None and not m.done for m in self._slots):
                self._dispatch_step()
                self._collect_finished()
        self._sync()
        return self.report(time.perf_counter() - t_run)

    def report(self, wall_s: float) -> dict:
        s = self.stats.summary()
        toks = s["generated_tokens"]
        return {
            "wall_s": wall_s,
            "sustained_tok_s": toks / wall_s if wall_s > 0 else 0.0,
            "decode_steps": self.decode_steps,
            "prefill_batches": self.prefill_batches,
            "prefill_fill": (self.prefill_rows_real
                             / max(self.prefill_rows, 1)),
            "bucket_edges": list(self.edges),
            "prefill_impl": self.prefill_impl,
            **s,
            "plan_cache": self.plan_cache.stats.to_dict(),
            **({"ranks": {
                "rank": self.ranks.rank, "size": self.ranks.size,
                "backend": self.ranks.backend, "kind": self.scfg.kind,
                "frames": list(self.mesh.frames),
                "slots": list(self.share[0]),
                "positions": list(self.share[1]),
                **self.wire}} if self.ranks.grouped else {}),
        }
