"""Wire formats for FCP communication on stacked workers (codec layer).

A port of :mod:`repro.runtime.wire`.  :class:`WireFormat`,
:func:`parse_wire` and :func:`coerce_wire` are copies of the reference
(the planner prices communication with them, so both packages plan
byte-identical schedules).  The codec is PyTorch:

* :func:`encode` / :func:`decode` — ``f32`` passthrough (payloads ship
  in their compute dtype, bit-exact), ``bf16`` truncation, or ``int8``
  with per-(payload row, head) float32 scales.  An all-zero group (a
  trash-padded row) encodes to zeros with a zero scale — no NaN paths.
* :func:`ship` — the stacked-worker transport.  On one card the N
  context-parallel workers sit on a leading tensor dimension, so the
  reference's ``encode -> ppermute -> decode`` becomes an index copy:
  receiver ``dst`` of each ``(src, dst)`` pair gets
  ``decode(encode(x[src]))`` and a receiver no pair names gets zeros.
  It is differentiable (:class:`_Ship`): the backward ships the
  cotangent through the reversed partial permutation in the same wire
  format, as the reference's ``custom_vjp`` does — exact for ``f32``,
  the same bounded error as the forward for ``bf16``/``int8``.

**Across processes.**  Under a ``torch.distributed`` process group of
R ranks (:class:`Ranks`), rank r holds the r-th of R contiguous shares
of the plan's frames (:meth:`Ranks.share`: equal when R divides them, as
evenly as floor division allows after a worker loss), and :func:`ship`
takes that rank's payloads
with the plan's global ``(src, dst)`` pairs: a pair with both ends on
the rank stays the index copy, a pair that crosses ranks is encoded,
sent with ``dist.batch_isend_irecv`` (one batch a ship, every rank
posting its ops in the plan's pair order) and decoded on arrival, its
int8 scales travelling beside the payload.  gloo moves host memory, so
under gloo a CUDA payload is staged through a host tensor; NCCL takes
CUDA tensors as they are.  The reductions a ranked train step needs
(:func:`all_sum`, and :func:`all_max` for the fleet's step wall), the
agreement checks (:func:`agree`, :func:`digest`), the barrier and
joining the group live here too: this is the only module of the port
that calls ``torch.distributed`` (``analysis/lints.py``).
:func:`wire_stats` counts the bytes a rank puts on the wire.

**Survivor groups.**  A :class:`Ranks` spans the world, or the ordered
global ranks ``members`` of a subgroup (:func:`subgroup`: the ranks that
still hold a worker after a loss); every collective and point-to-point
op here runs in the group of the ``Ranks`` it is given, a peer's group
rank mapped to its global rank through ``members``.  :func:`broadcast`
sends one rank's tensors to the rest of a group in place (a rejoin's
state), priced by :func:`broadcast_bytes`.

Serving across ranks adds two operations: :func:`move`, a reshard of
row ranges along a host table (a prefill's cache rows and first tokens
into the ranks that own the slots), priced by :func:`move_bytes`; and
:func:`gather`, the all-gather the decode's cross-rank flash merge
reads (every rank merges the same gathered partials in shard order, so
every rank ends with the same bytes; ``runtime/serving`` prices both).
"""

from __future__ import annotations

import bisect
import dataclasses
import hashlib
import os
import time

import torch
import torch.distributed as dist

KINDS = ("f32", "bf16", "int8")

# bytes per payload value on the wire
_BYTES = {"f32": 4.0, "bf16": 2.0, "int8": 1.0}
# side-band bytes per scale group (one f32 scale per group)
_SCALE_BYTES = {"f32": 0.0, "bf16": 0.0, "int8": 4.0}


@dataclasses.dataclass(frozen=True)
class WireFormat:
    """One wire format.  Hashable: rides ``StaticSpec``, plan-cache keys
    and jit static arguments directly (same contract as ``MaskSpec``)."""

    kind: str = "f32"

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown wire format {self.kind!r} "
                             f"(expected one of {KINDS})")

    def key(self) -> tuple:
        """Hashable identity for plan-cache keys / jit signatures."""
        return (self.kind,)

    # ---- byte accounting ---------------------------------------------------
    #
    # All pricing is relative to the bytes the payload would ship
    # UNENCODED (``in_bytes`` = itemsize of the compute dtype): the
    # "f32" format is a passthrough — under bf16 compute it ships
    # 2-byte payloads, and the bf16 wire saves nothing there (it never
    # upcasts) while int8 still halves the traffic.  Defaults assume
    # f32 compute (the executor-test and benchmark configuration).

    @property
    def bytes_per_value(self) -> float:
        """Wire bytes per value under f32 compute (reference numbers)."""
        return _BYTES[self.kind]

    @property
    def scale_bytes(self) -> float:
        """Side-band bytes per scale group (0 unless quantized with
        explicit scales)."""
        return _SCALE_BYTES[self.kind]

    def payload_bytes_per_value(self, in_bytes: float = 4.0) -> float:
        """Wire bytes per value for payloads of an ``in_bytes``-byte
        compute dtype (passthrough ships as-is; bf16 never upcasts)."""
        if self.kind == "f32":
            return float(in_bytes)
        if self.kind == "bf16":
            return min(2.0, float(in_bytes))
        return 1.0

    def group_bytes(self, values_per_group: int,
                    in_bytes: float = 4.0) -> float:
        """Wire bytes of one scale group of ``values_per_group`` payload
        values (payload + scale side-band)."""
        return (self.payload_bytes_per_value(in_bytes) * values_per_group
                + self.scale_bytes)

    def comm_scale(self, values_per_group: int = 4096,
                   in_bytes: float = 4.0) -> float:
        """Per-value wire cost relative to the unencoded payload (<= 1).
        The planner's byte-aware heuristics weigh communication terms by
        this factor; the default group size is one 4K-token block row's
        worth of values, where the int8 scale side-band is negligible."""
        values_per_group = max(1, int(values_per_group))
        return (self.group_bytes(values_per_group, in_bytes)
                / (float(in_bytes) * values_per_group))

    def __str__(self) -> str:
        return self.kind


WIRE_F32 = WireFormat("f32")
WIRE_BF16 = WireFormat("bf16")
WIRE_INT8 = WireFormat("int8")


def parse_wire(s: str) -> WireFormat:
    """CLI/config syntax: ``f32`` | ``bf16`` | ``int8`` (plus the common
    dtype aliases)."""
    s = s.strip().lower()
    alias = {"": "f32", "f32": "f32", "fp32": "f32", "float32": "f32",
             "bf16": "bf16", "bfloat16": "bf16", "int8": "int8"}
    if s not in alias:
        raise ValueError(f"unknown wire format {s!r} "
                         f"(expected f32 | bf16 | int8)")
    return WireFormat(alias[s])


def coerce_wire(wire) -> WireFormat:
    """Normalize ``WireFormat | str | None`` to a ``WireFormat``
    (``None`` -> the exact f32 passthrough)."""
    if wire is None:
        return WIRE_F32
    if isinstance(wire, WireFormat):
        return wire
    if isinstance(wire, str):
        return parse_wire(wire)
    raise TypeError(f"cannot interpret {wire!r} as a WireFormat")


# --------------------------------------------------------------------------
# codec
# --------------------------------------------------------------------------

def encode(x: torch.Tensor, fmt: WireFormat,
           scale_axes: tuple | None = None
           ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Encode ``x`` for the wire.  Returns ``(payload, scales)`` where
    ``scales`` is ``None`` for the scale-free formats.

    ``scale_axes`` are the axes reduced per scale group (``None`` = one
    scale for the whole tensor); scales keep their reduced dims so
    decode broadcasts at any rank."""
    if fmt.kind == "f32":
        return x, None                     # passthrough, bit-exact
    if fmt.kind == "bf16":
        return x.to(torch.bfloat16), None
    axes = tuple(range(x.ndim)) if scale_axes is None else scale_axes
    x32 = x.to(torch.float32)
    amax = torch.amax(x32.abs(), dim=axes, keepdim=True)
    scales = amax / 127.0
    # amax == 0 -> every value is 0 -> 0 * (127/eps) == 0: safe
    q = torch.round(x32 * (127.0 / torch.clamp(amax, min=1e-30)))
    return torch.clamp(q, -127.0, 127.0).to(torch.int8), scales


def decode(payload: torch.Tensor, scales: torch.Tensor | None,
           fmt: WireFormat, dtype: torch.dtype) -> torch.Tensor:
    """Decode a wire payload back into the compute ``dtype``."""
    if fmt.kind == "f32":
        return payload
    if fmt.kind == "bf16":
        return payload.to(dtype)
    return (payload.to(torch.float32) * scales).to(dtype)


# --------------------------------------------------------------------------
# ranks: the stacked frames split over a process group
# --------------------------------------------------------------------------

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class Ranks:
    """This process's place in a ``torch.distributed`` process group:
    ``size`` ranks, this one ``rank``, over ``backend``.  ``backend=None``
    is no group: the stacked transport, every frame in this process.
    ``members`` are the global ranks of a subgroup in group-rank order
    (:func:`subgroup`; its process group lives in this module's registry,
    so a ``Ranks`` stays hashable), ``None`` the world.  Hashable: keys
    the memoized executor tables."""

    size: int = 1
    rank: int = 0
    backend: str | None = None
    members: tuple | None = None

    def __post_init__(self):
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} of {self.size}")
        if self.backend is None and self.size != 1:
            raise ValueError("ranks without a process group")
        if self.backend is not None and self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r} "
                             f"(expected one of {BACKENDS})")
        if self.members is not None and len(self.members) != self.size:
            raise ValueError(f"{len(self.members)} members for a group of "
                             f"{self.size}")

    @property
    def grouped(self) -> bool:
        return self.backend is not None

    @property
    def alone(self) -> bool:
        """No group, or a survivor subgroup of one rank: a collective is
        the identity.  A one-rank world still makes its calls, so its
        backend runs them."""
        return not self.grouped or (self.members is not None
                                    and self.size == 1)

    @property
    def group(self):
        """The subgroup's process group (None: the world's default)."""
        return None if self.members is None else _GROUPS[self.members]

    def global_rank(self, r: int) -> int:
        """The global rank of group rank ``r``."""
        return int(r) if self.members is None else self.members[r]

    def bounds(self, n_frames: int) -> tuple:
        """Where each rank's share of ``n_frames`` starts, and the end:
        rank i holds ``[floor(i·N/R), floor((i+1)·N/R))``."""
        return tuple(i * n_frames // self.size for i in range(self.size + 1))

    def share(self, n_frames: int, even: bool = False) -> tuple[int, int]:
        """The frame range ``[lo, hi)`` this rank holds of ``n_frames``
        (:meth:`bounds`); ``even`` refuses a count the ranks do not
        divide (the serving cache's rule, ``launch/serve.cache_share``;
        the training CLI holds its starting layouts in
        ``launch/train.check_ranked``)."""
        if even and n_frames % self.size:
            raise ValueError(f"{self.size} ranks do not divide "
                             f"{n_frames} frames")
        b = self.bounds(n_frames)
        return b[self.rank], b[self.rank + 1]


STACKED = Ranks()

# the subgroups' process groups, by their members (Ranks.group)
_GROUPS: dict = {}


def launch_env() -> dict | None:
    """``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), or None outside it."""
    if "WORLD_SIZE" not in os.environ:
        return None
    size = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ.get("RANK", 0))
    return {"rank": rank, "size": size,
            "local_rank": int(os.environ.get("LOCAL_RANK", rank)),
            "local_size": int(os.environ.get("LOCAL_WORLD_SIZE", size))}


def join(backend: str, device) -> Ranks:
    """Join the process group ``torchrun``'s environment names (its
    ``MASTER_ADDR`` / ``MASTER_PORT``), unless this process already has.
    NCCL needs a CUDA device; nothing falls back to another backend."""
    env = launch_env()
    if env is None:
        raise RuntimeError("no process group: RANK and WORLD_SIZE are not "
                           "set (start the ranks with torchrun)")
    device = torch.device(device)
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} "
                         f"(expected one of {BACKENDS})")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("NCCL needs a CUDA device (use --dist-backend gloo "
                         "on the CPU)")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://",
                                rank=env["rank"], world_size=env["size"])
    if dist.get_backend() != backend:
        raise RuntimeError(f"the process group runs {dist.get_backend()}, "
                           f"not {backend}")
    return Ranks(dist.get_world_size(), dist.get_rank(), backend)


def in_group() -> bool:
    """Whether this process has joined a process group."""
    return dist.is_initialized()


def leave() -> None:
    """Leave the process group (if this process is in one), and with it
    every subgroup."""
    _GROUPS.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def subgroup(members, ranks: Ranks) -> Ranks | None:
    """This process's place in the group of the global ranks
    ``members`` (sorted), or None when it is not one of them.  Every
    process of ``ranks``'s group calls it at the same step boundary; the
    group is made once per member set (``dist.new_group`` with local
    synchronization: the members wait for one another, a process left
    out goes on).  The world's members give the world itself."""
    if not ranks.grouped:
        raise ValueError("a subgroup without a process group")
    members = tuple(sorted(int(m) for m in members))
    world, me = dist.get_world_size(), dist.get_rank()
    if not members or not set(members) <= set(range(world)):
        raise ValueError(f"bad members {members} of {world} ranks")
    if members == tuple(range(world)):
        return Ranks(world, me, ranks.backend)
    if me not in members:
        return None
    if members not in _GROUPS:
        _GROUPS[members] = dist.new_group(list(members),
                                          use_local_synchronization=True)
    return Ranks(len(members), members.index(me), ranks.backend, members)


def _host(x: torch.Tensor) -> torch.Tensor:
    """``x`` in host memory (pinned when it comes from the card, so the
    copies each way run at the link's rate; the caching host allocator
    keeps such a buffer until the copies that use it are done)."""
    if not x.is_cuda:
        return x.contiguous()
    return torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x)


def _wire(x: torch.Tensor, ranks: Ranks, stage: bool = True
          ) -> torch.Tensor:
    """``x`` as ``ranks``'s backend moves it: through host memory under
    gloo (when ``stage``), else on its device, contiguous.  A caller that
    receives into it copies it back when it is not ``x``."""
    if stage and ranks.backend == "gloo":
        return _host(x)
    return x.contiguous()


def _landing(like: torch.Tensor, ranks: Ranks, stage: bool = True
             ) -> torch.Tensor:
    """A zeroed buffer of ``like``'s shape and dtype where ``ranks``'s
    backend receives (:func:`_wire`'s placement)."""
    host = stage and ranks.backend == "gloo"
    return torch.zeros(like.shape, dtype=like.dtype,
                       device="cpu" if host else like.device,
                       pin_memory=host and like.is_cuda)


def _small_device(ranks: Ranks, device):
    """Where a collective's few host numbers go: the card under NCCL,
    which moves device memory only, else the host."""
    return torch.device(device) if ranks.backend == "nccl" else "cpu"


def barrier(ranks: Ranks) -> None:
    """Wait until every rank has come here (nothing without a group)."""
    if not ranks.alone:
        dist.barrier(group=ranks.group)


def all_sum(tensors, ranks: Ranks) -> list[torch.Tensor]:
    """Each tensor summed over the ranks: one flat bucket per dtype, the
    tensors in the order given (every rank passes the same order), one
    ``all_reduce`` each.  Returns views of the summed buckets; without a
    group, or alone in one, the tensors themselves."""
    tensors = list(tensors)
    if ranks.alone:
        return tensors
    t0 = time.perf_counter()
    out = list(tensors)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        # gloo moves host memory: the bucket goes through the host whole
        buf = _wire(flat, ranks)
        dist.all_reduce(buf, group=ranks.group)
        if buf is not flat:
            flat.copy_(buf, non_blocking=True)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view(tensors[i].shape)
            off += n
    _STATS["reduce_s"] += time.perf_counter() - t0
    return out


def all_max(x: float, ranks: Ranks, device) -> float:
    """The largest of the ranks' ``x`` (one ``all_reduce``); without a
    group, or alone in one, ``x``."""
    if ranks.alone:
        return x
    buf = torch.tensor([float(x)], dtype=torch.float64,
                       device=_small_device(ranks, device))
    dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=ranks.group)
    return float(buf)


def broadcast(tensors, src: int, ranks: Ranks) -> None:
    """Each tensor of group rank ``src`` into the other ranks' tensors of
    the same shapes and dtypes, in place (one ``dist.broadcast`` a
    tensor, in the order given; staged through the host under gloo).
    :func:`wire_stats` counts the bytes ``src`` sends, once to every
    other rank (:func:`broadcast_bytes`).  Alone, nothing."""
    if ranks.alone:
        return
    t0 = time.perf_counter()
    sent = 0
    with torch.no_grad():
        for t in tensors:
            buf = _wire(t, ranks)
            dist.broadcast(buf, src=ranks.global_rank(src),
                           group=ranks.group)
            if buf is not t:
                t.copy_(buf)
            sent += buf.nbytes
    _STATS["broadcasts"] += 1
    if ranks.rank == src:
        _STATS["broadcast_bytes"] += sent * (ranks.size - 1)
    _STATS["broadcast_s"] += time.perf_counter() - t0


def broadcast_bytes(tensors, src: int, ranks: Ranks) -> int:
    """The bytes ``ranks``'s rank sends in :func:`broadcast` of
    ``tensors`` from ``src``: all of them to every other rank from
    ``src``, none from the rest."""
    if ranks.rank != src:
        return 0
    return sum(t.nbytes for t in tensors) * (ranks.size - 1)


def digest(tensors) -> bytes:
    """A digest of the tensors' bytes, computed where they lie: each
    tensor's 32-bit words summed in 64-bit integers weighted by their
    position, per chunk (exact, so every rank's device gives the same
    number for the same bytes), folded with its shape and dtype."""
    h = hashlib.sha256()
    for t in tensors:
        b = t.detach().contiguous().reshape(-1).view(torch.uint8)
        if b.numel() % 4:
            b = torch.cat([b, b.new_zeros(4 - b.numel() % 4)])
        words = b.view(torch.int32)
        h.update(f"{tuple(t.shape)} {t.dtype}".encode())
        for chunk in words.split(1 << 24):
            w = torch.arange(1, chunk.numel() + 1, dtype=torch.int64,
                             device=chunk.device)
            h.update(int((chunk.long() * w).sum()).to_bytes(
                8, "little", signed=True))
    return h.digest()


def agree(what: str, data: bytes, ranks: Ranks, device) -> None:
    """Raise unless every rank passes the same ``data`` (an all-gather of
    its hash)."""
    if ranks.alone:
        return
    dev = _small_device(ranks, device)
    mine = int.from_bytes(hashlib.sha256(data).digest()[:8], "little",
                          signed=True)
    got = [torch.zeros(1, dtype=torch.int64, device=dev)
           for _ in range(ranks.size)]
    dist.all_gather(got, torch.tensor([mine], dtype=torch.int64,
                                      device=dev), group=ranks.group)
    hashes = [int(x) for x in got]
    if len(set(hashes)) != 1:
        raise RuntimeError(f"the ranks disagree on the {what} (hashes "
                           f"{hashes})")


_STATS = {"ships": 0, "messages": 0, "sent_bytes": 0, "recv_bytes": 0,
          "ship_s": 0.0, "reduce_s": 0.0,
          "moves": 0, "move_bytes": 0, "move_s": 0.0,
          "merges": 0, "merge_bytes": 0, "merge_s": 0.0,
          "broadcasts": 0, "broadcast_bytes": 0, "broadcast_s": 0.0}


def wire_stats() -> dict:
    """This process's cross-rank traffic since :func:`reset_wire_stats`:
    ship calls across ranks, messages posted, bytes sent and received
    (payloads plus int8 scales), and the host seconds spent in the ships
    that crossed ranks and in :func:`all_sum` (their staging and waits
    included; a host clock: under NCCL the device may still be moving
    the data when a call returns); the :func:`move` calls that crossed
    ranks, the bytes they sent and their seconds; the :func:`gather`
    calls, the bytes each sent (its share, once to every other rank) and
    their seconds; the :func:`broadcast` calls, the bytes this rank sent
    in them and their seconds."""
    return dict(_STATS)


def reset_wire_stats() -> None:
    for k in _STATS:
        _STATS[k] = type(_STATS[k])(0)


def rank_wire_bytes(spec, ranks: Ranks, n_q_heads: int, n_kv_heads: int,
                    head_dim: int, in_bytes: float,
                    out_bytes: float = 4.0,
                    pods: int = 1) -> tuple[float, float]:
    """The bytes ``ranks``'s rank puts on the wire in one FCP attention
    call on ``spec``'s plan, ``(forward, backward)``, the sent bytes
    :func:`wire_stats` should count: each ship group's pairs that leave
    this rank (forward) or arrive at it (the backward sends those back),
    ``rows`` blocks each, at ``core.cost_model``'s prices of a block.
    The reshuffle ships q, k and v (``in_bytes`` a value), the rounds k
    and v, the restore o (``out_bytes``: f32, or the executor's
    ``out_dtype``).  Over ``pods`` pods every pod ships its own copy of
    the plan's pairs (``core.executor.pod_perm``), the frames split over
    the ranks pod-major."""
    from ..core import cost_model as cm     # which imports this module
    bs = spec.block_size
    qkv = cm.qkv_wire_block_bytes(spec.wire, bs, n_q_heads, n_kv_heads,
                                  head_dim, in_bytes)
    o = cm.o_wire_block_bytes(spec.wire, bs, n_q_heads, head_dim, out_bytes)
    kv = cm.kv_wire_block_bytes(spec.wire, bs, n_kv_heads, head_dim,
                                in_bytes)
    n = spec.n_workers
    lo, hi = ranks.share(n * pods)
    fwd = bwd = 0.0

    def price(perm, rows, block_bytes):
        nonlocal fwd, bwd
        for s, d in ((s + p * n, d + p * n) for p in range(pods)
                     for s, d in perm):
            if (lo <= s < hi) != (lo <= d < hi):
                if lo <= s < hi:
                    fwd += rows * block_bytes
                else:
                    bwd += rows * block_bytes

    for rnd in spec.resh_rounds:
        for g in rnd.groups:
            price(g.perm, g.rows, qkv)
            price(tuple((d, s) for s, d in g.perm), g.rows, o)
    for rnd in spec.comm_rounds:
        for g in rnd.groups:
            price(g.perm, g.rows, kv)
    return fwd, bwd


# --------------------------------------------------------------------------
# the transport
# --------------------------------------------------------------------------

def _ship(x: torch.Tensor, perm, fmt: WireFormat, ranks: Ranks | None,
          n_frames: int | None = None) -> torch.Tensor:
    """``x``'s frames along the global pairs ``perm``: all of the frames
    without a group (every pair an index copy), else this rank's share
    of ``n_frames`` (an equal share of ``x.shape[0] x R`` frames when
    None), in order.  Receive buffers take their shapes from ``x``'s
    (every frame's payload has the same shape): no shape travels at run
    time."""
    ranks = ranks or STACKED
    t0 = time.perf_counter()
    n, me = x.shape[0], ranks.rank
    total = n * ranks.size if n_frames is None else int(n_frames)
    bounds = ranks.bounds(total)
    lo = bounds[me]
    if bounds[me + 1] - lo != n:
        raise ValueError(f"{n} frames on rank {me} of {ranks.size}, whose "
                         f"share of {total} is {bounds[me + 1] - lo}")

    def owner(f):
        return bisect.bisect_right(bounds, f) - 1
    payload, scales = encode(x, fmt, (-2, -1))
    parts = [payload] if scales is None else [payload, scales]
    # gloo moves host memory: a ship with a pair across ranks takes its
    # payloads through the host whole, one copy each way; NCCL moves the
    # device's
    stage = ranks.backend == "gloo" and any(
        (owner(s) == me) != (owner(d) == me) for s, d in perm)
    recvs = [_landing(p, ranks, stage) for p in parts]
    parts = [_wire(p, ranks, stage) for p in parts]
    ops, sent, got = [], 0, 0
    for s, d in perm:
        rs, rd = owner(s), owner(d)
        if rs == me and rd == me:
            for src, dst in zip(parts, recvs):
                dst[d - lo] = src[s - lo]
        elif rs == me:
            for src in parts:
                ops.append(dist.P2POp(dist.isend, src[s - lo],
                                      ranks.global_rank(rd), ranks.group))
                sent += src[s - lo].nbytes
        elif rd == me:
            for dst in recvs:
                ops.append(dist.P2POp(dist.irecv, dst[d - lo],
                                      ranks.global_rank(rs), ranks.group))
                got += dst[d - lo].nbytes
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        _STATS["ships"] += 1
        _STATS["messages"] += len(ops)
        _STATS["sent_bytes"] += sent
        _STATS["recv_bytes"] += got
    if stage:
        recvs = [r.to(x.device, non_blocking=True) for r in recvs]
    if ops:
        _STATS["ship_s"] += time.perf_counter() - t0
    return decode(recvs[0], recvs[1] if scales is not None else None, fmt,
                  x.dtype)


class _Ship(torch.autograd.Function):
    """The quantized formats are not differentiable elementwise (round /
    truncate), so the whole hop is one Function, as in the reference:
    autograd through ``encode`` would give another gradient.  Across
    ranks the backward's ships match up because every rank's graph is the
    same, so autograd runs their backwards in the same order."""

    @staticmethod
    def forward(ctx, x, perm, fmt, ranks, n_frames):
        ctx.perm, ctx.fmt, ctx.ranks = perm, fmt, ranks
        ctx.n_frames = n_frames
        return _ship(x, perm, fmt, ranks, n_frames)

    @staticmethod
    def backward(ctx, g):
        rev = tuple((d, s) for s, d in ctx.perm)
        return (_ship(g.contiguous(), rev, ctx.fmt, ctx.ranks, ctx.n_frames),
                None, None, None, None)


def ship(x: torch.Tensor, perm, fmt: WireFormat = WIRE_F32,
         ranks: Ranks | None = None,
         n_frames: int | None = None) -> torch.Tensor:
    """Move worker payloads along a partial permutation.

    ``x``: ``[N, rows, heads, bs, D]`` — one payload per stacked
    worker.  ``perm``: ``(src, dst)`` pairs.  Returns the received
    payloads in ``x.dtype``: worker ``dst`` holds
    ``decode(encode(x[src]))``, workers no pair names hold zeros.
    Quantized formats carry one scale per (worker, row, head) — never
    across workers, whose payloads are separate messages.  The gradient
    travels the reversed permutation in the same format.

    With ``ranks`` in a process group, ``x`` is this rank's share of the
    ``n_frames`` frames (``Ranks.share``; None: ``N x R`` of them, split
    evenly) and ``perm`` names global frames (module docstring)."""
    perm = tuple((int(s), int(d)) for s, d in perm)
    if torch.is_grad_enabled() and x.requires_grad:
        return _Ship.apply(x, perm, fmt, ranks, n_frames)
    return _ship(x, perm, fmt, ranks, n_frames)


# --------------------------------------------------------------------------
# row moves and the gathered merge (serving across ranks)
# --------------------------------------------------------------------------

def move(srcs, dsts, table, ranks: Ranks, dim: int = 0) -> None:
    """Copy row ranges from ranks' ``srcs`` into ranks' ``dsts``, in
    place: the reshard of token ranges a serving insert makes.

    ``table`` holds ``(src rank, dst rank, src row, dst row, rows)``
    entries, ranges along ``dim``, the same on every rank (a host table
    each rank computes alike).  ``srcs`` and ``dsts`` are a tensor each,
    or lists of tensors paired in order (every entry moves the same rows
    of each pair; a pair has one dtype and the same shape apart from
    ``dim``); no destination row is named twice.  An entry with both
    ends on this rank is a local copy; one
    that leaves it is sent and one that arrives is received, all in one
    ``dist.batch_isend_irecv`` (every rank posting its ops in table
    order), staged through the host under gloo.  Without a group every
    entry must name rank 0: all of them are local copies."""
    srcs = [srcs] if isinstance(srcs, torch.Tensor) else list(srcs)
    dsts = [dsts] if isinstance(dsts, torch.Tensor) else list(dsts)
    for x, y in zip(srcs, dsts):
        if x.dtype != y.dtype:
            raise ValueError(f"move of {x.dtype} rows into {y.dtype}")
    if not ranks.grouped and any(s or d for s, d, *_ in table):
        raise ValueError("a move across ranks without a process group")
    t0 = time.perf_counter()
    me = ranks.rank
    ops, sent, landed = [], 0, []
    for s, d, a, b, n in table:
        if s == me and d == me:
            for x, y in zip(srcs, dsts):
                y.narrow(dim, b, n).copy_(x.narrow(dim, a, n))
        elif s == me:
            for x in srcs:
                buf = _wire(x.narrow(dim, a, n), ranks)
                ops.append(dist.P2POp(dist.isend, buf, ranks.global_rank(d),
                                      ranks.group))
                sent += buf.nbytes
        elif d == me:
            for y in dsts:
                part = y.narrow(dim, b, n)
                buf = _landing(part, ranks)
                ops.append(dist.P2POp(dist.irecv, buf, ranks.global_rank(s),
                                      ranks.group))
                landed.append((part, buf))
    if not ops:
        return
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    for part, buf in landed:
        part.copy_(buf, non_blocking=True)
    _STATS["moves"] += 1
    _STATS["move_bytes"] += sent
    _STATS["move_s"] += time.perf_counter() - t0


def move_bytes(table, ranks: Ranks, row_bytes: int) -> int:
    """The bytes ``ranks``'s rank sends in :func:`move` of ``table``:
    the rows of each entry that leaves it, ``row_bytes`` a row (summed
    over the tensors moved)."""
    return sum(n * row_bytes for s, d, _, _, n in table
               if s == ranks.rank and d != s)


def gather(x: torch.Tensor, ranks: Ranks, dim: int) -> torch.Tensor:
    """Every rank's ``x`` (one shape on all of them), concatenated along
    ``dim`` in rank order (one ``all_gather``): every rank ends with the
    same bytes, so a merge computed from them is the same on each.
    Without a group, or alone in one, ``x`` itself."""
    if ranks.alone:
        return x
    t0 = time.perf_counter()
    buf = _wire(x, ranks)
    parts = [torch.empty_like(buf) for _ in range(ranks.size)]
    dist.all_gather(parts, buf, group=ranks.group)
    out = torch.cat(parts, dim).to(x.device, non_blocking=True)
    _STATS["merges"] += 1
    # its share, once to every other rank
    _STATS["merge_bytes"] += buf.nbytes * (ranks.size - 1)
    _STATS["merge_s"] += time.perf_counter() - t0
    return out
