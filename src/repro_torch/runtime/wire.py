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
"""

from __future__ import annotations

import dataclasses

import torch

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
# the stacked-worker transport
# --------------------------------------------------------------------------

def _ship(x: torch.Tensor, perm, fmt: WireFormat) -> torch.Tensor:
    payload, scales = encode(x, fmt, (-2, -1))
    recv = torch.zeros_like(payload)
    recv_scales = None if scales is None else torch.zeros_like(scales)
    for s, d in perm:
        recv[d] = payload[s]
        if scales is not None:
            recv_scales[d] = scales[s]
    return decode(recv, recv_scales, fmt, x.dtype)


class _Ship(torch.autograd.Function):
    """The quantized formats are not differentiable elementwise (round /
    truncate), so the whole hop is one Function, as in the reference:
    autograd through ``encode`` would give another gradient."""

    @staticmethod
    def forward(ctx, x, perm, fmt):
        ctx.perm, ctx.fmt = perm, fmt
        return _ship(x, perm, fmt)

    @staticmethod
    def backward(ctx, g):
        rev = tuple((d, s) for s, d in ctx.perm)
        return _ship(g.contiguous(), rev, ctx.fmt), None, None


def ship(x: torch.Tensor, perm, fmt: WireFormat = WIRE_F32
         ) -> torch.Tensor:
    """Move worker payloads along a partial permutation.

    ``x``: ``[N, rows, heads, bs, D]`` — one payload per stacked
    worker.  ``perm``: ``(src, dst)`` pairs.  Returns the received
    payloads in ``x.dtype``: worker ``dst`` holds
    ``decode(encode(x[src]))``, workers no pair names hold zeros.
    Quantized formats carry one scale per (worker, row, head) — never
    across workers, whose payloads are separate messages.  The gradient
    travels the reversed permutation in the same format."""
    perm = tuple((int(s), int(d)) for s, d in perm)
    if torch.is_grad_enabled() and x.requires_grad:
        return _Ship.apply(x, perm, fmt)
    return _ship(x, perm, fmt)
