"""Error-feedback gradient compression (port of
``repro.runtime.compression``).

The quantization error of step t is added back into step t+1's gradient
before quantization, so the bias does not accumulate.  Quantization is
the port's wire codec (:mod:`repro_torch.runtime.wire`); only the
scale-free formats (``f32``/``bf16``) are reducible, so ``int8`` is
rejected.  With one card there is no cross-pod reduction: the
quantize -> dequantize path wraps the gradient dict itself, which is
numerically what the reference does on one host.
"""

from __future__ import annotations

import torch

from ..optimizer.adamw import tree_map
from . import wire


def init_residuals(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)


def compress_grads(grads, residuals, fmt: wire.WireFormat = wire.WIRE_BF16):
    """Returns ``(compressed grads, residuals)``, the new residuals written
    into ``residuals`` (a step program holds them: the reference donates
    them to its jitted step).  ``fmt`` must be a scale-free wire
    format."""
    fmt = wire.coerce_wire(fmt)
    if fmt.scale_bytes:
        raise ValueError(
            f"EF-DCN compression needs a reducible (scale-free) wire "
            f"format, got {fmt} — per-group scales cannot be all-reduced")

    def one(g, r):
        g32 = g.to(torch.float32) + r
        gc, _ = wire.encode(g32, fmt)
        with torch.no_grad():
            r.copy_(g32 - wire.decode(gc, None, fmt, torch.float32))
        return gc
    return tree_map(one, grads, residuals), residuals


def reset_residuals(residuals) -> None:
    """Zero the residuals in place (a resize never reuses them)."""
    with torch.no_grad():
        tree_map(lambda r: r.zero_(), residuals)


def decompress_grads(comp):
    return tree_map(lambda g: g.to(torch.float32), comp)
