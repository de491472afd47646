"""Shared neural-net layers (port of ``repro.models.layers``; plain
PyTorch on parameter dictionaries)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding. x: [..., T, H, D]; positions: [..., T]."""
    d = x.shape[-1]
    half = d // 2
    freq = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    freq = torch.from_numpy(np.asarray(freq, np.float32)).to(x.device)
    ang = positions[..., None].to(torch.float32) * freq      # [..., T, half]
    cos = torch.cos(ang)[..., None, :]                       # [..., T, 1, h]
    sin = torch.sin(ang)[..., None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
           wo: torch.Tensor) -> torch.Tensor:
    h = torch.matmul(x, wi)
    g = torch.matmul(x, wg)
    return torch.matmul(F.silu(g) * h, wo)


def normal(generator: torch.Generator, shape, scale: float,
           dtype: torch.dtype, device) -> torch.Tensor:
    """Seeded normal init (drawn in f32 on ``device``, then cast)."""
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (x * scale).to(dtype)
