"""Shared neural-net layers (port of ``repro.models.layers``; plain
PyTorch on parameter dictionaries)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def gated_rms_norm(x: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """Mamba2's normalization: RMSNorm(x * silu(z)), the gate in f32."""
    return rms_norm(x * F.silu(z.to(torch.float32)).to(x.dtype), w, eps)


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


def maybe_checkpoint(fn, remat, *args):
    """``fn(*args)``, under a non-reentrant ``torch.utils.checkpoint`` when
    ``remat`` is set and a gradient flows: the backward keeps only the
    inputs and recomputes ``fn`` (the reference's ``apply_remat``)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def normal(generator: torch.Generator, shape, scale: float,
           dtype: torch.dtype, device) -> torch.Tensor:
    """Seeded normal init (drawn in f32 on ``device``, then cast)."""
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (x * scale).to(dtype)


def _masked_logits(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """f32 logits with the vocab-padding columns pushed to -1e30 (out of
    the partition function), as the reference adds its mask row."""
    logits = logits.to(torch.float32)
    v_pad = logits.shape[-1]
    if v_pad > vocab_size:
        neg = torch.zeros(v_pad, dtype=torch.float32, device=logits.device)
        neg[vocab_size:] = -1e30
        logits = logits + neg
    return logits


def _nll_sum(logits: torch.Tensor, labels: torch.Tensor,
             mask: torch.Tensor, vocab_size: int) -> torch.Tensor:
    logits = _masked_logits(logits, vocab_size)
    lz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long().clamp(
        0, vocab_size - 1)[..., None])[..., 0]
    return torch.sum((lz - gold) * mask)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Masked token-mean cross entropy; logits may be vocab-padded (the
    padding columns are excluded from the partition function)."""
    return _nll_sum(logits, labels, mask, vocab_size) / torch.clamp(
        torch.sum(mask), min=1.0)


def chunked_cross_entropy(features: torch.Tensor, head_fn, labels,
                          mask, vocab_size: int,
                          chunk: int = 4096) -> torch.Tensor:
    """Masked CE without materializing full ``[T, V]`` logits: a loop over
    token chunks of the unembedding + loss (the reference's
    ``lax.scan``).  Each chunk runs under a non-reentrant
    ``torch.utils.checkpoint``, so the backward keeps only the features
    and recomputes one chunk's logits at a time; without it the loop
    would save every chunk's f32 logits.

    features: ``[F, T, d]``; ``head_fn(x [n, d]) -> logits [n, v]``."""
    f, t, d = features.shape
    flat = features.reshape(f * t, d)
    lab = labels.reshape(f * t)
    msk = mask.reshape(f * t).to(torch.float32)

    def piece(xc, lc, mc):
        return _nll_sum(head_fn(xc), lc, mc, vocab_size)

    num = torch.zeros((), dtype=torch.float32, device=features.device)
    for lo in range(0, f * t, chunk):
        sl = slice(lo, lo + chunk)
        if torch.is_grad_enabled():
            part = checkpoint(piece, flat[sl], lab[sl], msk[sl],
                              use_reentrant=False)
        else:
            part = piece(flat[sl], lab[sl], msk[sl])
        num = num + part
    return num / torch.clamp(torch.sum(msk), min=1.0)
