"""Shared neural-net layers (port of ``repro.models.layers``; plain
PyTorch on parameter dictionaries)."""

from __future__ import annotations

import functools
import math
import threading

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


@functools.lru_cache(maxsize=64)
def _rope_freq(half: int, theta: float, device: torch.device
               ) -> torch.Tensor:
    """The rotary frequencies on ``device``, uploaded once: a host copy
    inside a captured CUDA graph (the serving programs) is refused."""
    freq = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    return torch.from_numpy(np.asarray(freq, np.float32)).to(device)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding. x: [..., T, H, D]; positions: [..., T]."""
    d = x.shape[-1]
    half = d // 2
    freq = _rope_freq(half, float(theta), x.device)
    ang = positions[..., None].to(torch.float32) * freq      # [..., T, half]
    cos = torch.cos(ang)[..., None, :]                       # [..., T, 1, h]
    sin = torch.sin(ang)[..., None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class _DotsStore:
    """The outputs of one checkpointed call's saved products, in call
    order: recorded by the call's forward, replayed by its recompute."""

    def __init__(self):
        self.outs: list[torch.Tensor] = []
        self.replay = False
        self.next = 0


_dots = threading.local()        # the _DotsStore of the running call


class _SavedProduct(torch.autograd.Function):
    """``a @ b`` whose output the ``"dots"`` checkpoint keeps: its
    recompute takes the kept output instead of running the product
    again; the backward is the product's, on the recomputed inputs."""

    @staticmethod
    def forward(ctx, a, b, store):
        ctx.save_for_backward(a, b)
        if store.replay:
            store.next += 1
            return store.outs[store.next - 1].detach()
        out = torch.mm(a, b)
        store.outs.append(out.detach())
        return out

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = g.mm(b.t()) if ctx.needs_input_grad[0] else None
        gb = a.t().mm(g) if ctx.needs_input_grad[1] else None
        return ga, gb, None


def dense(x: torch.Tensor, w: torch.Tensor, n_in: int = 1,
          save: bool = True) -> torch.Tensor:
    """The product of ``x``'s last ``n_in`` dims with ``w``'s first
    ``n_in`` (``"...d,dhk->...hk"`` for ``n_in=1``), a product without
    batch dimensions, as one 2-D ``torch.mm``.  Inside a ``"dots"``
    checkpoint (:func:`maybe_checkpoint`) its output is kept, unless
    ``save=False``: a product whose output no backward reads (a layer's
    last, added into the residual stream), as the reference's partial
    evaluation keeps no such residual."""
    k = math.prod(w.shape[:n_in])
    a, b = x.reshape(-1, k), w.reshape(k, -1)
    store = getattr(_dots, "store", None)
    out = (_SavedProduct.apply(a, b, store) if save and store is not None
           else torch.mm(a, b))
    return out.reshape(*x.shape[:x.ndim - n_in], *w.shape[n_in:])


def swiglu(x: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
           wo: torch.Tensor) -> torch.Tensor:
    h = dense(x, wi)
    g = dense(x, wg)
    return dense(F.silu(g) * h, wo, save=False)


def maybe_checkpoint(fn, remat, *args):
    """``fn(*args)``, under a non-reentrant ``torch.utils.checkpoint`` when
    ``remat`` is set and a gradient flows (the reference's
    ``apply_remat``).  ``"nothing"`` keeps only the inputs and recomputes
    all of ``fn`` in the backward.  ``True`` or ``"dots"`` (the default)
    is the reference's ``dots_with_no_batch_dims_saveable``: it also
    keeps the output of every product without batch dimensions (each
    :func:`dense` call; batched products, such as the MoE experts', the
    SSD einsums and attention, dispatch ``bmm`` or run in the kernels)
    and the recompute takes those instead of running them again."""
    if not (remat and torch.is_grad_enabled()):
        return fn(*args)
    if remat == "nothing":
        return checkpoint(fn, *args, use_reentrant=False)
    store = _DotsStore()

    def run(*a):
        outer = getattr(_dots, "store", None)
        _dots.store = store
        try:
            return fn(*a)
        finally:
            _dots.store = outer
            store.replay, store.next = True, 0     # the recompute's turn
    return checkpoint(run, *args, use_reentrant=False)


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


def _token_count(mask: torch.Tensor, denom) -> torch.Tensor:
    return torch.clamp(torch.sum(mask), min=1.0) if denom is None else denom


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor, vocab_size: int,
                  denom: torch.Tensor | None = None) -> torch.Tensor:
    """Masked token-mean cross entropy; logits may be vocab-padded (the
    padding columns are excluded from the partition function).  With
    ``denom`` (a rank's share of the frames: the whole batch's token
    count) it is this share's summed loss over ``denom``, and the sum
    over the ranks is the batch's mean."""
    return _nll_sum(logits, labels, mask, vocab_size) / _token_count(
        mask, denom)


def chunked_cross_entropy(features: torch.Tensor, head_fn, labels,
                          mask, vocab_size: int,
                          chunk: int = 4096,
                          denom: torch.Tensor | None = None) -> torch.Tensor:
    """Masked CE without materializing full ``[T, V]`` logits: a loop over
    token chunks of the unembedding + loss (the reference's
    ``lax.scan``).  Each chunk runs under a non-reentrant
    ``torch.utils.checkpoint``, so the backward keeps only the features
    and recomputes one chunk's logits at a time; without it the loop
    would save every chunk's f32 logits.

    features: ``[F, T, d]``; ``head_fn(x [n, d]) -> logits [n, v]``;
    ``denom`` as in :func:`cross_entropy`."""
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
    return num / _token_count(msk, denom)
