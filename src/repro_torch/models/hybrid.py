"""Zamba2-style hybrid: a Mamba2 backbone and one *shared* attention block
applied every ``attn_every`` layers (port of ``repro.models.hybrid``;
arXiv:2411.15242).

The shared block is where FCP applies in this family: it attends over
the whole packed stream, while the SSM layers stay attention-free.  Its
weights are one set, invoked ``n_layers / attn_every`` times; each
invocation has its own KV cache at decode time.  Every invocation takes
the same attention closure, so one FCP plan serves them all.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..configs.base import ModelConfig
from . import layers as L
from . import ssm as S
from .transformer import _attention_qkv, _dt, unembed


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda", tp: int = 1) -> dict:
    """Random weights drawn from ``generator`` (on ``device``) with the
    reference's shapes and scales."""
    assert cfg.attn_every > 0 and cfg.n_layers % cfg.attn_every == 0
    nh, nkv = cfg.padded_heads(tp)
    vpad = cfg.padded_vocab(tp)
    d, dh, ff = cfg.d_model, cfg.head_dim, cfg.d_ff
    dt = _dt(cfg)

    def normal(shape, scale):
        return L.normal(generator, shape, scale, dt, device)
    ones = torch.ones((d,), dtype=dt, device=device)
    shared = {
        "ln1": ones.clone(), "ln2": ones.clone(),
        "wq": normal((d, nh, dh), d ** -0.5),
        "wk": normal((d, nkv, dh), d ** -0.5),
        "wv": normal((d, nkv, dh), d ** -0.5),
        "wo": normal((nh, dh, d), (nh * dh) ** -0.5),
        "wi": normal((d, ff), d ** -0.5),
        "wg": normal((d, ff), d ** -0.5),
        "wdown": normal((ff, d), ff ** -0.5),
    }
    # zero the padded heads (exactness of head padding)
    shared["wq"][:, cfg.n_heads:] = 0
    shared["wo"][cfg.n_heads:] = 0
    return {
        "embed": normal((vpad, d), 1.0),
        "mamba": S.init_mamba_layers(cfg, generator, cfg.n_layers, device,
                                     tp),
        "shared_attn": shared,
        "final_norm": ones.clone(),
        "lm_head": normal((d, vpad), d ** -0.5),
    }


def _shared_attn_block(x, sp, cfg: ModelConfig, pos, attn_fn):
    """x: ``[F, T, d]``; the shared attention + MLP block."""
    h = L.rms_norm(x, sp["ln1"], cfg.norm_eps)
    q, k, v = _attention_qkv(sp, cfg, h, pos)
    o = attn_fn(q, k, v)
    x = x + L.dense(o.to(x.dtype), sp["wo"], 2)
    h2 = L.rms_norm(x, sp["ln2"], cfg.norm_eps)
    return x + L.swiglu(h2, sp["wi"], sp["wg"], sp["wdown"]), k, v


def forward(params, cfg: ModelConfig, batch: dict, attn_fn: Callable,
            remat=False, return_features: bool = False) -> torch.Tensor:
    """Packed-stream forward.  batch: tokens/positions ``[F, T]`` ->
    logits (or the pre-unembed features ``[F, T, d]``).  The Mamba layers
    scan the stream as one sequence (resets at document starts); with
    ``remat`` each Mamba layer and each shared-block invocation is
    checkpointed under the policy ``remat`` names, as the reference's
    ``apply_remat`` (``"dots"`` saves the Mamba layers' ``in_proj`` and
    the shared block's projections)."""
    f, t = batch["tokens"].shape
    x = params["embed"][batch["tokens"].long()]
    pos = batch["positions"]
    pos_flat = pos.reshape(1, f * t)
    names = sorted(params["mamba"])
    snames = sorted(params["shared_attn"])
    sws = [params["shared_attn"][n] for n in snames]

    def one(x, *ws):
        xs = S.mamba_block(x.reshape(1, f * t, cfg.d_model),
                           dict(zip(names, ws)), cfg, pos_flat)
        return xs.reshape(f, t, cfg.d_model)

    def blk(x, *ws):
        return _shared_attn_block(x, dict(zip(snames, ws)), cfg, pos,
                                  attn_fn)[0]

    for g in range(cfg.n_layers // cfg.attn_every):
        for i in range(cfg.attn_every):
            li = g * cfg.attn_every + i
            x = L.maybe_checkpoint(one, remat, x,
                                   *[params["mamba"][n][li] for n in names])
        x = L.maybe_checkpoint(blk, remat, x, *sws)
    if return_features:
        return x
    return unembed(params, cfg, x)


def forward_prefill(params, cfg: ModelConfig, batch: dict,
                    attn_fn: Callable, batch_size: int, seq_len: int):
    """Prefill: the logits of each sequence's last token and the decode
    caches (per-sequence SSM states and conv tails, shared-attention
    K/V).

    The Mamba layers run on ``[batch_size, seq_len]`` (per-sequence final
    states); the shared attention in the frames layout (FCP).  The stream
    is sequence-major, so the two layouts interconvert by reshape."""
    f, t = batch["tokens"].shape
    assert f * t == batch_size * seq_len
    x = params["embed"][batch["tokens"].long()]
    pos_f = batch["positions"]                          # frames layout
    pos_b = pos_f.reshape(batch_size, seq_len)
    sp = params["shared_attn"]
    states, convs, kss, vss = [], [], [], []
    xb = x.reshape(batch_size, seq_len, cfg.d_model)
    for g in range(cfg.n_layers // cfg.attn_every):
        for i in range(cfg.attn_every):
            li = g * cfg.attn_every + i
            lp = {k: v[li] for k, v in params["mamba"].items()}
            xb, (st, cv) = S.mamba_block(xb, lp, cfg, pos_b,
                                         return_state=True)
            states.append(st)
            convs.append(cv)
        xf, k, v = _shared_attn_block(xb.reshape(f, t, cfg.d_model), sp,
                                      cfg, pos_f, attn_fn)
        xb = xf.reshape(batch_size, seq_len, cfg.d_model)
        kh, dh = k.shape[2], k.shape[3]
        kss.append(k.to(xf.dtype).reshape(batch_size, seq_len, kh, dh))
        vss.append(v.to(xf.dtype).reshape(batch_size, seq_len, kh, dh))
    logits = unembed(params, cfg, xb[:, -1])
    cache = {"state": torch.stack(states), "conv": torch.stack(convs),
             "k": torch.stack(kss), "v": torch.stack(vss)}
    return logits, cache


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, seq_len: int, tp: int = 1,
               device="cuda") -> dict:
    nh, nkv = cfg.padded_heads(tp)
    kv = (cfg.n_layers // cfg.attn_every, batch, seq_len, nkv,
          cfg.head_dim)
    c = S.init_ssm_cache(cfg, cfg.n_layers, batch, tp, device)
    c["k"] = torch.zeros(kv, dtype=_dt(cfg), device=device)
    c["v"] = torch.zeros(kv, dtype=_dt(cfg), device=device)
    return c


def decode_step(params, cfg: ModelConfig, tokens, pos, cache,
                decode_attn_fn: Callable, cache_update_fn: Callable):
    """tokens: ``[B]``; pos: ``[B]``.  Returns ``(logits [B, V], cache)``;
    the cache (``state``, ``conv``, ``k``, ``v``) is written in place, as
    the transformer's."""
    x = params["embed"][tokens.long()]                       # [B, d]
    sp = params["shared_attn"]
    for g in range(cfg.n_layers // cfg.attn_every):
        for i in range(cfg.attn_every):
            li = g * cfg.attn_every + i
            lp = {k: v[li] for k, v in params["mamba"].items()}
            x, st, cv = S.mamba_decode_step(
                x, lp, cache["state"][li], cache["conv"][li], cfg)
            cache["state"][li] = st
            cache["conv"][li] = cv
        # shared attention invocation g
        h = L.rms_norm(x, sp["ln1"], cfg.norm_eps)
        q, k, v = _attention_qkv(sp, cfg, h[:, None], pos[:, None])
        kc = cache_update_fn(cache["k"][g], k[:, 0], pos)
        vc = cache_update_fn(cache["v"][g], v[:, 0], pos)
        o = decode_attn_fn(q[:, 0], kc, vc, pos + 1)
        x = x + torch.einsum("bhk,hkd->bd", o.to(x.dtype), sp["wo"])
        h2 = L.rms_norm(x, sp["ln2"], cfg.norm_eps)
        x = x + L.swiglu(h2, sp["wi"], sp["wg"], sp["wdown"])
    return unembed(params, cfg, x), cache
