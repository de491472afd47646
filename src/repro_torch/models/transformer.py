"""Decoder-only transformer, GQA + RoPE + SwiGLU or a Mixture-of-Experts
FFN (port of ``repro.models.transformer``: the dense and MoE families, and
the audio and vision-language backbones behind the front-end stub of
:func:`embed_tokens`).

The parameter tree is a dict of tensors in the reference's layout
(``wq [L, d, H, Dh]``, ``wo [L, H, Dh, d]``, ...), so every einsum maps
one to one.  Entry points:

* ``forward`` — packed stream ``[F, T]`` for training: logits or the
  pre-unembed features, with optional per-layer activation
  checkpointing (``remat``);
* ``forward_prefill`` — the same stack, also returning every layer's
  roped K/V for cache construction; attention is pluggable
  (``attn_fn``), so the same code runs the dense oracle or FCP attention
  on stacked workers — the transparency property of §4.3;
* ``decode_step`` — one token per row against a KV cache; cache read and
  update are pluggable (dense or sequence-sharded).

PyTorch runs eagerly, so the layer stack is a Python loop (the
reference's ``lax.scan``); inference needs no activation checkpointing.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..configs.base import ModelConfig
from . import layers as L
from .moe import init_moe_ffn, moe_ffn


def _dt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda", tp: int = 1) -> dict:
    """Random weights drawn from ``generator`` (which must live on
    ``device``), with the reference's shapes and scales.  A given seed
    gives other numbers than ``jax.random``; to run both packages on
    the same weights, convert the reference's with
    :func:`repro_torch.models.convert.params_from_numpy`.  An MoE config
    (``n_experts``) gets the router and expert leaves of
    :func:`repro_torch.models.moe.init_moe_ffn` in place of ``wi``,
    ``wg`` and ``wdown``; a multimodal config (``frontend_dim``) gets
    ``frontend_proj [frontend_dim, d]`` (drawn last, so the other leaves
    are those of the same config without a front end)."""
    nh, nkv = cfg.padded_heads(tp)
    vpad = cfg.padded_vocab(tp)
    d, dh, ff, nl = cfg.d_model, cfg.head_dim, cfg.d_ff, cfg.n_layers
    dt = _dt(cfg)

    def normal(shape, scale):
        return L.normal(generator, shape, scale, dt, device)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    wq = normal((nl, d, nh, dh), d ** -0.5)
    wo = normal((nl, nh, dh, d), (nh * dh) ** -0.5)
    # zero the padded heads (exactness of head padding)
    wq[:, :, cfg.n_heads:] = 0
    wo[:, cfg.n_heads:] = 0
    lyr = {
        "ln1": ones(nl, d), "ln2": ones(nl, d), "wq": wq,
        "wk": normal((nl, d, nkv, dh), d ** -0.5),
        "wv": normal((nl, d, nkv, dh), d ** -0.5), "wo": wo,
    }
    if cfg.n_experts:
        lyr.update(init_moe_ffn(cfg, generator, device, tp))
    else:
        lyr.update(wi=normal((nl, d, ff), d ** -0.5),
                   wg=normal((nl, d, ff), d ** -0.5),
                   wdown=normal((nl, ff, d), ff ** -0.5))
    if cfg.qkv_bias:
        for name, h in (("bq", nh), ("bk", nkv), ("bv", nkv)):
            lyr[name] = torch.zeros((nl, h, dh), dtype=dt, device=device)
    params = {"embed": normal((vpad, d), 1.0), "layers": lyr,
              "final_norm": ones(d)}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, vpad), d ** -0.5)
    if cfg.frontend_dim:
        params["frontend_proj"] = normal((cfg.frontend_dim, d),
                                         cfg.frontend_dim ** -0.5)
    return params


def layer_params(params: dict, i: int) -> dict:
    return {k: v[i] for k, v in params["layers"].items()}


def _attention_qkv(lp, cfg: ModelConfig, h, pos):
    """h: [..., T, d] -> q [..., T, H, Dh], k/v [..., T, KH, Dh] (roped)."""
    q = L.dense(h, lp["wq"])
    k = L.dense(h, lp["wk"])
    v = L.dense(h, lp["wv"])
    if "bq" in lp:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    return L.rope(q, pos, cfg.rope_theta), L.rope(k, pos, cfg.rope_theta), v


def _ffn(x, lp, cfg: ModelConfig):
    """The residual FFN block of ``x [F, T, d]``, or ``[B, d]`` at decode
    (the MoE then routes each row as a frame of one token, as the
    reference's ``moe_ffn(h2[:, None])[:, 0]``)."""
    h2 = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    if not cfg.n_experts:
        return x + L.swiglu(h2, lp["wi"], lp["wg"], lp["wdown"])
    if h2.ndim == 2:
        return x + moe_ffn(h2[:, None], lp, cfg)[:, 0]
    return x + moe_ffn(h2, lp, cfg)


def _layer_body(x, lp, cfg: ModelConfig, pos, attn_fn):
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = _attention_qkv(lp, cfg, h, pos)
    o = attn_fn(q, k, v)                                     # [F,T,H,Dh]
    x = x + L.dense(o.to(x.dtype), lp["wo"], 2)
    return _ffn(x, lp, cfg)


def forward(params, cfg: ModelConfig, batch: dict, attn_fn,
            remat=False, return_features: bool = False) -> torch.Tensor:
    """batch: tokens/positions ``[F, T]`` → logits (or the pre-unembed
    features ``[F, T, d]`` for the chunked loss).

    ``attn_fn`` is one callable shared by every layer, or a per-layer
    sequence (models that interleave mask families route each layer
    through its mask group's schedule).  A per-layer entry may carry the
    layer-pipelined reshuffle protocol (``launch.train.PipelinedAttn``):
    ``enter(x, pos) -> (x', pos')`` moves the hidden state (and rope
    positions) into the entry's layout before a group's first layer,
    ``exit(x) -> x`` moves it back after its last, and ``attn`` is the
    attention callable (the entry itself when absent).  Layers in
    between run with the moved positions.

    ``remat`` (``False`` | ``True`` | ``"dots"`` | ``"nothing"``) wraps
    each layer in a non-reentrant ``torch.utils.checkpoint``
    (:func:`layers.maybe_checkpoint`).  ``True`` and ``"dots"`` save what
    the reference's ``dots_with_no_batch_dims_saveable`` saves: the q, k,
    v and output projections, the FFN's gate and up products and an MoE
    layer's router logits; the backward recomputes the rest of the layer,
    attention and the expert products included.  ``"nothing"`` keeps
    only the layer inputs and recomputes the whole layer.  The numbers
    are those of no remat (the MoE dispatch is deterministic, so a
    recomputed layer routes as the forward did).
    """
    fns = [attn_fn] * cfg.n_layers if callable(attn_fn) else list(attn_fn)
    if len(fns) != cfg.n_layers:
        raise ValueError(f"per-layer attn_fn sequence has {len(fns)} "
                         f"entries for {cfg.n_layers} layers")
    x = embed_tokens(params, cfg, batch)
    pos = cur_pos = batch["positions"]
    names = sorted(params["layers"])
    for i, fn in enumerate(fns):
        ws = [params["layers"][n][i] for n in names]
        enter = getattr(fn, "enter", None)
        if enter is not None:
            x, cur_pos = enter(x, pos)

        def body(x, *ws, fn=getattr(fn, "attn", fn), pos=cur_pos):
            return _layer_body(x, dict(zip(names, ws)), cfg, pos, fn)
        x = L.maybe_checkpoint(body, remat, x, *ws)
        exit_fn = getattr(fn, "exit", None)
        if exit_fn is not None:
            x = exit_fn(x)
            cur_pos = pos
    if return_features:
        return x
    return unembed(params, cfg, x)


def embed_tokens(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Token embeddings ``[F, T, d]``; multimodal front-end stub (the
    reference's): ``frontend_embeds [F, P, frontend_dim]`` are precomputed
    patch / frame embeddings, projected by ``frontend_proj``, that take
    the first P positions of each frame where ``frontend_mask [F, T]`` is
    set."""
    x = params["embed"][batch["tokens"].long()]
    if "frontend_embeds" in batch and "frontend_proj" in params:
        fe = batch["frontend_embeds"]
        pp = fe.shape[1]
        fep = torch.matmul(fe.to(x.dtype), params["frontend_proj"])
        mask = batch["frontend_mask"][:, :pp, None]
        x = torch.cat([torch.where(mask, fep, x[:, :pp]), x[:, pp:]], dim=1)
    return x


def unembed(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return torch.matmul(x, params["embed"].T)
    return torch.matmul(x, params["lm_head"])


def forward_prefill(params, cfg: ModelConfig, batch: dict,
                    attn_fn: Callable, return_features: bool = False):
    """batch: tokens/positions ``[F, T]``.  Returns ``(logits, k, v)``
    with the per-layer roped ``k``/``v`` ``[L, F, T, KH, Dh]`` for cache
    construction; with ``return_features`` the pre-unembed hidden state
    ``[F, T, d]`` comes back instead of the logits (the serving loop
    unembeds only each prompt's last token)."""
    x = embed_tokens(params, cfg, batch)
    pos = batch["positions"]
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = _attention_qkv(lp, cfg, h, pos)
        o = attn_fn(q, k, v)                                 # [F,T,H,Dh]
        x = x + L.dense(o.to(x.dtype), lp["wo"], 2)
        x = _ffn(x, lp, cfg)
        ks.append(k.to(x.dtype))
        vs.append(v.to(x.dtype))
    out = x if return_features else unembed(params, cfg, x)
    return out, torch.stack(ks), torch.stack(vs)


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def init_kv_cache(cfg: ModelConfig, batch: int, seq_len: int, tp: int = 1,
                  device="cuda") -> dict:
    nh, nkv = cfg.padded_heads(tp)
    shape = (cfg.n_layers, batch, seq_len, nkv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=_dt(cfg), device=device),
            "v": torch.zeros(shape, dtype=_dt(cfg), device=device)}


def decode_step(params, cfg: ModelConfig, tokens, pos, cache,
                decode_attn_fn: Callable, cache_update_fn: Callable):
    """tokens: ``[B]``; pos: ``[B]`` current positions; cache:
    ``{"k", "v"}`` ``[L, B, S, KH, Dh]``.  Returns ``(logits [B, V],
    cache)``.  ``cache_update_fn(cache_layer, new, pos)`` writes the
    layer's cache **in place** (it receives a view), so the returned
    cache is the same dict.

    ``decode_attn_fn(q [B,H,Dh], k_cache, v_cache, lengths) -> o`` and
    ``cache_update_fn`` abstract over dense vs CP-sharded caches.
    """
    x = params["embed"][tokens.long()]                       # [B, d]
    posf = pos[:, None]                                      # [B, 1]
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = _attention_qkv(lp, cfg, h[:, None], posf)
        q, k, v = q[:, 0], k[:, 0], v[:, 0]
        kc = cache_update_fn(cache["k"][i], k, pos)
        vc = cache_update_fn(cache["v"][i], v, pos)
        o = decode_attn_fn(q, kc, vc, pos + 1)               # [B, H, Dh]
        x = x + torch.einsum("bhk,hkd->bd", o.to(x.dtype), lp["wo"])
        x = _ffn(x, lp, cfg)
    return unembed(params, cfg, x), cache
