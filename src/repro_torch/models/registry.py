"""Model registry (port of ``repro.models.registry``: every family the
reference takes).

``Model(cfg, tp)`` dispatches on ``cfg.family``:

* dense / moe / audio / vlm -> ``transformer.py`` (the MoE FFN via the
  config; audio and vlm are transformer backbones behind the front-end
  stub of ``transformer.embed_tokens``: musicgen, internvl2)
* ssm                       -> a pure Mamba2 stack (this module;
  mamba2-130m)
* hybrid                    -> ``hybrid.py`` (zamba2)

It offers ``init``, ``forward``, ``features``, ``head_fn``, ``loss`` and
``param_count`` (training), ``forward_prefill``, ``init_cache``,
``decode_step`` and ``unembed`` (serving), all with pluggable attention
(the SSM family takes none), plus the single-device oracles
``dense_attn_fn`` / ``dense_decode_attn`` / ``dense_cache_update``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..configs.base import ModelConfig
from ..kernels import ref
from . import hybrid, layers, ssm, transformer

RECURRENT = ("ssm", "hybrid")


# --------------------------------------------------------------------------
# pure-SSM model (mamba2-130m)
# --------------------------------------------------------------------------

def _init_ssm_model(cfg: ModelConfig, generator: torch.Generator, device,
                    tp: int) -> dict:
    dt = transformer._dt(cfg)
    vpad = cfg.padded_vocab(tp)
    # tied embeddings are also the unembedding: scale d^-1/2 keeps the
    # initial logits O(1)
    emb_scale = cfg.d_model ** -0.5 if cfg.tie_embeddings else 1.0
    params = {
        "embed": layers.normal(generator, (vpad, cfg.d_model), emb_scale,
                               dt, device),
        "mamba": ssm.init_mamba_layers(cfg, generator, cfg.n_layers, device,
                                       tp),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.normal(
            generator, (cfg.d_model, vpad), cfg.d_model ** -0.5, dt, device)
    return params


def _forward_ssm(params, cfg: ModelConfig, batch: dict, remat=False,
                 return_features: bool = False) -> torch.Tensor:
    """The packed stream ``[F, T]`` scanned as one sequence (resets at
    document starts); ``remat`` checkpoints each layer under its policy
    (``"dots"`` saves ``in_proj``, as the reference)."""
    f, t = batch["tokens"].shape
    x = params["embed"][batch["tokens"].long()].reshape(1, f * t, -1)
    pos = batch["positions"].reshape(1, f * t)
    names = sorted(params["mamba"])

    def one(x, *ws):
        return ssm.mamba_block(x, dict(zip(names, ws)), cfg, pos)
    for i in range(cfg.n_layers):
        x = layers.maybe_checkpoint(one, remat, x,
                                    *[params["mamba"][n][i] for n in names])
    x = x.reshape(f, t, -1)
    return x if return_features else transformer.unembed(params, cfg, x)


def _prefill_ssm(params, cfg: ModelConfig, batch: dict, batch_size: int,
                 seq_len: int):
    """Per-sequence scans of a prefill batch (the reference's ``vmap`` in
    ``launch/serve.py``): the logits of each sequence's last token and
    every layer's final state and conv tail."""
    x = params["embed"][batch["tokens"].long()]
    xb = x.reshape(batch_size, seq_len, cfg.d_model)
    pos_b = batch["positions"].reshape(batch_size, seq_len)
    states, convs = [], []
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in params["mamba"].items()}
        xb, (st, cv) = ssm.mamba_block(xb, lp, cfg, pos_b,
                                       return_state=True)
        states.append(st)
        convs.append(cv)
    logits = transformer.unembed(params, cfg, xb[:, -1])
    return logits, {"state": torch.stack(states), "conv": torch.stack(convs)}


def _decode_ssm(params, cfg: ModelConfig, tokens, pos, cache):
    """One recurrent step of every layer; the cache is written in place."""
    x = params["embed"][tokens.long()]
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in params["mamba"].items()}
        x, st, cv = ssm.mamba_decode_step(x, lp, cache["state"][i],
                                          cache["conv"][i], cfg)
        cache["state"][i] = st
        cache["conv"][i] = cv
    return transformer.unembed(params, cfg, x), cache


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    tp: int = 1

    def init(self, generator: torch.Generator, device="cuda") -> dict:
        if self.cfg.family == "ssm":
            return _init_ssm_model(self.cfg, generator, device, self.tp)
        if self.cfg.family == "hybrid":
            return hybrid.init_params(self.cfg, generator, device, self.tp)
        return transformer.init_params(self.cfg, generator, device,
                                       self.tp)

    def _stack(self, params, batch, attn_fn, remat, return_features):
        if self.cfg.family == "ssm":
            return _forward_ssm(params, self.cfg, batch, remat,
                                return_features)
        if self.cfg.family == "hybrid":
            return hybrid.forward(params, self.cfg, batch, attn_fn, remat,
                                  return_features)
        return transformer.forward(params, self.cfg, batch, attn_fn, remat,
                                   return_features)

    def forward(self, params, batch: dict, attn_fn=None,
                remat=False) -> torch.Tensor:
        return self._stack(params, batch, attn_fn, remat, False)

    def features(self, params, batch: dict, attn_fn=None, remat=False):
        """Pre-unembed hidden states (chunked-loss path)."""
        return self._stack(params, batch, attn_fn, remat, True)

    def head_fn(self, params):
        """Chunk-applicable unembedding (norm + lm head)."""
        return lambda x: self.unembed(params, x)

    def loss(self, params, batch: dict, attn_fn=None, remat=False,
             chunked: bool = False, chunk: int = 4096) -> torch.Tensor:
        """The token-mean loss; a batch that holds one rank's frames
        carries the whole batch's token count as ``loss_denom``, and the
        loss is then this rank's share of the mean."""
        denom = batch.get("loss_denom")
        if chunked:
            feats = self.features(params, batch, attn_fn, remat)
            return layers.chunked_cross_entropy(
                feats, self.head_fn(params), batch["labels"],
                batch["loss_mask"], self.cfg.vocab_size, chunk, denom)
        logits = self.forward(params, batch, attn_fn, remat)
        return layers.cross_entropy(logits, batch["labels"],
                                    batch["loss_mask"], self.cfg.vocab_size,
                                    denom)

    def param_count(self, params) -> int:
        def count(t):
            if isinstance(t, dict):
                return sum(count(v) for v in t.values())
            return t.numel()
        return count(params)

    def forward_prefill(self, params, batch: dict, attn_fn: Callable,
                        return_features: bool = False,
                        batch_size: int | None = None,
                        seq_len: int | None = None):
        """Attention families: ``(logits or features [F, T, ...], k, v)``
        with every layer's roped K/V ``[L, F, T, KH, Dh]``.  Recurrent
        families (``batch_size`` sequences of ``seq_len``): ``(last-token
        logits [batch_size, V], cache)``, the cache in the layout of
        :meth:`init_cache` with ``batch_size`` rows."""
        if self.cfg.family == "ssm":
            return _prefill_ssm(params, self.cfg, batch, batch_size,
                                seq_len)
        if self.cfg.family == "hybrid":
            return hybrid.forward_prefill(params, self.cfg, batch, attn_fn,
                                          batch_size, seq_len)
        return transformer.forward_prefill(params, self.cfg, batch,
                                           attn_fn, return_features)

    def init_cache(self, batch: int, seq_len: int, device="cuda") -> dict:
        if self.cfg.family == "ssm":
            return ssm.init_ssm_cache(self.cfg, self.cfg.n_layers, batch,
                                      self.tp, device)
        if self.cfg.family == "hybrid":
            return hybrid.init_cache(self.cfg, batch, seq_len, self.tp,
                                     device)
        return transformer.init_kv_cache(self.cfg, batch, seq_len,
                                         self.tp, device)

    def decode_step(self, params, tokens, pos, cache, decode_attn_fn=None,
                    cache_update_fn=None):
        if self.cfg.family == "ssm":
            return _decode_ssm(params, self.cfg, tokens, pos, cache)
        if self.cfg.family == "hybrid":
            return hybrid.decode_step(params, self.cfg, tokens, pos, cache,
                                      decode_attn_fn, cache_update_fn)
        return transformer.decode_step(params, self.cfg, tokens, pos,
                                       cache, decode_attn_fn,
                                       cache_update_fn)

    def unembed(self, params, x: torch.Tensor) -> torch.Tensor:
        return transformer.unembed(params, self.cfg, x)


def dense_attn_fn(seg: torch.Tensor, pos: torch.Tensor, mask=True,
                  chunk: int = 512):
    """Single-device oracle attention over the packed stream: frames
    reshape to the stream and run chunked masked attention."""

    def attn(q, k, v):
        f, t, h, d = q.shape
        kh = k.shape[2]
        qq = q.reshape(f * t, h, d).transpose(0, 1)
        kk = k.reshape(f * t, kh, d).transpose(0, 1)
        vv = v.reshape(f * t, kh, d).transpose(0, 1)
        s_flat, p_flat = seg.reshape(f * t), pos.reshape(f * t)
        o, _ = ref.chunked_attention(qq, kk, vv, s_flat, p_flat, s_flat,
                                     p_flat, mask, chunk=chunk)
        return o.transpose(0, 1).reshape(f, t, h, d)

    return attn


def dense_cache_update(cache: torch.Tensor, new: torch.Tensor,
                       pos: torch.Tensor) -> torch.Tensor:
    """cache: ``[B, S, KH, D]`` (written in place); new: ``[B, KH, D]``;
    pos: ``[B]``."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, pos.long()] = new.to(cache.dtype)
    return cache


def dense_decode_attn(q, kc, vc, lengths):
    """Oracle decode attention (single device)."""
    pos = torch.arange(kc.shape[1], dtype=torch.int32, device=q.device)
    seg_k = torch.where(pos[None] < lengths[:, None], 0, -1).to(torch.int32)
    zero = torch.zeros((q.shape[0], 1), dtype=torch.int32, device=q.device)
    o, _ = ref.reference_attention(
        q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2), zero, zero,
        seg_k, pos.expand_as(seg_k), mask=False)
    return o[:, :, 0]
