"""Model registry (port of ``repro.models.registry``: the dense and MoE
families).

``Model(cfg, tp)`` offers ``init``, ``forward``, ``features``,
``head_fn``, ``loss`` and ``param_count`` (training), ``forward_prefill``,
``init_cache`` and ``decode_step`` (serving), all with pluggable
attention, plus the single-device oracles ``dense_attn_fn`` /
``dense_decode_attn`` / ``dense_cache_update``.  The SSM, hybrid, audio
and vision-language families are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..configs.base import ModelConfig
from ..kernels import ref
from . import layers, transformer

PORTED_FAMILIES = ("dense", "moe")


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    tp: int = 1

    def __post_init__(self):
        if self.cfg.family not in PORTED_FAMILIES:
            raise NotImplementedError(
                f"family {self.cfg.family!r} is not ported yet (ported: "
                f"{', '.join(PORTED_FAMILIES)})")

    def init(self, generator: torch.Generator, device="cuda") -> dict:
        return transformer.init_params(self.cfg, generator, device,
                                       self.tp)

    def forward(self, params, batch: dict, attn_fn=None,
                remat=False) -> torch.Tensor:
        return transformer.forward(params, self.cfg, batch, attn_fn, remat)

    def features(self, params, batch: dict, attn_fn=None, remat=False):
        """Pre-unembed hidden states (chunked-loss path)."""
        return transformer.forward(params, self.cfg, batch, attn_fn, remat,
                                   return_features=True)

    def head_fn(self, params):
        """Chunk-applicable unembedding (norm + lm head)."""
        return lambda x: transformer.unembed(params, self.cfg, x)

    def loss(self, params, batch: dict, attn_fn=None, remat=False,
             chunked: bool = False, chunk: int = 4096) -> torch.Tensor:
        if chunked:
            feats = self.features(params, batch, attn_fn, remat)
            return layers.chunked_cross_entropy(
                feats, self.head_fn(params), batch["labels"],
                batch["loss_mask"], self.cfg.vocab_size, chunk)
        logits = self.forward(params, batch, attn_fn, remat)
        return layers.cross_entropy(logits, batch["labels"],
                                    batch["loss_mask"], self.cfg.vocab_size)

    def param_count(self, params) -> int:
        def count(t):
            if isinstance(t, dict):
                return sum(count(v) for v in t.values())
            return t.numel()
        return count(params)

    def forward_prefill(self, params, batch: dict, attn_fn: Callable,
                        return_features: bool = False):
        return transformer.forward_prefill(params, self.cfg, batch,
                                           attn_fn, return_features)

    def init_cache(self, batch: int, seq_len: int, device="cuda") -> dict:
        return transformer.init_kv_cache(self.cfg, batch, seq_len,
                                         self.tp, device)

    def decode_step(self, params, tokens, pos, cache, decode_attn_fn,
                    cache_update_fn):
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
