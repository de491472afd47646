"""PyTorch oracles for the attention kernels (port of ``repro.kernels.ref``).

Conventions shared by every implementation in this package:

* layouts are head-leading: ``q: [..., H, Sq, D]``, ``k/v: [..., KH, Sk,
  D]``, ``o: [..., H, Sq, D]``, ``lse: [..., H, Sq]`` (GQA: query head
  ``h`` reads kv head ``h // (H // KH)``).  Leading batch dims are
  optional; ``seg``/``pos`` carry the same leading dims as their tokens
  (or none, when shared by the batch),
* masking is entirely described by per-token ``(segment_id, position)``
  plus a :class:`~repro_torch.masks.MaskSpec` family:
  ``valid = (seg_q == seg_k) & (seg_q != PAD) & mask.visible(pos_q,
  pos_k)`` (legacy ``causal: bool`` arguments coerce),
* outputs are normalized within the call plus a log-sum-exp, so partial
  results over disjoint KV ranges merge exactly with :func:`merge_partials`,
* fully masked query rows return ``o = 0`` and ``lse = NEG_INF``.

``NEG_INF`` stays finite on purpose: the fused kernel seeds its running
max from an incoming ``lse``, and ``-inf - -inf`` would make the rescale
NaN.
"""

from __future__ import annotations

import torch

from ..masks import coerce_mask

NEG_INF = -1e30
PAD_SEGMENT = -1


def mask_matrix(seg_q: torch.Tensor, pos_q: torch.Tensor,
                seg_k: torch.Tensor, pos_k: torch.Tensor,
                mask) -> torch.Tensor:
    """``[..., Sq, Sk]`` bool validity mask under a MaskSpec (or causal
    bool).  The position predicate is ``MaskSpec.visible`` itself."""
    mask = coerce_mask(mask)
    sq, pq = seg_q[..., :, None], pos_q[..., :, None]
    sk, pk = seg_k[..., None, :], pos_k[..., None, :]
    ok = (sq == sk) & (sq != PAD_SEGMENT)
    return ok & mask.visible(pq, pk)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        seg_q: torch.Tensor, pos_q: torch.Tensor,
                        seg_k: torch.Tensor, pos_k: torch.Tensor,
                        mask=True, scale: float | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense oracle.  Returns ``(o [..., H, Sq, D], lse [..., H, Sq])`` in
    f32; products run in f32 whatever the storage dtype."""
    h, d = q.shape[-3], q.shape[-1]
    kh = k.shape[-3]
    assert h % kh == 0, (h, kh)
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    group = h // kh
    kx = torch.repeat_interleave(k.float(), group, dim=-3)   # [..., H, Sk, D]
    vx = torch.repeat_interleave(v.float(), group, dim=-3)
    s = torch.matmul(q.float(), kx.transpose(-1, -2)) * scale
    m = mask_matrix(seg_q, pos_q, seg_k, pos_k, mask).unsqueeze(-3)
    s = torch.where(m, s, NEG_INF)
    smax = s.amax(dim=-1)                                    # [..., H, Sq]
    p = torch.where(m, torch.exp(s - smax[..., None]), 0.0)
    l = p.sum(dim=-1)
    o = torch.matmul(p, vx)
    safe_l = torch.clamp(l, min=1e-37)
    o = torch.where(l[..., None] > 0, o / safe_l[..., None], 0.0)
    lse = torch.where(l > 0, smax + torch.log(safe_l), NEG_INF)
    return o, lse


def merge_partials(o_a: torch.Tensor, lse_a: torch.Tensor,
                   o_b: torch.Tensor, lse_b: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exactly combine two normalized partial attentions over disjoint KV
    sets (flash-attention merge; associative and commutative)."""
    lse = torch.logaddexp(lse_a, lse_b)
    wa = torch.exp(lse_a - lse)
    wb = torch.exp(lse_b - lse)
    return o_a * wa[..., None] + o_b * wb[..., None], lse


def merge_many(os: torch.Tensor, lses: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge partials stacked on dim 0 (CP decode's cross-shard merge)."""
    lse = torch.logsumexp(lses, dim=0)
    w = torch.exp(lses - lse[None])
    return (os * w[..., None]).sum(dim=0), lse


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      seg_q: torch.Tensor, pos_q: torch.Tensor,
                      seg_k: torch.Tensor, pos_k: torch.Tensor,
                      mask=True, chunk: int = 512,
                      scale: float | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Flash-style chunked attention: a loop over KV chunks with a
    running ``(o, lse)``; ``O(Sq * chunk)`` live scores instead of
    ``O(Sq * Sk)``."""
    sk = k.shape[-2]
    if sk <= chunk:
        return reference_attention(q, k, v, seg_q, pos_q, seg_k, pos_k,
                                   mask, scale)
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.full(q.shape[:-1], NEG_INF, dtype=torch.float32,
                     device=q.device)
    for lo in range(0, sk, chunk):
        hi = min(lo + chunk, sk)
        o_c, lse_c = reference_attention(
            q, k[..., lo:hi, :], v[..., lo:hi, :], seg_q, pos_q,
            seg_k[..., lo:hi], pos_k[..., lo:hi], mask, scale)
        o, lse = merge_partials(o, lse, o_c, lse_c)
    return o, lse
