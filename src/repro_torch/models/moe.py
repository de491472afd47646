"""Mixture-of-Experts FFN with sort/scatter token dispatch (port of
``repro.models.moe``).

Top-k routing with per-frame capacity, as the reference computes it: the
router's logits in f32 (padded experts masked to -1e30), softmax, top-k,
the k weights renormalized; a stable sort of the frame's flat expert ids,
``searchsorted`` for the first row of each expert, and each routed row's
place in its expert, with rows past the capacity dropped.  The
reference's MoE has no Pallas kernel (its expert products are einsums
XLA compiles), so this is plain PyTorch; the expert products are batched
matrix products over ``[E, F * cap, d]``, one per weight for all frames.

What differs is mechanism, not numbers: every move of rows is a row
copy through an index (``index_select`` / ``index_copy``), never a
scatter-add of rows that share an index —

* a token's k copies are an expanded view (its backward sums them);
* the sorted rows go to their expert buffer rows, a dropped row to a
  spare row that is sliced off (the reference's scatter drops
  out-of-range indices);
* each buffer row's output goes straight back to the routed row that
  filled it (the reference gathers it by slot and un-sorts through the
  permutation); a dropped routed row stays zero;

so no kept row is written twice, every backward is a row gather or an
add of one term into each element, and forward and backward give the
same bytes on every call.  No host sync: every shape follows from T, k,
E and the capacity.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from . import layers as L


def padded_experts(cfg: ModelConfig, tp: int) -> int:
    return ((cfg.n_experts + tp - 1) // tp) * tp


def init_moe_ffn(cfg: ModelConfig, generator: torch.Generator,
                 device="cuda", tp: int = 1) -> dict:
    """The MoE leaves of every layer, stacked over layers: the router in
    f32 (whatever ``param_dtype`` is, as in the reference), the experts in
    ``param_dtype``.  Experts past ``n_experts`` (padding to a multiple of
    ``tp``) are zero and masked out of the router."""
    ep = padded_experts(cfg, tp)
    d, ff, nl = cfg.d_model, cfg.d_ff, cfg.n_layers
    dt = getattr(torch, cfg.param_dtype)
    lp = {
        "router": L.normal(generator, (nl, d, ep), d ** -0.5, torch.float32,
                           device),
        "we_i": L.normal(generator, (nl, ep, d, ff), d ** -0.5, dt, device),
        "we_g": L.normal(generator, (nl, ep, d, ff), d ** -0.5, dt, device),
        "we_down": L.normal(generator, (nl, ep, ff, d), ff ** -0.5, dt,
                            device),
    }
    for name in ("we_i", "we_g", "we_down"):
        lp[name][:, cfg.n_experts:] = 0
    return lp


def capacity(t: int, cfg: ModelConfig) -> int:
    """Rows each expert takes from a frame of ``t`` tokens (the
    reference's formula, in Python ints)."""
    cap = int(-(-t * cfg.experts_per_token // cfg.n_experts)
              * cfg.capacity_factor)
    return max(4, min(cap, t))


def router_probs(x: torch.Tensor, router: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """``x [..., d]`` -> the router's f32 probabilities ``[..., E]``,
    padded experts masked out."""
    ep = router.shape[-1]
    logits = L.dense(x.to(torch.float32), router)
    if ep > cfg.n_experts:
        pad = torch.arange(ep, device=x.device) >= cfg.n_experts
        logits = torch.where(pad, -1e30, logits)
    return torch.softmax(logits, dim=-1)


def route(x: torch.Tensor, router: torch.Tensor, cfg: ModelConfig):
    """``x [..., d]`` -> the renormalized top-k weights (f32) and expert
    ids ``[..., k]``."""
    w, eidx = torch.topk(router_probs(x, router, cfg),
                         cfg.experts_per_token, dim=-1)
    w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    return w, eidx


def dispatch(eidx: torch.Tensor, ep: int, cap: int):
    """The sort/scatter plan of frames' expert ids ``[F, T, k]``:
    ``order [F, T*k]`` (the stable sort of the flat ids), ``keep`` (the
    sorted row fits its expert's capacity) and ``slot``, the buffer row
    of each sorted row.  Frame f's rows of expert e fill rows ``(e * F +
    f) * cap ..`` of one buffer ``[ep * F * cap (+ 1 spare), d]``, so the
    buffer is ``[ep, F * cap, d]`` for the expert products; a dropped row
    goes to the spare row ``ep * F * cap``."""
    f_, t, k = eidx.shape
    flat_e = eidx.reshape(f_, t * k)
    e_sorted, order = torch.sort(flat_e, dim=-1, stable=True)
    experts = torch.arange(ep, device=eidx.device, dtype=e_sorted.dtype)
    starts = torch.searchsorted(e_sorted, experts.expand(f_, ep).contiguous())
    rows = torch.arange(t * k, device=eidx.device)
    pos_in_e = rows - torch.gather(starts, 1, e_sorted)
    keep = pos_in_e < cap
    frame = torch.arange(f_, device=eidx.device)[:, None]
    slot = torch.where(keep, (e_sorted * f_ + frame) * cap + pos_in_e,
                       ep * f_ * cap)
    return order, keep, slot


def moe_ffn(x: torch.Tensor, lp: dict, cfg: ModelConfig) -> torch.Tensor:
    """x: ``[F, T, d]`` -> ``[F, T, d]``.  Routing and capacity are per
    frame (each CP worker dispatches its own tokens), as the reference's
    ``vmap`` over frames."""
    f_, t, d = x.shape
    ep = lp["router"].shape[-1]
    k = cfg.experts_per_token
    cap = capacity(t, cfg)
    rows, n_buf = f_ * t * k, ep * f_ * cap
    w, eidx = route(x, lp["router"], cfg)
    order, _, slot = dispatch(eidx, ep, cap)
    # flat routed row (frame, token, choice) of each sorted row, and the
    # routed row that fills each buffer row (rows, a spare, for none)
    frame = torch.arange(f_, device=x.device)[:, None] * (t * k)
    order = (order + frame).reshape(rows)
    slot = slot.reshape(rows)
    src = torch.full((n_buf + 1,), rows, dtype=order.dtype,
                     device=x.device).scatter_(0, slot, order)[:n_buf]
    xk = x[:, :, None, :].expand(f_, t, k, d).reshape(rows, d)
    buf = x.new_zeros((n_buf + 1, d)).index_copy(
        0, slot, xk.index_select(0, order))[:n_buf]
    h_in = buf.view(ep, f_ * cap, d)
    h = torch.bmm(h_in, lp["we_i"])
    g = torch.bmm(h_in, lp["we_g"])
    out = torch.bmm(F.silu(g) * h, lp["we_down"]).reshape(n_buf, d)
    y = out.new_zeros((rows + 1, d)).index_copy(0, src, out)[:rows]
    return torch.einsum("ftkd,ftk->ftd", y.view(f_, t, k, d), w.to(x.dtype))


def _moe_frame(x: torch.Tensor, lp: dict, cfg: ModelConfig) -> torch.Tensor:
    """x: ``[T, d]``, one frame's tokens -> ``[T, d]``."""
    return moe_ffn(x[None], lp, cfg)[0]


def router_load(x: torch.Tensor, lp: dict, cfg: ModelConfig) -> torch.Tensor:
    """Tokens routed per expert (f32 ``[E]``; diagnostics and
    load-balance tests): the top-k of the raw logits, as the reference
    counts them."""
    logits = torch.matmul(x.to(torch.float32), lp["router"])
    eidx = torch.topk(logits, cfg.experts_per_token, dim=-1).indices
    return torch.bincount(eidx.reshape(-1),
                          minlength=lp["router"].shape[-1]).to(torch.float32)
