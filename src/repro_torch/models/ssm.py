"""Mamba2 / SSD blocks (port of ``repro.models.ssm``; arXiv:2405.21060).

Chunked SSD with *segment resets*: the per-token log-decay is forced to
``RESET_LOG_DECAY`` wherever ``position == 0``, so the recurrence never
crosses a document boundary although a whole packed stream is scanned
as one sequence.  Intra-chunk terms use within-chunk cumsums; the
inter-chunk recurrence, a ``lax.associative_scan`` in the reference, is
a loop over chunks here (at most 32 at 8192 tokens and chunk 256): the
same recurrence, summed in another order.

Unlike the reference, which ``vmap``\\ s a block over the sequences of a
prefill batch, :func:`ssd_scan` and :func:`mamba_block` take a leading
batch dimension, so a batch of sequences is one set of products (the
training forward scans the packed stream as a batch of one).  A chunk's
decay matrix ``Lmat [B, Z, nh, c, c]`` (f32) is formed once a layer.

The family has no Pallas kernel in the reference, so it stays plain
PyTorch: the products are ``torch.einsum`` / ``matmul``, as the JAX
package leaves them to XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from . import layers as L
from .transformer import _dt

RESET_LOG_DECAY = -40.0


def ssm_dims(cfg: ModelConfig, tp: int = 1):
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_head_dim
    nheads_pad = ((nheads + tp - 1) // tp) * tp
    return d_inner, nheads, nheads_pad, nheads_pad * cfg.ssm_head_dim


def init_mamba_layers(cfg: ModelConfig, generator: torch.Generator,
                      n_layers: int, device="cuda", tp: int = 1) -> dict:
    """Stacked Mamba2 layer weights with the reference's shapes and scales,
    drawn from ``generator`` (which must live on ``device``); ``A_log``,
    ``D`` and ``dt_bias`` are f32 whatever ``param_dtype`` is, as in the
    reference."""
    _, _, nh, din = ssm_dims(cfg, tp)
    d, ds, cw = cfg.d_model, cfg.ssm_state, cfg.ssm_conv
    dt = _dt(cfg)
    f32 = dict(dtype=torch.float32, device=device)

    def normal(shape, scale):
        return L.normal(generator, shape, scale, dt, device)
    a_log = torch.log(torch.linspace(1.0, 16.0, nh, **f32))
    return {
        "ln": torch.ones((n_layers, d), dtype=dt, device=device),
        "in_proj": normal((n_layers, d, 2 * din + 2 * ds + nh), d ** -0.5),
        "conv_w": normal((n_layers, cw, din + 2 * ds), 0.2),
        "conv_b": torch.zeros((n_layers, din + 2 * ds), dtype=dt,
                              device=device),
        "A_log": a_log.repeat(n_layers, 1),
        "D": torch.ones((n_layers, nh), **f32),
        "dt_bias": torch.zeros((n_layers, nh), **f32),
        "ssm_norm": torch.ones((n_layers, din), dtype=dt, device=device),
        "out_proj": normal((n_layers, din, d), din ** -0.5),
    }


def _masked_causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        same_doc: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the stream, masked at doc boundaries.

    x: ``[B, S, C]``; w: ``[cw, C]``; same_doc: ``[B, S, cw]``
    (``same_doc[:, t, i]`` iff token t-i belongs to token t's
    document)."""
    cw = w.shape[0]
    out = x * w[0]
    for i in range(1, cw):
        shifted = F.pad(x[:, :-i], (0, 0, i, 0))
        out = out + torch.where(same_doc[..., i:i + 1], shifted, 0.0) * w[i]
    return F.silu(out + b)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """L[..., t, s] = sum_{r=s+1..t} a[..., r] for t >= s else -inf."""
    c = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=a.device))
    return diff.masked_fill(~tri, float("-inf"))


def ssd_scan(xdt: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, chunk: int):
    """Chunked SSD of a batch of sequences.  xdt: ``[B, S, nh, hd]``
    (inputs pre-scaled by dt); a: ``[B, S, nh]`` log decay; Bm/Cm: ``[B,
    S, ds]`` (ngroups = 1).  Returns y ``[B, S, nh, hd]`` and the final
    state ``[B, nh, hd, ds]``.

    A tail shorter than a chunk is padded with zero inputs and the reset
    decay, as in the reference: the padding adds nothing to ``y``, and
    the final state of a padded sequence passes through the resets (it
    is ~0, as the reference's is)."""
    bt, s, nh, hd = xdt.shape
    ds = Bm.shape[-1]
    pad = (-s) % chunk
    if pad:
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad), value=RESET_LOG_DECAY)
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = (s + pad) // chunk
    xz = xdt.reshape(bt, nc, chunk, nh, hd)
    az = a.reshape(bt, nc, chunk, nh)
    Bz = Bm.reshape(bt, nc, chunk, ds)
    Cz = Cm.reshape(bt, nc, chunk, ds)

    acum = torch.cumsum(az, dim=2)                      # [b, z, c, nh]
    # intra-chunk (the "quadratic attention-like" branch of SSD)
    Lmat = torch.exp(_segsum(az.transpose(2, 3)))       # [b, z, nh, c, c]
    G = torch.matmul(Cz, Bz.transpose(-1, -2))          # [b, z, t, s]
    y_diag = torch.matmul(G[:, :, None] * Lmat,
                          xz.transpose(2, 3))           # [b, z, nh, t, hd]
    y_diag = y_diag.transpose(2, 3)                     # [b, z, t, nh, hd]

    # per-chunk output states [b, z, nh, hd, ds]
    decay_out = torch.exp(acum[:, :, -1:] - acum)       # [b, z, c, nh]
    states = torch.einsum("bzcnh,bzcd->bznhd", xz * decay_out[..., None],
                          Bz)

    # inter-chunk recurrence: the state before each chunk, in order
    chunk_decay = torch.exp(acum[:, :, -1])             # [b, z, nh]
    h = torch.zeros_like(states[:, 0])
    h_prev = []
    for z in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, z, :, None, None] + states[:, z]
    h_prev = torch.stack(h_prev, dim=1)                 # [b, z, nh, hd, ds]

    y_off = torch.einsum("bzcd,bznhd->bzcnh", Cz, h_prev)
    y_off = y_off * torch.exp(acum)[..., None]          # [b, z, c, nh, hd]
    y = (y_diag + y_off).reshape(bt, nc * chunk, nh, hd)[:, :s]
    return y, h


def mamba_block(x: torch.Tensor, lp: dict, cfg: ModelConfig,
                positions: torch.Tensor, return_state: bool = False):
    """One Mamba2 block over a batch of streams.  x: ``[B, S, d]``;
    positions: ``[B, S]``.  With ``return_state``: ``(out, (final ssm
    state [B, nh, hd, ds], conv tail [B, cw - 1, C]))`` for the prefill
    -> decode handoff."""
    bt, s, d = x.shape
    din = lp["ssm_norm"].shape[-1]
    nh = lp["A_log"].shape[-1]
    hd = din // nh
    ds = cfg.ssm_state

    h = L.rms_norm(x, lp["ln"], cfg.norm_eps)
    zxbcdt = L.dense(h, lp["in_proj"])
    z, xbc, dtraw = torch.split(zxbcdt, [din, din + 2 * ds, nh], dim=-1)

    # doc-boundary masks: token t-i is in t's document iff position >= i
    cw = lp["conv_w"].shape[0]
    doc_start = positions == 0
    same_doc = positions[..., None] >= torch.arange(cw, device=x.device)

    xbc_raw = xbc
    xbc = _masked_causal_conv(xbc, lp["conv_w"], lp["conv_b"], same_doc)
    xin, Bm, Cm = torch.split(xbc, [din, ds, ds], dim=-1)
    xin = xin.reshape(bt, s, nh, hd)

    dt = F.softplus(dtraw.to(torch.float32) + lp["dt_bias"])
    a = -torch.exp(lp["A_log"]) * dt                    # [B, S, nh]
    a = torch.where(doc_start[..., None], RESET_LOG_DECAY, a)
    xdt = xin.to(torch.float32) * dt[..., None]

    y, final_state = ssd_scan(xdt, a, Bm.to(torch.float32),
                              Cm.to(torch.float32), cfg.ssm_chunk)
    y = y + lp["D"][:, None] * xin.to(torch.float32)
    y = y.reshape(bt, s, din).to(x.dtype)
    y = L.gated_rms_norm(y, z, lp["ssm_norm"], cfg.norm_eps)
    out = x + L.dense(y, lp["out_proj"], save=False)
    if return_state:
        conv_tail = xbc_raw[:, s - (cw - 1):] if cw > 1 else xbc_raw[:, :0]
        return out, (final_state, conv_tail)
    return out


# --------------------------------------------------------------------------
# decode (recurrent step)
# --------------------------------------------------------------------------

def init_ssm_cache(cfg: ModelConfig, n_layers: int, batch: int,
                   tp: int = 1, device="cuda") -> dict:
    _, _, nh, din = ssm_dims(cfg, tp)
    ds, cw = cfg.ssm_state, cfg.ssm_conv
    return {
        "state": torch.zeros((n_layers, batch, nh, din // nh, ds),
                             dtype=torch.float32, device=device),
        "conv": torch.zeros((n_layers, batch, cw - 1, din + 2 * ds),
                            dtype=_dt(cfg), device=device),
    }


def mamba_decode_step(x: torch.Tensor, lp: dict, state: torch.Tensor,
                      conv_state: torch.Tensor, cfg: ModelConfig):
    """x: ``[B, d]``; state: ``[B, nh, hd, ds]``; conv_state: ``[B, cw-1,
    C]``.  Returns ``(y [B, d], state, conv_state)`` (new tensors)."""
    b, d = x.shape
    din = lp["ssm_norm"].shape[-1]
    nh = lp["A_log"].shape[-1]
    hd = din // nh
    ds = cfg.ssm_state

    h = L.rms_norm(x, lp["ln"], cfg.norm_eps)
    zxbcdt = torch.matmul(h, lp["in_proj"])
    z, xbc, dtraw = torch.split(zxbcdt, [din, din + 2 * ds, nh], dim=-1)

    window = torch.cat([conv_state, xbc[:, None]], dim=1)    # [B, cw, C]
    # window rows are oldest -> newest; conv_w rows are lag 0..cw-1: flip
    conv = torch.einsum("bwc,wc->bc", window,
                        torch.flip(lp["conv_w"], dims=(0,))) + lp["conv_b"]
    xbc = F.silu(conv)
    new_conv_state = window[:, 1:]

    xin, Bm, Cm = torch.split(xbc, [din, ds, ds], dim=-1)
    xin = xin.reshape(b, nh, hd).to(torch.float32)
    dt = F.softplus(dtraw.to(torch.float32) + lp["dt_bias"])
    decay = torch.exp(-torch.exp(lp["A_log"]) * dt)          # [B, nh]
    new_state = state * decay[..., None, None] + (
        (xin * dt[..., None])[..., None] * Bm.to(torch.float32)[:, None,
                                                               None])
    y = torch.matmul(new_state, Cm.to(torch.float32)[:, None, :, None])
    y = y[..., 0] + lp["D"][:, None] * xin
    y = y.reshape(b, din).to(x.dtype)
    y = L.gated_rms_norm(y, z, lp["ssm_norm"], cfg.norm_eps)
    return x + torch.matmul(y, lp["out_proj"]), new_state, new_conv_state
