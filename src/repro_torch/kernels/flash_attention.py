"""Wrappers, plain versions and launch counters of the CUDA attention kernels.

Two kernels of :mod:`repro.kernels.flash_attention` are ported (the
serving path runs them; the four backward kernels come with training):

* :func:`fused_flash_fwd` — ``csrc/fused_flash_fwd.cu``: one launch per
  executor run, for all stacked workers at once.
* :func:`flash_attention_fwd` — ``csrc/flash_attention_fwd.cu``: varlen
  flash forward with a batch dimension and strided K/V (the decode
  kernel at ``Sq = 1``, reading the cache in place).

Each wrapper keeps the reference's positional signature and layout and
accepts an optional leading batch (worker) dimension.  The reference's
``block_q``/``block_k``/``interpret`` knobs have no counterpart: the
CUDA kernels fix their own tiles.  A wrapper takes
its plain PyTorch version (``*_plain``, same module) only because the
tensors it was given lie on the CPU; on a CUDA tensor it launches the
kernel or raises.  ``<wrapper>.launches`` counts kernel launches (plain
integers; reset them to 0 to count a region).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..masks import coerce_mask
from . import build
from .ref import NEG_INF, reference_attention

_MASK_KINDS = {"causal": 0, "sliding_window": 1, "chunked": 2, "full": 3}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int


def _mask_args(mask) -> tuple[int, int, int]:
    mask = coerce_mask(mask)
    return _MASK_KINDS[mask.kind], int(mask.window), int(mask.chunk)


def _ptr(x: torch.Tensor) -> int:
    return x.data_ptr()


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _bind(lib_name: str, fn_name: str, argtypes: list):
    fn = getattr(build.library(lib_name), fn_name)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


# --------------------------------------------------------------------------
# per-step varlen flash forward (decode at Sq = 1)
# --------------------------------------------------------------------------

def flash_attention_fwd_plain(q, k, v, seg_q, pos_q, seg_k, pos_k, *,
                              mask=True, scale: float | None = None):
    """Plain PyTorch version of :func:`flash_attention_fwd` (the dense
    oracle: same function, products in f32)."""
    if q.ndim == 4:
        seg_q, pos_q = _batched(seg_q, q.shape[0]), _batched(pos_q,
                                                             q.shape[0])
        seg_k, pos_k = _batched(seg_k, q.shape[0]), _batched(pos_k,
                                                             q.shape[0])
    return reference_attention(q, k, v, seg_q, pos_q, seg_k, pos_k, mask,
                               scale)


def _batched(x: torch.Tensor, b: int) -> torch.Tensor:
    return x if x.ndim == 2 else x.expand(b, x.shape[-1])


def flash_attention_fwd(q, k, v, seg_q, pos_q, seg_k, pos_k, *,
                        mask=True, scale: float | None = None):
    """Varlen flash forward.  Returns ``(o, lse)`` in f32.

    q: ``[H, Sq, D]`` or ``[B, H, Sq, D]``; k/v: ``[KH, Sk, D]`` or
    ``[B, KH, Sk, D]`` with any strides (unit stride on ``D``), so a
    KV cache ``[B, S, KH, D]`` is passed as ``cache.transpose(1, 2)``
    without a copy; seg/pos: ``[Sq]``/``[Sk]`` (shared by the batch) or
    ``[B, Sq]``/``[B, Sk]``, int32.  A fully masked row gives ``o = 0``,
    ``lse = NEG_INF``.  On the CUDA kernel ``D`` is 32 or 64.
    """
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, seg_q, pos_q, seg_k,
                                         pos_k, mask=mask, scale=scale)
    _require(q.device.type == "cuda", f"unsupported device {q.device}")
    unbatched = q.ndim == 3
    if unbatched:
        q, k, v = q[None], k[None], v[None]
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    _require(k.shape == (B, KH, Sk, D) and v.shape == k.shape,
             f"k/v shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    _require(v.stride() == k.stride(), "k and v must share strides")
    _require(H % KH == 0, f"{H} heads not a multiple of {KH} kv heads")
    _require(q.dtype in _DTYPES and k.dtype == q.dtype
             and v.dtype == q.dtype, f"unsupported dtypes {q.dtype}")
    _require(D in (32, 64), f"head_dim {D} not in (32, 64)")
    _require(q.stride(-1) == 1 and k.stride(-1) == 1,
             "head_dim must be the unit-stride dim")
    metas = []
    for x, n in ((seg_q, Sq), (pos_q, Sq), (seg_k, Sk), (pos_k, Sk)):
        _require(x.dtype == torch.int32 and x.is_contiguous()
                 and x.shape[-1] == n and x.ndim in (1, 2)
                 and (x.ndim == 1 or x.shape[0] == B)
                 and x.device == q.device,
                 "seg/pos must be contiguous int32 [S] or [B, S] "
                 "tensors on the device of q")
        metas.append(x)
    sq_b = Sq if seg_q.ndim == 2 else 0
    sk_b = Sk if seg_k.ndim == 2 else 0
    _require(pos_q.ndim == seg_q.ndim and pos_k.ndim == seg_k.ndim,
             "seg and pos must share their batching")
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    kind, window, chunk = _mask_args(mask)
    o = torch.empty((B, H, Sq, D), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    fn = _bind("flash_attention_fwd", "fcp_flash_attention_fwd",
               [_P] * 9 + [_I] * 7 + [ctypes.c_longlong] * 8
               + [ctypes.c_float, _I, _I, _I, _P])
    qs, ks = q.stride(), k.stride()
    _check(fn(_ptr(q), _ptr(k), _ptr(v), *[_ptr(x) for x in metas],
              _ptr(o), _ptr(lse), B, H, KH, Sq, Sk, D, _DTYPES[q.dtype],
              qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], sq_b, sk_b,
              float(scale), kind, window, chunk, _stream()),
           "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    if unbatched:
        return o[0], lse[0]
    return o, lse


flash_attention_fwd.launches = 0


# --------------------------------------------------------------------------
# fused schedule-driven run forward
# --------------------------------------------------------------------------

def run_segments(step_q: np.ndarray, skip_slot: int | None = None
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Segment table of one run: per worker, one ``(lo, hi)`` step range
    per distinct q slot of the (q-slot-sorted) ``step_q [N, S]``,
    padded per worker with empty ``(0, 0)`` segments.  Steps of
    ``skip_slot`` (the executor's q trash slot) get no segment."""
    step_q = np.asarray(step_q)
    segs = []
    for row in step_q:
        cuts = np.flatnonzero(np.diff(row)) + 1
        los = np.concatenate([[0], cuts]).astype(np.int64)
        his = np.concatenate([cuts, [row.shape[0]]]).astype(np.int64)
        keep = [(a, b) for a, b in zip(los, his)
                if skip_slot is None or row[a] != skip_slot]
        if len({row[a] for a, _ in keep}) != len(keep):
            raise ValueError("step_q is not q-slot-sorted within the run")
        segs.append(keep)
    G = max(1, max(len(s) for s in segs))
    lo = np.zeros((len(segs), G), np.int32)
    hi = np.zeros((len(segs), G), np.int32)
    for w, s in enumerate(segs):
        for g, (a, b) in enumerate(s):
            lo[w, g], hi[w, g] = a, b
    return lo, hi


def fused_flash_fwd_plain(step_q, step_kv, qs, kxt, vxt, q_seg, q_pos,
                          k_seg, k_pos, acc_o, acc_lse, *, mask=True,
                          scale: float | None = None):
    """Plain PyTorch version of :func:`fused_flash_fwd`: one batched
    attention over the run's steps, then one scatter flash merge of
    ``{acc} ∪ {partials}`` per visited slot.  Same in-place contract."""
    batched = qs.ndim == 5
    if not batched:
        step_q, step_kv, qs, kxt, vxt = (x[None] for x in (
            step_q, step_kv, qs, kxt, vxt))
        q_seg, q_pos, k_seg, k_pos = (x[None] for x in (
            q_seg, q_pos, k_seg, k_pos))
        ao, al = acc_o[None], acc_lse[None]
    else:
        ao, al = acc_o, acc_lse
    N, SL, H, bs, D = qs.shape
    S = step_q.shape[1]
    ni = torch.arange(N, device=qs.device)[:, None]
    sq, skv = step_q.long(), step_kv.long()
    o_p, lse_p = reference_attention(
        qs[ni, sq], kxt[ni, skv], vxt[ni, skv], q_seg[ni, sq],
        q_pos[ni, sq], k_seg, k_pos, mask, scale)   # [N, S, H, bs(, D)]
    flat = (ni * SL + sq).reshape(N * S)
    o_p, lse_p = o_p.reshape(N * S, H, bs, D), lse_p.reshape(N * S, H, bs)
    a_o, a_l = ao.view(N * SL, H, bs, D), al.view(N * SL, H, bs)
    m = a_l.scatter_reduce(0, flat[:, None, None].expand_as(lse_p), lse_p,
                           reduce="amax")
    w_a = torch.exp(a_l - m)
    w_p = torch.exp(lse_p - m[flat])
    den = w_a.index_add(0, flat, w_p)
    num = (a_o * w_a[..., None]).index_add(0, flat, o_p * w_p[..., None])
    vis = torch.unique(flat)
    a_o[vis] = (num[vis] / den[vis][..., None])
    a_l[vis] = m[vis] + torch.log(den[vis])
    return acc_o, acc_lse


def fused_flash_fwd(step_q, step_kv, qs, kxt, vxt, q_seg, q_pos,
                    k_seg, k_pos, acc_o, acc_lse, *, mask=True,
                    scale: float | None = None, segments=None):
    """One fused launch over a run of (q slot, kv slot) steps.

    Reference layout, with an optional leading worker dim ``N`` on every
    argument: step_q/step_kv ``[S]`` int32, q-slot-sorted; qs ``[SL, H,
    bs, D]``; kxt/vxt ``[EX, KH, bs, D]``; q_seg/q_pos ``[SL, bs]``;
    k_seg/k_pos ``[S, bs]`` (metadata of the kv block each step
    consumes); acc_o/acc_lse ``[SL, H, bs(, D)]`` f32.

    Updates ``acc_o``/``acc_lse`` **in place** — only the slots named by
    ``step_q`` change — and returns them.  ``segments`` is the run's
    ``(seg_lo, seg_hi)`` table on the device (:func:`run_segments`);
    when omitted it is derived from ``step_q`` on the host.  On the CUDA
    kernel ``D`` is 32, 64 or 128.
    """
    if qs.device.type == "cpu":
        return fused_flash_fwd_plain(
            step_q, step_kv, qs, kxt, vxt, q_seg, q_pos, k_seg, k_pos,
            acc_o, acc_lse, mask=mask, scale=scale)
    _require(qs.device.type == "cuda", f"unsupported device {qs.device}")
    batched = qs.ndim == 5
    args = [step_q, step_kv, qs, kxt, vxt, q_seg, q_pos, k_seg, k_pos,
            acc_o, acc_lse]
    if not batched:
        args = [x[None] for x in args]
    step_q, step_kv, qs, kxt, vxt, q_seg, q_pos, k_seg, k_pos, ao, al = args
    N, SL, H, bs, D = qs.shape
    EX, KH = kxt.shape[1], kxt.shape[2]
    S = step_q.shape[1]
    _require(kxt.shape == (N, EX, KH, bs, D) and vxt.shape == kxt.shape,
             f"kxt/vxt {tuple(kxt.shape)} do not match qs {tuple(qs.shape)}")
    _require(H % KH == 0, f"{H} heads not a multiple of {KH} kv heads")
    _require(D in (32, 64, 128), f"head_dim {D} not in (32, 64, 128)")
    _require(qs.dtype in _DTYPES and kxt.dtype == qs.dtype
             and vxt.dtype == qs.dtype, f"unsupported dtypes {qs.dtype}")
    _require(ao.shape == (N, SL, H, bs, D) and al.shape == (N, SL, H, bs)
             and ao.dtype == torch.float32 and al.dtype == torch.float32,
             "acc_o/acc_lse must be f32 [N, SL, H, bs(, D)]")
    _require(step_q.shape == (N, S) and step_kv.shape == (N, S)
             and k_seg.shape == (N, S, bs)
             and k_pos.shape == (N, S, bs) and q_seg.shape == (N, SL, bs)
             and q_pos.shape == (N, SL, bs), "step/meta table shapes")
    if segments is None:
        lo, hi = run_segments(step_q.cpu().numpy())
        segments = (torch.from_numpy(lo).to(qs.device),
                    torch.from_numpy(hi).to(qs.device))
    seg_lo, seg_hi = segments
    G = seg_lo.shape[-1]
    _require(seg_lo.shape == (N, G) and seg_hi.shape == (N, G),
             "segments must be [N, G]")
    for x in (step_q, step_kv, q_seg, q_pos, k_seg, k_pos, seg_lo, seg_hi):
        _require(x.dtype == torch.int32 and x.device == qs.device,
                 "tables must be int32 on the device of qs")
    tensors = [qs, kxt, vxt, step_q, step_kv, q_seg, q_pos, k_seg, k_pos,
               seg_lo, seg_hi, ao, al]
    for x in tensors:
        _require(x.is_contiguous(), "fused_flash_fwd takes contiguous "
                 "tensors")
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    kind, window, chunk = _mask_args(mask)
    fn = _bind("fused_flash_fwd", "fcp_fused_flash_fwd",
               [_P] * 13 + [_I] * 10 + [ctypes.c_float, _I, _I, _I, _P])
    _check(fn(*[_ptr(x) for x in tensors], N, SL, EX, S, G, H, KH, bs, D,
              _DTYPES[qs.dtype], float(scale), kind, window, chunk,
              _stream()), "fused_flash_fwd")
    fused_flash_fwd.launches += 1
    return acc_o, acc_lse


fused_flash_fwd.launches = 0

__all__ = ["NEG_INF", "flash_attention_fwd", "flash_attention_fwd_plain",
           "fused_flash_fwd", "fused_flash_fwd_plain", "run_segments"]
