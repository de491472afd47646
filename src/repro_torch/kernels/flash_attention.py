"""Wrappers, plain versions and launch counters of the CUDA attention kernels.

All six kernels of :mod:`repro.kernels.flash_attention` are ported:

* :func:`fused_flash_fwd` — ``csrc/fused_flash_fwd.cu``: one launch per
  executor run, for all stacked workers at once (prefill and the fused
  training forward).
* :func:`fused_flash_bwd_dq` / :func:`fused_flash_bwd_dkv` —
  ``csrc/fused_flash_bwd_dq.cu`` / ``csrc/fused_flash_bwd_dkv.cu``: the
  backward of one run against its run-final softmax stats.
* :func:`flash_attention_fwd` — ``csrc/flash_attention_fwd.cu``: varlen
  flash forward with a batch dimension and strided K/V, in two variants
  chosen on the host by :func:`fwd_variant`: split-KV decode (``Sq = 1``
  on the serving path, reading the cache in place) and tiled on the
  tensor cores (the per-step training forward).
* :func:`flash_attention_bwd_dq` / :func:`flash_attention_bwd_dkv` —
  ``csrc/flash_attention_bwd.cu``: its backward, two kernels with a
  wrapper and a counter each (:func:`flash_attention_bwd` runs both).

Each wrapper keeps the reference's positional signature and layout and
accepts an optional leading batch (worker) dimension.  The reference's
``block_q``/``block_k``/``interpret`` knobs have no counterpart: the
CUDA kernels fix their own tiles.  A wrapper takes
its plain PyTorch version (``*_plain``, same module) only because the
tensors it was given lie on the CPU; on a CUDA tensor it launches the
kernel or raises.  ``<wrapper>.launches`` counts kernel launches (plain
integers; reset them to 0 to count a region).  A replay of a captured
CUDA graph adds the launches its capture recorded
(``runtime/graphs.py``), so the counters count what the card runs.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..masks import coerce_mask
from . import build
from .ref import NEG_INF, mask_matrix, reference_attention

_MASK_KINDS = {"causal": 0, "sliding_window": 1, "chunked": 2, "full": 3}
# the head dims every CUDA kernel is built for (the reference's kernels
# take any D whose blocks divide)
HEAD_DIMS = (16, 32, 64, 80, 128)
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


# The wrapper's host-side choice between the kernel's two variants (both
# compute any shape): up to DECODE_MAX_SQ query rows the split-KV decode
# variant (f32 on the CUDA cores, one block per DECODE_SPLIT keys of a
# (batch row, kv head), partials merged in split order by a second small
# launch); above it the tiled tensor-core variant (64 query rows a block).
DECODE_MAX_SQ = 16
DECODE_SPLIT = 256


def fwd_variant(sq: int) -> str:
    """``"decode"`` or ``"tiled"``: the variant of
    ``csrc/flash_attention_fwd.cu`` that :func:`flash_attention_fwd`
    launches for ``sq`` query rows."""
    return "decode" if sq <= DECODE_MAX_SQ else "tiled"


def decode_splits(sk: int) -> int:
    """Key splits of the decode variant: ``ceil(sk / DECODE_SPLIT)``."""
    return -(-sk // DECODE_SPLIT)


def _aligned(x: torch.Tensor, nbytes: int) -> bool:
    """Base pointer and the strides of the three leading dims of ``x``
    (``[B, H, S, D]``) are multiples of ``nbytes``."""
    s, per = x.stride(), nbytes // x.element_size()
    return (x.data_ptr() % nbytes == 0 and s[0] % per == 0
            and s[1] % per == 0 and s[2] % per == 0)


def _flash_fwd_prep(q, k, v, seg_q, pos_q, seg_k, pos_k, mask, scale):
    """Checked, batched launch arguments of kernel 2 and its outputs."""
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
    _require(D in HEAD_DIMS, f"head_dim {D} not in {HEAD_DIMS}")
    _require(q.stride(-1) == 1 and k.stride(-1) == 1,
             "head_dim must be the unit-stride dim")
    _require(_aligned(k, 16) and _aligned(v, 16) and _aligned(q, 8),
             "k/v rows must be 16-byte aligned and q rows 8-byte aligned")
    metas = []
    for x, n in ((seg_q, Sq), (pos_q, Sq), (seg_k, Sk), (pos_k, Sk)):
        _require(x.dtype == torch.int32 and x.is_contiguous()
                 and x.shape[-1] == n and x.ndim in (1, 2)
                 and (x.ndim == 1 or x.shape[0] == B)
                 and x.device == q.device,
                 "seg/pos must be contiguous int32 [S] or [B, S] "
                 "tensors on the device of q")
        metas.append(x)
    _require(pos_q.ndim == seg_q.ndim and pos_k.ndim == seg_k.ndim,
             "seg and pos must share their batching")
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    o = torch.empty((B, H, Sq, D), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    qs, ks = q.stride(), k.stride()
    args = [_ptr(q), _ptr(k), _ptr(v), *[_ptr(x) for x in metas], _ptr(o),
            _ptr(lse)]
    shape = [B, H, KH, Sq, Sk, D, _DTYPES[q.dtype], qs[0], qs[1], qs[2],
             ks[0], ks[1], ks[2], Sq if seg_q.ndim == 2 else 0,
             Sk if seg_k.ndim == 2 else 0, float(scale),
             *_mask_args(mask)]
    return {"args": args, "shape": shape, "o": o, "lse": lse,
            "unbatched": unbatched}


_FWD_ARGS = [_P] * 9 + [_I] * 7 + [ctypes.c_longlong] * 8 \
    + [ctypes.c_float, _I, _I, _I]


def _launch_fwd(prep, variant: str):
    """Launch one variant of kernel 2 on prepared arguments; returns
    ``(o, lse)``.  Counts nothing: the wrapper counts its launches."""
    o, lse = prep["o"], prep["lse"]
    if variant == "tiled":
        fn = _bind("flash_attention_fwd", "fcp_flash_attention_fwd",
                   _FWD_ARGS + [_P])
        err = fn(*prep["args"], *prep["shape"], _stream())
    elif variant == "decode":
        # workspace: the splits' partial acc [B, H, Sq, ns, D], then their
        # (m, l) [B, H, Sq, ns, 2], in one allocation
        B, H, _, Sq, Sk, D = prep["shape"][:6]
        ns = decode_splits(Sk)
        ws = torch.empty(B * H * Sq * ns * (D + 2), dtype=torch.float32,
                         device=o.device)
        fn = _bind("flash_attention_fwd", "fcp_flash_attention_fwd_decode",
                   _FWD_ARGS[:9] + [_P, _P] + _FWD_ARGS[9:] + [_I, _P])
        err = fn(*prep["args"], _ptr(ws), _ptr(ws) + B * H * Sq * ns * D * 4,
                 *prep["shape"], ns, _stream())
    else:
        raise ValueError(f"unknown variant {variant!r}")
    _check(err, f"flash_attention_fwd ({variant})")
    if prep["unbatched"]:
        return o[0], lse[0]
    return o, lse


def flash_attention_fwd(q, k, v, seg_q, pos_q, seg_k, pos_k, *,
                        mask=True, scale: float | None = None):
    """Varlen flash forward.  Returns ``(o, lse)`` in f32.

    q: ``[H, Sq, D]`` or ``[B, H, Sq, D]``; k/v: ``[KH, Sk, D]`` or
    ``[B, KH, Sk, D]`` with any strides (unit stride on ``D``, rows
    16-byte aligned), so a KV cache ``[B, S, KH, D]`` is passed as
    ``cache.transpose(1, 2)`` without a copy; seg/pos: ``[Sq]``/``[Sk]``
    (shared by the batch) or ``[B, Sq]``/``[B, Sk]``, int32.  A fully
    masked row gives ``o = 0``, ``lse = NEG_INF``.  On the CUDA kernel
    ``D`` is 16, 32, 64, 80 or 128, and the variant is
    :func:`fwd_variant` of ``Sq``.
    """
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, seg_q, pos_q, seg_k,
                                         pos_k, mask=mask, scale=scale)
    _require(q.device.type == "cuda", f"unsupported device {q.device}")
    prep = _flash_fwd_prep(q, k, v, seg_q, pos_q, seg_k, pos_k, mask, scale)
    out = _launch_fwd(prep, fwd_variant(q.shape[-2]))
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0


# --------------------------------------------------------------------------
# fused schedule-driven run forward
# --------------------------------------------------------------------------

def run_segments(keys: np.ndarray, skip_slot: int | None = None
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Segment table of one run: per worker, one ``(lo, hi)`` step range
    per distinct key of ``keys [N, S]``, padded per worker with empty
    ``(0, 0)`` segments.  The keys are the q slots of the q-slot-sorted
    ``step_q`` (the forward and dq kernels) or the extended-buffer rows
    of the kv-sorted ``bwd_kv`` (the dk/dv kernel); steps of
    ``skip_slot`` (the executor's q trash slot, or its kv trash row) get
    no segment."""
    keys = np.asarray(keys)
    segs = []
    for row in keys:
        cuts = np.flatnonzero(np.diff(row)) + 1
        los = np.concatenate([[0], cuts]).astype(np.int64)
        his = np.concatenate([cuts, [row.shape[0]]]).astype(np.int64)
        keep = [(a, b) for a, b in zip(los, his)
                if skip_slot is None or row[a] != skip_slot]
        if len({row[a] for a, _ in keep}) != len(keep):
            raise ValueError("the run's keys are not sorted (each key "
                             "must own one contiguous step range)")
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
    # index_put's accumulate sorts the indices and sums each slot's
    # partials in one order (index_add's CUDA atomics do not), so the
    # plain version gives the same bytes run after run
    den = w_a.index_put((flat,), w_p, accumulate=True)
    num = (a_o * w_a[..., None]).index_put((flat,), o_p * w_p[..., None],
                                           accumulate=True)
    # visited slots take the merge, the others keep their bytes (a mask,
    # not ``torch.unique``: no host sync or copy, so a CUDA graph can
    # capture it)
    vis = torch.zeros((N * SL,), dtype=torch.bool,
                      device=qs.device).index_fill_(0, flat, True)
    a_o.copy_(torch.where(vis[:, None, None, None], num / den[..., None],
                          a_o))
    a_l.copy_(torch.where(vis[:, None, None], m + torch.log(den), a_l))
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
    kernel ``D`` is 16, 32, 64, 80 or 128.
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
    _require(D in HEAD_DIMS, f"head_dim {D} not in {HEAD_DIMS}")
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


# --------------------------------------------------------------------------
# fused schedule-driven run backward
# --------------------------------------------------------------------------

def _unbatched(args):
    return [x[None] for x in args]


def _device_segments(keys: torch.Tensor, segments):
    if segments is None:
        lo, hi = run_segments(keys.cpu().numpy())
        segments = (torch.from_numpy(lo).to(keys.device),
                    torch.from_numpy(hi).to(keys.device))
    return segments


def _fused_bwd_terms(step_q, step_kv, qs, kxt, vxt, q_seg, q_pos, k_seg,
                     k_pos, lse, go, delta, mask, scale):
    """Per-step tensors of the run backward, all ``[N, S, H, bs, ...]``
    f32: ``p = exp(s - L)`` on valid pairs, ``ds``, the gathered q and
    the GQA-expanded k (plain PyTorch, products in f32)."""
    N, SL, H, bs, D = qs.shape
    group = H // kxt.shape[2]
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    ni = torch.arange(N, device=qs.device)[:, None]
    sq, skv = step_q.long(), step_kv.long()
    q = qs[ni, sq].float()
    k = torch.repeat_interleave(kxt[ni, skv].float(), group, dim=2)
    v = torch.repeat_interleave(vxt[ni, skv].float(), group, dim=2)
    g = go[ni, sq].float()
    valid = mask_matrix(q_seg[ni, sq], q_pos[ni, sq], k_seg, k_pos,
                        mask).unsqueeze(2)                 # [N, S, 1, bs, bs]
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    p = torch.where(valid, torch.exp(s - lse[ni, sq][..., None]), 0.0)
    dov = torch.matmul(g, v.transpose(-1, -2))
    ds = p * ((dov - delta[ni, sq][..., None]) * scale)
    return p, ds, q, k, g


def fused_flash_bwd_dq_plain(step_q, step_kv, qs, kxt, vxt, q_seg, q_pos,
                             k_seg, k_pos, lse, go, delta, *, mask=True,
                             scale: float | None = None):
    """Plain PyTorch version of :func:`fused_flash_bwd_dq`: the per-step
    dq of every step, summed into its q slot (one sorted ``index_put``)."""
    batched = qs.ndim == 5
    args = [step_q, step_kv, qs, kxt, vxt, q_seg, q_pos, k_seg, k_pos, lse,
            go, delta]
    if not batched:
        args = _unbatched(args)
    step_q, step_kv, qs, kxt, vxt, q_seg, q_pos, k_seg, k_pos, lse, go, \
        delta = args
    N, SL, H, bs, D = qs.shape
    p, ds, q, k, g = _fused_bwd_terms(step_q, step_kv, qs, kxt, vxt, q_seg,
                                      q_pos, k_seg, k_pos, lse, go, delta,
                                      coerce_mask(mask), scale)
    dq_s = torch.matmul(ds, k)                             # [N, S, H, bs, D]
    ni = torch.arange(N, device=qs.device)[:, None]
    flat = (ni * SL + step_q.long()).reshape(-1)
    dq = torch.zeros((N * SL, H, bs, D), dtype=torch.float32,
                     device=qs.device).index_put(
        (flat,), dq_s.reshape(-1, H, bs, D), accumulate=True)
    dq = dq.view(N, SL, H, bs, D)
    return dq if batched else dq[0]


def fused_flash_bwd_dq(step_q, step_kv, qs, kxt, vxt, q_seg, q_pos, k_seg,
                       k_pos, lse, go, delta, *, mask=True,
                       scale: float | None = None, segments=None):
    """d qs of a fused run (f32 ``[(N,) SL, H, bs, D]``).

    Reference layout, with an optional leading worker dim ``N`` as for
    :func:`fused_flash_fwd`: the forward's q-slot-sorted tables;
    ``lse``: the run-final acc_lse ``[SL, H, bs]``; ``go``: d(acc_o)
    ``[SL, H, bs, D]``; ``delta``: ``g_o . o_out - g_lse`` ``[SL, H,
    bs]``, all f32.  ``segments`` as for :func:`fused_flash_fwd`.  Slots
    no segment names come back zero (the reference's visited mask).  On
    the CUDA kernel ``D`` is 16, 32, 64, 80 or 128.
    """
    if qs.device.type == "cpu":
        return fused_flash_bwd_dq_plain(
            step_q, step_kv, qs, kxt, vxt, q_seg, q_pos, k_seg, k_pos, lse,
            go, delta, mask=mask, scale=scale)
    batched = qs.ndim == 5
    args = [step_q, step_kv, qs, kxt, vxt, q_seg, q_pos, k_seg, k_pos, lse,
            go, delta]
    if not batched:
        args = _unbatched(args)
    step_q, step_kv, qs, kxt, vxt, q_seg, q_pos, k_seg, k_pos, lse, go, \
        delta = args
    N, SL, H, bs, D, EX, KH, S = _check_fused(
        "fused_flash_bwd_dq", step_q, step_kv, qs, kxt, vxt, q_seg, q_pos,
        k_seg, k_pos, lse, go, delta)
    seg_lo, seg_hi = _device_segments(step_q, segments)
    G = _check_segments(seg_lo, seg_hi, N, qs.device)
    dq = torch.zeros((N, SL, H, bs, D), dtype=torch.float32,
                     device=qs.device)
    tensors = [qs, kxt, vxt, step_q, step_kv, q_seg, q_pos, k_seg, k_pos,
               seg_lo, seg_hi, lse, go, delta, dq]
    _require(all(x.is_contiguous() for x in tensors),
             "fused_flash_bwd_dq takes contiguous tensors")
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    kind, window, chunk = _mask_args(mask)
    fn = _bind("fused_flash_bwd_dq", "fcp_fused_flash_bwd_dq",
               [_P] * 15 + [_I] * 10 + [ctypes.c_float, _I, _I, _I, _P])
    _check(fn(*[_ptr(x) for x in tensors], N, SL, EX, S, G, H, KH, bs, D,
              _DTYPES[qs.dtype], float(scale), kind, window, chunk,
              _stream()), "fused_flash_bwd_dq")
    fused_flash_bwd_dq.launches += 1
    return dq if batched else dq[0]


fused_flash_bwd_dq.launches = 0


def fused_flash_bwd_dkv_plain(bwd_q, bwd_kv, qs, kxt, vxt, q_seg, q_pos,
                              k_seg, k_pos, lse, go, delta, *, mask=True,
                              scale: float | None = None):
    """Plain PyTorch version of :func:`fused_flash_bwd_dkv`: per-step dk
    (summed over the GQA group) and dv, summed into their rows."""
    batched = qs.ndim == 5
    args = [bwd_q, bwd_kv, qs, kxt, vxt, q_seg, q_pos, k_seg, k_pos, lse,
            go, delta]
    if not batched:
        args = _unbatched(args)
    bwd_q, bwd_kv, qs, kxt, vxt, q_seg, q_pos, k_seg, k_pos, lse, go, \
        delta = args
    N, SL, H, bs, D = qs.shape
    EX, KH = kxt.shape[1], kxt.shape[2]
    S = bwd_q.shape[1]
    p, ds, q, k, g = _fused_bwd_terms(bwd_q, bwd_kv, qs, kxt, vxt, q_seg,
                                      q_pos, k_seg, k_pos, lse, go, delta,
                                      coerce_mask(mask), scale)
    dk_s = torch.matmul(ds.transpose(-1, -2), q)
    dv_s = torch.matmul(p.transpose(-1, -2), g)
    dk_s = dk_s.view(N, S, KH, H // KH, bs, D).sum(3)
    dv_s = dv_s.view(N, S, KH, H // KH, bs, D).sum(3)
    ni = torch.arange(N, device=qs.device)[:, None]
    flat = (ni * EX + bwd_kv.long()).reshape(-1)
    out = []
    for x in (dk_s, dv_s):
        y = torch.zeros((N * EX, KH, bs, D), dtype=torch.float32,
                        device=qs.device).index_put(
            (flat,), x.reshape(-1, KH, bs, D), accumulate=True
        ).view(N, EX, KH, bs, D)
        out.append(y if batched else y[0])
    return out[0], out[1]


def fused_flash_bwd_dkv(bwd_q, bwd_kv, qs, kxt, vxt, q_seg, q_pos, k_seg,
                        k_pos, lse, go, delta, *, mask=True,
                        scale: float | None = None, segments=None):
    """(d kxt, d vxt) of a fused run, f32 ``[(N,) EX, KH, bs, D]``.

    ``bwd_q``/``bwd_kv`` are the run's steps sorted by extended-buffer
    row; ``k_seg``/``k_pos`` the kv metadata in that order; ``lse``,
    ``go``, ``delta`` as in :func:`fused_flash_bwd_dq`.  ``segments`` is
    the ``(lo, hi)`` table over ``bwd_kv`` (:func:`run_segments`; the
    executor skips the kv trash row), derived on the host when omitted.
    Rows no segment names come back zero.  On the CUDA kernel ``D`` is
    16, 32, 64, 80 or 128.
    """
    if qs.device.type == "cpu":
        return fused_flash_bwd_dkv_plain(
            bwd_q, bwd_kv, qs, kxt, vxt, q_seg, q_pos, k_seg, k_pos, lse,
            go, delta, mask=mask, scale=scale)
    batched = qs.ndim == 5
    args = [bwd_q, bwd_kv, qs, kxt, vxt, q_seg, q_pos, k_seg, k_pos, lse,
            go, delta]
    if not batched:
        args = _unbatched(args)
    bwd_q, bwd_kv, qs, kxt, vxt, q_seg, q_pos, k_seg, k_pos, lse, go, \
        delta = args
    N, SL, H, bs, D, EX, KH, S = _check_fused(
        "fused_flash_bwd_dkv", bwd_q, bwd_kv, qs, kxt, vxt, q_seg, q_pos,
        k_seg, k_pos, lse, go, delta)
    seg_lo, seg_hi = _device_segments(bwd_kv, segments)
    G = _check_segments(seg_lo, seg_hi, N, qs.device)
    dk = torch.zeros((N, EX, KH, bs, D), dtype=torch.float32,
                     device=qs.device)
    dv = torch.zeros_like(dk)
    tensors = [qs, kxt, vxt, bwd_q, bwd_kv, q_seg, q_pos, k_seg, k_pos,
               seg_lo, seg_hi, lse, go, delta, dk, dv]
    _require(all(x.is_contiguous() for x in tensors),
             "fused_flash_bwd_dkv takes contiguous tensors")
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    kind, window, chunk = _mask_args(mask)
    fn = _bind("fused_flash_bwd_dkv", "fcp_fused_flash_bwd_dkv",
               [_P] * 16 + [_I] * 10 + [ctypes.c_float, _I, _I, _I, _P])
    _check(fn(*[_ptr(x) for x in tensors], N, SL, EX, S, G, H, KH, bs, D,
              _DTYPES[qs.dtype], float(scale), kind, window, chunk,
              _stream()), "fused_flash_bwd_dkv")
    fused_flash_bwd_dkv.launches += 1
    if batched:
        return dk, dv
    return dk[0], dv[0]


fused_flash_bwd_dkv.launches = 0


def _check_fused(name, step_q, step_kv, qs, kxt, vxt, q_seg, q_pos, k_seg,
                 k_pos, lse, go, delta):
    """Shape/dtype/device checks of a fused backward launch; returns
    ``(N, SL, H, bs, D, EX, KH, S)``."""
    N, SL, H, bs, D = qs.shape
    EX, KH = kxt.shape[1], kxt.shape[2]
    S = step_q.shape[1]
    _require(kxt.shape == (N, EX, KH, bs, D) and vxt.shape == kxt.shape,
             f"{name}: kxt/vxt {tuple(kxt.shape)} do not match qs "
             f"{tuple(qs.shape)}")
    _require(H % KH == 0, f"{H} heads not a multiple of {KH} kv heads")
    _require(D in HEAD_DIMS, f"{name}: head_dim {D} not in {HEAD_DIMS}")
    _require(qs.dtype in _DTYPES and kxt.dtype == qs.dtype
             and vxt.dtype == qs.dtype, f"unsupported dtypes {qs.dtype}")
    _require(lse.shape == (N, SL, H, bs) and delta.shape == lse.shape
             and go.shape == (N, SL, H, bs, D)
             and all(x.dtype == torch.float32 for x in (lse, go, delta)),
             f"{name}: lse/delta [N, SL, H, bs] and go [N, SL, H, bs, D] "
             f"must be f32")
    _require(step_q.shape == (N, S) and step_kv.shape == (N, S)
             and k_seg.shape == (N, S, bs) and k_pos.shape == (N, S, bs)
             and q_seg.shape == (N, SL, bs) and q_pos.shape == (N, SL, bs),
             f"{name}: step/meta table shapes")
    for x in (step_q, step_kv, q_seg, q_pos, k_seg, k_pos):
        _require(x.dtype == torch.int32 and x.device == qs.device,
                 "tables must be int32 on the device of qs")
    _require(qs.device.type == "cuda", f"unsupported device {qs.device}")
    return N, SL, H, bs, D, EX, KH, S


def _check_segments(seg_lo, seg_hi, N, device) -> int:
    G = seg_lo.shape[-1]
    _require(seg_lo.shape == (N, G) and seg_hi.shape == (N, G)
             and seg_lo.dtype == torch.int32 and seg_hi.dtype == torch.int32
             and seg_lo.device == device and seg_hi.device == device,
             "segments must be int32 [N, G] on the device of qs")
    return G


# --------------------------------------------------------------------------
# per-step varlen flash backward
# --------------------------------------------------------------------------

def _delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``sum(do * o)`` per q row, f32 (computed outside the kernels, as
    the reference does)."""
    return torch.sum(do.float() * o.float(), dim=-1)


def _flash_bwd_terms(q, k, v, seg_q, pos_q, seg_k, pos_k, o, lse, do,
                     dlse, mask, scale):
    """Dense f32 terms of the per-step backward: ``(p, ds, q, k, do)``
    with k GQA-expanded (plain PyTorch)."""
    if q.ndim == 4:
        seg_q, pos_q = _batched(seg_q, q.shape[0]), _batched(pos_q,
                                                             q.shape[0])
        seg_k, pos_k = _batched(seg_k, q.shape[0]), _batched(pos_k,
                                                             q.shape[0])
    H, D = q.shape[-3], q.shape[-1]
    group = H // k.shape[-3]
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    kx = torch.repeat_interleave(k.float(), group, dim=-3)
    vx = torch.repeat_interleave(v.float(), group, dim=-3)
    qf, g = q.float(), do.float()
    valid = mask_matrix(seg_q, pos_q, seg_k, pos_k,
                        coerce_mask(mask)).unsqueeze(-3)
    s = torch.matmul(qf, kx.transpose(-1, -2)) * scale
    p = torch.where(valid, torch.exp(s - lse[..., None]), 0.0)
    dov = torch.matmul(g, vx.transpose(-1, -2))
    ds = p * (((dov - _delta(o, do)[..., None]) + dlse.float()[..., None])
              * scale)
    return p, ds, qf, kx, g


def flash_attention_bwd_dq_plain(q, k, v, seg_q, pos_q, seg_k, pos_k, o,
                                 lse, do, dlse, *, mask=True,
                                 scale: float | None = None):
    """Plain PyTorch version of :func:`flash_attention_bwd_dq` (dense,
    f32 products)."""
    p, ds, qf, kx, g = _flash_bwd_terms(q, k, v, seg_q, pos_q, seg_k,
                                        pos_k, o, lse, do, dlse, mask,
                                        scale)
    return torch.matmul(ds, kx).to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, seg_q, pos_q, seg_k, pos_k, o,
                                  lse, do, dlse, *, mask=True,
                                  scale: float | None = None):
    """Plain PyTorch version of :func:`flash_attention_bwd_dkv`."""
    p, ds, qf, kx, g = _flash_bwd_terms(q, k, v, seg_q, pos_q, seg_k,
                                        pos_k, o, lse, do, dlse, mask,
                                        scale)
    KH, Sk, D = k.shape[-3:]
    shape = (*q.shape[:-3], KH, q.shape[-3] // KH, Sk, D)
    dk = torch.matmul(ds.transpose(-1, -2), qf).reshape(shape).sum(-3)
    dv = torch.matmul(p.transpose(-1, -2), g).reshape(shape).sum(-3)
    return dk.to(k.dtype), dv.to(v.dtype)


def _flash_bwd_prep(q, k, v, seg_q, pos_q, seg_k, pos_k, o, lse, do, dlse,
                    mask, scale) -> dict:
    """Checks and the inputs kernels 5 and 6 share: contiguous q/k/v,
    batched seg/pos, and the f32 lse, do, delta = sum(do * o) (computed
    here, as the reference computes it outside its kernel) and dlse."""
    unbatched = q.ndim == 3
    if unbatched:
        q, k, v, o, lse, do, dlse = (x[None] for x in (q, k, v, o, lse, do,
                                                        dlse))
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    _require(k.shape == (B, KH, Sk, D) and v.shape == k.shape,
             f"k/v shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    _require(H % KH == 0, f"{H} heads not a multiple of {KH} kv heads")
    _require(q.dtype in _DTYPES and k.dtype == q.dtype
             and v.dtype == q.dtype, f"unsupported dtypes {q.dtype}")
    _require(D in HEAD_DIMS, f"head_dim {D} not in {HEAD_DIMS}")
    _require(q.device.type == "cuda", f"unsupported device {q.device}")
    _require(o.shape == q.shape and do.shape == q.shape
             and lse.shape == (B, H, Sq) and dlse.shape == lse.shape,
             "o/do must be [B, H, Sq, D] and lse/dlse [B, H, Sq]")
    metas = []
    for x, n in ((seg_q, Sq), (pos_q, Sq), (seg_k, Sk), (pos_k, Sk)):
        _require(x.dtype == torch.int32 and x.shape[-1] == n
                 and x.ndim in (1, 2) and (x.ndim == 1 or x.shape[0] == B)
                 and x.device == q.device,
                 "seg/pos must be int32 [S] or [B, S] tensors on the "
                 "device of q")
        metas.append(_batched(x, B).contiguous())
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    do32 = do.float().contiguous()
    return {"q": q, "k": k, "v": v, "unbatched": unbatched,
            "ins": [q, k, v, *metas, lse.float().contiguous(), do32,
                    _delta(o, do32).contiguous(),
                    dlse.float().contiguous()],
            "dims": (B, H, KH, Sq, Sk, D),
            "scale": 1.0 / (D ** 0.5) if scale is None else scale,
            "mask": _mask_args(mask)}


def _flash_bwd_launch(name: str, prep: dict, out: list) -> list:
    """One launch of ``fcp_flash_attention_bwd_<name>`` on the prepared
    inputs of :func:`_flash_bwd_prep`; fills ``out``."""
    kind, window, chunk = prep["mask"]
    fn = _bind("flash_attention_bwd", f"fcp_flash_attention_bwd_{name}",
               [_P] * (11 + len(out)) + [_I] * 7
               + [ctypes.c_float, _I, _I, _I, _P])
    _check(fn(*[_ptr(x) for x in prep["ins"] + out], *prep["dims"],
              _DTYPES[prep["q"].dtype], float(prep["scale"]), kind, window,
              chunk, _stream()), f"flash_attention_bwd_{name}")
    return [x[0] for x in out] if prep["unbatched"] else out


def _launch_bwd_dq(prep: dict) -> torch.Tensor:
    (dq,) = _flash_bwd_launch("dq", prep, [torch.empty_like(prep["q"])])
    flash_attention_bwd_dq.launches += 1
    return dq


def _launch_bwd_dkv(prep: dict):
    dk, dv = _flash_bwd_launch(
        "dkv", prep, [torch.empty_like(prep["k"]),
                      torch.empty_like(prep["v"])])
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, seg_q, pos_q, seg_k, pos_k, o, lse,
                           do, dlse, *, mask=True,
                           scale: float | None = None):
    """dq of :func:`flash_attention_fwd` (kernel 5), in the dtype of q.

    Layouts as for the forward (``[(B,) H, Sq, D]`` / ``[(B,) KH, Sk,
    D]``; seg/pos ``[S]`` or ``[B, S]``); o/do ``[(B,) H, Sq, D]``,
    lse/dlse ``[(B,) H, Sq]``.  ``dlse`` is the cotangent of the lse
    output (non-zero when the partial feeds a flash merge, the
    executor's case).  On the CUDA kernel ``D`` is 16, 32, 64, 80 or
    128; q/k/v are taken contiguous.
    """
    args = (q, k, v, seg_q, pos_q, seg_k, pos_k, o, lse, do, dlse)
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(*args, mask=mask, scale=scale)
    return _launch_bwd_dq(_flash_bwd_prep(*args, mask, scale))


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, seg_q, pos_q, seg_k, pos_k, o, lse,
                            do, dlse, *, mask=True,
                            scale: float | None = None):
    """(dk, dv) of :func:`flash_attention_fwd` (kernel 6), summed over the
    GQA group members, in the dtypes of k/v.  Arguments as for
    :func:`flash_attention_bwd_dq`."""
    args = (q, k, v, seg_q, pos_q, seg_k, pos_k, o, lse, do, dlse)
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_plain(*args, mask=mask, scale=scale)
    return _launch_bwd_dkv(_flash_bwd_prep(*args, mask, scale))


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd_plain(q, k, v, seg_q, pos_q, seg_k, pos_k, o, lse,
                              do, dlse, *, mask=True,
                              scale: float | None = None):
    """Plain PyTorch version of :func:`flash_attention_bwd`."""
    args = (q, k, v, seg_q, pos_q, seg_k, pos_k, o, lse, do, dlse)
    return (flash_attention_bwd_dq_plain(*args, mask=mask, scale=scale),
            *flash_attention_bwd_dkv_plain(*args, mask=mask, scale=scale))


def flash_attention_bwd(q, k, v, seg_q, pos_q, seg_k, pos_k, o, lse, do,
                        dlse, *, mask=True, scale: float | None = None):
    """Backward of :func:`flash_attention_fwd`: ``(dq, dk, dv)`` in the
    dtypes of q/k/v — kernel 5 then kernel 6 on inputs prepared once
    (contiguous q/k/v, f32 do/lse/dlse, delta), each kernel with its
    own ``launches`` counter (:func:`flash_attention_bwd_dq`,
    :func:`flash_attention_bwd_dkv`)."""
    args = (q, k, v, seg_q, pos_q, seg_k, pos_k, o, lse, do, dlse)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(*args, mask=mask, scale=scale)
    prep = _flash_bwd_prep(*args, mask, scale)
    return (_launch_bwd_dq(prep), *_launch_bwd_dkv(prep))


# the wrappers whose ``launches`` count (a graph replay adds its captured
# launches to each, runtime/graphs.py)
COUNTED = (fused_flash_fwd, flash_attention_fwd, fused_flash_bwd_dq,
           fused_flash_bwd_dkv, flash_attention_bwd_dq,
           flash_attention_bwd_dkv)


__all__ = ["COUNTED", "NEG_INF", "flash_attention_bwd",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dkv_plain",
           "flash_attention_bwd_dq",
           "flash_attention_bwd_dq_plain", "flash_attention_bwd_plain",
           "flash_attention_fwd", "flash_attention_fwd_plain",
           "fused_flash_bwd_dkv", "fused_flash_bwd_dkv_plain",
           "fused_flash_bwd_dq", "fused_flash_bwd_dq_plain",
           "fused_flash_fwd", "fused_flash_fwd_plain", "run_segments"]
