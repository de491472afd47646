"""Attention ops with implementation dispatch (port of ``repro.kernels.ops``).

``block_attention`` is the per-step primitive (normalized attention +
lse over one (q, kv) range); ``fused_run_attention`` is the run-granular
primitive of the fused executor: one call consumes a whole run of
schedule steps against the executor's resident buffers and folds the
results into the per-slot flash accumulators.

``impl="kernel"`` (default) goes through the kernel wrappers of
:mod:`.flash_attention`, which launch the CUDA kernels on CUDA tensors
and take their plain versions on CPU tensors; ``impl="plain"`` runs the
plain PyTorch versions on any device (the yardstick the kernels are
held against on the card).

Both ops are differentiable.  While grad mode is on and an input
requires grad they run through a ``torch.autograd.Function`` whose
backward is the backward kernels (or their plain versions), as the
reference's ``custom_vjp`` ops are: ``_BlockAttention`` (kernel 2
forward, kernels 5 and 6 backward) and ``_FusedRun`` (kernel 1 forward,
kernels 3 and 4 backward).  Otherwise (serving) they run the forward
alone, and ``fused_run_attention`` updates the accumulators in place.
"""

from __future__ import annotations

import torch

from ..masks import coerce_mask
from . import flash_attention as fa
from . import ref

IMPLS = ("kernel", "plain")


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} (expected {IMPLS})")


def _needs_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


class _BlockAttention(torch.autograd.Function):
    """Per-step attention: forward kernel 2, backward kernels 5 and 6
    with the ``dlse`` cotangent (reference ``ops._pallas_attention``)."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, pos_q, seg_k, pos_k, mask, scale,
                impl):
        fwd = fa.flash_attention_fwd if impl == "kernel" \
            else fa.flash_attention_fwd_plain
        o, lse = fwd(q, k, v, seg_q, pos_q, seg_k, pos_k, mask=mask,
                     scale=scale)
        ctx.save_for_backward(q, k, v, seg_q, pos_q, seg_k, pos_k, o, lse)
        ctx.mask, ctx.scale, ctx.impl = mask, scale, impl
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, seg_q, pos_q, seg_k, pos_k, o, lse = ctx.saved_tensors
        bwd = fa.flash_attention_bwd if ctx.impl == "kernel" \
            else fa.flash_attention_bwd_plain
        dq, dk, dv = bwd(q, k, v, seg_q, pos_q, seg_k, pos_k, o, lse, do,
                         dlse, mask=ctx.mask, scale=ctx.scale)
        return dq, dk, dv, None, None, None, None, None, None, None


def block_attention(q, k, v, seg_q, pos_q, seg_k, pos_k, *, mask=True,
                    scale: float | None = None, impl: str = "kernel"):
    """Normalized attention + lse over one (q, kv) pair of token ranges.

    q: ``[(B,) H, Sq, D]``; k/v: ``[(B,) KH, Sk, D]`` (strided views
    allowed) → ``(o [(B,) H, Sq, D] f32, lse [(B,) H, Sq] f32)``.
    """
    _check_impl(impl)
    mask = coerce_mask(mask)
    if _needs_grad(q, k, v):
        return _BlockAttention.apply(q, k, v, seg_q, pos_q, seg_k, pos_k,
                                     mask, scale, impl)
    fn = fa.flash_attention_fwd if impl == "kernel" \
        else fa.flash_attention_fwd_plain
    return fn(q, k, v, seg_q, pos_q, seg_k, pos_k, mask=mask, scale=scale)


merge_partials = ref.merge_partials
merge_many = ref.merge_many


def _fused_forward(qs, kxt, vxt, acc_o, acc_lse, tabs, mask, scale, impl):
    """Kernel 1 (or its plain version) on ``acc_o``/``acc_lse``, in
    place."""
    args = (tabs["step_q"], tabs["step_kv"], qs, kxt, vxt, tabs["q_seg"],
            tabs["q_pos"], tabs["k_seg"], tabs["k_pos"], acc_o, acc_lse)
    if impl == "plain":
        return fa.fused_flash_fwd_plain(*args, mask=mask, scale=scale)
    return fa.fused_flash_fwd(*args, mask=mask, scale=scale,
                              segments=tabs.get("segments"))


class _FusedRun(torch.autograd.Function):
    """One fused run (reference ``ops._fused_pallas``): forward kernel 1
    on fresh copies of the accumulators (the incoming ones are saved for
    the backward); backward the merge-chain collapse of
    ``_fused_pl_bwd`` — elementwise terms in PyTorch, then kernels 3 and
    4 against the run-final ``(o2, l2)``."""

    @staticmethod
    def forward(ctx, qs, kxt, vxt, acc_o, acc_lse, tabs, mask, scale,
                impl):
        o2, l2 = acc_o.clone(), acc_lse.clone()
        _fused_forward(qs, kxt, vxt, o2, l2, tabs, mask, scale, impl)
        ctx.save_for_backward(qs, kxt, vxt, acc_o, acc_lse, o2, l2)
        ctx.tabs, ctx.mask, ctx.scale, ctx.impl = tabs, mask, scale, impl
        return o2, l2

    @staticmethod
    def backward(ctx, g_o, g_l):
        qs, kxt, vxt, acc_o, acc_lse, o2, l2 = ctx.saved_tensors
        tabs, mask, scale = ctx.tabs, ctx.mask, ctx.scale
        g_o, g_l = g_o.float(), g_l.float()
        # the incoming accumulator is one more partial, at weight
        # exp(lse_in - L); every per-step weight cancels against the
        # run-final L = l2 (reference ops._fused_pl_bwd)
        w_a = torch.exp(acc_lse - l2)
        go_o2 = torch.sum(g_o * o2, dim=-1)
        d_acc_o = (w_a[..., None] * g_o).to(acc_o.dtype)
        d_acc_lse = (w_a * (g_l + torch.sum(g_o * acc_o, dim=-1) - go_o2)
                     ).to(acc_lse.dtype)
        delta = (go_o2 - g_l).contiguous()
        g_o = g_o.contiguous()
        kernel = ctx.impl == "kernel"
        dq_fn = fa.fused_flash_bwd_dq if kernel else \
            fa.fused_flash_bwd_dq_plain
        dkv_fn = fa.fused_flash_bwd_dkv if kernel else \
            fa.fused_flash_bwd_dkv_plain
        extra = {"segments": tabs.get("segments")} if kernel else {}
        # slots / rows the run does not visit come back zero from both
        # kernels (the reference's _visited masks)
        d_qs = dq_fn(tabs["step_q"], tabs["step_kv"], qs, kxt, vxt,
                     tabs["q_seg"], tabs["q_pos"], tabs["k_seg"],
                     tabs["k_pos"], l2, g_o, delta, mask=mask, scale=scale,
                     **extra)
        if kernel:
            extra = {"segments": tabs.get("kv_segments")}
        d_k, d_v = dkv_fn(tabs["bwd_q"], tabs["bwd_kv"], qs, kxt, vxt,
                          tabs["q_seg"], tabs["q_pos"], tabs["k_seg_b"],
                          tabs["k_pos_b"], l2, g_o, delta, mask=mask,
                          scale=scale, **extra)
        return (d_qs.to(qs.dtype), d_k.to(kxt.dtype), d_v.to(vxt.dtype),
                d_acc_o, d_acc_lse, None, None, None, None)


def fused_run_attention(qs, kxt, vxt, acc_o, acc_lse, tabs, *, mask=True,
                        scale: float | None = None, impl: str = "kernel"):
    """Fold one run of schedule steps into the flash accumulators.

    qs: ``[(N,) SL, H, bs, D]`` schedule-layout q; kxt/vxt: ``[(N,) EX,
    KH, bs, D]`` extended KV buffers; acc_o/acc_lse: ``[(N,) SL, H,
    bs(, D)]`` f32; ``tabs``: the run's ``step_q``/``step_kv``
    ``[(N,) S]``, ``q_seg``/``q_pos`` ``[(N,) SL, bs]``,
    ``k_seg``/``k_pos`` ``[(N,) S, bs]`` and optionally its
    ``segments`` table, plus for the backward the same steps sorted by
    kv row, ``bwd_q``/``bwd_kv`` with their kv metadata
    ``k_seg_b``/``k_pos_b`` and optionally their ``kv_segments``.

    Returns the updated accumulators: slots the run visits take the
    merged result, every other slot keeps its bytes (the reference's
    visited-slot pass-through).  Without autograd the accumulators are
    updated **in place** and returned; when grad is needed the result
    is new tensors and the inputs are left as they were.
    """
    _check_impl(impl)
    mask = coerce_mask(mask)
    if _needs_grad(qs, kxt, vxt, acc_o, acc_lse):
        return _FusedRun.apply(qs, kxt, vxt, acc_o, acc_lse, tabs, mask,
                               scale, impl)
    return _fused_forward(qs, kxt, vxt, acc_o, acc_lse, tabs, mask, scale,
                          impl)
