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
"""

from __future__ import annotations

from ..masks import coerce_mask
from . import flash_attention as fa
from . import ref

IMPLS = ("kernel", "plain")


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} (expected {IMPLS})")


def block_attention(q, k, v, seg_q, pos_q, seg_k, pos_k, *, mask=True,
                    scale: float | None = None, impl: str = "kernel"):
    """Normalized attention + lse over one (q, kv) pair of token ranges.

    q: ``[(B,) H, Sq, D]``; k/v: ``[(B,) KH, Sk, D]`` (strided views
    allowed) → ``(o [(B,) H, Sq, D] f32, lse [(B,) H, Sq] f32)``.
    """
    _check_impl(impl)
    mask = coerce_mask(mask)
    fn = fa.flash_attention_fwd if impl == "kernel" \
        else fa.flash_attention_fwd_plain
    return fn(q, k, v, seg_q, pos_q, seg_k, pos_k, mask=mask, scale=scale)


merge_partials = ref.merge_partials
merge_many = ref.merge_many


def fused_run_attention(qs, kxt, vxt, acc_o, acc_lse, tabs, *, mask=True,
                        scale: float | None = None, impl: str = "kernel"):
    """Fold one run of schedule steps into the flash accumulators.

    qs: ``[(N,) SL, H, bs, D]`` schedule-layout q; kxt/vxt: ``[(N,) EX,
    KH, bs, D]`` extended KV buffers; acc_o/acc_lse: ``[(N,) SL, H,
    bs(, D)]`` f32; ``tabs``: the run's ``step_q``/``step_kv``
    ``[(N,) S]``, ``q_seg``/``q_pos`` ``[(N,) SL, bs]``,
    ``k_seg``/``k_pos`` ``[(N,) S, bs]`` and optionally its
    ``segments`` table.

    The accumulators are updated **in place** and returned: slots the
    run visits take the merged result, every other slot keeps its
    bytes (the reference's visited-slot pass-through).
    """
    _check_impl(impl)
    mask = coerce_mask(mask)
    args = (tabs["step_q"], tabs["step_kv"], qs, kxt, vxt, tabs["q_seg"],
            tabs["q_pos"], tabs["k_seg"], tabs["k_pos"], acc_o, acc_lse)
    if impl == "plain":
        return fa.fused_flash_fwd_plain(*args, mask=mask, scale=scale)
    return fa.fused_flash_fwd(*args, mask=mask, scale=scale,
                              segments=tabs.get("segments"))
