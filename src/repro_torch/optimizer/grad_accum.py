"""Microbatch gradient accumulation (for batches beyond per-step memory;
port of ``repro.optimizer.grad_accum``)."""

from __future__ import annotations

import torch

from .adamw import tree_leaves, tree_unflatten


def accumulate(loss_fn, params, microbatches):
    """``loss_fn(params, mb) -> scalar``; ``microbatches``: a nested dict
    with a leading microbatch dim on every leaf.  Returns (mean loss,
    mean f32 grads), one microbatch's activations alive at a time (the
    reference's ``lax.scan``)."""
    leaves = tree_leaves(params)
    for p in leaves:
        if not p.requires_grad:
            p.requires_grad_(True)
    n = tree_leaves(microbatches)[0].shape[0]
    acc_loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    acc_g = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in leaves]

    def take(tree, i):
        if isinstance(tree, dict):
            return {k: take(v, i) for k, v in tree.items()}
        return tree[i]

    for i in range(n):
        loss = loss_fn(params, take(microbatches, i))
        for a, g in zip(acc_g, torch.autograd.grad(loss, leaves)):
            a += g
        acc_loss = acc_loss + loss.detach()
    inv = 1.0 / n
    return acc_loss * inv, tree_unflatten(params, [g * inv for g in acc_g])
