"""AdamW with global-norm clipping over a parameter dict (port of
``repro.optimizer.adamw``).

Parameter trees are nested dicts of tensors.  Leaves are visited in
sorted key order, the order ``jax.tree`` flattens dicts in, so the
global norm sums its terms in the reference's order.  ``m``/``v`` are
f32; the update runs in f32 and casts back to the parameter dtype.

The reference is pure; here ``update`` writes the new parameters and
moments **in place** (under ``torch.no_grad``) and returns the same
objects: at full width an out-of-place step would hold a second copy of
the weights and of both f32 moments (~16 GB for 1.6 B parameters).  The
update is elementwise, so each leaf is updated in blocks of at most
``BLOCK`` elements along its leading dim, with the same arithmetic per
element: its f32 temporaries stay near ``4 * BLOCK`` bytes each, where
the stacked expert weights of an MoE config (1e9 elements a leaf at
granite-3b) would take 4 GB each.
"""

from __future__ import annotations

import dataclasses

import torch

BLOCK = 1 << 26                     # elements a block of a large leaf


@dataclasses.dataclass
class AdamWState:
    step: torch.Tensor              # int32 scalar on the parameters' device
    m: dict
    v: dict


def tree_leaves(tree) -> list[torch.Tensor]:
    """Leaves of a nested dict in sorted key order (``jax.tree`` order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves: list):
    """The inverse of :func:`tree_leaves`: ``leaves`` (in sorted key
    order) into a nested dict shaped like ``like``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(like)


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def init(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    leaf = tree_leaves(params)[0]
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=leaf.device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def _blocks(*xs: torch.Tensor):
    """Blocks of matching views of same-shaped leaves along their leading
    dim, each of at most ``BLOCK`` elements where a row allows (one block
    for a leaf of at most ``BLOCK`` elements)."""
    if xs[0].ndim == 0:
        return [xs]
    rows = max(1, xs[0].shape[0] * BLOCK // max(xs[0].numel(), 1))
    return list(zip(*(torch.split(x, rows) for x in xs)))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(x.to(torch.float32) ** 2)
                          for x in tree_leaves(tree)))


@torch.no_grad()
def update(params, grads, state: AdamWState, *, lr, b1=0.9, b2=0.95,
           eps=1e-8, weight_decay=0.1, grad_clip=1.0):
    """Returns ``(params, state, grad_norm)``; ``params`` and the state's
    moments are updated in place."""
    gnorm = global_norm(grads)
    scale = None
    if grad_clip > 0:
        scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
    state.step += 1
    t = state.step.to(torch.float32)
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t
    for leaf in zip(tree_leaves(params), tree_leaves(grads),
                    tree_leaves(state.m), tree_leaves(state.v)):
        for p, g, m, v in _blocks(*leaf):
            g32 = g.to(torch.float32)   # jnp promotes g * f32 scale
            if scale is not None:
                g32 = g32 * scale
            m.copy_(b1 * m + (1 - b1) * g32)
            v.copy_(b2 * v + (1 - b2) * g32 * g32)
            mh = m / bc1
            vh = v / bc2
            p32 = p.to(torch.float32)
            delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p32
            p.copy_((p32 - lr * delta).to(p.dtype))
    return params, state, gnorm
