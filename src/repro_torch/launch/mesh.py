"""Stacked-worker mesh: named axis sizes on one device.

The reference builds a ``jax.sharding.Mesh`` over real devices.  On one
card the port keeps only the axis sizes: the ``data`` axis is the
number of context-parallel workers stacked on the leading tensor dim of
the prefill executor, and the ``model`` axis is the number of sequence
shards the decode cache is split into.
"""

from __future__ import annotations



class StackedMesh:
    """``StackedMesh((4, 2), ("data", "model"))``: axis sizes only, all
    on one device.  ``shape`` maps axis name to size, as
    ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, shape, axes=("data", "model")):
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        if len(shape) != len(axes) or min(shape, default=1) < 1:
            raise ValueError(f"bad stacked mesh {shape} x {axes}")
        if len(set(axes)) != len(axes):
            raise ValueError(f"duplicate mesh axes {axes}")
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))

    def __repr__(self) -> str:
        return f"StackedMesh({self.shape})"
