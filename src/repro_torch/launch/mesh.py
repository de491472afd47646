"""Stacked-worker mesh: named axis sizes on one device.

The reference builds a ``jax.sharding.Mesh`` over real devices.  On one
card the port keeps only the axis sizes: the ``data`` axis is the
number of context-parallel workers stacked on the leading tensor dim of
the prefill executor, and the ``model`` axis is the number of sequence
shards the decode cache is split into.

A pod mesh ``(P, D, M)`` over ``("pod", "data", "model")`` stacks P·D
frames, pod-major (frame ``p * D + w`` is worker ``w`` of pod ``p``, as
:class:`~repro_torch.runtime.health.FleetTopology` numbers them), and
every pod runs the same D-worker FCP plan on its own D frames: the
reference's frames shard over ``("pod", "data")`` with the schedule
tables replicated over ``pod``.

**Ranks.**  Under a ``torch.distributed`` process group of R ranks
(``ranks``, a :class:`~repro_torch.runtime.wire.Ranks`), rank r holds
the frames ``[r·F/R, (r+1)·F/R)`` of the F = P·D pod-major frames on its
own device (:attr:`StackedMesh.frames`); R = D is the reference's
layout, one worker per device.  The split is ``Ranks.share``'s floor
rule, so a survivor fleet's uneven count splits too; which layouts a
run may start in is the CLIs' call (``launch/train.check_ranked``,
``launch/serve.check_ranked``), made before the group is joined.
"""

from __future__ import annotations

from ..runtime.wire import STACKED, Ranks


class StackedMesh:
    """``StackedMesh((4, 2), ("data", "model"))``: axis sizes only, all
    on one device.  ``shape`` maps axis name to size, as
    ``jax.sharding.Mesh.shape`` does.  Without ``axes``, two sizes name
    ``("data", "model")`` and three ``("pod", "data", "model")``."""

    def __init__(self, shape, axes=None, ranks: Ranks = STACKED):
        shape = tuple(int(s) for s in shape)
        if axes is None:
            axes = (("data", "model") if len(shape) == 2
                    else ("pod", "data", "model"))
        axes = tuple(axes)
        if len(shape) != len(axes) or min(shape, default=1) < 1:
            raise ValueError(f"bad stacked mesh {shape} x {axes}")
        if len(set(axes)) != len(axes):
            raise ValueError(f"duplicate mesh axes {axes}")
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))
        self.ranks = ranks

    def with_ranks(self, ranks: Ranks) -> "StackedMesh":
        """The same axes split over ``ranks``."""
        return StackedMesh(tuple(self.shape.values()), self.axis_names,
                           ranks)

    @property
    def frames(self) -> tuple[int, int]:
        """The frame range ``[lo, hi)`` of :func:`stacked_frames` this
        process holds (all of them without a process group)."""
        return self.ranks.share(stacked_frames(self))

    @property
    def pods(self) -> int:
        return self.shape.get("pod", 1)

    def __repr__(self) -> str:
        if self.ranks.grouped:
            return f"StackedMesh({self.shape}, {self.ranks})"
        return f"StackedMesh({self.shape})"


def stacked_frames(mesh) -> int:
    """The stacked CP frames of a mesh: pods x data workers (the
    reference shards prefill and training frames over both), over all
    ranks."""
    return mesh.shape.get("pod", 1) * mesh.shape.get("data", 1)


def parse_mesh(spec: str) -> StackedMesh:
    """``"DxM"`` or ``"PxDxM"`` (the CLIs' ``--mesh``)."""
    dims = [int(x) for x in spec.split("x")]
    if len(dims) not in (2, 3):
        raise SystemExit("--mesh must be DxM or PxDxM")
    return StackedMesh(tuple(dims))
