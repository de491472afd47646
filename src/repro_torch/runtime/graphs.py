"""Compiled programs: one CUDA graph per program and static key.

The port's counterpart of a ``jax.jit`` cache entry (no module of the
reference matches this one; the reference's serving loop jits its steps
and counts their compiles, ``repro.runtime.serving.ServingLoop``).

A :class:`Program` wraps an eager function ``fn(*inputs)``.  Each call
copies its ``inputs`` (tensors, or dicts / lists / tuples of them, on
any device) into static device buffers held per key, the inputs' shapes
and dtypes, and returns the key's static outputs.  What ``fn`` reads
through its closure and updates in place (the weights, the decode state
and cache, another program's outputs) is passed as ``held``: those
tensors are not copied, and every call must pass the same ones (by
address), which the program checks.

* **On CUDA** the first call of a key builds it: ``fn`` runs once
  eagerly on a side stream, and its result is that call's result (the
  kernels' first-launch work happens there: ``nvcc``, the ``static``
  ``cudaFuncSetAttribute`` guards, cuBLAS's workspace, the plan's
  device tables), then ``fn`` is captured into a
  ``torch.cuda.CUDAGraph`` on the same stream.  Every later call copies
  its inputs and replays the graph.  A capture that fails raises: no
  call falls back to the eager function.
* **On the CPU** nothing is captured: the first call of a key is its
  build, and every call runs ``fn`` on the static buffers and copies its
  result into the static outputs, so the same buffer plumbing runs.

**Outputs** are the key's static outputs: valid until this program next
runs, or until any program sharing its memory pool replays.

**Memory pools.**  Programs given one ``pool``
(``torch.cuda.graph_pool_handle()``) capture into one graph memory pool.  That is safe only while (1) a program's
outputs are consumed before any other program of the pool replays, and
(2) no two programs of the pool replay concurrently.  The serving loop
shares one pool among its prefill and insert programs (a prefill batch's
outputs are inserted before the next prefill or fresh insert runs) and
keeps the decode program in a pool of its own.

**Launch counters.**  The kernel wrappers count launches in Python
(``kernels.flash_attention.COUNTED``).  A capture runs the wrappers but
launches nothing, so the program takes back the counters' delta over
the capture and adds it on every replay: the counters keep counting the
launches the card runs.
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels import flash_attention as fa


def _leaves(tree) -> list:
    """The tensors of a tree of dicts / lists / tuples, in order."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    raise TypeError(f"a program takes tensors, not {type(tree).__name__}")


def _map(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return tree


def _counts() -> dict:
    return {f.__name__: f.launches for f in fa.COUNTED}


@dataclasses.dataclass
class _Entry:
    inputs: tuple                   # static input buffers (trees)
    outputs: object                 # static outputs (a tree)
    graph: object = None            # torch.cuda.CUDAGraph on CUDA
    launches: dict = dataclasses.field(default_factory=dict)


class Program:
    """One program: a static key's buffers, outputs and (on CUDA) graph
    (module docstring).  ``builds`` counts the keys built, the
    counterpart of a jitted function's ``_cache_size()``."""

    def __init__(self, name: str, fn, device, pool=None):
        self.name, self.fn = name, fn
        self.device = torch.device(device)
        self.pool = pool
        self._entries: dict = {}
        self._held: tuple | None = None

    @property
    def builds(self) -> int:
        return len(self._entries)

    def _check_held(self, held) -> None:
        ptrs = tuple(x.data_ptr() for x in _leaves(held))
        if self._held is None:
            self._held = ptrs
        elif ptrs != self._held:
            raise ValueError(
                f"program {self.name!r}: the held tensors are not the ones "
                f"it was built on (a captured graph reads them in place)")

    def __call__(self, *inputs, held=None):
        self._check_held(held)
        flat = _leaves(inputs)
        key = tuple((tuple(x.shape), x.dtype) for x in flat)
        e = self._entries.get(key)
        if e is None:
            return self._build(key, inputs)
        for buf, x in zip(_leaves(e.inputs), flat):
            buf.copy_(x, non_blocking=True)
        if e.graph is None:
            out = self.fn(*e.inputs)
            for s, x in zip(_leaves(e.outputs), _leaves(out)):
                s.copy_(x)
        else:
            e.graph.replay()
            for f in fa.COUNTED:
                f.launches += e.launches[f.__name__]
        return e.outputs

    def _build(self, key, inputs):
        bufs = _map(inputs, lambda x: torch.empty(
            x.shape, dtype=x.dtype, device=self.device).copy_(
                x, non_blocking=True))
        if self.device.type != "cuda":
            e = self._entries[key] = _Entry(bufs, self.fn(*bufs))
            return e.outputs
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self.fn(*bufs)        # this call's result, eagerly
        # the eager call's intermediates sit in the allocator's cache,
        # where a graph's private pool cannot reuse them: hand them back
        # (``torch.cuda.graph`` does too, beside a ``gc.collect()`` this
        # capture skips by calling capture_begin / capture_end itself)
        torch.cuda.empty_cache()
        before = _counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            graph.capture_begin(pool=self.pool)
            try:
                static = self.fn(*bufs)
            finally:
                graph.capture_end()
        after = _counts()
        for f in fa.COUNTED:            # the capture launched nothing
            f.launches = before[f.__name__]
        with torch.cuda.stream(side):
            for s, x in zip(_leaves(static), _leaves(out)):
                s.copy_(x)
        main.wait_stream(side)
        e = self._entries[key] = _Entry(
            bufs, static, graph,
            {n: after[n] - before[n] for n in before})
        return e.outputs
