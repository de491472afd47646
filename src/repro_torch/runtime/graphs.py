"""Compiled programs: one CUDA graph per program and static key.

The port's counterpart of a ``jax.jit`` cache entry (no module of the
reference matches this one; the reference jits its serving steps and its
training step and counts their compiles: ``repro.runtime.serving.
ServingLoop``, ``repro.launch.train.jit_train_step``).  Two users: the
serving loop (``runtime/serving.py``: the decode step, each bucket's
prefill and insert) and the training loops (``launch/train.py``: one
program per plan key, ``fn(batch) -> (loss, gnorm)``).

A :class:`Program` wraps an eager function ``fn(*inputs)``.  Each call
copies its ``inputs`` (tensors, or dicts / lists / tuples of them, on
any device) into static device buffers held per key, the inputs' shapes
and dtypes, and returns the key's static outputs.  What ``fn`` reads
through its closure and updates in place (the weights, the decode state
and cache, another program's outputs; the AdamW moments and the
error-feedback residuals) is passed as ``held``: those tensors are not
copied, and every call must pass the same ones (by address), which the
program checks.

* **On CUDA** the first call of a key builds it: ``fn`` runs once
  eagerly on a side stream, and its result is that call's result (the
  kernels' first-launch work happens there: ``nvcc``, the ``static``
  ``cudaFuncSetAttribute`` guards, cuBLAS's workspace, the plan's
  device tables), then ``fn`` is captured into a
  ``torch.cuda.CUDAGraph`` on the same stream.  Every later call copies
  its inputs and replays the graph.  A capture that fails raises: no
  call falls back to the eager function.  ``build_log`` records each
  build: the eager call's and the capture's seconds and the graph's
  node count (on the CPU the first call's seconds only).
* **On the CPU** nothing is captured: the first call of a key is its
  build, and every call runs ``fn`` on the static buffers and copies its
  result into the static outputs, so the same buffer plumbing runs.  A
  program made with ``capture=False`` does the same on the card (the
  training step across ranks: ``launch/train.Trainer`` says why).

**Outputs** are the key's static outputs: valid until this program next
runs, or until any program sharing its memory pool replays.

**Memory pools.**  Programs given one ``pool`` capture into one graph
memory pool.  That is safe only while (1) a program's outputs are
consumed before any other program of the pool replays, and (2) no two
programs of the pool replay concurrently.  The serving loop shares one
pool (``torch.cuda.graph_pool_handle()``) among its prefill and insert
programs (a prefill batch's outputs are inserted before the next prefill
or fresh insert runs) and keeps the decode program in a pool of its own.
A training loop gives all of its step programs one :class:`Pool` (a
step's loss and gnorm are read on the host before the next step runs,
and steps run one at a time): its builds run and capture on the pool's
one stream, the eager call allocating in the pool too, so every key
reuses the blocks the others freed and the pool stays near one step's
activations, not one copy per key.

**Launch counters.**  The kernel wrappers count launches in Python
(``kernels.flash_attention.COUNTED``).  A capture runs the wrappers but
launches nothing, so the program takes back the counters' delta over
the capture (the backward's wrappers count on autograd's thread, inside
the same span) and adds it on every replay: the counters keep counting
the launches the card runs.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import time
import weakref

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


def _node_count(graph) -> int | None:
    """Nodes of a captured graph (``cuGraphGetNodes`` on its
    ``cudaGraph_t``), None where PyTorch does not keep the graph."""
    try:
        raw = graph.raw_cuda_graph()
        n = ctypes.c_size_t(0)
        err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
            ctypes.c_void_p(raw), None, ctypes.byref(n))
    except (AttributeError, OSError, RuntimeError):
        return None
    return int(n.value) if err == 0 else None


@functools.lru_cache(maxsize=None)
def build_stream(index: int) -> torch.cuda.Stream:
    """The stream every :class:`Pool`'s builds run and capture on, one
    per device for the process.  cuBLAS keeps a workspace per handle and
    stream, allocated at the handle's first product there: made inside a
    build it would land in that loop's pool and keep a segment of it
    from the card after the loop is gone, so a product and its backward
    (this thread's handle and autograd's) make them first."""
    dev = torch.device("cuda", index)
    stream = torch.cuda.Stream(dev)
    with torch.cuda.stream(stream):
        for dtype in (torch.float32, torch.bfloat16):
            a = torch.ones((64, 64), dtype=dtype, device=dev,
                           requires_grad=True)
            torch.autograd.grad((a @ a).sum(), a)
    stream.synchronize()
    return stream


class Pool:
    """One graph memory pool for programs that run one at a time (a
    training loop's step programs; module docstring), built and captured
    on :func:`build_stream`: the allocator hands a pool's free block only
    to the stream that freed it.  The pool lives while this object or a
    graph captured into it does.  On the CPU it holds nothing."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.id = self.stream = None
        if self.device.type != "cuda":
            return
        self._idx = (self.device.index if self.device.index is not None
                     else torch.cuda.current_device())
        self.id = torch.cuda.graph_pool_handle()
        self.stream = build_stream(self._idx)
        # this object's reference to the pool, dropped when it is
        # collected (the allocator frees a pool nothing refers to)
        torch._C._cuda_beginAllocateToPool(self._idx, self.id)
        torch._C._cuda_endAllocateToPool(self._idx, self.id)
        weakref.finalize(self, torch._C._cuda_releasePool, self._idx,
                         self.id)

    @contextlib.contextmanager
    def allocating(self):
        """Every allocation on the device, from any thread, comes from the
        pool: the eager build call's backward runs on autograd's thread,
        which ``torch.cuda.use_mem_pool`` (this thread's only) misses."""
        torch._C._cuda_beginAllocateToPool(self._idx, self.id)
        try:
            yield
        finally:
            torch._C._cuda_endAllocateToPool(self._idx, self.id)
            torch._C._cuda_releasePool(self._idx, self.id)


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

    def __init__(self, name: str, fn, device, pool=None,
                 capture: bool = True):
        self.name, self.fn = name, fn
        self.device = torch.device(device)
        self.capture = capture and self.device.type == "cuda"
        self.pool = pool                # None, a graph pool handle or a Pool
        self._entries: dict = {}
        self._held: tuple | None = None
        self.build_log: list[dict] = []

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
        if not self.capture:
            t0 = time.perf_counter()
            e = self._entries[key] = _Entry(bufs, self.fn(*bufs))
            self.build_log.append({"eager_s": time.perf_counter() - t0,
                                   "capture_s": None, "instantiate_s": None,
                                   "nodes": None})
            return e.outputs
        shared = isinstance(self.pool, Pool)
        main = torch.cuda.current_stream(self.device)
        side = self.pool.stream if shared else torch.cuda.Stream(self.device)
        side.wait_stream(main)
        t0 = time.perf_counter()
        with torch.cuda.stream(side), (self.pool.allocating() if shared
                                       else contextlib.nullcontext()):
            out = self.fn(*bufs)        # this call's result, eagerly
        side.synchronize()
        eager_s = time.perf_counter() - t0
        # the eager call's intermediates sit in the allocator's cache,
        # where a graph's private pool cannot reuse them: hand them back
        # (``torch.cuda.graph`` does too, beside a ``gc.collect()`` this
        # capture skips by calling capture_begin / capture_end itself);
        # a Pool's build allocated in the pool, whose blocks stay
        torch.cuda.empty_cache()
        before = _counts()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            graph.capture_begin(pool=self.pool.id if shared else self.pool)
            try:
                static = self.fn(*bufs)
            finally:
                graph.capture_end()
        capture_s = time.perf_counter() - t0
        nodes = _node_count(graph)
        t0 = time.perf_counter()
        graph.instantiate()
        instantiate_s = time.perf_counter() - t0
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
        self.build_log.append({"eager_s": eager_s, "capture_s": capture_s,
                               "instantiate_s": instantiate_s,
                               "nodes": nodes})
        return e.outputs
