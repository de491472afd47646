"""Amortized planning: length-bucketed canonical batches, an LRU
schedule cache, and a plan-ahead pipeline.

FCP replans block placement per batch, so every fresh ``seqlens`` vector
pays the full host pipeline (distributor -> congestion-free matching ->
coalescer -> ``PlanArrays``) and risks a fresh XLA compile of the
executor.  This module amortizes that cost the way DCP amortizes
schedule reuse and FlexSP bounds solver outputs:

* :func:`canonicalize_lengths` maps a raw length multiset onto a
  *canonical composition*: long documents round up to geometric bucket
  edges, short documents are re-packed into a deterministic filler
  pattern of edge-sized documents.  Canonical compositions (and hence
  the schedule's static shapes — ``n_steps``, run widths, recv-slot
  counts, table dims) are drawn from a small set.
* :class:`PlanCache` is a thread-safe LRU over built
  :class:`~repro.core.schedule.Schedule` objects keyed by
  :func:`plan_key` (canonical layout + every planner knob).  A hit skips
  the planner entirely, and — because the cached ``StaticSpec`` repeats
  — the executor's jit cache hits too: no XLA recompilation.
* :class:`PlanAheadPlanner` owns one background thread that plans batch
  ``t+1`` on the host while batch ``t`` executes on the devices, moving
  cold-planning latency off the critical path.

The loader applies canonicalization at composition time (documents are
*generated* at their bucketed lengths), so a cached plan's token-level
metadata (``blk_seg`` / ``blk_pos``) is exact for every batch sharing
the canonical composition — cached and uncached planning are bit-equal.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Sequence

from ..masks import coerce_mask
from ..runtime.wire import coerce_wire
from .blocks import bucket_length, length_bucket_edges
from .schedule import Schedule, StaticSpec

# documents at least this many buckets-of-min_len long are kept
# individually (they drive KV traffic and load balance); shorter ones
# are fungible and re-pack into the canonical filler pattern
LONG_DOC_FACTOR = 4


# --------------------------------------------------------------------------
# canonicalization (length bucketing)
# --------------------------------------------------------------------------

def canonicalize_lengths(seqlens: Sequence[int], budget: int,
                         min_len: int, per_octave: int = 1
                         ) -> tuple[int, ...]:
    """Map ``seqlens`` onto a canonical composition of ``budget`` tokens.

    Long documents (>= ``LONG_DOC_FACTOR * min_len``) are rounded up to
    geometric bucket edges (``per_octave`` edges per doubling) and kept
    — they dominate placement and KV traffic.  Everything else is
    re-packed into a deterministic greedy filler of edge-sized documents
    (largest edge first), with one exact-remainder tail document below
    ``min_len``.  The result sums to exactly ``budget`` and is sorted
    descending, so batches that differ only in fungible short-document
    detail collapse onto one plan-cache key.
    """
    budget = int(budget)
    if budget <= 0:
        return ()
    min_len = max(1, int(min_len))
    edges = length_bucket_edges(min_len, budget, per_octave)
    long_cut = LONG_DOC_FACTOR * min_len

    longs = sorted((bucket_length(int(L), edges)
                    for L in seqlens if int(L) >= long_cut), reverse=True)
    kept: list[int] = []
    total = 0
    for L in longs:
        L = min(L, budget - total)
        if L < long_cut:
            break                          # remainder goes to the filler
        kept.append(L)
        total += L

    # deterministic filler: greedy change-making over the edge set,
    # capped below the long cut so fillers stay intra-worker-ish
    rest = budget - total
    fill_edges = [e for e in edges if e < long_cut] or [min_len]
    while rest >= fill_edges[0]:
        e = max(x for x in fill_edges if x <= rest)
        kept.append(e)
        rest -= e
    if rest > 0:
        kept.append(rest)                  # exact tail (< min_len)
    return tuple(sorted(kept, reverse=True))


# --------------------------------------------------------------------------
# serving-prefill canonical layouts
# --------------------------------------------------------------------------

def prefill_bucket_edges(min_len: int, budget: int) -> list[int]:
    """Serving prefill bucket edges: the geometric edge set restricted
    to divisors of ``budget``.

    A serving prefill batch is a *uniform* composition — ``budget /
    edge`` sequences all padded (or chunked) to one edge — so each edge
    must divide the budget exactly or the batch cannot tile it.  With
    ``budget / min_len`` a power of two every geometric edge divides;
    otherwise the non-divisor edges are dropped (and at least the
    budget itself always qualifies when ``min_len`` divides it)."""
    budget, min_len = int(budget), int(min_len)
    if budget <= 0 or min_len <= 0:
        raise ValueError("budget and min_len must be positive")
    edges = [e for e in length_bucket_edges(min_len, budget)
             if e <= budget and budget % e == 0]
    if not edges:
        raise ValueError(
            f"no prefill bucket edge in [{min_len}, {budget}] divides "
            f"the budget {budget}; pick bucket_min dividing the budget "
            f"(ideally budget/bucket_min a power of two)")
    return edges


def prefill_composition(bucket_len: int, budget: int) -> tuple[int, ...]:
    """Canonical composition of one serving prefill batch: ``budget /
    bucket_len`` sequences of exactly ``bucket_len`` tokens.

    Every prompt whose length falls in the same bucket maps onto this
    layout, so a mixed-length request stream mints at most one plan key
    (and one executor compile) per bucket edge."""
    bucket_len, budget = int(bucket_len), int(budget)
    if bucket_len <= 0 or budget % bucket_len:
        raise ValueError(
            f"bucket_len {bucket_len} must divide the prefill budget "
            f"{budget}")
    return (bucket_len,) * (budget // bucket_len)


def prefill_plan_key(bucket_len: int, budget: int, n_workers: int,
                     block_size: int, *, mask=True, coalesce: int = 1,
                     locality: bool | str = "auto", wire="f32",
                     in_dtype_bytes: float = 4.0, overlap: bool = False,
                     extra: tuple = ()) -> tuple:
    """Plan-cache key of one serving prefill bucket — :func:`plan_key`
    over the canonical uniform composition, so every prefill batch of
    the same bucket re-hits the same schedule (and the executor's jit
    cache) no matter which requests fill it."""
    return plan_key(
        prefill_composition(bucket_len, budget), n_workers,
        int(budget) // int(n_workers), block_size, mask=mask,
        coalesce=coalesce, locality=locality, wire=wire,
        in_dtype_bytes=in_dtype_bytes, overlap=overlap, extra=extra)


# --------------------------------------------------------------------------
# cache key
# --------------------------------------------------------------------------

def plan_key(seqlens: Sequence[int], n_workers: int,
             tokens_per_worker: int, block_size: int, *,
             mask=True, coalesce: int = 1,
             locality: bool | str = "auto",
             alpha: float = 1.0, beta: float = 1.0,
             speeds=None, wire="f32", in_dtype_bytes: float = 4.0,
             overlap: bool = False, extra: tuple = ()) -> tuple:
    """Hashable key capturing every input the planner is deterministic
    in: the (canonical) block layout plus all scheduling knobs.

    The *full* :class:`~repro.masks.MaskSpec` identity is folded in —
    a bare ``causal`` bool cannot distinguish window sizes or chunk
    widths, and cached plans must never cross mask families (their
    dependency sets and step tables differ).  The
    :class:`~repro.runtime.wire.WireFormat` is folded for the same
    reason: it changes both the planner's byte-aware decisions (pad
    cap, locality, distributor tolerance) and the executor's
    encode/decode graph, so cached plans must never cross wire formats
    (nor compute-dtype itemsizes, which reprice those decisions).
    ``overlap`` is the double-buffered-rounds parity bit: it changes the
    receive-slot allocation (parity pools) and the executor's pipelined
    loop, so cached plans must never cross overlap modes.  ``extra``
    folds in caller-side context (e.g. model head counts)."""
    sp = None if speeds is None else tuple(float(s) for s in speeds)
    return (tuple(int(L) for L in seqlens), int(n_workers),
            int(tokens_per_worker), int(block_size),
            coerce_mask(mask).key(),
            coerce_wire(wire).key() + (float(in_dtype_bytes),),
            int(coalesce), str(locality), float(alpha), float(beta), sp,
            tuple(extra), bool(overlap))


# --------------------------------------------------------------------------
# LRU schedule cache
# --------------------------------------------------------------------------

@dataclasses.dataclass
class PlanCacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    verified: int = 0       # insert-time static verifications (miss path
    #                         only — a hit never re-verifies)

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def to_dict(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "hit_rate": self.hit_rate,
                "verified": self.verified}


class PlanCache:
    """Thread-safe LRU cache of built schedules.

    Repeated canonical layouts skip the whole host planning pipeline;
    because a hit returns the *same* ``Schedule`` (same interned
    :class:`StaticSpec`, same table identities), downstream jit caches
    hit as well and the executor never recompiles for a repeat.
    """

    def __init__(self, max_size: int = 64, verify: bool | None = None):
        if max_size < 1:
            raise ValueError("max_size must be >= 1")
        self.max_size = int(max_size)
        # insert-time static verification (analysis/verifier).  None
        # follows the process default (on under tests), True/False pin
        # it.  Only the *miss* path verifies: a hit returns the cached
        # schedule untouched, so verification adds zero hit overhead.
        self.verify = verify
        self._entries: OrderedDict[tuple, Schedule] = OrderedDict()
        self._specs: dict[StaticSpec, StaticSpec] = {}
        self._lock = threading.Lock()
        self.stats = PlanCacheStats()

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: tuple) -> bool:
        with self._lock:
            return key in self._entries

    def keys(self) -> list[tuple]:
        with self._lock:
            return list(self._entries.keys())

    def lookup(self, key: tuple) -> Schedule | None:
        """Cache probe (counts a hit/miss, refreshes LRU recency)."""
        with self._lock:
            sched = self._entries.get(key)
            if sched is None:
                self.stats.misses += 1
                return None
            self._entries.move_to_end(key)
            self.stats.hits += 1
            return sched

    def insert(self, key: tuple, sched: Schedule) -> Schedule:
        """Insert a built schedule (interning its spec), evicting LRU
        entries beyond ``max_size``.  Returns the cached schedule (an
        earlier insert under the same key wins, keeping identities
        stable for downstream jit caches).

        With verification enabled, the schedule is statically verified
        here — once, before it can ever be served — including the
        spec/plan-key consistency check when ``key`` has the
        :func:`plan_key` layout.  Schedules ``make_schedule`` already
        verified (same invariants, exact head geometry) only re-run the
        key check."""
        self._verify_insert(key, sched)
        with self._lock:
            cur = self._entries.get(key)
            if cur is not None:
                self._entries.move_to_end(key)
                return cur
            spec = self._specs.setdefault(sched.spec, sched.spec)
            if spec is not sched.spec:
                sched.spec = spec          # intern: equal specs share id
            self._entries[key] = sched
            while len(self._entries) > self.max_size:
                self._entries.popitem(last=False)
                self.stats.evictions += 1
            if len(self._specs) > 4 * self.max_size:
                # drop interned specs that only evicted entries used
                live = {s.spec: s.spec for s in self._entries.values()}
                self._specs = live
            return sched

    def _verify_insert(self, key: tuple, sched: Schedule) -> None:
        from ..analysis import verifier
        if not verifier.should_verify(self.verify) or key in self:
            return
        pk = key if verifier.plan_key_shaped(key) else None
        if sched._verified:
            # full invariants already checked at build time with the
            # exact head geometry; only the key consistency is new here
            if pk is not None:
                violations = verifier.verify_plan_key(pk, sched)
                if violations:
                    raise verifier.PlanVerificationError(violations)
        else:
            # the wire key carries the compute itemsize; head geometry
            # is not part of the key, so the byte checks run with the
            # verifier's reference heads (self-consistent either way)
            idb = float(pk[5][-1]) if pk is not None else 4.0
            verifier.check_schedule(sched, in_dtype_bytes=idb, key=pk)
            sched._verified = True
        with self._lock:
            self.stats.verified += 1

    def get_or_build(self, key: tuple,
                     builder: Callable[[], Schedule]) -> Schedule:
        """Hit -> cached schedule; miss -> ``builder()`` (outside the
        lock: plan-ahead threads must not serialize on lookups)."""
        sched = self.lookup(key)
        if sched is not None:
            return sched
        return self.insert(key, builder())

    @property
    def n_unique_specs(self) -> int:
        """Distinct static specs alive in the cache — an upper bound on
        executor compilations caused by cached plans."""
        with self._lock:
            return len(self._specs)


# --------------------------------------------------------------------------
# plan-ahead pipeline
# --------------------------------------------------------------------------

class PlanAheadPlanner:
    """Plans batch ``t+1`` on a background host thread while batch ``t``
    executes, backed by a :class:`PlanCache`.

    Usage per training step::

        planner.prefetch(next_key, next_builder)   # overlap with step t
        sched = planner.get(key, builder)          # ready or built here

    ``enabled=False`` degrades to synchronous cached planning (same
    results, no thread), which is also the fallback whenever a prefetch
    raises: the error is re-raised on ``get`` of the same key.
    """

    def __init__(self, cache: PlanCache, enabled: bool = True):
        self.cache = cache
        self.enabled = bool(enabled)
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="plan-ahead") if enabled \
            else None
        self._pending: dict[tuple, Future] = {}
        self._lock = threading.Lock()
        self.prefetched_hits = 0

    def prefetch(self, key: tuple,
                 builder: Callable[[], Schedule]) -> None:
        """Schedule an async build of ``key`` (no-op if cached/pending)."""
        if not self.enabled:
            return
        with self._lock:
            if key in self._pending:
                return
            if key in self.cache:
                return
            fut = self._pool.submit(self.cache.get_or_build, key, builder)
            self._pending[key] = fut

    def get(self, key: tuple,
            builder: Callable[[], Schedule]) -> Schedule:
        """The plan for ``key``: prefetched (waits for the background
        build), cached, or built synchronously."""
        with self._lock:
            fut = self._pending.pop(key, None)
        if fut is not None:
            sched = fut.result()           # re-raises builder errors
            self.prefetched_hits += 1
            return sched
        return self.cache.get_or_build(key, builder)

    def shutdown(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
