"""Block abstraction and the sharding policy ``G`` (paper §4.1).

FCP shards every sequence into *fixed-size blocks* regardless of its
original length.  We adopt a *stream layout*: documents are concatenated
back-to-back into one global token stream (standard packed pre-training),
the stream is chopped into ``block_size`` chunks, and each chunk becomes a
scheduling :class:`Block`.  Short documents therefore share blocks
automatically ("FCP packs them into minimal number of blocks and adopts the
varlen API", §4.1), while long documents span many blocks.

Every token carries ``(segment_id, position)`` metadata; a single mask rule

    ``valid = (seg_q == seg_k) & mask.visible(pos_q, pos_k)``

uniformly implements every :class:`~repro.masks.MaskSpec` family
(causal, sliding-window, chunked, full), packed varlen, and padding
(``segment_id == -1`` never matches anything, including itself).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from ..masks import coerce_mask

PAD_SEGMENT = -1


@dataclasses.dataclass(frozen=True)
class Segment:
    """A contiguous slice of one document inside a block."""

    seq_id: int      # document id (-1 = padding)
    seq_len: int     # full length of the source document
    start: int       # position of the first token of this slice in the doc
    length: int      # number of tokens of this slice

    @property
    def end(self) -> int:
        return self.start + self.length


@dataclasses.dataclass(frozen=True)
class Block:
    """A fixed-size scheduling/computation unit (paper §4.1)."""

    bid: int                      # global block index (stream order)
    segments: tuple[Segment, ...]
    capacity: int                 # block_size

    @property
    def tokens(self) -> int:
        """Real (non-padding) tokens in the block."""
        return sum(s.length for s in self.segments if s.seq_id != PAD_SEGMENT)


@dataclasses.dataclass(frozen=True)
class BlockedBatch:
    """The result of applying ``G`` to one training batch."""

    blocks: tuple[Block, ...]
    block_size: int
    n_tokens: int                 # stream length incl. padding
    seqlens: tuple[int, ...]
    # token-level metadata over the full stream
    seg_ids: np.ndarray           # [n_tokens] int32, -1 = pad
    positions: np.ndarray         # [n_tokens] int32, position within doc

    @property
    def n_blocks(self) -> int:
        return len(self.blocks)

    def blocks_of_seq(self, seq_id: int) -> list[int]:
        """Block ids containing tokens of ``seq_id`` in stream order."""
        return [b.bid for b in self.blocks
                if any(s.seq_id == seq_id for s in b.segments)]


def stream_metadata(seqlens: Sequence[int], n_tokens: int
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Token-level (segment_id, position) arrays for a packed stream."""
    total = int(sum(seqlens))
    if total > n_tokens:
        raise ValueError(f"{total} tokens do not fit a {n_tokens} stream")
    seg = np.full(n_tokens, PAD_SEGMENT, dtype=np.int32)
    pos = np.zeros(n_tokens, dtype=np.int32)
    off = 0
    for sid, L in enumerate(seqlens):
        seg[off:off + L] = sid
        pos[off:off + L] = np.arange(L, dtype=np.int32)
        off += L
    return seg, pos


def shard_stream(seqlens: Sequence[int], block_size: int,
                 n_tokens: int | None = None) -> BlockedBatch:
    """The sharding policy ``G``: stream → fixed-size blocks.

    ``n_tokens`` (if given) must be a multiple of ``block_size``; the stream
    is padded up to it.  Otherwise the stream is padded to the next multiple
    of ``block_size``.
    """
    seqlens = [int(L) for L in seqlens]
    total = sum(seqlens)
    if n_tokens is None:
        n_tokens = ((total + block_size - 1) // block_size) * block_size
        n_tokens = max(n_tokens, block_size)
    if n_tokens % block_size != 0:
        raise ValueError("n_tokens must be a multiple of block_size")
    seg, pos = stream_metadata(seqlens, n_tokens)

    # doc offsets -> binary search for the docs overlapping each block
    offsets = np.zeros(len(seqlens) + 1, dtype=np.int64)
    np.cumsum(seqlens, out=offsets[1:])
    blocks = []
    for bid in range(n_tokens // block_size):
        lo, hi = bid * block_size, (bid + 1) * block_size
        segs: list[Segment] = []
        first = int(np.searchsorted(offsets, lo, side="right") - 1)
        for sid in range(max(first, 0), len(seqlens)):
            off = int(offsets[sid])
            L = seqlens[sid]
            s, e = max(off, lo), min(off + L, hi)
            if e > s:
                segs.append(Segment(seq_id=sid, seq_len=L,
                                    start=s - off, length=e - s))
            if off + L >= hi:
                break
        pad = block_size - sum(x.length for x in segs)
        if pad > 0:
            segs.append(Segment(seq_id=PAD_SEGMENT, seq_len=0, start=0,
                                length=pad))
        blocks.append(Block(bid=bid, segments=tuple(segs),
                            capacity=block_size))
    return BlockedBatch(blocks=tuple(blocks), block_size=block_size,
                        n_tokens=n_tokens, seqlens=tuple(seqlens),
                        seg_ids=seg, positions=pos)


def kv_dependencies(batch: BlockedBatch, mask=True) -> list[list[int]]:
    """``deps[i]`` = block ids whose KV is needed by the queries of block i.

    ``mask`` is a :class:`~repro.masks.MaskSpec` (or the legacy
    ``causal: bool``).  Dependencies are pruned to *mask-visible* block
    pairs: a block is a dependency iff it holds at least one key position
    some query of block *i* can see.  Sliding windows therefore need
    O(W / block_size) predecessor blocks instead of O(L / block_size) —
    the communication the mask already says is dead never ships.

    Exactness (property-tested against the token-level oracle in
    ``tests/test_mask_oracle.py``): documents are contiguous in the
    stream, so a doc-position range maps to a contiguous block range, and
    :meth:`MaskSpec.visible_key_range` is tight in both directions — no
    missing dependency, no dependency with zero visible pairs.
    """
    mask = coerce_mask(mask)
    bs = batch.block_size
    # stream offset of each document (contiguous by construction of G)
    offsets = np.zeros(len(batch.seqlens) + 1, dtype=np.int64)
    np.cumsum(batch.seqlens, out=offsets[1:])
    deps: list[list[int]] = []
    for b in batch.blocks:
        need: set[int] = set()
        for s in b.segments:
            if s.seq_id == PAD_SEGMENT:
                continue
            lo_p, hi_p = mask.visible_key_range(s.start, s.end, s.seq_len)
            if hi_p <= lo_p:
                continue
            off = int(offsets[s.seq_id])
            need.update(range((off + lo_p) // bs,
                              (off + hi_p - 1) // bs + 1))
        deps.append(sorted(need))
    return deps


def length_bucket_edges(min_len: int, max_len: int,
                        per_octave: int = 1) -> list[int]:
    """Geometric document-length bucket edges for amortized planning.

    Edges run ``min_len * 2**(i / per_octave)`` from ``min_len`` up to
    (and including one edge >=) ``max_len``, each rounded up to a
    multiple of ``min_len`` so bucketed documents tile the block grid.
    A small fixed edge set keeps the canonical batch layouts — and
    therefore the schedule's static shapes — drawn from a small set.
    """
    if min_len <= 0:
        raise ValueError("min_len must be positive")
    per_octave = max(1, int(per_octave))
    edges: list[int] = []
    i = 0
    while True:
        e = min_len * 2.0 ** (i / per_octave)
        e = int(-(-int(round(e)) // min_len) * min_len)   # round up to grid
        if not edges or e > edges[-1]:
            edges.append(e)
        if e >= max_len:
            break
        i += 1
    return edges


def bucket_length(length: int, edges: Sequence[int]) -> int:
    """Round ``length`` up to its bucket edge (clamped to the last edge)."""
    for e in edges:
        if length <= e:
            return int(e)
    return int(edges[-1])


def zigzag_order(n_blocks: int, n_workers: int) -> np.ndarray:
    """Zig-Zag placement (paper Fig. 4): block ``i`` pairs with ``2N-1-i``.

    Returns ``owner[block]`` for the ring-attention baseline: the first N
    blocks are dealt ``0..N-1`` and the next N blocks ``N-1..0``, repeating.
    Balances causal compute *within* one uniformly-sharded sequence.
    """
    owner = np.zeros(n_blocks, dtype=np.int32)
    for i in range(n_blocks):
        j = i % (2 * n_workers)
        owner[i] = j if j < n_workers else 2 * n_workers - 1 - j
    return owner
