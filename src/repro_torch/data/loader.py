"""Synthetic learnable corpus + packed-stream batch loader.

Documents are cyclic repetitions of patterns drawn from a small
per-loader pattern bank (induction structure over a *stationary*
corpus), so next-token loss visibly decreases within a handful of steps
even though every batch is fresh; tokens are otherwise uniform over the
vocab.

The loader emits the executor's packed frame layout directly:
``tokens/labels/positions/loss_mask [F, tokens_per_worker]`` plus the
batch's ``seqlens`` (the FCP scheduler input).  Iterator state (step
counter + rng) is checkpointable for exact resume.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from ..core import blocks as blockslib
from . import distributions


@dataclasses.dataclass
class LoaderState:
    step: int
    seed: int

    def to_dict(self):
        return {"step": self.step, "seed": self.seed}

    @classmethod
    def from_dict(cls, d):
        return cls(step=int(d["step"]), seed=int(d["seed"]))


@dataclasses.dataclass
class Batch:
    tokens: np.ndarray        # [F, T] int32
    labels: np.ndarray        # [F, T] int32
    positions: np.ndarray     # [F, T] int32
    seg_ids: np.ndarray       # [F, T] int32
    loss_mask: np.ndarray     # [F, T] float32
    seqlens: list[int]
    composition_id: int       # schedule-bucket index


def _doc_tokens(rng: np.random.Generator, length: int,
                bank: np.ndarray) -> np.ndarray:
    """One document: a rotated bank pattern tiled to ``length``.

    The bank is fixed per loader, so the token *distribution* is
    stationary across steps (learnable bigrams) while each document
    still varies by pattern choice and rotation."""
    p = bank[int(rng.integers(len(bank)))]
    p = np.roll(p, -int(rng.integers(len(p))))[:max(2, min(len(p), length))]
    reps = -(-length // len(p))
    return np.tile(p, reps)[:length]


class SyntheticLoader:
    """Packed-stream batches with a bounded set of length compositions.

    ``plan_buckets > 0`` canonicalizes every composition through the
    amortized-planning length buckets (``plan_buckets`` bucket edges per
    length doubling; see :mod:`repro.core.plan_cache`): long documents
    round up to bucket edges, short ones re-pack into a deterministic
    filler — so the batch layouts the scheduler sees are drawn from a
    small set and the plan cache hits even on ``fresh`` streams.

    ``fresh=True`` samples a new composition every step (a production
    batch stream) instead of round-robining ``n_buckets`` precomputed
    ones.  Compositions are a pure function of ``(seed, step)`` either
    way, so :meth:`peek_seqlens` can reveal batch ``t+1``'s layout for
    the plan-ahead pipeline without advancing loader state.
    """

    def __init__(self, *, dist: str, n_frames: int, tokens_per_worker: int,
                 vocab_size: int, n_buckets: int = 4, seed: int = 0,
                 uniform_len: int = 4096, pods: int = 1,
                 plan_buckets: int = 0, bucket_min_len: int = 1024,
                 fresh: bool = False):
        self.n_frames = n_frames            # per pod
        self.tpw = tokens_per_worker
        self.vocab = vocab_size
        self.pods = pods
        self.dist = dist
        self.uniform_len = uniform_len
        self.plan_buckets = int(plan_buckets)
        self.bucket_min_len = int(bucket_min_len)
        self.fresh = bool(fresh)
        self.budget = n_frames * tokens_per_worker
        if not self.fresh:
            self.compositions = [
                self._canonical(c) for c in distributions.batch_compositions(
                    dist, self.budget, n_buckets, seed=seed,
                    uniform_len=uniform_len)]
        bank_rng = np.random.default_rng((seed, 0x5eed))
        self.pattern_bank = bank_rng.integers(
            1, max(vocab_size, 2), size=(16, 64))
        self.state = LoaderState(step=0, seed=seed)

    def _canonical(self, lens: list[int]) -> list[int]:
        if self.plan_buckets <= 0:
            return lens
        from ..core.plan_cache import canonicalize_lengths
        return list(canonicalize_lengths(
            lens, self.budget, self.bucket_min_len,
            per_octave=self.plan_buckets))

    def composition(self, step: int) -> tuple[int, list[int]]:
        if self.fresh:
            lens = self._canonical(distributions.sample_composition(
                self.dist, self.budget,
                seed=self.state.seed * 1_000_003 + 7919 * step + 1,
                uniform_len=self.uniform_len))
            return hash(tuple(lens)) & 0x7FFFFFFF, lens
        i = step % len(self.compositions)
        return i, self.compositions[i]

    def peek_seqlens(self, ahead: int = 0) -> list[int]:
        """The ``seqlens`` of the batch ``ahead`` steps past the next
        one, without advancing state (plan-ahead input)."""
        return self.composition(self.state.step + ahead)[1]

    def next(self) -> Batch:
        step = self.state.step
        cid, seqlens = self.composition(step)
        rng = np.random.default_rng(
            (self.state.seed, step) if self.state.seed else step)
        n_tok = self.n_frames * self.tpw
        frames = []
        for pod in range(self.pods):
            seg, pos = blockslib.stream_metadata(seqlens, n_tok)
            toks = np.zeros(n_tok, np.int64)
            labels = np.zeros(n_tok, np.int64)
            mask = np.zeros(n_tok, np.float32)
            off = 0
            for L in seqlens:
                doc = _doc_tokens(rng, L, self.pattern_bank)
                toks[off:off + L] = doc
                labels[off:off + L - 1] = doc[1:]
                mask[off:off + L - 1] = 1.0
                off += L
            frames.append((toks, labels, pos, seg, mask))
        def cat(i):
            return np.concatenate([f[i] for f in frames])
        F = self.pods * self.n_frames
        b = Batch(
            tokens=cat(0).reshape(F, self.tpw).astype(np.int32),
            labels=cat(1).reshape(F, self.tpw).astype(np.int32),
            positions=cat(2).reshape(F, self.tpw).astype(np.int32),
            seg_ids=cat(3).reshape(F, self.tpw).astype(np.int32),
            loss_mask=cat(4).reshape(F, self.tpw).astype(np.float32),
            seqlens=seqlens, composition_id=cid)
        self.state.step += 1
        return b

    def __iter__(self) -> Iterator[Batch]:
        while True:
            yield self.next()
