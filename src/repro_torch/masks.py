"""First-class attention-mask families (``MaskSpec``).

FCP's block scheduling (§4.1–4.2) is derived from the mask: the mask
determines which (q-block, kv-block) pairs carry valid work, hence both
the KV dependency sets the planner must ship and the FLOP balance the
distributor packs.  Production pretraining mixes mask families in one
model (Mistral/Gemma-style interleaving), so the mask is a value, not a
boolean:

* ``causal``            — standard causal over packed segments,
* ``sliding_window(W)`` — causal, key within the last ``W`` positions
  (``0 <= pos_q - pos_k < W``; the window includes the query token),
* ``chunked(C)``        — causal within doc-local chunks of ``C`` tokens
  (``pos_q // C == pos_k // C``),
* ``full``              — bidirectional within the segment.

Every family composes with the packed-varlen segment rule: a (q, k) pair
is valid iff ``seg_q == seg_k != PAD`` **and** the family's position
predicate holds.  ``MaskSpec`` is a frozen (hashable) dataclass so it
can ride jit static arguments, ``StaticSpec``s, and plan-cache keys
directly.

Everything downstream — ``blocks.kv_dependencies``,
``cost_model.pair_valid_tokens``, the flash kernels' ``_mask_tile``,
``schedule.make_schedule``, ``plan_cache.plan_key`` — consumes a
``MaskSpec``.  Legacy ``causal: bool`` call sites keep working through
:func:`coerce_mask` (``True`` → causal, ``False`` → full).
"""

from __future__ import annotations

import dataclasses

KINDS = ("causal", "sliding_window", "chunked", "full")


@dataclasses.dataclass(frozen=True)
class MaskSpec:
    """One attention-mask family over packed ``(segment, position)``."""

    kind: str = "causal"
    window: int = 0               # sliding_window: W >= 1
    chunk: int = 0                # chunked: C >= 1

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown mask kind {self.kind!r}")
        if self.kind == "sliding_window" and self.window < 1:
            raise ValueError("sliding_window requires window >= 1")
        if self.kind == "chunked" and self.chunk < 1:
            raise ValueError("chunked requires chunk >= 1")
        if self.kind != "sliding_window" and self.window:
            raise ValueError(f"{self.kind} does not take a window")
        if self.kind != "chunked" and self.chunk:
            raise ValueError(f"{self.kind} does not take a chunk")

    # ---- static structure ---------------------------------------------------

    @property
    def causal(self) -> bool:
        """Whether the position-ordering constraint ``pos_k <= pos_q``
        applies (every family except ``full``)."""
        return self.kind != "full"

    def key(self) -> tuple:
        """Hashable identity for plan-cache keys / jit signatures."""
        return (self.kind, int(self.window), int(self.chunk))

    def visible_key_range(self, q_lo: int, q_hi: int, seq_len: int
                          ) -> tuple[int, int]:
        """Half-open in-document key-position range ``[lo, hi)`` visible
        to *some* query in ``[q_lo, q_hi)`` of a ``seq_len`` document.

        Exact: every position in the range is visible to at least one
        query in the range, and nothing outside it is visible to any.
        """
        if self.kind == "full":
            return 0, seq_len
        if self.kind == "sliding_window":
            return max(0, q_lo - self.window + 1), q_hi
        if self.kind == "chunked":
            return (q_lo // self.chunk) * self.chunk, q_hi
        return 0, q_hi                                     # causal

    # ---- token-level predicate (the oracle semantics) ----------------------

    def visible(self, pos_q, pos_k):
        """Position predicate ``valid(pos_q, pos_k)`` (segment match and
        padding are handled by the caller).  Works elementwise on numpy
        or jax arrays with broadcasting, and on plain ints."""
        ok = True
        if self.causal:
            ok = pos_q >= pos_k
        if self.window:
            ok = ok & (pos_q - pos_k < self.window)
        if self.chunk:
            ok = ok & (pos_q // self.chunk == pos_k // self.chunk)
        return ok

    def __str__(self) -> str:
        if self.kind == "sliding_window":
            return f"swa:{self.window}"
        if self.kind == "chunked":
            return f"chunked:{self.chunk}"
        return self.kind


CAUSAL = MaskSpec("causal")
FULL = MaskSpec("full")


def sliding_window(window: int) -> MaskSpec:
    return MaskSpec("sliding_window", window=int(window))


def chunked(chunk: int) -> MaskSpec:
    return MaskSpec("chunked", chunk=int(chunk))


def parse_mask(s: str) -> MaskSpec:
    """CLI/config syntax: ``causal`` | ``full`` | ``swa:4096`` |
    ``sliding_window:4096`` | ``chunked:8192``."""
    s = s.strip()
    if s in ("causal", ""):
        return CAUSAL
    if s == "full":
        return FULL
    if ":" in s:
        kind, _, val = s.partition(":")
        kind = kind.strip()
        try:
            n = int(val)
        except ValueError:
            raise ValueError(f"bad mask parameter in {s!r}") from None
        if kind in ("swa", "sliding_window", "window"):
            return sliding_window(n)
        if kind in ("chunked", "chunk"):
            return chunked(n)
    raise ValueError(
        f"unknown mask spec {s!r} (expected causal | full | swa:W |"
        f" chunked:C)")


def coerce_mask(mask) -> MaskSpec:
    """Normalize ``MaskSpec | bool | str`` to a ``MaskSpec``.

    ``True`` → causal, ``False`` → full (the legacy ``causal: bool``
    convention), strings go through :func:`parse_mask`.
    """
    if isinstance(mask, MaskSpec):
        return mask
    if isinstance(mask, bool):
        return CAUSAL if mask else FULL
    if isinstance(mask, str):
        return parse_mask(mask)
    raise TypeError(f"cannot interpret {mask!r} as a MaskSpec")
