"""Context-length distributions (paper Fig. 2, Fig. 15a, Fig. 16a).

The paper's internal pretraining trace is "long-tailed up to 512K,
approximately following a lognormal distribution".  We provide:

* ``real_world``     — heavy-tailed lognormal clipped to [128, 512K]
  (Fig. 2): sigma 1.4 around a ~8K median;
* ``less_long_tailed`` — lognormal s=0.7, mean 16K (Fig. 15a);
* ``bimodal``        — mix of lognormals s=0.5 at means 16K and 64K
  (Fig. 16a);
* ``uniform``        — every document the same length (the assigned
  fixed-shape cells).
"""

from __future__ import annotations

import numpy as np

MIN_LEN, MAX_LEN = 128, 524288


def _lognormal_mean(mean: float, sigma: float, rng, n: int) -> np.ndarray:
    # E[lognormal(mu, s)] = exp(mu + s^2/2)
    mu = np.log(mean) - sigma ** 2 / 2
    return rng.lognormal(mu, sigma, size=n)


def sample_lengths(dist: str, n: int, seed: int = 0,
                   uniform_len: int = 4096) -> list[int]:
    rng = np.random.default_rng(seed)
    if dist == "uniform":
        x = np.full(n, uniform_len, dtype=np.int64)
    elif dist == "real_world":
        x = _lognormal_mean(16384, 1.4, rng, n)
    elif dist == "less_long_tailed":
        x = _lognormal_mean(16384, 0.7, rng, n)
    elif dist == "bimodal":
        a = _lognormal_mean(16384, 0.5, rng, n)
        b = _lognormal_mean(65536, 0.5, rng, n)
        pick = rng.random(n) < 0.5
        x = np.where(pick, a, b)
    else:
        raise ValueError(f"unknown distribution {dist!r}")
    return np.clip(x.astype(np.int64), MIN_LEN, MAX_LEN).tolist()


def sample_composition(dist: str, token_budget: int, seed: int = 0,
                       uniform_len: int = 4096) -> list[int]:
    """One length multiset filling exactly ``token_budget`` tokens."""
    lens = sample_lengths(dist, 4 * max(1, token_budget // 4096),
                          seed=seed, uniform_len=uniform_len)
    chosen: list[int] = []
    tot = 0
    for L in lens:
        L = min(L, token_budget - tot)
        if L < MIN_LEN // 2:
            break
        chosen.append(int(L))
        tot += L
        if tot >= token_budget:
            break
    if tot < token_budget and chosen:
        chosen[-1] += token_budget - tot           # top up the last doc
    return chosen


def batch_compositions(dist: str, token_budget: int, n_buckets: int,
                       seed: int = 0, uniform_len: int = 4096
                       ) -> list[list[int]]:
    """Sample ``n_buckets`` length multisets, each filling ``token_budget``
    tokens.  Training reuses these compositions round-robin so each
    distinct FCP schedule compiles once (DESIGN.md §2: schedule-class
    static compilation)."""
    return [sample_composition(dist, token_budget, seed=seed * 1000 + b,
                               uniform_len=uniform_len)
            for b in range(n_buckets)]
