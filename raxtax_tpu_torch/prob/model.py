"""Analytic top-hit probability model.

Re-implementation of the reference's non-Bayesian replacement for SINTAX's
Monte-Carlo bootstrap (reference: src/prob.rs:8-170). Given a query with
``K`` distinct 8-mers, ``T = K // 2`` trials (SINTAX samples half the k-mers),
and per-reference intersection sizes ``s``, it computes for every reference
the probability that it attains the maximum draw count when ``T`` k-mers are
drawn from the query's multiset *with replacement* (multiset coefficients).

Structure for TPU-scale throughput:

- the ln-PMF/ln-CMF tables depend only on ``(K, s, i)`` with ``T = K // 2`` —
  **not** on the reference database — so they are memoized per ``K`` and
  shared by every query with the same distinct-k-mer count;
- all O(num_refs) reductions collapse through the intersection-size
  *histogram* (computed on device with an MXU outer-product trick), so the
  f64 stage here touches only ``(K+1) × (T+1)`` tables;
- per-reference probabilities are recovered on device as a gather from the
  returned per-size table.

The math is kept in f64 and mirrors the reference's iterative formulation
(src/prob.rs:121-170) so values agree to ~1 ulp; the final per-size
aggregation is restructured as ``Σ_i exp(pmf-cmf)[s,i] · exp(prod)[i]``
(mathematically identical to src/prob.rs:74-90, relative error ≤ 2 ulp).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy.special import gammaln

from ..utils.trace import span

NEG_INF = float("-inf")


def ln_binomial(n, k):
    """ln C(n, k), matching statrs `ln_binomial` (lgamma formulation)."""
    n = np.asarray(n, dtype=np.float64)
    k = np.asarray(k, dtype=np.float64)
    return gammaln(n + 1.0) - gammaln(k + 1.0) - gammaln(n - k + 1.0)


@dataclass
class KTables:
    """Per-K memoized tables. ``S = K + 1`` sizes, ``T = K // 2`` trials."""

    K: int
    T: int
    ln_z: float  #: ln C(K+T-1, T) — number of possible k-mer multisets
    pmf_ln: np.ndarray  #: f64 [S, T+1]
    cmf_ln: np.ndarray  #: f64 [S, T+1]
    ratio: np.ndarray  #: f64 [S, T+1] = exp(pmf - cmf), 0 where cmf == -inf
    cmf_safe: np.ndarray  #: f64 [S, T+1] with -inf replaced by -1e308
    full_match_probs: np.ndarray  #: f64 [S] — the only_last_pmf fast path


def build_k_tables(K: int, T: int | None = None) -> KTables:
    """Build pmf/cmf tables for all intersection sizes s in [0, K].

    Mirrors `iterative_pmfs_ln` (src/prob.rs:121-170) vectorized over s, and
    `only_last_pmf` (src/prob.rs:105-119). The engine always uses
    ``T = K // 2`` (src/raxtax.rs:57); the override exists for tests.
    """
    if T is None:
        T = K // 2
    S = K + 1
    ln_z = float(ln_binomial(K + T - 1, T)) if K > 0 else 0.0

    s = np.arange(S, dtype=np.float64)[:, None]  # [S, 1]
    i = np.arange(1, T + 1, dtype=np.float64)[None, :]  # [1, T]

    pmf = np.full((S, T + 1), NEG_INF, dtype=np.float64)
    if T >= 0 and S > 2:
        # interior sizes 1..K-1 via the reference's two running scans:
        # possible[i]   = Σ_{j=1..i} ln((s+j-1)/j)
        # impossible[i] = lnC(K-s+T-1, T) - Σ_{j=1..i} ln((K-s+T-j)/(T-j+1)),
        #                 with impossible[T] = 0
        sz = s[1:-1]  # [S-2, 1]
        with np.errstate(divide="ignore"):
            possible = np.cumsum(np.log((sz + i - 1.0) / i), axis=1)
        imp0 = ln_binomial(K - sz[:, 0] + T - 1, T)[:, None]  # [S-2, 1]
        # impossible scan runs i = 1..T-1 then chains 0.0 at i = T
        if T > 1:
            j = np.arange(1, T, dtype=np.float64)[None, :]
            dec = np.log((K - sz + T - j) / (T - j + 1.0))
            impossible_mid = imp0 - np.cumsum(dec, axis=1)  # [S-2, T-1]
        else:
            impossible_mid = np.empty((S - 2, 0), dtype=np.float64)
        impossible = np.concatenate(
            [impossible_mid, np.zeros((S - 2, 1))], axis=1
        )  # [S-2, T]
        pmf[1:-1, 0] = imp0[:, 0] - ln_z
        if T >= 1:
            pmf[1:-1, 1:] = possible + impossible - ln_z
    # s == 0: point mass at i = 0 (src/prob.rs:134-137)
    pmf[0, :] = NEG_INF
    pmf[0, 0] = 0.0
    # s == K: point mass at i = T (src/prob.rs:130-133)
    if S >= 2:
        pmf[-1, :] = NEG_INF
        pmf[-1, T] = 0.0

    # cmf: running ln of the cumulative sum of exp(pmf) (src/prob.rs:49-61)
    with np.errstate(divide="ignore"):
        cmf = np.log(np.cumsum(np.exp(pmf), axis=1))

    neg = cmf == NEG_INF
    with np.errstate(invalid="ignore"):
        ratio = np.exp(pmf - cmf)
    ratio[neg] = 0.0
    cmf_safe = np.where(neg, -1.0e308, cmf)

    # only_last_pmf fast path (src/prob.rs:105-119)
    sz_all = np.arange(S, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        fm = np.exp(ln_binomial(sz_all + T - 1, T) - ln_z)
    fm[0] = 0.0
    fm[-1] = 1.0
    return KTables(
        K=K, T=T, ln_z=ln_z, pmf_ln=pmf, cmf_ln=cmf, ratio=ratio,
        cmf_safe=cmf_safe, full_match_probs=fm,
    )


class KTableCache:
    """LRU memoization of :func:`build_k_tables` keyed by K, bounded by
    BYTES (an entry is ~16K^2 bytes — 5.8 MB at K=600 — so an entry-count
    bound could balloon to GBs on a long-tailed K distribution)."""

    def __init__(self, max_bytes: int = 1 << 30):
        self._cache: dict[int, KTables] = {}
        self._max_bytes = max_bytes
        self._bytes = 0
        #: tables built (misses) since creation
        self.builds = 0

    @staticmethod
    def _entry_bytes(t: KTables) -> int:
        return (
            t.pmf_ln.nbytes
            + t.cmf_ln.nbytes
            + t.ratio.nbytes
            + t.cmf_safe.nbytes
            + t.full_match_probs.nbytes
        )

    def get(self, K: int) -> KTables:
        t = self._cache.get(K)
        if t is None:
            with span("model.ktable_build"):
                t = build_k_tables(K)
            self.builds += 1
            sz = self._entry_bytes(t)
            while self._cache and self._bytes + sz > self._max_bytes:
                oldest = next(iter(self._cache))  # insertion-ordered LRU
                self._bytes -= self._entry_bytes(self._cache.pop(oldest))
            self._cache[K] = t
            self._bytes += sz
        else:
            # refresh LRU position
            self._cache.pop(K)
            self._cache[K] = t
        return t


_default_cache = KTableCache()


def size_probs_from_hist(hist: np.ndarray, K: int, cache: KTableCache | None = None) -> np.ndarray:
    """Unnormalized P(top hit | intersection size s) for s in [0, K].

    `hist[s]` is the number of references with intersection size s (length
    must be ≥ K+1; entries beyond K must be zero). Mirrors
    `highest_hit_prob_per_reference` (src/prob.rs:8-91) up to (not including)
    the final per-reference normalization, which callers perform against
    ``Σ_s hist[s]·probs[s]``.
    """
    cache = cache or _default_cache
    if K == 0:
        # Degenerate query with no valid k-mers: every reference "contains
        # all of them" — uniform probabilities (reference reaches the same
        # via only_last_pmf(0,0,0) == 1.0).
        return np.ones(1, dtype=np.float64)
    t = cache.get(K)
    hist = np.asarray(hist, dtype=np.float64)[: K + 1]
    if hist.shape[0] < K + 1:
        hist = np.pad(hist, (0, K + 1 - hist.shape[0]))
    if hist[K] > 0:
        # some reference contains every query k-mer: closed-form fast path
        return t.full_match_probs.copy()
    # prod[i] = Σ_s hist[s] · cmf_s[i]  (src/prob.rs:62-73); -inf cells were
    # replaced by -1e308 so that hist[s]==0 contributes exactly 0.
    prod = hist @ t.cmf_safe  # [T+1]
    with np.errstate(over="ignore"):
        e = np.exp(prod)
    # probs[s] = Σ_i exp(pmf-cmf)[s,i] · exp(prod[i])  (src/prob.rs:74-90)
    return t.ratio @ e


def normalized_size_probs(
    hist: np.ndarray, K: int, cache: KTableCache | None = None
) -> tuple[np.ndarray, float]:
    """Per-size probabilities normalized so Σ over references is 1.

    Returns (probs_per_size f64 [K+1], probs_sum) where probs_sum is the
    pre-normalization Σ_n probs[size_n] (must be > 0, src/prob.rs:97-98).
    """
    probs = size_probs_from_hist(hist, K, cache)
    hist = np.asarray(hist, dtype=np.float64)[: probs.shape[0]]
    probs_sum = float(hist @ probs)
    assert probs_sum > 0.0, "probability normalization sum must be positive"
    return probs / probs_sum, probs_sum
