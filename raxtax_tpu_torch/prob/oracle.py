"""Reference-structured probability oracle.

Direct, loop-level transcription of `highest_hit_prob_per_reference`
(reference: src/prob.rs:8-103) used to validate the vectorized/memoized fast
path in :mod:`raxtax_tpu_torch.prob.model`. Slow by design; test/debug
only. The port's own copy of the JAX package's oracle, on this package's
``ln_binomial``.
"""

from __future__ import annotations

import math

import numpy as np

from .model import ln_binomial

NEG_INF = float("-inf")


def _only_last_pmf(K: int, T: int, s: int, ln_z: float) -> float:
    if s == K:
        return 1.0
    if s == 0:
        return 0.0
    return math.exp(float(ln_binomial(s + T - 1, T)) - ln_z)


def _iterative_pmf_ln(K: int, T: int, s: int, ln_z: float) -> list[float]:
    if s == K:
        res = [NEG_INF] * (T + 1)
        res[T] = 0.0
        return res
    if s == 0:
        res = [NEG_INF] * (T + 1)
        res[0] = 0.0
        return res
    possible = []
    acc = 0.0
    for i in range(1, T + 1):
        acc += math.log((s + i - 1) / i)
        possible.append(acc)
    imp0 = float(ln_binomial(K - s + T - 1, T))
    impossible = []
    acc = imp0
    for i in range(1, T):
        acc -= math.log((K - s + T - i) / (T - i + 1))
        impossible.append(acc)
    impossible.append(0.0)
    return [imp0 - ln_z] + [p + im - ln_z for p, im in zip(possible, impossible)]


def highest_hit_prob_per_reference(
    total_num_k_mers: int, num_trials: int, intersection_sizes
) -> np.ndarray:
    """Normalized per-reference top-hit probabilities (src/prob.rs:8-103)."""
    K, T = total_num_k_mers, num_trials
    sizes = [int(s) for s in intersection_sizes]
    counts: dict[int, int] = {}
    for s in sizes:
        counts[s] = counts.get(s, 0) + 1
    ln_z = float(ln_binomial(K + T - 1, T))
    if any(s == K for s in counts):
        probs_by_size = {s: _only_last_pmf(K, T, s, ln_z) for s in counts}
    else:
        pmfs = {s: _iterative_pmf_ln(K, T, s, ln_z) for s in counts}
        cmfs = {}
        for s, pmf in pmfs.items():
            run = 0.0
            out = []
            for p in pmf:
                if p != NEG_INF:
                    run += math.exp(p)
                out.append(math.log(run) if run > 0.0 else NEG_INF)
            cmfs[s] = out
        prod = [
            sum(c * cmfs[s][i] for s, c in counts.items())
            for i in range(T + 1)
        ]
        probs_by_size = {}
        for s in counts:
            total = 0.0
            for p, c, pr in zip(pmfs[s], cmfs[s], prod):
                if c == NEG_INF or pr == NEG_INF:
                    continue
                total += math.exp(p + pr - c)
            probs_by_size[s] = total
    probs = np.array([probs_by_size[s] for s in sizes], dtype=np.float64)
    total = probs.sum()
    assert total > 0.0
    return probs / total
