"""The port's probability oracle (``raxtax_tpu_torch/prob/oracle.py``)
against the JAX package's, bit for bit on a seeded grid, and the checks of
``tests/test_prob.py`` that use the oracle, run on the port's own oracle and
``prob/model.py``: golden properties from src/prob.rs:182-235 and the
vectorized fast path against the loop-level transcription."""

import numpy as np
import pytest

from raxtax_tpu.prob import oracle as joracle
from raxtax_tpu_torch.prob.model import (
    build_k_tables,
    ln_binomial,
    normalized_size_probs,
)
from raxtax_tpu_torch.prob.oracle import (
    _iterative_pmf_ln,
    _only_last_pmf,
    highest_hit_prob_per_reference,
)


def test_oracle_bit_equal_to_the_jax_oracle_on_a_seeded_grid():
    rng = np.random.default_rng(17)
    for K in (1, 2, 5, 17, 64, 151, 301):
        T = K // 2
        for full in (False, True):
            sizes = rng.integers(0, K + 1 if full else K, size=60)
            if full:
                sizes[0] = K
            want = joracle.highest_hit_prob_per_reference(K, T, sizes)
            got = highest_hit_prob_per_reference(K, T, sizes)
            np.testing.assert_array_equal(got.view(np.uint64), want.view(np.uint64))
        ln_z = float(ln_binomial(K + T - 1, T))
        for s in (0, 1, K // 3, K - 1, K):
            assert _iterative_pmf_ln(K, T, s, ln_z) == joracle._iterative_pmf_ln(
                K, T, s, ln_z
            )
            assert _only_last_pmf(K, T, s, ln_z) == joracle._only_last_pmf(
                K, T, s, ln_z
            )


def _closed_form_pmf(K, i, T, s, ln_z):
    # closed-form PMF from the reference test (src/prob.rs:182-207)
    if s == K:
        return 1.0 if i == T else 0.0
    if s == 0:
        return 1.0 if i == 0 else 0.0
    return float(np.exp(
        ln_binomial(s + i - 1, i) + ln_binomial((K - s) + (T - i) - 1, T - i) - ln_z
    ))


def test_pmf_vs_closed_form():
    # src/prob.rs:208-227 (K=200, T=32, s=50)
    K, T, s = 200, 32, 50
    ln_z = float(ln_binomial(K + T - 1, T))
    iterative = _iterative_pmf_ln(K, T, s, ln_z)
    closed = [_closed_form_pmf(K, i, T, s, ln_z) for i in range(T + 1)]
    assert abs(sum(np.exp(p) for p in iterative) - 1.0) < 1e-7
    assert abs(sum(closed) - 1.0) < 1e-7
    for a, b in zip(iterative, closed):
        assert abs(np.exp(a) - b) < 1e-7
    # the vectorized table row matches the scalar oracle
    t = build_k_tables(K, T)
    np.testing.assert_allclose(t.pmf_ln[s], iterative, rtol=1e-12, atol=1e-12)


def test_hit_prob_monotone_and_normalized():
    # src/prob.rs:229-235: probs over sizes 0..400 with K=400, T=200
    probs = highest_hit_prob_per_reference(400, 200, np.arange(401))
    assert abs(probs.sum() - 1.0) < 1e-7
    assert (np.diff(probs) >= 0).all()


def test_fast_path_matches_oracle():
    from raxtax_tpu_torch.prob.model import KTableCache

    rng = np.random.default_rng(0)
    cache = KTableCache()
    for K in [5, 17, 64, 301]:
        sizes = rng.integers(0, K, size=200)  # no full match
        hist = np.bincount(sizes, minlength=K + 1)
        probs_size, _ = normalized_size_probs(hist, K, cache)
        expected = highest_hit_prob_per_reference(K, K // 2, sizes)
        np.testing.assert_allclose(probs_size[sizes], expected, rtol=1e-9, atol=1e-300)


def test_full_match_fast_path():
    K = 40
    sizes = np.array([0, 3, 20, 40, 40])
    hist = np.bincount(sizes, minlength=K + 1)
    probs_size, _ = normalized_size_probs(hist, K)
    expected = highest_hit_prob_per_reference(K, K // 2, sizes)
    np.testing.assert_allclose(probs_size[sizes], expected, rtol=1e-12)
    # full matches dominate
    assert probs_size[40] > probs_size[20] > probs_size[3]
    assert probs_size[0] == 0.0


@pytest.mark.parametrize("K", [1, 2, 3])
def test_tiny_k(K):
    sizes = np.zeros(5, dtype=int)
    hist = np.bincount(sizes, minlength=K + 1)
    probs_size, _ = normalized_size_probs(hist, K)
    expected = highest_hit_prob_per_reference(K, K // 2, sizes)
    np.testing.assert_allclose(probs_size[sizes], expected, rtol=1e-12)
