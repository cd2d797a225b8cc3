"""K6 and K7, the double-f32 prefix scans, on the CPU: the port's plain
versions against ``dd_cumsum_pallas`` / ``dd_cumsum_pallas_bitmajor`` of the
JAX package (Pallas kernels in interpret mode) on the same numpy inputs.
Tolerance 0 on both words: the port follows the kernel's add tree."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raxtax_tpu.ops import planes as jpl
from raxtax_tpu_torch.ops import planes as tpl
from raxtax_tpu_torch.ops.nodeconf import tip_prob_cumsum_dd


def _probs(rng, shape):
    return (rng.random(shape) * 10.0 ** rng.integers(-9, -1, shape)).astype(
        np.float32
    )


def _same_bits(a, b):
    np.testing.assert_array_equal(
        np.asarray(a).view(np.uint32), b.numpy().view(np.uint32)
    )


def _unprefixed(pair, n):
    """The port's scans return ``[B, n + 1]`` with a leading zero column
    (the JAX ``tip_prob_cumsum_dd`` contract); the JAX kernels return
    ``[B, n]``. Checks the column and drops it."""
    hi, lo = pair
    assert hi.shape[1] == lo.shape[1] == n + 1
    assert not hi[:, 0].any() and not lo[:, 0].any()
    return hi[:, 1:], lo[:, 1:]


# below one 1,024-row tile; exactly one; one and a partial second
@pytest.mark.parametrize("n_rows", [3, 1024, 1024 + 300])
def test_dd_cumsum_equals_jax_kernel(n_rows):
    rng = np.random.default_rng(n_rows)
    x = _probs(rng, (3, n_rows * 128))
    want_hi, want_lo = jpl.dd_cumsum_pallas(jnp.asarray(x), interpret=True)
    hi, lo = _unprefixed(tpl.dd_cumsum(torch.from_numpy(x)), x.shape[1])
    _same_bits(want_hi, hi)
    _same_bits(want_lo, lo)
    exact = np.cumsum(x.astype(np.float64), axis=1)
    got = hi.numpy().astype(np.float64) + lo.numpy().astype(np.float64)
    assert np.abs(got - exact).max() < 1e-11
    # a plain f32 prefix sum is far coarser: the low word carries weight
    assert np.abs(hi.numpy().astype(np.float64) - exact).max() > 1e-9 or n_rows == 3


# S*32 rows per query against 256-row tiles: below one, one, and 1.375
@pytest.mark.parametrize("S", [1, 8, 11])
def test_dd_cumsum_bitmajor_equals_jax_kernel(S):
    rng = np.random.default_rng(S)
    x = _probs(rng, (2, 32, S, 128))
    want_hi, want_lo = jpl.dd_cumsum_pallas_bitmajor(jnp.asarray(x), interpret=True)
    hi, lo = _unprefixed(tpl.dd_cumsum_bitmajor(torch.from_numpy(x)), x[0].size)
    _same_bits(want_hi, hi)
    _same_bits(want_lo, lo)
    tip_order = x.transpose(0, 2, 3, 1).reshape(2, -1).astype(np.float64)
    got = hi.numpy().astype(np.float64) + lo.numpy().astype(np.float64)
    assert np.abs(got - np.cumsum(tip_order, axis=1)).max() < 1e-11


def test_tile_height_changes_the_bits_and_prefix_forms():
    """K6 and K7 add in different trees (1,024 against 256 rows a tile), so
    each is held against its own JAX function, not against the other;
    ``tip_prob_cumsum_dd`` is K6's scan at a multiple of 128 tips; widths that are
    no multiple of 128 take the pairwise tree, as in the JAX package."""
    from raxtax_tpu.ops.nodeconf import tip_prob_cumsum_dd as jcum

    rng = np.random.default_rng(7)
    x = _probs(rng, (2, 32, 16, 128))
    flat = torch.from_numpy(x).permute(0, 2, 3, 1).reshape(2, -1).contiguous()
    hi6, lo6 = _unprefixed(tpl.dd_cumsum(flat), flat.shape[1])
    hi7, lo7 = _unprefixed(tpl.dd_cumsum_bitmajor(torch.from_numpy(x)), flat.shape[1])
    assert not (torch.equal(hi6, hi7) and torch.equal(lo6, lo7))
    d = (hi6.double() + lo6.double()) - (hi7.double() + lo7.double())
    assert float(d.abs().max()) < 1e-11
    hp, lp = tip_prob_cumsum_dd(flat)
    assert torch.equal(hp[:, 1:], hi6) and torch.equal(lp[:, 1:], lo6)
    odd = flat[:, :1000].contiguous()
    want = jcum(jnp.asarray(odd.numpy()), interpret=True)
    got = tip_prob_cumsum_dd(odd)
    _same_bits(want[0], got[0])
    _same_bits(want[1], got[1])
    with pytest.raises(ValueError):
        tpl.dd_cumsum(odd)
    with pytest.raises(TypeError):
        tpl.dd_cumsum(flat.double())
