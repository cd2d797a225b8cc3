"""K3 parity and the plane helpers: the port's plane histogram, tip zeroing
and row decoding against the JAX package's Pallas kernels (interpret mode)
and numpy. Tolerance 0: integers. The table lookups (K4) are in
``test_torch_planes_probs.py`` and ``test_torch_planes_mux.py``: no file of
the port's slow parity tests holds more than ten tests (ROADMAP, tier-1's
clock).

``world`` is the fixture the three files share."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raxtax_tpu.ops.planes import (
    planes_histogram as jax_hist,
    zero_tips_in_planes as jax_zero,
)
from raxtax_tpu_torch.ops.intersect_fold import planes_to_counts
from raxtax_tpu_torch.ops.planes import (
    decode_plane_rows,
    planes_histogram,
    zero_tips_in_planes,
)
from tests.test_torch_common import TIPS_PER_WORD, encode_planes, to_i32, to_u32


@pytest.fixture(params=[(2, 1), (3, 3)], ids=["S1", "S3"])
def world(request):
    B, S = request.param
    rng = np.random.default_rng(42 + S)
    n_pad = S * 128 * TIPS_PER_WORD
    num_tips = int(n_pad - rng.integers(1, 128 * TIPS_PER_WORD))  # ragged tail
    counts = np.zeros((B, n_pad), np.int64)
    counts[:, :num_tips] = rng.integers(0, 100, size=(B, num_tips))
    hot = rng.integers(0, num_tips, size=20)
    counts[:, hot] = rng.integers(100, 128, size=(B, 20))
    planes = encode_planes(counts, n_planes=7)  # counts < 128
    return counts, planes, num_tips


def test_histogram_equals_jax_kernel_and_bincount(world):
    counts, planes, num_tips = world
    s_max = 128
    want = np.asarray(jax_hist(jnp.asarray(planes), s_max, num_tips, interpret=True))
    got = planes_histogram(to_i32(planes), s_max, num_tips)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    for b in range(counts.shape[0]):
        np.testing.assert_array_equal(
            got[b].numpy(), np.bincount(counts[b, :num_tips], minlength=s_max)
        )


def test_histogram_drops_counts_past_s_max(world):
    """s_max below the largest count: those tips are dropped, as the JAX
    kernel drops values it has no bucket for."""
    counts, planes, num_tips = world
    s_max = 64
    want = np.asarray(jax_hist(jnp.asarray(planes), s_max, num_tips, interpret=True))
    got = planes_histogram(to_i32(planes), s_max, num_tips).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("layout", ["packed", "flat"])
def test_zero_tips_equal_jax_both_layouts(world, layout):
    counts, planes, num_tips = world
    B = counts.shape[0]
    rng = np.random.default_rng(5)
    ids = np.full((B, 6), -1, np.int32)
    for b in range(B):
        n = int(rng.integers(0, 6))
        ids[b, :n] = rng.choice(num_tips, size=n, replace=False)
    ids[0, :3] = [0, 31, num_tips - 1]  # both ends of a word, bit 31
    want = np.asarray(jax_zero(jnp.asarray(planes), jnp.asarray(ids), layout=layout))
    got = zero_tips_in_planes(to_i32(planes), torch.from_numpy(ids), layout=layout)
    np.testing.assert_array_equal(to_u32(got), want)
    c = planes_to_counts(got, num_tips, layout).numpy()
    c0 = planes_to_counts(to_i32(planes), num_tips, layout).numpy()
    for b in range(B):
        sel = ids[b][ids[b] >= 0]
        assert (c[b, sel] == 0).all()
        keep = np.ones(num_tips, bool)
        keep[sel] = False
        np.testing.assert_array_equal(c[b, keep], c0[b, keep])


def test_decode_plane_rows_is_the_count_row(world):
    counts, planes, num_tips = world
    rows = decode_plane_rows(to_i32(planes), [1, 0], "packed").numpy()
    np.testing.assert_array_equal(rows[0, :num_tips], counts[1, :num_tips])
    np.testing.assert_array_equal(rows[1, :num_tips], counts[0, :num_tips])
