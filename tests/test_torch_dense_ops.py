"""The dense-count (``xla``) backend's ops against the JAX package's, on the
same numpy inputs: bit unpacking and popcount, the count matrix, the
histogram and the table lookup. (The nibble wire is held in
``test_torch_compress.py``, the significance stage in
``test_torch_dense_sig.py``.)

Tolerance 0 everywhere: counts and histograms are integers and the lookup
selects one f32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raxtax_tpu.ops import bitops as jbit
from raxtax_tpu.ops import nodeconf as jnc
from raxtax_tpu.ops.histogram import intersection_histogram as jax_histogram
from raxtax_tpu.ops.intersect_xla import (
    intersection_counts_xla as jax_counts,
    zero_reference_ids as jax_zero_ids,
)
from raxtax_tpu_torch.ops import bitops, nodeconf
from raxtax_tpu_torch.ops.histogram import intersection_histogram
from raxtax_tpu_torch.ops.intersect_xla import (
    intersection_counts_xla,
    zero_reference_ids,
)
from tests.test_torch_common import to_i32


def _words(rng, shape, density=0.5):
    w = rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    if density < 0.5:
        w &= rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
        w &= rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    return w


def _bits(a: torch.Tensor) -> np.ndarray:
    return a.numpy().view(np.uint32)


def test_unpack_bits_and_popcount_equal_jax():
    rng = np.random.default_rng(0)
    w = _words(rng, (3, 5))
    w[0, 0], w[0, 1], w[0, 2] = 0xFFFFFFFF, 0x80000000, 0
    got = bitops.unpack_bits(to_i32(w))
    want = np.asarray(jbit.unpack_bits(jnp.asarray(w), jnp.float32))
    assert got.shape == (3, 160) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    pc = bitops.popcount_u32(to_i32(w))
    np.testing.assert_array_equal(
        pc.numpy(), np.asarray(jbit.popcount_u32(jnp.asarray(w))).astype(np.int32)
    )
    assert pc[0, :3].tolist() == [32, 1, 0]


@pytest.mark.parametrize("n_refs", [1, 37, 130])
def test_counts_equal_jax_bit_matmul_and_popcount(n_refs):
    rng = np.random.default_rng(n_refs)
    q = _words(rng, (4, 2048), density=0.1)
    r = _words(rng, (n_refs, 2048), density=0.1)
    q[3] = 0  # an empty query
    got = intersection_counts_xla(to_i32(q), to_i32(r))
    want = np.asarray(jax_counts(jnp.asarray(q), jnp.asarray(r)))
    assert got.dtype == torch.float32 and got.shape == (4, n_refs)
    np.testing.assert_array_equal(got.numpy(), want)
    pop = bitops.popcount_u32(to_i32(q)[:, None, :] & to_i32(r)[None]).sum(dim=2)
    np.testing.assert_array_equal(got.numpy(), pop.numpy().astype(np.float32))
    assert not got[3].any() and got.max() > 15


def test_counts_in_chunks_of_references(monkeypatch):
    from raxtax_tpu_torch.ops import intersect_xla

    rng = np.random.default_rng(3)
    q, r = _words(rng, (2, 2048), 0.1), _words(rng, (21, 2048), 0.1)
    whole = intersection_counts_xla(to_i32(q), to_i32(r))
    monkeypatch.setattr(intersect_xla, "REF_CHUNK", 8)
    assert torch.equal(intersection_counts_xla(to_i32(q), to_i32(r)), whole)
    with pytest.raises(ValueError):
        intersection_counts_xla(to_i32(q), to_i32(r), slab_words=100)


def test_zero_reference_ids_equals_jax():
    rng = np.random.default_rng(4)
    counts = rng.integers(1, 50, size=(3, 40)).astype(np.float32)
    ids = np.array([[5, 39, -1], [-1, -1, -1], [0, -1, -1]], np.int32)
    want = np.asarray(jax_zero_ids(jnp.asarray(counts), jnp.asarray(ids)))
    got = zero_reference_ids(torch.from_numpy(counts.copy()), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 5] == 0 and got[0, 39] == 0 and got[2, 0] == 0 and got[1].all()


@pytest.mark.parametrize("s_max", [32, 64, 128])
def test_histogram_equals_jax_outer_product_histogram(s_max):
    rng = np.random.default_rng(s_max)
    counts = rng.integers(0, 40, size=(5, 333)).astype(np.float32)
    counts[4] = 0
    got = intersection_histogram(torch.from_numpy(counts), s_max)
    want = np.asarray(jax_histogram(jnp.asarray(counts), s_max))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if s_max == 32:  # counts past the last bucket land nowhere, as there
        assert got.sum() < counts.size
    elif s_max == 64:
        assert got.sum() == counts.size and not got[:, 40:].any()
    else:
        assert got.sum(dim=1).tolist() == [333] * 5 and got[4, 0] == 333


def test_gather_table_equals_jax_one_hot_lookup():
    rng = np.random.default_rng(6)
    counts = rng.integers(0, 70, size=(3, 500)).astype(np.float32)
    table = rng.random((3, 64)).astype(np.float32) * 1e-3
    got = nodeconf.gather_table(torch.from_numpy(counts), torch.from_numpy(table))
    want = np.asarray(jnc.gather_table(jnp.asarray(counts), jnp.asarray(table)))
    np.testing.assert_array_equal(_bits(got), want.view(np.uint32))
    assert (got[torch.from_numpy(counts) >= 64] == 0).all()
