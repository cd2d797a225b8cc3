"""K9 parity: the port's gathered-rows fold (plain version, CPU) against the
JAX package's ``_hs_planes`` kernel in interpret mode (through its XLA row
gather, chunked and whole), bit for bit, and against the port's own K1 plain
version.

Tolerance 0: the planes are integers."""

import numpy as np
import pytest
import torch

from raxtax_tpu.ops.intersect_pallas import (
    intersection_planes_pallas,
    prepare_kmer_major as jax_prepare,
)
from raxtax_tpu_torch.ops.intersect_fold import (
    fold_planes,
    fold_planes_gathered,
    fold_planes_gathered_plain,
    gather_chunk,
    intersection_planes_gathered,
    n_high_for,
    prepare_kmer_major,
)
from tests.test_torch_common import port_db, to_u32
from tests.test_torch_stream_fold import _world


@pytest.mark.parametrize("batch", ["mixed", "pad_only"])
@pytest.mark.parametrize("layout", ["packed", "flat"])
def test_gathered_planes_equal_jax_hs_kernel(layout, batch):
    """The JAX package's default for ``RAXTAX_SPARSE_FOLD=0``: a 2-D matrix,
    an XLA row gather, then ``_hs_planes``."""
    db, kmer_sets, kidx = _world(layout, batch)
    k_pad = kidx.shape[1]
    km2 = jax_prepare(db, fused_gather=False)
    assert km2.ndim == 2
    want = np.asarray(
        intersection_planes_pallas(kidx, km2, max_count=k_pad, interpret=True)
    )
    pdb = port_db(db)
    km3 = prepare_kmer_major(pdb, "cpu")
    got = intersection_planes_gathered(torch.from_numpy(kidx), km3, max_count=k_pad)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(to_u32(got), want)
    if batch == "mixed":
        assert not got[3].any() and got[0].any()
    else:
        assert not got.any()


@pytest.mark.parametrize("layout", ["packed", "flat"])
def test_gathered_chunks_equal_jax_chunks_and_the_dense_fold(layout):
    """A gather budget of two queries' rows: both packages fold the batch in
    chunks and give the planes of the unchunked fold and of K1."""
    db, kmer_sets, kidx = _world(layout, "mixed")
    B, k_pad = kidx.shape
    pdb = port_db(db)
    km3 = prepare_kmer_major(pdb, "cpu")
    row_bytes = km3.shape[1] * km3.shape[2] * 4
    budget = 2 * k_pad * row_bytes
    assert gather_chunk(B, k_pad, row_bytes, budget) == 2
    assert gather_chunk(B, k_pad, row_bytes, 1) == 1  # never below one query
    assert gather_chunk(B, k_pad, row_bytes) == B
    want = np.asarray(
        intersection_planes_pallas(
            kidx, jax_prepare(db, fused_gather=False), max_count=k_pad,
            interpret=True, gather_budget_bytes=budget,
        )
    )
    idx = torch.from_numpy(kidx)
    got = intersection_planes_gathered(idx, km3, max_count=k_pad, budget_bytes=budget)
    np.testing.assert_array_equal(to_u32(got), want)
    assert torch.equal(got, intersection_planes_gathered(idx, km3, max_count=k_pad))
    ks = torch.tensor([k.size for k in kmer_sets], dtype=torch.int32)
    assert torch.equal(got, fold_planes(idx, ks, km3, max_count=k_pad))


def test_gathered_fold_reads_every_slot_and_checks_its_arguments():
    rng = np.random.default_rng(9)
    rows = torch.from_numpy(
        rng.integers(0, 2**32, size=(2 * 32, 1, 128), dtype=np.uint64)
        .astype(np.uint32).view(np.int32)
    )
    got = fold_planes_gathered(rows, 2, n_high_for(32))
    assert torch.equal(got, fold_planes_gathered_plain(rows, 2, n_high_for(32)))
    # plane p holds bit p of the column sums: check one word by hand
    bits = (rows[:32, 0, 5].numpy().view(np.uint32)[:, None] >> np.arange(32)) & 1
    sums = bits.sum(axis=0)
    word = sum(
        ((to_u32(got)[0, p, 0, 5] >> np.arange(32)) & 1).astype(np.int64) << p
        for p in range(got.shape[1])
    )
    np.testing.assert_array_equal(word, sums)
    with pytest.raises(ValueError):
        fold_planes_gathered(rows[:40], 2, 2)  # 20 rows a query: not 16-fold
    with pytest.raises(ValueError):
        fold_planes_gathered(rows, 3, 2)
    with pytest.raises(ValueError):
        fold_planes_gathered(rows.reshape(64, 2, 64), 2, 2)
    assert fold_planes_gathered.launches == 0
