"""K10 parity: the port's stream fold (plain version, CPU) against the JAX
package's streaming kernel ``_stream_planes`` in interpret mode, bit for bit,
against the port's own K1 plain version, and ``build_pairs`` against the JAX
one.

Tolerance 0: the planes and the pair lists are integers."""

import numpy as np
import pytest
import torch

from raxtax_tpu.db.database import build_database
from raxtax_tpu.ops.intersect_stream import (
    PAIR_BUCKET,
    ROW_BLOCK,
    build_pairs as jax_build_pairs,
    intersection_planes_stream as jax_planes_stream,
    prepare_kmer_major_stream,
)
from raxtax_tpu.utils.encoding import encode_sequence, sequence_to_kmers
from raxtax_tpu_torch.ops import intersect_stream as ts
from raxtax_tpu_torch.ops.intersect_fold import (
    PAD_ROW,
    fold_planes,
    n_high_for,
    planes_to_counts,
    prepare_kmer_major_sparse,
)
from tests.test_torch_common import port_db, to_u32

BASES = "ACGT"


def _world(layout: str, batch: str):
    """The 30-reference world of the JAX package's stream-kernel test, and a
    batch: ``mixed`` holds two copies of references, a random query and an
    empty one (every slot ``PAD_ROW``); ``pad_only`` holds nothing else."""
    rng = np.random.default_rng(11)
    seqs = ["".join(BASES[i] for i in rng.integers(0, 4, size=240)) for _ in range(30)]
    db = build_database(
        [f"p:P{i % 3},s:S{i}" for i in range(30)],
        [encode_sequence(s) for s in seqs], kmer_layout=layout,
    )
    queries = [encode_sequence(seqs[i]) for i in (1, 9)]
    queries.append(encode_sequence("".join(BASES[i] for i in rng.integers(0, 4, size=230))))
    queries.append(encode_sequence("ACG"))  # no 8-mer: an empty query
    if batch == "pad_only":
        queries = [encode_sequence("AC"), encode_sequence("")]
    kmer_sets = [sequence_to_kmers(s) for s in queries]
    k_pad = -(-max(max(k.size for k in kmer_sets), 1) // 16) * 16
    kidx = np.full((len(queries), k_pad), PAD_ROW, dtype=np.int32)
    for i, km in enumerate(kmer_sets):
        kidx[i, : km.size] = km
    return db, kmer_sets, kidx


@pytest.mark.parametrize("batch", ["mixed", "pad_only"])
@pytest.mark.parametrize("layout", ["packed", "flat"])
def test_stream_planes_equal_jax_stream_kernel(layout, batch):
    db, kmer_sets, kidx = _world(layout, batch)
    k_pad = kidx.shape[1]
    want = np.asarray(
        jax_planes_stream(kidx, prepare_kmer_major_stream(db), max_count=k_pad,
                          interpret=True)
    )
    pdb = port_db(db)
    km3, _, _ = prepare_kmer_major_sparse(pdb, "cpu")  # S % 8 == 0, as there
    got = ts.intersection_planes_stream(torch.from_numpy(kidx), km3, max_count=k_pad)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert got.shape[1] == ts.n_planes_for(k_pad)
    np.testing.assert_array_equal(to_u32(got), want)
    if batch == "pad_only":
        assert not got.any()
    else:
        assert not got[3].any() and got[0].any()  # the empty query, a full one


@pytest.mark.parametrize("layout", ["packed", "flat"])
def test_stream_planes_equal_the_dense_fold_and_the_postings(layout):
    """Same planes as the port's K1 (plain version) on the same batch, for
    one group and for several with a ragged last one; decoded counts equal a
    numpy count of the postings."""
    db, kmer_sets, kidx = _world(layout, "mixed")
    B, k_pad = kidx.shape
    pdb = port_db(db)
    km3, _, _ = prepare_kmer_major_sparse(pdb, "cpu")
    ks = torch.tensor([k.size for k in kmer_sets], dtype=torch.int32)
    idx = torch.from_numpy(kidx)
    dense = fold_planes(idx, ks, km3, max_count=k_pad)
    P = ts.n_planes_for(k_pad)
    assert P == 4 + n_high_for(k_pad) == dense.shape[1]
    for group in (B, 3, 1):
        pairs = ts.build_pairs(idx, group)
        got = ts.fold_planes_stream(*pairs, km3, B, group, P)
        assert torch.equal(got, dense), group
    counts = planes_to_counts(dense, pdb.num_tips, layout).numpy()
    ref_sets = [set(sequence_to_kmers(pdb.sequence(t)).tolist())
                for t in range(pdb.num_tips)]
    for b, km in enumerate(kmer_sets):
        want = np.array([len(set(km.tolist()) & r) for r in ref_sets])
        np.testing.assert_array_equal(counts[b], want)


def test_build_pairs_equals_jax_build_pairs():
    """With one group the pair order is the JAX package's: rows ascending,
    queries ascending within a row, padding slots last. Its padding pairs go
    to a zero row and a bucket boundary; here they stay outside the group's
    range."""
    rng = np.random.default_rng(5)
    B, k_pad = 6, 32
    kidx = np.full((B, k_pad), PAD_ROW, np.int32)
    for b, k in enumerate([32, 0, 7, 20, 1, 16]):
        kidx[b, :k] = np.sort(rng.choice(600, k, replace=False))
    kidx[2, :7] = kidx[0, :7]  # k-mers shared between queries
    n_rows_pad = 65792
    jq, jr, jptr = jax_build_pairs(kidx, n_rows_pad)
    p_qry, p_row, lo, hi = (t.numpy() for t in ts.build_pairs(torch.from_numpy(kidx), B))
    n = B * k_pad
    assert jq.shape[0] == -(-n // PAIR_BUCKET) * PAIR_BUCKET and p_qry.shape == (n,)
    n_real = int((kidx < PAD_ROW).sum())
    assert lo.tolist() == [0] and hi.tolist() == [n_real]
    np.testing.assert_array_equal(p_qry, jq[:n])
    np.testing.assert_array_equal(np.where(p_row >= PAD_ROW, n_rows_pad - 1, p_row), jr[:n])
    assert (p_row[:n_real] < PAD_ROW).all() and (p_row[n_real:] == PAD_ROW).all()
    # the JAX block pointers, recovered from the port's sorted rows
    bounds = np.arange(n_rows_pad // ROW_BLOCK) * ROW_BLOCK
    np.testing.assert_array_equal(
        np.searchsorted(p_row[:n_real], bounds, side="left"), jptr[:-1]
    )


def test_build_pairs_groups_partition_the_batch():
    rng = np.random.default_rng(6)
    B, k_pad, group = 7, 16, 3
    kidx = np.full((B, k_pad), PAD_ROW, np.int32)
    for b in range(B):
        k = int(rng.integers(0, k_pad + 1))
        kidx[b, :k] = np.sort(rng.choice(100, k, replace=False))
    p_qry, p_row, lo, hi = (t.numpy() for t in ts.build_pairs(torch.from_numpy(kidx), group))
    assert lo.shape == hi.shape == (3,)
    seen = []
    for g in range(3):
        q, r = p_qry[lo[g] : hi[g]], p_row[lo[g] : hi[g]]
        assert ((q // group) == g).all() and (np.diff(r) >= 0).all()
        assert (r < PAD_ROW).all()
        same = np.diff(r) == 0
        assert (np.diff(q)[same] > 0).all()  # queries ascend within a row
        seen += list(zip(q.tolist(), r.tolist()))
    want = [(b, int(k)) for b in range(B) for k in kidx[b] if k < PAD_ROW]
    assert sorted(seen) == sorted(want)


def test_group_size_and_argument_checks():
    # the measured group, at most the batch and the kernel's largest
    assert ts.stream_group_size(256, 10) == ts.GROUP_SIZE <= ts.MAX_GROUP
    assert ts.stream_group_size(1, 10) == 1 and ts.stream_group_size(256, 16) >= 1
    assert [ts.n_planes_for(k) for k in (1, 15, 16, 32, 512)] == [1, 4, 5, 6, 10]
    km3 = torch.zeros((65537, 1, 128), dtype=torch.int32)
    idx = torch.full((2, 16), PAD_ROW, dtype=torch.int32)
    pairs = ts.build_pairs(idx, 2)
    with pytest.raises(ValueError):
        ts.fold_planes_stream(*pairs, km3, 2, 1, 5)  # lists made for one group
    with pytest.raises(ValueError):
        ts.fold_planes_stream(*pairs, km3, 2, 2, 17)
    with pytest.raises(ValueError):
        ts.fold_planes_stream(*pairs, km3.reshape(65537, 2, 64), 2, 2, 5)
    assert ts.fold_planes_stream.launches == 0  # the CPU never counts a launch
