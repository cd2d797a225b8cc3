"""K1 parity: the port's fold against the JAX package's fused Pallas fold
(interpret mode), bit for bit, and against a numpy count of the postings.

Tolerance 0: the planes are integers."""

import numpy as np
import pytest
import torch

from raxtax_tpu.db.database import build_database
from raxtax_tpu.ops.intersect_pallas import (
    intersection_planes_pallas,
    prepare_kmer_major as jax_prepare,
)
from raxtax_tpu.utils.encoding import encode_sequence, sequence_to_kmers
from raxtax_tpu_torch.ops.intersect_fold import (
    PAD_ROW,
    fold_planes,
    n_high_for,
    planes_to_counts,
    prepare_kmer_major,
)
from tests.test_torch_common import port_db, to_u32


def _world(seed: int, layout: str):
    rng = np.random.default_rng(seed)
    n_refs = 40
    fam = ["".join("ACGT"[i] for i in rng.integers(0, 4, 90)) for _ in range(4)]
    lineages, seqs = [], []
    for i in range(n_refs):
        s = list(fam[i % 4])
        for _ in range(int(rng.integers(0, 8))):
            s[rng.integers(0, len(s))] = "ACGT"[rng.integers(0, 4)]
        seqs.append("".join(s))
        lineages.append(f"a:A{i % 2},b:B{i % 5},c:C{i}")
    db = build_database(
        lineages, [encode_sequence(s) for s in seqs], kmer_layout=layout
    )
    # ragged k-mer counts, one empty query, one longer than a fold step
    qs = [
        encode_sequence(seqs[3]),
        encode_sequence(seqs[17][:20]),
        encode_sequence("ACGT"),  # shorter than one 8-mer: no k-mers
        encode_sequence(fam[1] + fam[2][:40]),
    ]
    kmer_sets = [sequence_to_kmers(q) for q in qs]
    k_pad = 128
    kmer_idx = np.full((len(qs), k_pad), PAD_ROW, np.int32)
    for i, km in enumerate(kmer_sets):
        kmer_idx[i, : km.size] = km
    kcounts = np.array([k.size for k in kmer_sets], np.int64)
    return db, kmer_sets, kmer_idx, kcounts


@pytest.mark.parametrize("layout", ["packed", "flat"])
def test_fold_planes_equal_jax_fused_fold(layout):
    db, kmer_sets, kmer_idx, kcounts = _world(11, layout)
    assert kcounts.min() == 0 and kcounts.max() > 16
    want = np.asarray(
        intersection_planes_pallas(
            kmer_idx, jax_prepare(db, fused_gather=True),
            max_count=kmer_idx.shape[1], interpret=True, kcounts=kcounts,
        )
    )
    pdb = port_db(db)
    km3 = prepare_kmer_major(pdb, "cpu")
    got = fold_planes(
        torch.from_numpy(kmer_idx),
        torch.from_numpy(kcounts.astype(np.int32)),
        km3,
        max_count=kmer_idx.shape[1],
    )
    assert got.dtype == torch.int32
    assert got.shape[1] == 4 + n_high_for(kmer_idx.shape[1]) == want.shape[1]
    np.testing.assert_array_equal(to_u32(got), want)


@pytest.mark.parametrize("layout", ["packed", "flat"])
def test_fold_counts_equal_numpy_postings_count(layout):
    db, kmer_sets, kmer_idx, kcounts = _world(12, layout)
    pdb = port_db(db)
    km3 = prepare_kmer_major(pdb, "cpu")
    planes = fold_planes(
        torch.from_numpy(kmer_idx),
        torch.from_numpy(kcounts.astype(np.int32)),
        km3,
    )
    counts = planes_to_counts(planes, pdb.num_tips, layout).numpy()
    # numpy ground truth from the reference k-mer sets themselves
    ref_sets = [
        set(sequence_to_kmers(pdb.sequence(t)).tolist())
        for t in range(pdb.num_tips)
    ]
    for b, km in enumerate(kmer_sets):
        want = np.array([len(set(km.tolist()) & r) for r in ref_sets])
        np.testing.assert_array_equal(counts[b], want)
    assert (counts[2] == 0).all()  # the empty query


def test_fold_ignores_slots_past_kcount():
    """Ids in slots at or past a query's real k-mer count are never folded
    (the kernel does not read them)."""
    db, kmer_sets, kmer_idx, kcounts = _world(13, "packed")
    pdb = port_db(db)
    km3 = prepare_kmer_major(pdb, "cpu")
    dirty = kmer_idx.copy()
    for b, k in enumerate(kcounts):
        dirty[b, k:] = 7  # garbage past the end
    a = fold_planes(torch.from_numpy(kmer_idx),
                    torch.from_numpy(kcounts.astype(np.int32)), km3)
    b_ = fold_planes(torch.from_numpy(dirty),
                     torch.from_numpy(kcounts.astype(np.int32)), km3)
    assert torch.equal(a, b_)
