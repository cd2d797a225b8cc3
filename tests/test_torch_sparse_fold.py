"""K2, the block-sparse fold, on the CPU: the port's plain version against
the JAX package's ``intersection_planes_sparse`` (its Pallas kernel in
interpret mode) and against the port's dense fold, bit for bit, on the same
pairs made from a numpy seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raxtax_tpu.ops import intersect_pallas as jp
from raxtax_tpu_torch.convert import device_state
from raxtax_tpu_torch.db.database import ensure_kmer_layout
from raxtax_tpu_torch.ops import intersect_fold as tf
from raxtax_tpu_torch.utils.encoding import sequence_to_kmers
from tests.test_fuzz_parity import make_world
from tests.test_torch_common import port_db, to_i32, to_u32

PAD = tf.PAD_ROW


def _kmer_idx(queries, k_pad, n_rows):
    idx = np.full((n_rows, k_pad), PAD, np.int32)
    ks = np.zeros(n_rows, np.int32)
    for i, (_, s) in enumerate(queries):
        k = sequence_to_kmers(s)
        idx[i, : k.size] = k
        ks[i] = k.size
    return idx, ks


@pytest.mark.parametrize("layout", ["packed", "flat"])
def test_sparse_fold_equals_jax_and_dense(layout):
    """A real small world in both layouts; the batch carries a query with
    no k-mers at all (no pairs). Few short queries: the interpreted Pallas
    kernel costs seconds per query and step."""
    jdb, queries = make_world(9100)
    queries = sorted(queries, key=lambda q: len(q[1]))[:2]
    db = port_db(jdb)
    if layout == "flat":
        from raxtax_tpu.db.database import ensure_kmer_layout as jensure

        jdb = jensure(jdb, "flat")
        db = ensure_kmer_layout(db, "flat")
    km3j, blk_ptr, blk_ids = jp.prepare_kmer_major_sparse(jdb)
    st = device_state(db, "cpu", sparse=True)
    assert st.kmer_major3.shape[1] % tf.BLOCK_SUB == 0
    np.testing.assert_array_equal(np.asarray(km3j), to_u32(st.kmer_major3))
    np.testing.assert_array_equal(blk_ptr, st.blk_ptr)
    np.testing.assert_array_equal(blk_ids, st.blk_ids)
    kmer_idx, ks = _kmer_idx(queries, 128, 3)
    want_pairs = jp.build_pairs(kmer_idx, blk_ptr, blk_ids, 1 << 20)
    got_pairs = tf.build_pairs(kmer_idx, st.blk_ptr, st.blk_ids, 1 << 20)
    for w, g in zip(want_pairs, got_pairs):
        np.testing.assert_array_equal(w, g)
    pair_kmer, pair_blk, _, totals = got_pairs
    assert (totals[len(queries):] == 0).all()
    want = np.asarray(jp.intersection_planes_sparse(
        pair_kmer, pair_blk, km3j, max_count=128, interpret=True, totals=totals
    ))
    got = tf.fold_planes_sparse(
        torch.from_numpy(pair_kmer), torch.from_numpy(pair_blk),
        torch.from_numpy(totals.astype(np.int32)), st.kmer_major3, max_count=128,
    )
    np.testing.assert_array_equal(want, to_u32(got))
    dense = tf.fold_planes(
        torch.from_numpy(kmer_idx), torch.from_numpy(ks), st.kmer_major3,
        max_count=128,
    )
    assert torch.equal(got, dense)
    assert not got[len(queries):].any()


def test_sparse_fold_over_several_blocks_equals_jax():
    """A synthetic postings matrix of three 8 x 128-word blocks whose rows
    post in one to three of them: the block index math, blocks a query never
    touches, and the grouping of pairs by block."""
    rng = np.random.default_rng(3)
    n_rows, n_blocks = 301, 3  # row 300 is the zero row
    km = np.zeros((n_rows, n_blocks * tf.BLOCK_WORDS), np.uint32)
    for k in range(n_rows - 1):
        for blk in rng.choice(n_blocks, size=rng.integers(1, 4), replace=False):
            pos = rng.choice(tf.BLOCK_WORDS, size=60, replace=False)
            km[k, blk * tf.BLOCK_WORDS + pos] |= rng.integers(
                0, 1 << 32, size=60, dtype=np.uint64
            ).astype(np.uint32)
    km[:40, tf.BLOCK_WORDS :] = 0  # k-mers below 40 post in block 0 only
    nz = km.reshape(n_rows, n_blocks, -1).any(axis=2)
    blk_ptr = np.zeros(PAD + 2, np.int64)
    np.cumsum(nz.sum(axis=1), out=blk_ptr[1 : n_rows + 1])
    blk_ptr[n_rows + 1 :] = blk_ptr[n_rows]
    blk_ids = np.nonzero(nz)[1].astype(np.int32)
    B, k_pad = 4, 64
    kmer_idx = np.full((B, k_pad), PAD, np.int32)
    ks = np.zeros(B, np.int32)
    for b, (n, hi) in enumerate(((50, 300), (17, 40), (0, 300), (64, 300))):
        kmer_idx[b, :n] = np.sort(rng.choice(hi, size=n, replace=False))
        ks[b] = n
    pair_kmer, pair_blk, max_pairs, totals = tf.build_pairs(
        kmer_idx, blk_ptr, blk_ids, 1 << 20
    )
    assert max_pairs > k_pad and totals[2] == 0
    pad_row = n_rows - 1  # the small matrix's own zero row, for both sides
    small = np.where(pair_kmer == PAD, pad_row, pair_kmer).astype(np.int32)
    want = np.asarray(jp.intersection_planes_sparse(
        small, pair_blk, jnp.asarray(km.reshape(n_rows, -1, 128)),
        max_count=k_pad, interpret=True, totals=totals,
    ))
    km3 = to_i32(km).reshape(n_rows, -1, 128)
    t_tot = torch.from_numpy(totals.astype(np.int32))
    got = tf.fold_planes_sparse(
        torch.from_numpy(small), torch.from_numpy(pair_blk), t_tot, km3,
        max_count=k_pad,
    )
    np.testing.assert_array_equal(want, to_u32(got))
    assert not got[1, :, tf.BLOCK_SUB :].any() and not got[2].any()
    # the counts the planes spell, recomputed from the raw bit matrix
    counts = tf.planes_to_counts(got, km.shape[1] * 32, "packed").numpy()
    for b in range(B):
        rows = km[kmer_idx[b, : ks[b]]]
        bits = (rows[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
        np.testing.assert_array_equal(
            counts[b], bits.sum(axis=0).reshape(-1), err_msg=f"query {b}"
        )
    # the grouping the CUDA kernel is handed: block j of query b
    by_blk, off = tf.group_pairs_by_block(
        torch.from_numpy(small), torch.from_numpy(pair_blk), t_tot, n_blocks
    )
    assert off[:, -1].tolist() == totals.tolist() and (off[:, 0] == 0).all()
    for b in range(B):
        for j in range(n_blocks):
            want_k = sorted(small[b, : totals[b]][pair_blk[b, : totals[b]] == j])
            assert sorted(by_blk[b, off[b, j] : off[b, j + 1]].tolist()) == want_k


def test_build_pairs_over_budget_and_shape_checks():
    jdb, queries = make_world(9100)
    st = device_state(port_db(jdb), "cpu", sparse=True)
    kmer_idx, _ = _kmer_idx(queries, 256, 8)
    assert tf.build_pairs(kmer_idx, st.blk_ptr, st.blk_ids, budget=3) is None
    dense_state = device_state(port_db(jdb), "cpu")
    assert dense_state.blk_ptr is None
    z = torch.zeros((2, 16), dtype=torch.int32)
    with pytest.raises(ValueError):
        tf.fold_planes_sparse(
            z, z, torch.zeros(2, dtype=torch.int32),
            torch.zeros((5, 3, 128), dtype=torch.int32), max_count=16,
        )
