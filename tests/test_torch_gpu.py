"""The CUDA kernels against their plain versions, on the GPU.

These tests need an NVIDIA GPU and ``nvcc``; elsewhere they skip. Run them
on a GPU machine with ``python -m pytest tests/test_torch_gpu.py -m gpu``
(``python3 chip_smoke.py`` makes the same comparisons at full size)."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    # decided here, inside a fixture, never at import time
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no interpret mode")
    return torch.device("cuda")


def _planes(rng, B, P, S):
    return torch.from_numpy(
        rng.integers(0, 2**32, size=(B, P, S, 128), dtype=np.uint64)
        .astype(np.uint32).view(np.int32)
    )


@pytest.mark.parametrize(
    "n_lanes,sorted_ids,k_pad,cut",
    # through the wrapper a row is 32 * n_lanes uint4, always whole 32-column
    # slices; cut > 0 calls the C entry on rows cut uint4 short, so the last
    # slice is partly past the row's end. Ids in any order; more ids than one
    # shared-memory chunk of 1024
    [(2, True, 128, 0), (5, False, 128, 0), (9, True, 1100, 0),
     (9, False, 1100, 0), (4, False, 128, 25), (3, True, 1100, 1)],
)
def test_fold_kernel_equals_plain(cuda, n_lanes, sorted_ids, k_pad, cut):
    from raxtax_tpu_torch.ops import _build
    from raxtax_tpu_torch.ops import intersect_fold as tf

    rng = np.random.default_rng(0)
    km = torch.from_numpy(
        rng.integers(0, 2**32, size=(65537, n_lanes, 128), dtype=np.uint64)
        .astype(np.uint32).view(np.int32)
    )
    km[65536] = 0
    kc = np.array([0, 5, 16, 17, 100, k_pad], np.int32)
    if k_pad > 1024:
        kc[4] = 1024 + 37
    idx = np.full((6, k_pad), 65536, np.int32)
    for b, k in enumerate(kc):
        ids = rng.choice(65536, k, replace=False)
        idx[b, :k] = np.sort(ids) if sorted_ids else ids
    args = [torch.from_numpy(idx).to(cuda), torch.from_numpy(kc).to(cuda), km.to(cuda)]
    n_high = tf.n_high_for(k_pad)
    want = tf.fold_planes_plain(*args, n_high)
    if not cut:
        assert torch.equal(tf.fold_planes(*args), want)
        return
    # the fold is column by column: a short row's planes are the first
    # words of the full row's
    W = (32 * n_lanes - cut) * 4
    rows = args[2].reshape(65537, -1)[:, :W].contiguous()
    got = torch.empty((6, 4 + n_high, W), dtype=torch.int32, device=cuda)
    fn = _build.entry("fold_planes", "rx_fold_planes", tf._ARGTYPES)
    code = fn(args[0].data_ptr(), args[1].data_ptr(), rows.data_ptr(),
              got.data_ptr(), 6, k_pad, W, n_high,
              torch.cuda.current_stream().cuda_stream)
    _build.check("fold_planes", code, "fold_planes")
    assert torch.equal(got, want.reshape(6, 4 + n_high, -1)[:, :, :W])


def test_hist_and_probs_kernels_equal_plain(cuda):
    from raxtax_tpu_torch.ops import planes as pl

    rng = np.random.default_rng(1)
    p = _planes(rng, 3, 7, 3).to(cuda)
    num_tips = 3 * 128 * 32 - 77
    assert torch.equal(
        pl.planes_histogram(p, 128, num_tips),
        pl.planes_histogram_plain(p, 128, num_tips),
    )
    for dtype in (torch.float32, torch.float64):
        tab = torch.from_numpy(rng.random((3, 100))).to(dtype).to(cuda)
        for mux, zh in ((None, False), (4, True), (6, False)):
            a = pl.planes_probs(p, tab, mux_bits=mux, zero_high=zh)
            b = pl.planes_probs_plain(p, tab, mux_bits=mux, zero_high=zh)
            assert torch.equal(a, b)


def _scan_tile() -> int:
    import re
    from pathlib import Path

    src = Path(__file__).resolve().parent.parent / "raxtax_tpu_torch/csrc/exact_cumsum.cu"
    return int(re.search(r"SCAN_TILE = (\d+);", src.read_text()).group(1))


@pytest.mark.parametrize("b", [1, 3, 11, 133])
@pytest.mark.parametrize(
    "tiles,extra",
    # N = tiles * SCAN_TILE + extra: nothing, one tip, a tile but one, a tile
    # and one, and two lengths past the ring of four slots, the longer one
    # wrapping it and ending in a partial tile
    [(0, 0), (0, 1), (1, -1), (1, 1), (3, 5), (6, 7)],
)
def test_cumsum_kernel_equals_plain_and_numpy(cuda, b, tiles, extra):
    """K5 bit for bit at ragged shapes (the tile size is read from the
    source; a CTA walks two chains), with a row of zeros and subnormal
    addends."""
    from raxtax_tpu_torch.ops.exactscan import exact_cumsum, exact_cumsum_plain

    n = tiles * _scan_tile() + extra
    rng = np.random.default_rng(2 + b * 10_000 + n)
    p = rng.random((b, n)) * 10.0 ** rng.integers(-12, 0, (b, n))
    if b > 1:
        p[1] = 0.0
    p[0, ::5] = 5e-324 * rng.integers(1, 1000, size=p[0, ::5].shape)
    d = torch.from_numpy(p).to(cuda)
    got = exact_cumsum(d)
    assert got.shape == (b, n + 1)
    assert torch.equal(got.view(torch.int64), exact_cumsum_plain(d).view(torch.int64))
    want = np.concatenate([np.zeros((b, 1)), np.cumsum(p, axis=1)], axis=1)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint64), want.view(np.uint64))


def test_dadd_chain_equals_host_loop(cuda):
    """The chain that measures K5's floor adds what a host loop adds, and
    counts cycles."""
    from raxtax_tpu_torch.ops.exactscan import dadd_chain, dadd_chain_plain
    from raxtax_tpu_torch.tools.kernel_batch import CHAIN_ADDENDS

    x = torch.tensor(CHAIN_ADDENDS, dtype=torch.float64)
    got = dadd_chain(x.to(cuda), 4096).cpu()
    assert got[0].view(torch.int64) == dadd_chain_plain(x, 4096)[0].view(torch.int64)
    assert got[1] >= 4096
    with pytest.raises(RuntimeError):
        dadd_chain(x.to(cuda), 33)


def test_sparse_fold_kernel_equals_plain_and_dense(cuda):
    from raxtax_tpu_torch.ops import intersect_fold as tf

    rng = np.random.default_rng(3)
    n_blocks = 3
    km = np.zeros((65537, n_blocks * tf.BLOCK_WORDS), np.uint32)
    used = rng.choice(65536, size=200, replace=False)
    for k in used:
        for blk in rng.choice(n_blocks, size=rng.integers(1, 4), replace=False):
            pos = rng.choice(tf.BLOCK_WORDS, size=80, replace=False)
            km[k, blk * tf.BLOCK_WORDS + pos] |= rng.integers(
                0, 1 << 32, size=80, dtype=np.uint64
            ).astype(np.uint32)
    nz = km.reshape(65537, n_blocks, -1).any(axis=2)
    blk_ptr = np.zeros(65538, np.int64)
    np.cumsum(nz.sum(axis=1), out=blk_ptr[1:])
    blk_ids = np.nonzero(nz)[1].astype(np.int32)
    kc = np.array([0, 5, 16, 17, 100, 128], np.int32)
    idx = np.full((6, 128), 65536, np.int32)
    for b, k in enumerate(kc):
        idx[b, :k] = np.sort(rng.choice(used, k, replace=False))
    pair_kmer, pair_blk, _, totals = tf.build_pairs(idx, blk_ptr, blk_ids, 1 << 20)
    km3 = torch.from_numpy(km.view(np.int32)).reshape(65537, -1, 128).to(cuda)
    args = [torch.from_numpy(pair_kmer).to(cuda), torch.from_numpy(pair_blk).to(cuda),
            torch.from_numpy(totals.astype(np.int32)).to(cuda), km3]
    got = tf.fold_planes_sparse(*args, max_count=128)
    assert torch.equal(got, tf.fold_planes_sparse_plain(*args, got.shape[1]))
    dense = tf.fold_planes(
        torch.from_numpy(idx).to(cuda), torch.from_numpy(kc).to(cuda), km3,
        max_count=128,
    )
    assert torch.equal(got, dense)


def test_high_counts_kernel_equals_plain(cuda):
    from raxtax_tpu_torch.ops import planes as pl

    rng = np.random.default_rng(4)
    p = _planes(rng, 3, 9, 3)
    p[:, 5:] &= p[:, 4:5] & p[:, 3:4]  # counts above 15 on a share of tips
    p = p.to(cuda)
    got = pl.planes_high_counts(p)
    assert torch.equal(got, pl.planes_high_counts_plain(p))
    assert bool((got > 15).any()) and bool((got == 0).any())


def _dd_inputs(rng, shape):
    return torch.from_numpy(
        (rng.random(shape) * 10.0 ** rng.integers(-9, -1, shape)).astype(np.float32)
    )


def test_dd_cumsum_kernel_equals_plain(cuda):
    """K6 against the same add tree in plain PyTorch, both words bit for
    bit: below a tile, a whole tile, and a partial last tile."""
    from raxtax_tpu_torch.ops import planes as pl

    rng = np.random.default_rng(5)
    for n_rows in (3, 1024, 1024 + 300):
        x = _dd_inputs(rng, (5, n_rows * 128)).to(cuda)
        hz, lz = pl.dd_cumsum(x)
        assert not bool(hz[:, 0].any()) and not bool(lz[:, 0].any())
        hi, lo = hz[:, 1:].contiguous(), lz[:, 1:].contiguous()
        p_hi, p_lo = pl.dd_cumsum_plain(x, pl.DD_TILE_ROWS)
        assert torch.equal(hi.view(torch.int32), p_hi.view(torch.int32))
        assert torch.equal(lo.view(torch.int32), p_lo.view(torch.int32))
        want = np.cumsum(x.cpu().numpy().astype(np.float64), axis=1)
        got = hi.cpu().numpy().astype(np.float64) + lo.cpu().numpy().astype(np.float64)
        assert np.abs(got - want).max() < 1e-11


def test_dd_cumsum_bitmajor_kernel_equals_plain(cuda):
    from raxtax_tpu_torch.ops import planes as pl

    rng = np.random.default_rng(6)
    for S in (1, 8, 11):
        x = _dd_inputs(rng, (4, 32, S, 128)).to(cuda)
        hz, lz = pl.dd_cumsum_bitmajor(x)
        assert not bool(hz[:, 0].any()) and not bool(lz[:, 0].any())
        hi, lo = hz[:, 1:].contiguous(), lz[:, 1:].contiguous()
        flat = pl.probs_to_tip_order(x).contiguous()
        p_hi, p_lo = pl.dd_cumsum_plain(flat, pl.DD_TILE_ROWS_BITMAJOR)
        assert torch.equal(hi.view(torch.int32), p_hi.view(torch.int32))
        assert torch.equal(lo.view(torch.int32), p_lo.view(torch.int32))


def _fold_batch(rng, cuda, n_words=384, sparse_rows=True):
    """A postings matrix with sparse rows (as real postings are) and a batch
    with an empty query, a PAD_ROW-only tail and a full query."""
    km = rng.integers(0, 2**32, size=(65537, n_words), dtype=np.uint64).astype(np.uint32)
    if sparse_rows:
        km &= rng.integers(0, 2**32, size=km.shape, dtype=np.uint64).astype(np.uint32)
        km[:, rng.random(n_words) < 0.5] = 0
    km[65536] = 0
    kc = np.array([0, 5, 16, 17, 100, 128, 1, 64, 33], np.int32)
    idx = np.full((kc.size, 128), 65536, np.int32)
    for b, k in enumerate(kc):
        idx[b, :k] = np.sort(rng.choice(4000, k, replace=False))
    km3 = torch.from_numpy(km.view(np.int32)).reshape(65537, -1, 128).to(cuda)
    return torch.from_numpy(idx).to(cuda), torch.from_numpy(kc).to(cuda), km3


def test_gathered_fold_kernel_equals_plain_and_dense(cuda):
    """K9 against its plain version and against K1, whole and chunked."""
    from raxtax_tpu_torch.ops import intersect_fold as tf

    idx, kc, km3 = _fold_batch(np.random.default_rng(7), cuda)
    B, k_pad = idx.shape
    dense = tf.fold_planes(idx, kc, km3, max_count=k_pad)
    rows = km3.index_select(0, idx.reshape(-1).long())
    got = tf.fold_planes_gathered(rows, B, dense.shape[1] - 4)
    assert torch.equal(got, tf.fold_planes_gathered_plain(rows, B, got.shape[1] - 4))
    assert torch.equal(got, dense)
    before = tf.fold_planes_gathered.launches
    chunked = tf.intersection_planes_gathered(
        idx, km3, max_count=k_pad, budget_bytes=4 * k_pad * 384 * 4
    )
    assert tf.fold_planes_gathered.launches - before == 3  # 9 queries, 4 a chunk
    assert torch.equal(chunked, dense)


def test_stream_fold_kernel_equals_plain_and_dense(cuda):
    """K10 against its plain version and against K1: one group, several
    groups with a ragged last one, and a ragged column tile."""
    from raxtax_tpu_torch.ops import intersect_fold as tf
    from raxtax_tpu_torch.ops import intersect_stream as ts

    for n_words, sparse in ((384, True), (256, False)):
        idx, kc, km3 = _fold_batch(np.random.default_rng(8), cuda, n_words, sparse)
        B, k_pad = idx.shape
        dense = tf.fold_planes(idx, kc, km3, max_count=k_pad)
        P = ts.n_planes_for(k_pad)
        assert P == dense.shape[1]
        for group in (B, 4, 1):
            pairs = ts.build_pairs(idx, group)
            got = ts.fold_planes_stream(*pairs, km3, B, group, P)
            assert torch.equal(got, dense)
            assert torch.equal(
                got, ts.fold_planes_stream_plain(pairs[0], pairs[1], km3, B, P)
            )
        assert torch.equal(ts.intersection_planes_stream(idx, km3, k_pad), dense)


def test_probe_f64_ew_kernel_equals_plain_and_hardware(cuda):
    """K11 against its plain version and against the card's f64 unit on
    adversarial pairs."""
    from raxtax_tpu_torch.ops import exactf64 as xf
    from raxtax_tpu_torch.tools.probe_f64 import adversarial_pairs

    a, b = adversarial_pairs(np.random.default_rng(9), 50_000)
    halves = [
        torch.from_numpy(x.view(np.int32)).to(cuda)
        for x in (*xf.split64(a), *xf.split64(b))
    ]
    got = xf.probe_f64_ew(*halves)
    for g, w in zip(got, xf.probe_f64_ew_plain(*halves)):
        assert torch.equal(g, w)
    c = np.stack([got[1].cpu().numpy(), got[0].cpu().numpy()], -1).view(np.float64)
    d = np.stack([got[3].cpu().numpy(), got[2].cpu().numpy()], -1).view(np.float64)
    ta, tb = torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda)
    np.testing.assert_array_equal(c.reshape(-1).view(np.uint64),
                                  (ta + tb).cpu().numpy().view(np.uint64))
    np.testing.assert_array_equal(d.reshape(-1).view(np.uint64),
                                  (ta + tb - tb).cpu().numpy().view(np.uint64))


def test_probe_f64_scan_kernel_equals_plain_and_k5(cuda):
    """K12 against its plain version and against K5 on the same values, with
    a tip count that leaves a partial last tile."""
    from raxtax_tpu_torch.ops import exactf64 as xf
    from raxtax_tpu_torch.ops.exactscan import exact_cumsum
    from raxtax_tpu_torch.tools.probe_f64 import scan_inputs

    p = scan_inputs(256, 300, cuda, seed=10)
    ph, pl = xf.to_lane_groups(p)
    oh, ol = xf.probe_f64_scan(ph, pl)
    w_h, w_l = xf.probe_f64_scan_plain(ph, pl)
    assert torch.equal(oh, w_h) and torch.equal(ol, w_l)
    got = xf.from_lane_groups(oh, ol)
    want = exact_cumsum(p)[:, 1:].contiguous()
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))


def test_probe_op_chain_kernel_equals_plain(cuda):
    """K13: every chain's bits against the plain version."""
    from raxtax_tpu_torch.ops.opchain import (
        CHAINS,
        probe_op_chain,
        probe_op_chain_plain,
        probe_state,
    )

    x, y = probe_state(cuda)
    for name in CHAINS:
        for iters in (0, 1, 37):
            assert torch.equal(
                probe_op_chain(name, x, y, iters),
                probe_op_chain_plain(name, x, y, iters),
            ), (name, iters)
