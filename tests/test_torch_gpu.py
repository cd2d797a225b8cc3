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


@pytest.mark.parametrize("n_blocks,max_count,n_planes",
                         [(1, 31, 5), (3, 1000, 10), (2, 40_000, 16)])
def test_sparse_fold_kernel_stage_edges_equal_plain_and_dense(
        cuda, n_blocks, max_count, n_planes):
    """K2 at one block (W = 1,024 words) and more, at 5, 10 and 16 planes:
    queries with 0 pairs and with 1, 15, 16, 17 and 33 pairs in their one
    block (the edges of a 16-row stage and of the three-stage ring; the
    other blocks have no pair), and a query whose 33 k-mers post in random
    blocks. Bit-equal to the plain version and to K1 on the same k-mers."""
    from raxtax_tpu_torch.ops import intersect_fold as tf

    rng = np.random.default_rng(30 + n_blocks)
    W = n_blocks * tf.BLOCK_WORDS
    counts = [0, 1, 15, 16, 17, 33, 33]
    ids = rng.choice(65536, sum(counts), replace=False)
    idx = np.full((len(counts), 48), 65536, np.int32)
    nz = np.zeros((65537, n_blocks), bool)
    rows = np.zeros((len(ids), W), np.uint32)
    o = 0
    for b, k in enumerate(counts):
        idx[b, :k] = np.sort(ids[o : o + k])
        for i in range(o, o + k):
            blocks = ([b % n_blocks] if b < len(counts) - 1 else
                      rng.choice(n_blocks, rng.integers(1, n_blocks + 1),
                                 replace=False))
            for blk in blocks:
                pos = blk * tf.BLOCK_WORDS + rng.choice(tf.BLOCK_WORDS, 200,
                                                        replace=False)
                rows[i, pos] = rng.integers(
                    1, 2**32, 200, dtype=np.uint64).astype(np.uint32)
            nz[ids[i], blocks] = True
        o += k
    blk_ptr = np.zeros(65538, np.int64)
    np.cumsum(nz.sum(axis=1), out=blk_ptr[1:])
    blk_ids = np.nonzero(nz)[1].astype(np.int32)
    km = torch.zeros((65537, W), dtype=torch.int32, device=cuda)
    km[torch.from_numpy(ids).to(cuda)] = torch.from_numpy(rows.view(np.int32)).to(cuda)
    km3 = km.reshape(65537, -1, 128)
    pair_kmer, pair_blk, _, totals = tf.build_pairs(idx, blk_ptr, blk_ids, 1 << 20)
    args = [torch.from_numpy(pair_kmer).to(cuda), torch.from_numpy(pair_blk).to(cuda),
            torch.from_numpy(totals.astype(np.int32)).to(cuda), km3]
    got = tf.fold_planes_sparse(*args, max_count=max_count)
    assert got.shape == (len(counts), n_planes, W // 128, 128)
    assert torch.equal(got, tf.fold_planes_sparse_plain(*args, n_planes))
    dense = tf.fold_planes(
        torch.from_numpy(idx).to(cuda),
        torch.from_numpy(np.array(counts, np.int32)).to(cuda), km3,
        max_count=max_count,
    )
    assert torch.equal(got, dense)
    assert not got[0].any()


def _planes_of_counts(counts, P):
    """``[B, P, S, 128]`` int32 planes that spell ``counts`` ``[B, S * 128 *
    32]`` in the packed tip order (tip = word * 32 + bit)."""
    B, n = counts.shape
    c = counts.reshape(B, n // 32, 32).astype(np.uint64)
    bits = np.uint64(1) << np.arange(32, dtype=np.uint64)
    planes = np.stack(
        [(((c >> np.uint64(p)) & np.uint64(1)) * bits).sum(axis=2)
         for p in range(P)], axis=1).astype(np.uint32)
    return torch.from_numpy(planes.view(np.int32).reshape(B, P, -1, 128))


@pytest.mark.parametrize("P", [1, 4, 5, 10, 24])
@pytest.mark.parametrize("s_max", [8, 16, 17, 512, 13_000])
def test_hist_kernel_low_counts_tail_and_s_max_equal_plain(cuda, P, s_max):
    """K3 bit for bit against its plain version at every plane count it
    compiles for and at s_max below, at and past 16, at the path's 512 and
    past the shared-memory histogram (13,000): counts mostly below 16, a
    tail of larger ones, counts past s_max (dropped), a query of all-zero
    planes, a query whose tips are all 16 or more, and 77 pad tips. The row
    (S = 17) ends in a partly filled CTA."""
    from raxtax_tpu_torch.ops import planes as pl

    rng = np.random.default_rng(40 + P)
    top = (1 << P) - 1
    B, S = 5, 17
    n = S * 128 * 32
    counts = np.where(rng.random((B, n)) < 0.8, rng.integers(0, 16, (B, n)),
                      rng.integers(16, 20_000, (B, n)))
    counts = np.minimum(counts, top)
    counts[1] = 0  # all-zero planes
    if P > 4:
        counts[2] = rng.integers(16, top + 1, n)  # every tip in the tail
    num_tips = n - 77
    counts[:, num_tips:] = 0
    planes = _planes_of_counts(counts, P).to(cuda)
    got = pl.planes_histogram(planes, s_max, num_tips)
    want = pl.planes_histogram_plain(planes, s_max, num_tips)
    assert torch.equal(got, want)
    # the plain version is the histogram of the counts
    ref = np.stack([np.bincount(c[:num_tips][c[:num_tips] < s_max],
                                minlength=s_max) for c in counts])
    np.testing.assert_array_equal(got.cpu().numpy(), ref)


def test_hist_kernel_ragged_row_equals_plain(cuda):
    """The C entry at a row length that is no multiple of 4 words (the
    wrapper always passes whole 128-word rows): the planes past the row's
    end are never read."""
    from raxtax_tpu_torch.ops import _build, planes as pl

    rng = np.random.default_rng(50)
    B, P, W = 3, 10, 2 * 2048 + 5
    counts = np.minimum(rng.geometric(0.3, (B, W * 32)) - 1, 1023)
    counts[:, -40:] = 0
    num_tips = W * 32 - 40
    padded = np.zeros((B, 33 * 128 * 32), np.int64)
    padded[:, : W * 32] = counts
    full = _planes_of_counts(padded, P).to(cuda)  # [B, P, 33, 128]
    rows = full.reshape(B, P, -1)[:, :, :W].contiguous()
    got = torch.zeros((B, 512), dtype=torch.int32, device=cuda)
    fn = _build.entry("planes_hist", "rx_planes_hist", pl._HIST_ARGTYPES)
    code = fn(rows.data_ptr(), got.data_ptr(), B, P, W, 512, num_tips,
              torch.cuda.current_stream().cuda_stream)
    _build.check("planes_hist", code, "planes_histogram")
    assert torch.equal(got, pl.planes_histogram_plain(full, 512, num_tips))


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
    """K10 against its plain version and against K1: groups of two with a
    ragged last group (9 queries) and of one, on rows of 384 words (ragged
    on the 128-word column slices) and of 256; larger groups are refused."""
    from raxtax_tpu_torch.ops import intersect_fold as tf
    from raxtax_tpu_torch.ops import intersect_stream as ts

    for n_words, sparse in ((384, True), (256, False)):
        idx, kc, km3 = _fold_batch(np.random.default_rng(8), cuda, n_words, sparse)
        B, k_pad = idx.shape
        dense = tf.fold_planes(idx, kc, km3, max_count=k_pad)
        P = ts.n_planes_for(k_pad)
        assert P == dense.shape[1]
        for group in (ts.MAX_GROUP, 1):
            pairs = ts.build_pairs(idx, group)
            plain = ts.fold_planes_stream_plain(pairs[0], pairs[1], km3, B, P)
            got = ts.fold_planes_stream(*pairs, km3, B, group, P)
            assert torch.equal(got, dense), group
            assert torch.equal(got, plain), group
        assert torch.equal(ts.intersection_planes_stream(idx, km3, k_pad), dense)
        pairs = ts.build_pairs(idx, ts.MAX_GROUP + 1)
        with pytest.raises(ValueError, match="groups of 1 to"):
            ts.fold_planes_stream(*pairs, km3, B, ts.MAX_GROUP + 1, P)


def test_stream_fold_kernel_ragged_groups_and_full_counts(cuda):
    """K10 where a whole group has no real pair, where rows are shared
    inside groups (one load, several queries), past a chunk of 1,024 pairs,
    and where a count reaches 2^P - 1 in every plane: equal to its plain
    version and to K1."""
    from raxtax_tpu_torch.ops import intersect_fold as tf
    from raxtax_tpu_torch.ops import intersect_stream as ts

    rng = np.random.default_rng(9)
    n_words = 640  # 160 uint4 a row: five 512-byte column slices
    km = rng.integers(0, 2**32, size=(65537, n_words), dtype=np.uint64).astype(np.uint32)
    km[65536] = 0
    km[:255, :128] = 0xFFFFFFFF  # rows 0..254: every bit of the first 128 words
    k_pad = 256
    kc = np.array([255, 0, 0, 0, 0, 0, 0, 0, 255, 7, 200, 255, 3, 1], np.int32)
    idx = np.full((kc.size, k_pad), 65536, np.int32)
    idx[0, :255] = np.arange(255)
    idx[8, :255] = np.arange(255)  # the same rows as query 0
    idx[11, :255] = np.sort(rng.choice(900, 255, replace=False))
    for b in (9, 10, 12, 13):
        idx[b, : kc[b]] = np.sort(rng.choice(300, kc[b], replace=False))
    idx_t = torch.from_numpy(idx).to(cuda)
    km3 = torch.from_numpy(km.view(np.int32)).reshape(65537, -1, 128).to(cuda)
    kc_t = torch.from_numpy(kc).to(cuda)
    B = kc.size
    P = ts.n_planes_for(255)  # 8 planes: a count of 255 sets all of them
    dense = tf.fold_planes(idx_t, kc_t, km3, max_count=255)
    assert dense.shape[1] == P
    assert bool((dense[0, :, 0, 0] == -1).all())  # 255 = 2^8 - 1
    for group in (2, 1):  # queries 1..7: empty groups; 14 = 7 groups of 2
        pairs = ts.build_pairs(idx_t, group)
        plain = ts.fold_planes_stream_plain(pairs[0], pairs[1], km3, B, P)
        got = ts.fold_planes_stream(*pairs, km3, B, group, P)
        assert torch.equal(got, plain), group
        assert torch.equal(got, dense), group
    # one group of 2 queries with 1,200 pairs: the run list is rebuilt
    big = np.full((3, 640), 65536, np.int32)
    for b in range(3):
        big[b, :600] = np.sort(rng.choice(1000, 600, replace=False))
    big_t = torch.from_numpy(big).to(cuda)
    kc_big = torch.full((3,), 600, dtype=torch.int32, device=cuda)
    dense = tf.fold_planes(big_t, kc_big, km3, max_count=640)
    pairs = ts.build_pairs(big_t, 2)
    assert int(pairs[3][0] - pairs[2][0]) == 2 * 600 > 1024
    assert torch.equal(
        ts.fold_planes_stream(*pairs, km3, 3, 2, dense.shape[1]), dense)


@pytest.mark.parametrize("bitmajor", [False, True])
@pytest.mark.parametrize("b", [1, 133])
def test_dd_scan_kernels_ragged_shapes_equal_plain(cuda, bitmajor, b):
    """K6 and K7 bit for bit against their plain versions where the chunks
    of 64 rows, the tiles and the tickets are ragged: one row (K6, N = 128),
    a tile that ends in a partial chunk, a partial last tile, and a carry
    handed across many tiles."""
    from raxtax_tpu_torch.ops import planes as pl

    rng = np.random.default_rng(10 + b)
    if bitmajor:
        shapes, tile = [(b, 32, s, 128) for s in (1, 11, 40)], pl.DD_TILE_ROWS_BITMAJOR
    else:
        shapes, tile = [(b, n * 128) for n in (1, 37, 1024 + 65, 12 * 1024 + 1)], \
            pl.DD_TILE_ROWS
    for shape in shapes:
        x = _dd_inputs(rng, shape).to(cuda)
        hz, lz = (pl.dd_cumsum_bitmajor if bitmajor else pl.dd_cumsum)(x)
        flat = pl.probs_to_tip_order(x).contiguous() if bitmajor else x
        N = flat.shape[1]
        assert hz.shape == lz.shape == (b, N + 1)
        assert not bool(hz[:, 0].any()) and not bool(lz[:, 0].any())
        p_hi, p_lo = pl.dd_cumsum_plain(flat, tile)
        assert torch.equal(hz[:, 1:].contiguous().view(torch.int32),
                           p_hi.view(torch.int32)), shape
        assert torch.equal(lz[:, 1:].contiguous().view(torch.int32),
                           p_lo.view(torch.int32)), shape


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


def test_probe_op_chain_kernel_at_unroll_edges_on_whole_space_words(cuda):
    """K13: every chain at 0, 1, U - 1, U, U + 1 and 2U + 3 steps (U the
    kernel's unroll), on the probe's state and on whole-space words."""
    from raxtax_tpu_torch.ops.opchain import UNROLL
    from raxtax_tpu_torch.tools.probe_ops import EDGE_ITERS, edge_mismatches

    assert EDGE_ITERS == (0, 1, UNROLL - 1, UNROLL, UNROLL + 1, 2 * UNROLL + 3)
    assert edge_mismatches(cuda, seed=5) == []


@pytest.mark.parametrize("n_tips", [1, 63, 65, 65_539])
def test_probe_f64_scan_kernel_ragged_tips_on_whole_space_words(cuda, n_tips):
    """K12 at tip counts around its ring tile (one tip, a tile less one, a
    tile and one, many tiles and a partial last one) on whole-space words,
    against its plain version (run on the CPU: the same function)."""
    from raxtax_tpu_torch.ops import exactf64 as xf
    from raxtax_tpu_torch.tools.probe_f64 import whole_space_halves

    assert xf.SCAN_TILE == 64
    G = 2 if n_tips < 1000 else 1
    ph, pl, _, _ = whole_space_halves((G, n_tips, 128), cuda, n_tips)
    oh, ol = xf.probe_f64_scan(ph, pl)
    w_h, w_l = xf.probe_f64_scan_plain(ph.cpu(), pl.cpu())
    assert torch.equal(oh.cpu(), w_h) and torch.equal(ol.cpu(), w_l)


def test_probe_f64_ew_kernel_equals_plain_on_whole_space_words(cuda):
    """K11 on word pairs drawn from the whole u32 space (every exponent and
    the sign bit), against its plain version: outside the contract the
    answer is the JAX algorithm's."""
    from raxtax_tpu_torch.ops import exactf64 as xf
    from raxtax_tpu_torch.tools.probe_f64 import whole_space_halves

    halves = whole_space_halves((1 << 20,), cuda, 6)
    for g, w in zip(xf.probe_f64_ew(*halves), xf.probe_f64_ew_plain(*halves)):
        assert torch.equal(g, w)


# -- the engine's options, the trace and the bench (the checks of
# chip_smoke.py's phases path_65k_split2_off, path_65k_split_sig,
# path_65k_descent_device, trace and bench, on small worlds) ----------------


@pytest.fixture(scope="module")
def small_world():
    from raxtax_tpu_torch.tools.synth import build_world

    db, queries, _ = build_world(8192, 64)
    return db, queries


@pytest.mark.parametrize(
    "split_sig,bm_scan", [(False, False), (True, False), (True, True)],
    ids=["split2_off", "split_sig", "split_sig_bm_scan"],
)
def test_split_options_equal_the_oracle_on_the_card(cuda, small_world, split_sig,
                                                    bm_scan):
    """``RAXTAX_SPLIT2=0`` (with ``RAXTAX_SPLIT_SIG=1``, and on the bit-major
    scan of a packed copy): every output line the oracle's, K6 or K7 run,
    and the single-tip split compacts every batch where it is asked for."""
    import copy

    from raxtax_tpu_torch.db.database import ensure_kmer_layout
    from raxtax_tpu_torch.engine.classify import make_classifier
    from raxtax_tpu_torch.models.oracle import OracleClassifier
    from raxtax_tpu_torch.ops import nodeconf, planes
    from raxtax_tpu_torch.tools.compare_descents import dd_args

    db, queries = small_world
    if bm_scan:
        db = ensure_kmer_layout(copy.copy(db), "packed")
    calls = []
    split = nodeconf._compact_split
    nodeconf._compact_split = lambda *a: calls.append(1) or split(*a)
    try:
        clf = make_classifier(db, dd_args("cuda", 32, "exact", split2=False,
                                          split_sig=split_sig, bm_scan=bm_scan))
        assert clf.state.split2 is None
        planes.dd_cumsum.launches = planes.dd_cumsum_bitmajor.launches = 0
        got = [r for lo in range(0, 64, 32)
               for r in clf.classify_batch(queries[lo : lo + 32])]
    finally:
        nodeconf._compact_split = split
    scan, other = planes.dd_cumsum, planes.dd_cumsum_bitmajor
    if bm_scan:
        scan, other = other, scan
    assert scan.launches >= 2 and other.launches == 0
    assert len(calls) >= 2 if split_sig else not calls
    orc = OracleClassifier(db)
    for (label, seq), r in zip(queries, got):
        want = orc.classify(label, seq)
        assert r.out_string() == want.out_string(), label
        assert r.tsv_string() == want.tsv_string(), label


def test_device_descent_agrees_with_the_exact_one_where_not_replayed(
    cuda, small_world
):
    from raxtax_tpu_torch.tools.compare_descents import compare_descents

    db, queries = small_world
    got = compare_descents(db, queries, 32, "cuda")
    assert got["differ"] == [] and got["host_replays_device"] == 0
    assert got["compared"] + got["replayed_by_exact"] == len(queries)
    assert got["equal"] == got["compared"] > 0


def test_cli_trace_names_a_csrc_kernel(cuda, tmp_path):
    """``--trace DIR`` on the default path: the profiler trace in DIR names
    K1's kernel (``fold_planes_kernel``), launched through ctypes."""
    from pathlib import Path

    from raxtax_tpu_torch.cli import main
    from raxtax_tpu_torch.utils.trace import csrc_kernels, csrc_kernels_in

    data = Path(__file__).resolve().parent / "data"
    out, tr = tmp_path / "out", tmp_path / "trace"
    assert main(["-d", str(data / "golden_refs.fasta"), "-i",
                 str(data / "golden_queries.fasta"), "-o", str(out),
                 "--trace", str(tr)]) == 0
    assert (out / "raxtax.out").read_bytes() == (data / "golden_raxtax.out").read_bytes()
    found = csrc_kernels_in(tr)
    assert "fold_planes_kernel" in found and set(found) <= csrc_kernels()


def test_bench_prints_its_line_on_the_card(cuda, tmp_path, monkeypatch, capsys):
    import json

    from raxtax_tpu_torch.tools import bench

    for k, v in {"RAXTAX_BENCH_REFS": "4096", "RAXTAX_BENCH_QUERIES": "256",
                 "RAXTAX_BENCH_BATCH": "64", "RAXTAX_BENCH_REPS": "3",
                 "RAXTAX_BENCH_ORACLE_QUERIES": "2",
                 "RAXTAX_BENCH_CACHE_DIR": str(tmp_path)}.items():
        monkeypatch.setenv(k, v)
    assert bench.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["metric"] == "classify_throughput_4096ref_db"
    assert line["unit"] == "queries/s/gpu" and len(line["pass_s"]) == 3
    assert line["batch"] == 64 and line["value"] >= line["median"] > 0


def test_mesh_engine_at_world_size_one_on_nccl_at_1m(cuda):
    """The sharded pipeline on a mesh ``1,1`` (a world of one rank on NCCL)
    at 1,000,000 references, one batch of 256 queries for each backend:
    the single-device double-f32 engine's lines, and the oracle's on two."""
    import copy

    from raxtax_tpu_torch.db.database import ensure_kmer_layout
    from raxtax_tpu_torch.engine.device import DeviceClassifier
    from raxtax_tpu_torch.models.oracle import OracleClassifier
    from raxtax_tpu_torch.parallel.mesh import make_mesh
    from raxtax_tpu_torch.parallel.multihost import shutdown
    from raxtax_tpu_torch.tools.synth import build_world

    db, queries, _ = build_world(1_000_000, 256, with_ref_major=True)
    packed = ensure_kmer_layout(copy.copy(db), "packed")
    single = DeviceClassifier.create(db, significance="dd", batch_size=256)
    want = [r.out_string() for r in single.classify_batch(queries)]
    del single
    orc = OracleClassifier(db)
    assert want[:2] == [orc.classify(l, s).out_string() for l, s in queries[:2]]
    try:
        mesh = make_mesh("1,1")
        assert mesh.backend == "nccl"
        for counts, fold in (("planes", "gathered"), ("planes", "stream"),
                             ("dense", "dense")):
            dev = DeviceClassifier.create(packed, batch_size=256, counts=counts,
                                          fold=fold, mesh=mesh)
            got = [r.out_string() for r in dev.classify_batch(queries)]
            assert got == want, fold
            del dev
            torch.cuda.empty_cache()
    finally:
        shutdown()


def test_two_ranks_share_the_card_over_gloo(cuda, tmp_path):
    """The CLI in two ranks on ``cuda:0`` (gloo, every collective through
    pinned host memory): a global mesh ``1,2`` and two independent ranks,
    each the goldens' bytes with no shard left."""
    import os
    from pathlib import Path

    from raxtax_tpu_torch.parallel.launch import launch

    root = Path(__file__).resolve().parent.parent
    data = root / "tests" / "data"
    for name, flags in (("global", ["--global-mesh", "--mesh", "1,2"]),
                        ("independent", [])):
        out = tmp_path / name
        codes, logs = launch(
            2, ["-m", "raxtax_tpu_torch.cli", "-d", str(data / "golden_refs.fasta"),
                "-i", str(data / "golden_queries.fasta"), "-o", str(out),
                "--tsv", "--batch-size", "4", *flags],
            env=dict(os.environ, PYTHONPATH=str(root)), timeout=600,
            cwd=str(root))
        assert codes == [0, 0], "\n".join(logs)[-4000:]
        for ext in ("out", "tsv"):
            assert (out / f"raxtax.{ext}").read_bytes() == (
                data / f"golden_raxtax.{ext}").read_bytes()
        assert not list(out.glob("*.shard*"))
        if flags:
            log = (out / "raxtax.log").read_text()
            assert "mesh collectives copied" in log and " 0 CUDA" not in log


def test_span_clock_holds_each_kernel_inside_its_span(cuda):
    """The recorder's clock against the profiler's device clock: in each of
    100 spans a kernel of known length (``torch.cuda._sleep``) runs to a
    synchronise; once converted with the recorder's offset, every kernel's
    device interval lies inside its span. Prints the worst slack."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from raxtax_tpu_torch.utils.trace import SpanRecorder

    rec = SpanRecorder()
    rec.enable()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):  # short kernels: the trace's first records
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for i in range(100):
            with rec.span("clock.check", i):
                torch.cuda._sleep(100_000)  # ~50 us at the card's clock
                torch.cuda.synchronize()
    got = rec.drain()
    kernels = sorted(
        (e.start_ns(), e.start_ns() + e.duration_ns())
        for e in prof.profiler.kineto_results.events()
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 20_000
    )
    spans = sorted(got["spans"], key=lambda s: s["start_ns"])
    off = got["offset_ns"]
    slack = []
    for s in spans:
        a, b = s["start_ns"] + off, s["end_ns"] + off
        # the kernel that starts nearest the span's middle is its own
        k0, k1 = min(kernels, key=lambda k: abs(k[0] - (a + b) // 2))
        slack.append(min(k0 - a, b - k1))
    print(f"span clock: {len(kernels)} kernels for {len(spans)} spans, worst "
          f"slack {min(slack) / 1e3:.3f} us, median "
          f"{sorted(slack)[len(slack) // 2] / 1e3:.3f} us")
    assert len(kernels) == len(spans) == 100 and got["dropped"] == 0
    assert min(slack) >= 0
