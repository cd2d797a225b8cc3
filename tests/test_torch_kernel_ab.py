"""``tools/kernel_ab.py`` and ``tools/kernel_batch.py`` off the card: the
reading of nvcc's resource report, the argument lists it binds every design
with, the bounds of K1, K2, K3, K5, K10 and K6/K7, the count of K3's tail
tips, the one-family batch of K10, the plain version of the chain that
measures K5's floor, and the A/B tool's refusal to run without a GPU (it has
no CPU mode)."""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from raxtax_tpu_torch.ops.exactscan import dadd_chain
from raxtax_tpu_torch.tools import kernel_ab, kernel_batch

PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z3fooPd' for 'sm_90a'
ptxas info    : Function properties for _Z3fooPd
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 142 registers, used 16 barriers, 4096 bytes smem, 380 bytes cmem[0]
ptxas info    : Compiling entry function '_Z3barPi' for 'sm_90a'
ptxas info    : Function properties for _Z3barPi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers, 368 bytes cmem[0]
"""


def test_ptxas_usage_reads_registers_spills_and_smem():
    assert kernel_ab.ptxas_usage(PTXAS_LOG) == [
        {"kernel": "_Z3fooPd", "spill_store_bytes": 8, "spill_load_bytes": 4,
         "registers": 142, "static_smem_bytes": 4096},
        {"kernel": "_Z3barPi", "spill_store_bytes": 0, "spill_load_bytes": 0,
         "registers": 32, "static_smem_bytes": 0},
    ]


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="on a GPU the tool builds and times: not a unit test")
def test_kernel_ab_needs_a_gpu(tmp_path, capsys):
    assert kernel_ab.main(["--other", str(tmp_path)]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_bounds_of_fold_and_scan():
    B, N = 256, 1_015_808
    k5 = kernel_batch.exact_cumsum_bounds(B, N)
    assert k5["bound_by"] == "bytes"
    assert k5["bound_ms"] == (B * N * 8 + B * (N + 1) * 8) / 3.35e12 * 1e3
    # two queries naming rows {1, 2} and {2, 5, 7}: four rows read once,
    # five streamed
    ks = np.array([2, 3], np.int32)
    flat, off = np.array([1, 2, 2, 5, 7], np.int32), np.array([0, 2, 5])
    idx = np.zeros((2, 128), np.int32)
    k1 = kernel_batch.fold_planes_bounds(idx, ks, flat, off, W=4096, P=8)
    assert (k1["unique_rows"], k1["rows_folded"]) == (4, 5)
    out_bytes = 2 * 8 * 4096 * 4
    assert k1["stream_bound_ms"] == (5 * 4096 * 4 + out_bytes) / 3.35e12 * 1e3
    assert k1["bound_ms"] == (4 * 4096 * 4 + idx.nbytes + ks.nbytes + out_bytes) \
        / 3.35e12 * 1e3
    assert k1["bound_ms"] < k1["stream_bound_ms"]


def test_dadd_chain_on_the_cpu_is_the_host_loop():
    x = torch.tensor(kernel_batch.CHAIN_ADDENDS, dtype=torch.float64)
    got = dadd_chain(x, 96)
    acc = np.float64(0.0)
    for i in range(96):
        acc = acc + np.float64(kernel_batch.CHAIN_ADDENDS[i % 8])
    assert got[0].numpy().view(np.uint64) == np.array(acc).view(np.uint64)
    assert math.isnan(got[1].item())


CSRC = Path(kernel_ab.__file__).resolve().parent.parent / "csrc"


def _arity(source: str, entry: str) -> int:
    m = re.search(rf"RX_EXPORT [a-z ]+ {entry}\(([^)]*)\)", source)
    assert m is not None, entry
    return m.group(1).count(",") + 1


def test_package_sources_take_the_argument_lists_designs_are_bound_with():
    """Every design is bound with the argument types of the package's
    wrappers: the package's own C entry points take exactly those."""
    from raxtax_tpu_torch.ops import planes

    assert set(kernel_ab.CASES.values()) == set(kernel_ab.KERNELS)
    for stem, entry in kernel_ab.KERNELS.items():
        source = (CSRC / f"{stem}.cu").read_text()
        assert _arity(source, entry) == len(kernel_ab.package_argtypes(stem))
    source = (CSRC / "dd_cumsum.cu").read_text()
    assert _arity(source, "rx_dd_cumsum_scratch_words") == \
        len(planes._DD_SCRATCH_ARGTYPES)


def test_family_batch_shares_rows_within_groups():
    """The one-family batch K10 is also timed on: its queries share most
    rows, so groups of two load far fewer rows than its pairs; the world's
    queries, one per family, share almost none."""
    from raxtax_tpu_torch.tools.synth import synth_fam, synth_queries

    B = 16
    world = synth_queries(synth_fam()[0], B)
    for queries, lo, hi in ((kernel_batch.family_queries(B), 0.5, 0.8),
                            (world, 0.95, 1.0)):
        idx, ks, *_ = kernel_batch.batch_inputs(queries, B)
        pairs = int(ks.sum())
        assert kernel_batch.group_row_loads(idx, ks, 1) == pairs
        # a row is loaded once per group: at least half the pairs' loads
        assert lo * pairs <= kernel_batch.group_row_loads(idx, ks, 2) <= hi * pairs


def test_bounds_of_stream_fold_and_dd_scan():
    B, N = 256, 1_015_808
    dd = kernel_batch.dd_cumsum_bounds(B, N)
    assert dd["bound_by"] == "bytes"
    assert dd["bound_ms"] == (B * N * 12 + B * 8) / 3.35e12 * 1e3
    assert dd["reload_bound_ms"] == (B * N * 16 + B * 8) / 3.35e12 * 1e3
    # the K1 example's batch: four rows read once, the pair lists beside
    ks = np.array([2, 3], np.int32)
    flat, off = np.array([1, 2, 2, 5, 7], np.int32), np.array([0, 2, 5])
    idx = np.zeros((2, 128), np.int32)
    k10 = kernel_batch.fold_stream_bounds(idx, ks, flat, off, W=4096, P=8,
                                          n_pairs_listed=256, n_groups=1)
    out_bytes = 2 * 8 * 4096 * 4
    assert k10["bound_ms"] == (4 * 4096 * 4 + out_bytes + 256 * 4 + 8) \
        / 3.35e12 * 1e3
    assert (k10["unique_rows"], k10["rows_folded"]) == (4, 5)
    assert k10["stream_bound_ms"] == (5 * 4096 * 4 + out_bytes) / 3.35e12 * 1e3


def test_bounds_of_sparse_fold():
    """K2 reads each distinct (k-mer, block) sub-row once; the adder tree's
    six operations a word, not a ripple's 2 P, are its operation term."""
    # two queries over W = 2 blocks: (k-mer 3, block 0), (3, 1), (5, 1) and
    # (3, 0), (9, 0): four distinct pairs of five; the pad slots do not count
    pair_kmer = np.array([[3, 3, 5, 65536], [3, 9, 65536, 65536]], np.int32)
    pair_blk = np.array([[0, 1, 1, 0], [0, 0, 0, 0]], np.int32)
    totals = np.array([3, 2], np.int64)
    k2 = kernel_batch.fold_sparse_bounds(pair_kmer, pair_blk, totals, W=2048, P=8)
    assert (k2["pairs"], k2["unique_pairs"]) == (5, 4)
    out_bytes = 2 * 8 * 2048 * 4
    lists = 2 * (2 * 4 * 4) + 2 * 4
    assert k2["bound_by"] == "bytes"
    assert k2["bound_ms"] == (4 * 1024 * 4 + out_bytes + lists) / 3.35e12 * 1e3
    assert k2["stream_bound_ms"] == (5 * 1024 * 4 + out_bytes + lists) \
        / 3.35e12 * 1e3
    # six operations a word of every pair: under the bytes' time
    assert 5 * 1024 * 6 / 33.5e12 * 1e3 < k2["bound_ms"]


def test_bounds_of_histogram():
    """K3's bound is its bytes: the planes read once and the histogram
    written; the operations of its design and the tail share beside."""
    B, P, W, s_max = 256, 10, 31_744, 512
    k3 = kernel_batch.planes_hist_bounds(B, P, W, s_max, n_tail=1000)
    assert k3["bound_by"] == "bytes"
    assert k3["bound_ms"] == (B * P * W * 4 + B * s_max * 4) / 3.35e12 * 1e3
    assert k3["ops_ms"] == (B * W * (P + 59) + 1000 * (3 * P + 1)) \
        / 33.5e12 * 1e3
    assert k3["tail_tips"] == 1000
    assert k3["tail_share"] == 1000 / (B * W * 32)
    # nearly every tip in the tail: the one-by-one decode outweighs the bytes
    heavy = kernel_batch.planes_hist_bounds(B, P, W, 1024, n_tail=B * W * 32)
    assert heavy["bound_by"] == "operations"
    assert heavy["bound_ms"] == heavy["ops_ms"]


def test_tail_tips_counts_the_decoded_counts_of_16_or_more():
    """The tips K3 decodes one by one: counts of 16 or more, read from the
    planes as decode_counts_bitmajor reads them (sign bits included)."""
    from raxtax_tpu_torch.ops.planes import decode_counts_bitmajor

    rng = np.random.default_rng(11)
    for P in (3, 5, 10):
        planes = torch.from_numpy(
            rng.integers(0, 2**32, size=(2, P, 3, 128), dtype=np.uint64)
            .astype(np.uint32).view(np.int32))
        planes[1, 4:] = 0  # a query with no tail
        want = int((decode_counts_bitmajor(planes) >= 16).sum())
        assert kernel_batch.tail_tips(planes) == want
        assert (want == 0) == (P <= 4)
