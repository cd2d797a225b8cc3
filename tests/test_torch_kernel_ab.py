"""``tools/kernel_ab.py`` and ``tools/kernel_batch.py`` off the card: the
reading of nvcc's resource report, the bounds of K1 and K5, the plain
version of the chain that measures K5's floor, and the A/B tool's refusal to
run without a GPU (it has no CPU mode)."""

import math

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
