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


def test_fold_kernel_equals_plain(cuda):
    from raxtax_tpu_torch.ops.intersect_fold import fold_planes, fold_planes_plain

    rng = np.random.default_rng(0)
    km = torch.from_numpy(
        rng.integers(0, 2**32, size=(65537, 2, 128), dtype=np.uint64)
        .astype(np.uint32).view(np.int32)
    )
    km[65536] = 0
    kc = np.array([0, 5, 16, 17, 100, 128], np.int32)
    idx = np.full((6, 128), 65536, np.int32)
    for b, k in enumerate(kc):
        idx[b, :k] = np.sort(rng.choice(65536, k, replace=False))
    args = [torch.from_numpy(idx).to(cuda), torch.from_numpy(kc).to(cuda), km.to(cuda)]
    got = fold_planes(*args)
    want = fold_planes_plain(*args, got.shape[1] - 4)
    assert torch.equal(got, want)


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


def test_cumsum_kernel_equals_plain_and_numpy(cuda):
    from raxtax_tpu_torch.ops.exactscan import exact_cumsum, exact_cumsum_plain

    rng = np.random.default_rng(2)
    p = rng.random((11, 1000)) * 10.0 ** rng.integers(-12, 0, (11, 1000))
    d = torch.from_numpy(p).to(cuda)
    got = exact_cumsum(d)
    assert torch.equal(got.view(torch.int64), exact_cumsum_plain(d).view(torch.int64))
    want = np.concatenate([np.zeros((11, 1)), np.cumsum(p, axis=1)], axis=1)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint64), want.view(np.uint64))
