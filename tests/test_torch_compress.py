"""K8 and the planes wire on the CPU: ``planes_high_counts`` and
``compress_planes`` of the port against the JAX package (Pallas kernel in
interpret mode) on the same planes made from a numpy seed; the host decoders
against the known counts; the nibble wire of the dense-count backend
(``compress_counts`` / ``decompress_rows``) against the JAX package's.
Everything is an integer: tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raxtax_tpu.ops import compress as jc
from raxtax_tpu.ops import planes as jpl
from raxtax_tpu_torch import native
from raxtax_tpu_torch.ops import compress as tc
from raxtax_tpu_torch.ops import planes as tpl
from tests.test_torch_common import encode_planes, to_i32, to_u32

B, N, P, BUDGET = 4, 8192, 8, 40


def _counts(seed):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 16, (B, N))
    for b in range(B - 1):  # a contiguous family block plus scattered singles
        lo = int(rng.integers(0, N - 64))
        c[b, lo : lo + 20 + 15 * b] = rng.integers(16, 250, 20 + 15 * b)
        c[b, rng.choice(N, 5, replace=False)] = rng.integers(16, 250, 5)
    return c  # row B-1 has no count above 15; row 2 overflows the budget


def _flat_planes(counts):
    """The same counts in the flat layout: tip = bit * W + word."""
    W = N // 32
    by_word = counts.reshape(B, 32, W).transpose(0, 2, 1).reshape(B, N)
    return encode_planes(by_word, P)


def test_planes_high_counts_equals_jax_kernel():
    counts = _counts(1)
    planes = encode_planes(counts, P)
    want = np.asarray(jpl.planes_high_counts(jnp.asarray(planes), interpret=True))
    got = tpl.planes_high_counts(to_i32(planes))
    np.testing.assert_array_equal(want, got.numpy())
    tip_order = got.permute(0, 2, 3, 1).reshape(B, -1).numpy()
    np.testing.assert_array_equal(tip_order, np.where(counts > 15, counts, 0))


@pytest.mark.parametrize("layout", ["packed", "flat"])
def test_wire_equals_jax_and_decodes_to_the_counts(layout):
    counts = _counts(2)
    planes = encode_planes(counts, P) if layout == "packed" else _flat_planes(counts)
    j_lo4, j_idx, j_val, j_n, j_cov = (
        np.asarray(a) for a in jc.compress_planes(
            jnp.asarray(planes), budget=BUDGET, interpret=True, layout=layout
        )
    )
    lo4, over_idx, over_val, n_over = tc.compress_planes(
        to_i32(planes), budget=BUDGET, layout=layout
    )
    lo4_h = lo4.contiguous().numpy().view(np.uint32)
    np.testing.assert_array_equal(j_lo4, lo4_h)
    np.testing.assert_array_equal(j_n, n_over.numpy())
    np.testing.assert_array_equal(n_over.numpy(), (counts > 15).sum(axis=1))
    assert n_over[2] > BUDGET and n_over[B - 1] == 0
    idx_h = over_idx.numpy()
    val_h = over_val.numpy().astype(np.uint16)
    for b in range(B):
        n = min(int(n_over[b]), BUDGET)
        tips = np.nonzero(counts[b] > 15)[0][:n]
        np.testing.assert_array_equal(idx_h[b, :n], tips)  # ascending tip ids
        np.testing.assert_array_equal(val_h[b, :n], counts[b, tips])
        assert (idx_h[b, n:] == tc.OVER_SENTINEL).all()
        # an over-budget list is no one's contract (the JAX package keeps
        # the largest counts, the port the first tips; consumers use neither)
        if int(n_over[b]) <= BUDGET and int(j_cov[b]) == n:
            np.testing.assert_array_equal(j_idx[b], idx_h[b])
            np.testing.assert_array_equal(j_val[b, :n], val_h[b, :n])
    rows, over = tc.decompress_planes_rows(
        lo4_h, idx_h, val_h, n_over.numpy(), list(range(B)), N - 100,
        budget=BUDGET, layout=layout,
    )
    assert over == [2]
    for b in (0, 1, 3):
        np.testing.assert_array_equal(rows[b], counts[b, : N - 100])
    j_rows, j_over = jc.decompress_planes_rows(
        j_lo4, j_idx, j_val, j_n, list(range(B)), N - 100, budget=BUDGET,
        layout=layout,
    )
    assert j_over == over
    np.testing.assert_array_equal(j_rows[[0, 1, 3]], rows[[0, 1, 3]])
    np.testing.assert_array_equal(
        tc.decode_lo4(lo4_h[0], N, layout), counts[0] & 15
    )
    # the native decoder reads the same wire
    if native.get_lib() is not None:
        table = np.random.default_rng(0).random(256)
        cum = native.tip_cumsum_planes4(
            lo4_h[0], idx_h[0], val_h[0], int(n_over[0]), table, N - 100,
            flat_w=N // 32 if layout == "flat" else 0,
        )
        want = np.concatenate(([0.0], np.cumsum(table[counts[0, : N - 100]])))
        np.testing.assert_array_equal(cum, want)


@pytest.mark.parametrize("n,budget", [(203, 64), (256, 8), (40, 64)])
def test_nibble_wire_equals_jax_and_round_trips(n, budget):
    rng = np.random.default_rng(n)
    counts = rng.integers(0, 14, size=(4, n))
    hot = rng.random((4, n)) < 0.08
    counts[hot] = rng.integers(16, 400, size=int(hot.sum()))
    counts[3] = 15  # on the clamp, not over it
    cf = counts.astype(np.float32)
    jp, ji, jv, jn = (np.asarray(a) for a in
                      jc.compress_counts(jnp.asarray(cf), budget=budget))
    plane, idx, val, n_over = tc.compress_counts(torch.from_numpy(cf), budget=budget)
    assert plane.dtype == torch.int32 and plane.shape == (4, -(-n // 8))
    np.testing.assert_array_equal(to_u32(plane), jp)
    np.testing.assert_array_equal(n_over.numpy(), jn)
    idx, val = idx.numpy(), val.numpy()
    for b in range(4):
        m = min(int(jn[b]), budget)
        if jn[b] <= budget:  # the JAX list is exact whenever it fits
            np.testing.assert_array_equal(idx[b, :m], ji[b, :m])
            np.testing.assert_array_equal(val[b, :m], jv[b, :m])
        assert (idx[b, m:] == tc.OVER_SENTINEL).all() and not val[b, m:].any()
    rows = [2, 0, 3]
    got, over = tc.decompress_rows(
        to_u32(plane), idx, val.astype(np.uint16), n_over.numpy(), rows, n, budget=budget
    )
    want, jover = jc.decompress_rows(jp, ji, jv, jn, rows, n, budget=budget)
    assert over == jover
    for i, b in enumerate(rows):
        if i not in over:
            np.testing.assert_array_equal(got[i], counts[b])
            np.testing.assert_array_equal(got[i], want[i])
    assert n_over[3] == 0
    if n == 256:
        assert over  # eight slots do not hold a row's overflow
