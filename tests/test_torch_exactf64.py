"""The port's software f64 (``raxtax_tpu_torch.ops.exactf64``) against the JAX
package's ``ops/exactf64.py``, numpy and torch ``float64``, and the plain
versions of K11 and K12 against the JAX algorithm run the probes' way.
Every comparison is bit for bit (tolerance 0)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raxtax_tpu.ops import exactf64 as jx
from raxtax_tpu_torch.ops import exactf64 as xf
from raxtax_tpu_torch.tools.probe_f64 import adversarial_pairs
from tests import test_torch_common  # noqa: F401  (one torch thread per worker)

N_PAIRS = 30_000


@pytest.fixture(scope="module")
def pairs():
    """Adversarial pairs and their (hi, lo) halves, made once from a seed."""
    a, b = adversarial_pairs(np.random.default_rng(0), N_PAIRS)
    return a, b, xf.split64(a), xf.split64(b)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


@pytest.mark.parametrize("op", ["add", "sub", "to_f32", "lt", "le"])
def test_ops_equal_the_jax_module(pairs, op):
    a, b, (ah, al), (bh, bl) = pairs
    if op in ("add", "sub"):
        if op == "sub":  # contract: a >= b
            hi, lo = np.maximum(a, b), np.minimum(a, b)
            (ah, al), (bh, bl) = xf.split64(hi), xf.split64(lo)
        fn_t, fn_j = (xf.f64_add, jx.f64_add) if op == "add" else (xf.f64_sub, jx.f64_sub)
        th, tl = fn_t(ah, al, bh, bl)
        jh, jl = fn_j(ah, al, bh, bl)
        np.testing.assert_array_equal(_u32(th), np.asarray(jh))
        np.testing.assert_array_equal(_u32(tl), np.asarray(jl))
    elif op == "to_f32":
        got = xf.f64_to_f32(ah, al).numpy()
        want = np.asarray(jx.f64_to_f32(ah, al))
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    else:
        fn_t, fn_j = (xf.f64_lt, jx.f64_lt) if op == "lt" else (xf.f64_le, jx.f64_le)
        np.testing.assert_array_equal(
            fn_t(ah, al, bh, bl).numpy(), np.asarray(fn_j(ah, al, bh, bl)))


@pytest.mark.parametrize("op", ["add", "sub"])
def test_ops_equal_numpy_and_torch_float64(pairs, op):
    a, b, _, _ = pairs
    if op == "sub":
        a, b = np.maximum(a, b), np.minimum(a, b)
    (ah, al), (bh, bl) = xf.split64(a), xf.split64(b)
    fn = xf.f64_add if op == "add" else xf.f64_sub
    ch, cl = fn(ah, al, bh, bl)
    got = xf.join64(_u32(ch), _u32(cl))
    want_np = a + b if op == "add" else a - b
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    want_t = (ta + tb if op == "add" else ta - tb).numpy()
    np.testing.assert_array_equal(got.view(np.uint64), want_np.view(np.uint64))
    np.testing.assert_array_equal(got.view(np.uint64), want_t.view(np.uint64))


def test_ops_equal_the_jax_module_outside_the_contract():
    """Arbitrary words (the operation-chain probe feeds f64_add such state):
    the same integer algorithm gives the same bits, sign and inf/NaN
    patterns included."""
    w = np.random.default_rng(1).integers(0, 2**32, (4, 20_000), np.uint64)
    w = w.astype(np.uint32)
    for fn_t, fn_j in ((xf.f64_add, jx.f64_add), (xf.f64_sub, jx.f64_sub)):
        th, tl = fn_t(*w)
        jh, jl = fn_j(*w)
        np.testing.assert_array_equal(_u32(th), np.asarray(jh))
        np.testing.assert_array_equal(_u32(tl), np.asarray(jl))


def test_k11_plain_equals_jax_add_then_sub(pairs):
    """K11's plain version: ``c = a + b`` and ``c - b`` per element, as the
    probe kernel (probe_mosaic_f64.py ew_kernel) computes them."""
    _, _, (ah, al), (bh, bl) = pairs
    ch, cl, dh, dl = xf.probe_f64_ew_plain(
        *(torch.from_numpy(x.view(np.int32)) for x in (ah, al, bh, bl)))
    jch, jcl = jx.f64_add(ah, al, bh, bl)
    jdh, jdl = jx.f64_sub(jch, jcl, bh, bl)
    for got, want in ((ch, jch), (cl, jcl), (dh, jdh), (dl, jdl)):
        np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))


def test_k12_plain_equals_jax_scan_and_a_numpy_loop():
    """K12's plain version at ``[G=2, N=512, 128]`` against JAX ``f64_add``
    carried by ``lax.scan`` over tips (lanes vectorised) and against a numpy
    f64 running sum over tips."""
    rng = np.random.default_rng(2)
    G, N = 2, 512
    p = rng.random((G, N, 128)) * 1e-6
    p[rng.random(p.shape) < 0.3] = 0.0
    p[:, ::7] = p[:, :1]  # repeated values: ties in the running sum
    ph, pl = xf.split64(p)
    oh, ol = xf.probe_f64_scan_plain(
        torch.from_numpy(ph.view(np.int32)), torch.from_numpy(pl.view(np.int32)))

    def body(carry, x):
        h, l = jx.f64_add(carry[0], carry[1], x[0], x[1])
        return (h, l), (h, l)

    zero = jnp.zeros((G, 128), jnp.uint32)
    _, (jh, jl) = jax.lax.scan(
        body, (zero, zero),
        (jnp.asarray(ph.transpose(1, 0, 2)), jnp.asarray(pl.transpose(1, 0, 2))))
    np.testing.assert_array_equal(oh.numpy().view(np.uint32),
                                  np.asarray(jh).transpose(1, 0, 2))
    np.testing.assert_array_equal(ol.numpy().view(np.uint32),
                                  np.asarray(jl).transpose(1, 0, 2))
    acc = np.zeros((G, 128))
    want = np.empty_like(p)
    for t in range(N):
        acc = acc + p[:, t]
        want[:, t] = acc
    got = xf.join64(oh.numpy().view(np.uint32), ol.numpy().view(np.uint32))
    np.testing.assert_array_equal(got.view(np.uint64), want.view(np.uint64))
