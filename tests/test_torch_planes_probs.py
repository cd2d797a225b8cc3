"""K4 parity in f64: the port's plane table lookup against the JAX package's
Pallas kernel (interpret mode), bit for bit, over the two u32 halves of an
f64 table and past the end of a short table. The f32 lookups are in
``test_torch_planes_mux.py``."""

import numpy as np
import torch

import jax.numpy as jnp

from raxtax_tpu.ops.exactf64 import split64_np
from raxtax_tpu.ops.planes import planes_probs as jax_probs
from raxtax_tpu_torch.ops.planes import planes_probs, probs_to_tip_order
from tests.test_torch_common import to_i32
from tests.test_torch_planes import world  # noqa: F401  (the fixture)


def test_probs_f64_equals_jax_half_launches(world):
    """One f64 lookup == the JAX package's two launches over the u32 halves
    of the f64 table."""
    counts, planes, num_tips = world
    B = counts.shape[0]
    s_max = 128
    rng = np.random.default_rng(7)
    table = rng.random((B, s_max)) * 10.0 ** rng.integers(-12, 0, (B, s_max))
    th, tl = split64_np(table.reshape(-1))
    th, tl = th.reshape(B, s_max), tl.reshape(B, s_max)
    jp = jnp.asarray(planes)
    want_h = np.asarray(jax_probs(jp, jnp.asarray(th), interpret=True))
    want_l = np.asarray(jax_probs(jp, jnp.asarray(tl), interpret=True))
    got = planes_probs(to_i32(planes), torch.from_numpy(table))
    assert got.dtype == torch.float64 and got.shape == want_h.shape
    bits = got.contiguous().numpy().view(np.uint64)
    np.testing.assert_array_equal((bits >> np.uint64(32)).astype(np.uint32), want_h)
    np.testing.assert_array_equal(
        (bits & np.uint64(0xFFFFFFFF)).astype(np.uint32), want_l
    )
    flat = probs_to_tip_order(got).numpy()
    for b in range(B):
        np.testing.assert_array_equal(
            flat[b, :num_tips], table[b][counts[b, :num_tips]]
        )


def test_probs_short_table_reads_zero_past_its_end(world):
    counts, planes, num_tips = world
    B = counts.shape[0]
    table = np.random.default_rng(3).random((B, 40)).astype(np.float32)
    want = np.asarray(jax_probs(jnp.asarray(planes), jnp.asarray(table), interpret=True))
    got = planes_probs(to_i32(planes), torch.from_numpy(table))
    np.testing.assert_array_equal(got.numpy(), want)
