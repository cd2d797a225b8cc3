"""K4 parity in f32: the port's plane table lookup with the multiplexed
low bits and the zeroed high plane against the JAX package's Pallas kernel
(interpret mode), bit for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raxtax_tpu.ops.planes import planes_probs as jax_probs
from raxtax_tpu_torch.ops.planes import planes_probs
from tests.test_torch_common import to_i32
from tests.test_torch_planes import world  # noqa: F401  (the fixture)


@pytest.mark.parametrize("mux_bits,zero_high", [(4, False), (4, True), (6, True), (7, True)])
def test_probs_f32_mux_and_zero_high_equal_jax(world, mux_bits, zero_high):
    counts, planes, num_tips = world
    B = counts.shape[0]
    rng = np.random.default_rng(9)
    table = rng.random((B, 128)).astype(np.float32)
    want = np.asarray(
        jax_probs(
            jnp.asarray(planes), jnp.asarray(table), mux_bits=mux_bits,
            interpret=True, zero_high=zero_high,
        )
    )
    got = planes_probs(
        to_i32(planes), torch.from_numpy(table), mux_bits=mux_bits,
        zero_high=zero_high,
    )
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
