"""The sideband's prefix tree and the margin descent of the port against the
JAX package (Pallas kernels in interpret mode) on the world of
``test_torch_ddsig.py``. Tolerance 0: the prefix sums, the descent's final
nodes and its f32 margins match bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raxtax_tpu.ops import compress as jcompress
from raxtax_tpu.ops import nodeconf as jnc
from raxtax_tpu_torch.ops import compress as tcompress
from raxtax_tpu_torch.ops import nodeconf as tnc
from tests.test_torch_common import to_i32
from tests.test_torch_ddsig import B, BUDGET, _world


def test_sideband_scan_tree_equals_associative_scan():
    """The sideband prefix in the pairwise tree of
    ``jax.lax.associative_scan``, for even and odd lengths."""
    import jax

    rng = np.random.default_rng(5)
    for n in (1, 2, 7, 64, 513):
        v = (rng.random((3, n)) * 10.0 ** rng.integers(-8, 0, (3, n))).astype(np.float32)
        jh, jl = jax.lax.associative_scan(
            jnc._dd_add, (jnp.asarray(v), jnp.zeros_like(v)), axis=1
        )
        th, tl = tnc._dd_assoc_scan(torch.from_numpy(v), torch.zeros(3, n))
        np.testing.assert_array_equal(np.asarray(jh).view(np.uint32), th.numpy().view(np.uint32))
        np.testing.assert_array_equal(np.asarray(jl).view(np.uint32), tl.numpy().view(np.uint32))


@pytest.mark.parametrize("sideband", [True, False])
def test_cum_from_planes_and_margin_descent_equal_jax(sideband):
    """The descent's rebuilt prefix sums match bit for bit, and the margin
    descent ends at the same nodes with the same f32 margins."""
    from raxtax_tpu.engine.device import descent_arrays
    from raxtax_tpu.db.taxonomy import NODE_INNER

    db, tax, counts, planes, table = _world(41)
    jplanes = jnp.asarray(planes)
    wire = jcompress.compress_planes(jplanes, budget=BUDGET, interpret=True)
    t_wire = tcompress.compress_planes(to_i32(planes), budget=BUDGET)
    jcum = jnc.cum_from_planes(
        jplanes, jnp.asarray(table), wire[1], wire[2], interpret=True,
        sideband=sideband,
    )
    tcum = tnc.cum_from_planes(
        to_i32(planes), torch.from_numpy(table), t_wire[1], t_wire[2],
        sideband=sideband,
    )
    assert len(jcum) == len(tcum) == (5 if sideband else 2)
    for mine, theirs in zip(tcum, jcum):
        np.testing.assert_array_equal(
            mine.numpy().view(np.uint32), np.asarray(theirs).view(np.uint32)
        )
    inner = np.nonzero(tax.node_type == NODE_INNER)[0]
    rng = np.random.default_rng(9)
    starts = rng.choice(inner, 24).astype(np.int32)
    starts[0] = 0  # the root
    b_idx = rng.integers(0, B, 24).astype(np.int32)
    ptr, ids, is_inner, _ = descent_arrays(tax)
    jf, jm = jnc.max_descent(
        jcum, jnp.asarray(b_idx), jnp.asarray(starts),
        jnp.asarray(tax.range_start), jnp.asarray(tax.range_end),
        jnp.asarray(ptr), jnp.asarray(ids), jnp.asarray(is_inner),
    )
    tf, tm = tnc.max_descent(
        tcum, torch.from_numpy(b_idx), torch.from_numpy(starts),
        torch.from_numpy(tax.range_start), torch.from_numpy(tax.range_end),
        torch.from_numpy(tax.child_ptr), torch.from_numpy(tax.child_ids),
        torch.from_numpy(tax.node_type == NODE_INNER),
    )
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
    np.testing.assert_array_equal(
        np.asarray(jm).view(np.uint32), tm.numpy().view(np.uint32)
    )
    assert np.isfinite(np.asarray(jm)).any()
