"""The probe kernels' plain versions and tools on the CPU: K13's seven chains
against a JAX ``fori_loop`` of the same bodies (tolerance 0), and the two
probe tools end to end at tiny sizes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raxtax_tpu.ops.exactf64 import f64_add as jax_f64_add
from raxtax_tpu_torch.ops.opchain import CHAINS, probe_op_chain, probe_state
from raxtax_tpu_torch.tools import probe_f64, probe_ops
from tests import test_torch_common  # noqa: F401  (one torch thread per worker)

ITERS = 64

# the bodies of scripts/probe_mosaic_perf.py, on (st0, st1) and the inputs
BODIES = {
    "u32_add_x1": lambda st, a, b: (st[0] + b, st[1]),
    "u32_add_x8": lambda st, a, b: (st[0] + b + a + b + a + b + a + b + a, st[1]),
    "shift_fixed_x1": lambda st, a, b: (st[0] >> 5, st[1] + a),
    "shift_var_x1": lambda st, a, b: (st[0] >> (b & 31), st[1] + a),
    "shift_var_x4": lambda st, a, b: (
        (((st[0] >> (b & 31)) << (b & 15)) >> (b & 7)) << (b & 3), st[1] + a),
    "cmp_select_x1": lambda st, a, b: (
        jnp.where(st[0] > b, st[0] + a, st[1]), st[1] + a),
    "f64_add_full": lambda st, a, b: jax_f64_add(st[0], st[1], a, b),
}


@pytest.mark.parametrize("name", CHAINS)
def test_chain_plain_equals_jax_fori_loop(name):
    x, y = probe_state()
    a = jnp.asarray(x.numpy().view(np.uint32))
    b = jnp.asarray(y.numpy().view(np.uint32))
    body = BODIES[name]
    st = (a, a + jnp.uint32(1))
    st = jax.lax.fori_loop(0, ITERS, lambda i, s: body(s, a, b), st)
    want = np.asarray(st[0] ^ st[1])
    got = probe_op_chain(name, x, y, ITERS)  # a CPU tensor: the plain version
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_probe_tools_run_on_the_cpu(capsys):
    assert probe_f64.main([
        "--device", "cpu", "--pairs", "4096", "--plain-pairs", "512",
        "--tips", "256", "--plain-tips", "32",
    ]) == 0
    assert probe_ops.main(["--device", "cpu", "--iters", "16",
                           "--check-iters", "8"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3 + len(CHAINS)
    assert all('"bits_equal' in line for line in lines)
    assert '"not measured"' in lines[0]  # no device time on the CPU


def test_probe_f64_reports_the_first_mismatch():
    """The checker itself: a result one ulp off is found and located."""
    want = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)
    got = want.clone()
    got[1] = np.nextafter(2.0, 3.0)
    m = probe_f64.first_mismatch(got, want, want)
    assert m["index"] == 1 and m["count"] == 1
    assert m["want"]["value"] == 2.0
    assert probe_f64.first_mismatch(want, want.clone(), want) is None


def test_probe_tools_need_a_gpu_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe_f64.main(["--pairs", "16", "--tips", "128"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe_ops.main(["--iters", "1"])
