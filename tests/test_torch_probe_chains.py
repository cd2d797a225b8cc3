"""The probes' Hopper redesign off the card: K13's plain chains against the
JAX probe's bodies at the step counts around the kernel's unrolled loop,
K12's plain scan against a JAX scan at ragged tip counts, the device
header's software f64 (``csrc/exactf64.cuh``) built for the host against
the plain version on whole-space words, the floors and bounds of K11-K13,
the SASS reader that counts their instructions, and the A/B tool's probe
stems. Every comparison is bit for bit (tolerance 0)."""

import json
import re
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raxtax_tpu.ops.exactf64 import f64_add as jax_f64_add
from raxtax_tpu_torch.ops import exactf64 as xf
from raxtax_tpu_torch.ops.opchain import CHAINS, UNROLL, probe_op_chain, probe_state
from raxtax_tpu_torch.tools import kernel_ab, kernel_batch, probe_f64, probe_ops
from tests import test_torch_common  # noqa: F401  (one torch thread per worker)
from tests.test_torch_probes import BODIES

CSRC = Path(xf.__file__).resolve().parent.parent / "csrc"
EDGES = (0, 1, UNROLL - 1, UNROLL, UNROLL + 1, 2 * UNROLL + 3)


def _jax_chain(name, a, b, n):
    """``s0 ^ s1`` after 0, 1, ..., n steps of the JAX probe's body: the
    light bodies step by step, f64_add once compiled."""
    st = (a, a + jnp.uint32(1))
    if name == "f64_add_full":
        return _jax_f64_chain(st, b, a, n)
    out = [np.asarray(st[0] ^ st[1])]
    for _ in range(n):
        st = BODIES[name](st, a, b)
        out.append(np.asarray(st[0] ^ st[1]))
    return out


@jax.jit
def _jax_f64_chain_states(st, b, a, steps):
    def step(st, _):
        st = BODIES["f64_add_full"](st, a, b)
        return st, st[0] ^ st[1]

    _, after = jax.lax.scan(step, st, steps)
    return jnp.concatenate([(st[0] ^ st[1])[None], after])


def _jax_f64_chain(st, b, a, n):
    return np.asarray(_jax_f64_chain_states(st, b, a, jnp.zeros(n)))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _inputs():
    """The probe's state and one of whole-space words."""
    return [probe_state(), probe_ops.whole_space_state("cpu", 1)]


@pytest.mark.parametrize("names", [CHAINS[:-1], CHAINS[-1:]],
                         ids=["one_operation", "f64_add_full"])
def test_chains_plain_equal_jax_at_the_unroll_edges(names):
    """Every chain at 0, 1, U - 1, U, U + 1 and 2U + 3 steps, on the probe's
    state and on whole-space words (f64_add_full outside its contract)."""
    assert probe_ops.EDGE_ITERS == EDGES
    for x, y in _inputs():
        a, b = jnp.asarray(_u32(x)), jnp.asarray(_u32(y))
        for name in names:
            want = _jax_chain(name, a, b, max(EDGES))
            for n in EDGES:
                got = probe_op_chain(name, x, y, n)  # a CPU tensor: the plain version
                np.testing.assert_array_equal(_u32(got), want[n],
                                              err_msg=f"{name} at {n} steps")


def test_scan_plain_equals_a_jax_scan_at_ragged_tips_on_whole_space_words():
    """K12's plain version at one tip, a ring tile less one and a tile and
    one, on whole-space addends, against ``lax.scan`` of the JAX add."""
    assert xf.SCAN_TILE == 64

    def scan(ph, pl):
        def step(c, p):
            c = jax_f64_add(c[0], c[1], p[0], p[1])
            return c, c
        zero = jnp.zeros(ph.shape[::2], jnp.uint32)
        _, (h, l) = jax.lax.scan(step, (zero, zero),
                                 (jnp.swapaxes(ph, 0, 1), jnp.swapaxes(pl, 0, 1)))
        return np.swapaxes(np.asarray(h), 0, 1), np.swapaxes(np.asarray(l), 0, 1)

    n_max = xf.SCAN_TILE + 1
    ph, pl, _, _ = probe_f64.whole_space_halves((2, n_max, 128), "cpu", 7)
    want_h, want_l = scan(jnp.asarray(_u32(ph)), jnp.asarray(_u32(pl)))
    for n in (1, xf.SCAN_TILE - 1, n_max):  # a scan's prefix is a scan
        got_h, got_l = xf.probe_f64_scan(ph[:, :n].contiguous(),
                                         pl[:, :n].contiguous())  # plain
        np.testing.assert_array_equal(_u32(got_h), want_h[:, :n])
        np.testing.assert_array_equal(_u32(got_l), want_l[:, :n])


DRIVER = r"""
#define RX_EXACTF64_HOST 1
#include "exactf64.cuh"
#include <stdio.h>
int main() {
    unsigned w[4], c[4];
    while (fread(w, 4, 4, stdin) == 4) {
        rx_f64_add_u32(w[0], w[1], w[2], w[3], c[0], c[1]);
        rx_f64_sub_u32(w[0], w[1], w[2], w[3], c[2], c[3]);
        fwrite(c, 4, 4, stdout);
    }
    return 0;
}
"""


def _edge_words(rng, n):
    """Word pairs at the add's edges: the exponents 0 and 2047 with the sign
    bit, equal and 1-ulp-apart words, zeros, exponent gaps of 0..66, sparse
    mantissas (sticky bits and exact ties)."""
    w = rng.integers(0, 2**32, (n, 4), dtype=np.uint64).astype(np.uint32)
    k = n // 8
    w[:k, 0] &= 0x800FFFFF  # exponent 0
    w[k : 2 * k, 2] |= 0x7FF00000  # exponent 2047
    w[2 * k : 3 * k, 2:] = w[2 * k : 3 * k, :2]  # equal words
    w[3 * k : 4 * k, 2:] = w[3 * k : 4 * k, :2]
    w[3 * k : 4 * k, 3] += 1
    w[4 * k : 5 * k : 2, :2] = 0  # zeros
    w[4 * k + 1 : 5 * k : 2, 2:] = 0
    gap = rng.integers(0, 67, k).astype(np.uint32)
    hi = w[5 * k : 6 * k, 0] & 0x7FF00000
    w[5 * k : 6 * k, 2] = (((hi >> 20) - gap) & 0x7FF) << 20 | (
        w[5 * k : 6 * k, 2] & 0xFFFFF)
    sparse = rng.integers(0, 2**32, (2 * k, 2), dtype=np.uint64).astype(np.uint32)
    w[6 * k : 8 * k, 1::2] &= sparse & (sparse >> 3)
    return w


def test_device_add_and_sub_built_for_the_host_equal_the_plain_version(tmp_path):
    """``csrc/exactf64.cuh`` compiled by the host compiler (the kernels'
    arithmetic, with ``RX_EXACTF64_HOST``) against :func:`f64_add` and
    :func:`f64_sub` on whole-space words and on the add's edges."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    (tmp_path / "drv.cpp").write_text(DRIVER)
    exe = tmp_path / "drv"
    subprocess.run([cxx, "-O1", "-std=c++17", "-I", str(CSRC), "-o", str(exe),
                    str(tmp_path / "drv.cpp")], check=True)
    rng = np.random.default_rng(12)
    w = np.concatenate([
        rng.integers(0, 2**32, (1 << 16, 4), dtype=np.uint64).astype(np.uint32),
        _edge_words(rng, 1 << 16),
    ])
    out = subprocess.run([str(exe)], input=w.tobytes(), capture_output=True,
                         check=True).stdout
    got = np.frombuffer(out, np.uint32).reshape(-1, 4)
    ah, al, bh, bl = (torch.from_numpy(w[:, i].astype(np.int64)) for i in range(4))
    for cols, fn in (((0, 1), xf.f64_add), ((2, 3), xf.f64_sub)):
        want = np.stack([x.numpy() for x in fn(ah, al, bh, bl)], 1)
        np.testing.assert_array_equal(got[:, cols], want.astype(np.uint32),
                                      err_msg=fn.__name__)


def test_floors_and_bounds_of_the_probes():
    """K11-K13's bounds and chain floors on hand-computed shapes."""
    peak_b, peak_i = kernel_batch.PEAK_BYTES_PER_S, kernel_batch.PEAK_INT32_OPS
    k11 = kernel_batch.probe_ew_bounds(1000, 400.0)
    assert k11 == {"bound_ms": max(32_000 / peak_b, 400_000 / peak_i) * 1e3,
                   "bound_by": "operations"}
    k12 = kernel_batch.probe_scan_bounds(256, 1 << 20, 53.0, 48.0)
    assert k12["bound_by"] == "bytes"  # 53 instructions an add: under 16 B
    assert k12["bound_ms"] == 256 * (1 << 20) * 16 / peak_b * 1e3
    assert k12["chain_floor_ms"] == (1 << 20) * 48.0 * 1e-6
    sass = {"u32_add_x1": {"instructions_per_step": 0.75, "dependent_per_step": 0.5},
            "f64_add_full": {"instructions_per_step": 53.0, "dependent_per_step": 14.0}}
    # one dependent operation: 1.25 ns a step over half an operation a step
    assert kernel_batch.dependent_op_ns(1.25, sass) == 2.5
    k13 = kernel_batch.op_chain_bounds(sass, 1024, 1000, 2.5)
    assert k13["dependent_op_ns"] == 2.5
    assert k13["chain_floor_ms_by_chain"] == {
        "u32_add_x1": 1000 * 0.5 * 2.5 * 1e-6,
        "f64_add_full": 1000 * 14.0 * 2.5 * 1e-6}
    assert k13["chain_floor_ms"] == sum(k13["chain_floor_ms_by_chain"].values())
    assert k13["bound_ms"] == max(1024 * 24 / peak_b,
                                  53.75 * 1024 * 1000 / peak_i) * 1e3


SASS = """
        code for sm_90a
                Function : _ZN12_GLOBAL__N_115op_chain_kernelILi6EEEvPKjS2_Pjii
        /*0000*/                   MOV R1, c[0x0][0x28] ;          /* 0x0 */
        /*0010*/                   IADD3 R4, P0, R2, R3, RZ ;      /* 0x0 */
        /*0020*/                   ISETP.GT.U32.AND P1, PT, R4, R5, PT ;
        /*0030*/                   SEL R6, R4, R5, P1 ;
        /*0040*/                   IMAD.X R7, RZ, RZ, R6, P0 ;
        /*0050*/               @P1 LOP3.LUT R2, R7, R6, RZ, 0xfc, !PT ;
        /*0060*/                   SHF.R.U64 R3, R2, 0x2, R7.reuse ;
        /*0070*/                   UIADD3 UR4, UR4, 0x2, URZ ;
        /*0080*/              @!P2 BRA 0x10 ;
        /*0090*/                   EXIT ;
                Function : _ZN12_GLOBAL__N_119probe_f64_ew_kernelEPKjS1_S1_S1_PjS2_S2_S2_x
.L_x_3:
        /*0000*/                   LDG.E R4, desc[UR4][R2.64] ;
        /*0010*/                   IADD3 R5, R4, 0x1, RZ ;
        /*0020*/                   STG.E desc[UR4][R8.64], R5 ;
        /*0030*/                   STG.E desc[UR4][R10.64], R5 ;
        /*0040*/                   STG.E desc[UR4][R12.64], R5 ;
        /*0050*/               @P0 STG.E desc[UR4][R14.64], R5 ;
        /*0060*/              @!P0 BRA `(.L_x_3) ;
"""


def test_sass_reader_counts_the_loop_and_its_dependent_path():
    """The unrolled loop of a chain (a backward branch to an address), its
    instructions and its dependent path a step; predicate destinations and
    a predicated write (which keeps its old value) are dependences. K11's
    loop (a backward branch to a label) is one element a trip: four
    stores."""
    chains = probe_ops.chain_sass(SASS, unroll=2)
    # one trip: R2 -> IADD3 -> ISETP -> SEL -> IMAD.X -> @P1 LOP3 -> SHF,
    # and the next trip's IADD3 reads R2 and R3: six dependent a trip
    assert chains == {"f64_add_full": {"loop_instructions": 8,
                                       "instructions_per_step": 4.0,
                                       "dependent_per_step": 3.0}}
    assert probe_ops.ew_instructions_per_pair(SASS) == 7.0


def test_unroll_and_tile_constants_match_the_sources(tmp_path):
    """The Python constants the tests and tools use are the kernels'; an
    older K13 without ``CHAIN_UNROLL`` walks one step a trip."""
    ops_src = (CSRC / "probe_ops.cu").read_text()
    f64_src = (CSRC / "probe_f64.cu").read_text()
    assert int(re.search(r"CHAIN_UNROLL = (\d+);", ops_src).group(1)) == UNROLL
    assert int(re.search(r"SCAN_TILE = (\d+);", f64_src).group(1)) == xf.SCAN_TILE
    assert kernel_ab.design_unroll(CSRC) == UNROLL
    (tmp_path / "probe_ops.cu").write_text(ops_src.replace("CHAIN_UNROLL", "U"))
    assert kernel_ab.design_unroll(tmp_path) == 1


def test_kernel_ab_knows_the_probe_stems_and_builds_nothing_on_the_cpu(
        tmp_path, monkeypatch, capsys):
    """``probe_f64`` (K12, and K11 on the same source) and ``probe_ops``
    (K13) are stems of the A/B tool with the package's argument lists; the
    probe cases run on their own, and without a GPU nothing is built."""
    from raxtax_tpu_torch.ops import _build, exactf64, opchain

    assert kernel_ab.KERNELS["probe_f64"] == "rx_probe_f64_scan"
    assert kernel_ab.KERNELS["probe_ops"] == "rx_probe_op_chain"
    assert {kernel_ab.CASES[c] for c in kernel_ab.PROBE_CASES} == {
        "probe_f64", "probe_ops"}
    assert kernel_ab.package_argtypes("probe_f64") is exactf64._SCAN_ARGTYPES
    assert kernel_ab.package_argtypes("probe_ops") is opchain._ARGTYPES
    if torch.cuda.is_available():
        return
    monkeypatch.setattr(_build, "build_all", lambda *a, **k: pytest.fail("built"))
    cases = ",".join(kernel_ab.PROBE_CASES)
    assert kernel_ab.main(["--other", str(tmp_path), "--cases", cases]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        kernel_ab.main(["--other", str(tmp_path), "--cases", cases + ",fold_planes"])


def test_probe_f64_lines_carry_both_yardsticks_and_the_word_checks():
    """The probe tool's K11 line times the one call a + b and the two calls
    c = a + b; c - b (K11's function), "not measured" on the CPU; its
    whole-space line holds K11 and K12 at ragged tips against their plain
    versions."""
    rng = np.random.default_rng(3)
    a, b = probe_f64.adversarial_pairs(rng, 256)
    line = probe_f64.check_ew(a, b, torch.device("cpu"), "ew", 64)
    assert line["hardware_add_ms"] == line["hardware_add_sub_ms"] == "not measured"
    assert line["bits_equal_hardware_f64"] and line["bits_equal_plain"]
    words = probe_f64.check_words(torch.device("cpu"), 512, [(1, 1), (2, 3)], 4)
    assert probe_f64.passed(words)
    assert sorted(k for k in words if k.startswith("bits_equal")) == [
        "bits_equal_plain_ew", "bits_equal_plain_scan_1x1",
        "bits_equal_plain_scan_2x3"]
    json.dumps(words)
