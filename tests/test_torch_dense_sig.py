"""The dense-count backend's double-f32 significance stage against the JAX
package's ``significant_nodes``, on the same numpy inputs, with and without
the single-tip split, at tip counts that are a multiple of 128 (K6's add
order) and that are not (the pairwise tree of ``associative_scan``, odd and
even widths).

Tolerance 0: the scans add in the JAX package's order, so ``(hi, lo)`` are
compared bit for bit; the significant sets also after the host's rounding."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raxtax_tpu.db.database import build_database
from raxtax_tpu.ops import nodeconf as jnc
from raxtax_tpu.utils.encoding import encode_sequence
from raxtax_tpu_torch.ops import nodeconf
from tests.test_torch_common import port_db


def _bits(a: torch.Tensor) -> np.ndarray:
    return a.numpy().view(np.uint32)


def _taxonomy_world(n_refs: int):
    """A database whose eval view has inner nodes, single-tip nodes and
    1-record chains; only its taxonomy is used."""
    rng = np.random.default_rng(n_refs)
    seqs = ["".join("ACGT"[i] for i in rng.integers(0, 4, 24)) for _ in range(n_refs)]
    lineages = [f"p:P{i % 3},g:G{i % 3}_{i % 17},s:S{i // 2}" for i in range(n_refs)]
    return build_database(lineages, [encode_sequence(s) for s in seqs])


def _sig_inputs(n, seed):
    rng = np.random.default_rng(seed)
    B, s_max = 3, 32
    counts = rng.integers(0, 6, size=(B, n))
    counts[:, rng.choice(n, 9, replace=False)] = rng.integers(10, 31, size=(B, 9))
    table = np.zeros((B, s_max), np.float32)
    for b in range(B):
        w = np.exp(rng.normal(0, 1, s_max) + np.arange(s_max) * 0.45)
        table[b] = (w / w[counts[b]].sum()).astype(np.float32)
    return counts.astype(np.float32), table


@pytest.mark.parametrize("n", [203, 250, 256])
def test_dd_prefix_sums_equal_jax_bit_for_bit(n):
    """Odd and even widths go through the pairwise tree of
    ``associative_scan``, a multiple of 128 through K6's add order."""
    counts, table = _sig_inputs(n, 1)
    probs = np.array(jnc.gather_table(jnp.asarray(counts), jnp.asarray(table)))
    jhi, jlo = (np.asarray(a) for a in jnc.tip_prob_cumsum_dd(jnp.asarray(probs), interpret=True))
    hi, lo = nodeconf.tip_prob_cumsum_dd(torch.from_numpy(probs))
    assert hi.shape == (3, n + 1)
    np.testing.assert_array_equal(_bits(hi), jhi.view(np.uint32))
    np.testing.assert_array_equal(_bits(lo), jlo.view(np.uint32))
    exact = np.cumsum(probs.astype(np.float64), axis=1)
    got = hi.numpy().astype(np.float64) + lo.numpy().astype(np.float64)
    assert np.abs(got[:, 1:] - exact).max() < 1e-12


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("n", [203, 256])
def test_significant_nodes_equal_jax(n, split):
    """Same significant set, same ``(hi, lo)`` bits per entry, same values
    after the host's recombination and rounding; the descent's prefix sums
    too."""
    from raxtax_tpu.utils.encoding import round_half_away

    jdb = _taxonomy_world(n)
    tax = jdb.taxonomy
    assert tax.num_tips == n
    starts = tax.range_start[tax.eval_ids].astype(np.int32)
    ends = tax.range_end[tax.eval_ids].astype(np.int32)
    counts, table = _sig_inputs(n, 2)
    jsplit = tsplit = None
    if split:
        arrays = tax.split_sig_arrays()
        assert (arrays[3] >= 0).any() and arrays[0].size
        jsplit = tuple(jnp.asarray(a) for a in arrays)
        parr = port_db(jdb).taxonomy.split_sig_arrays()
        for a, b in zip(arrays, parr):
            np.testing.assert_array_equal(a, b)
        tsplit = tuple(torch.from_numpy(a.astype(np.int64)) for a in parr)
    vals, vals_lo, idx, n_sig, (jhi, jlo) = jnc.significant_nodes(
        jnp.asarray(counts), jnp.asarray(table), jnp.asarray(starts),
        jnp.asarray(ends), top_k=1024, split=jsplit,
    )
    vals, vals_lo, idx, n_sig = (np.asarray(a) for a in (vals, vals_lo, idx, n_sig))
    sig, (hi, lo) = nodeconf.significant_nodes(
        torch.from_numpy(counts), torch.from_numpy(table),
        torch.from_numpy(starts.astype(np.int64)),
        torch.from_numpy(ends.astype(np.int64)), split=tsplit,
    )
    np.testing.assert_array_equal(_bits(hi), np.asarray(jhi).view(np.uint32))
    np.testing.assert_array_equal(_bits(lo), np.asarray(jlo).view(np.uint32))
    off, pidx, phi, plo = sig.pull()
    assert off[-1] == n_sig.sum() and n_sig.min() > 0
    for b in range(counts.shape[0]):
        m = int(n_sig[b])
        want = {int(i): (h, l) for i, h, l in zip(
            idx[b, :m], vals[b, :m].view(np.uint32), vals_lo[b, :m].view(np.uint32))}
        s, e = off[b], off[b + 1]
        got = {int(i): (h, l) for i, h, l in zip(
            pidx[s:e], phi[s:e].view(np.uint32), plo[s:e].view(np.uint32))}
        assert len(got) == e - s and got == want
        c_got = phi[s:e].astype(np.float64) + plo[s:e].astype(np.float64)
        c_want = vals[b, :m].astype(np.float64) + vals_lo[b, :m].astype(np.float64)
        by = np.argsort(pidx[s:e]), np.argsort(idx[b, :m])
        np.testing.assert_array_equal(
            round_half_away(c_got[by[0]]), round_half_away(c_want[by[1]])
        )
