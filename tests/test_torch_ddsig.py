"""The double-f32 significance stage and the margin descent of the port
against the JAX package (Pallas kernels in interpret mode), on the same
planes, tables and overflow lists made from a numpy seed.

Tolerance 0 throughout: the significant sets are equal, and the (hi, lo)
words of every unit-tip and wide-node confidence match bit for bit — the
port reproduces the scan's add tree and the pairwise tree of the sideband's
``associative_scan``. The sideband's scan tree and the margin descent are
in ``test_torch_ddsig_scan.py``: no file of the port's slow parity tests
holds more than ten tests (ROADMAP, tier-1's clock)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raxtax_tpu.db.database import build_database
from raxtax_tpu.ops import compress as jcompress
from raxtax_tpu.ops import nodeconf as jnc
from raxtax_tpu.utils.encoding import encode_sequence
from raxtax_tpu_torch.ops import compress as tcompress
from raxtax_tpu_torch.ops import nodeconf as tnc
from tests.test_torch_common import encode_planes, to_i32

B, N_PAD, P, S_MAX, BUDGET = 4, 4096, 7, 128, 64


def _world(seed: int, n_refs: int = 300):
    """A taxonomy with unit and wide eval nodes (several records per
    species, and one-record chains), counts with a contiguous high-count
    family, and a normalised f32 table."""
    rng = np.random.default_rng(seed)
    lineages = [
        f"p:P{i % 3},f:F{i % 11},g:G{i % 40},s:S{i // 2 if i % 5 else i}"
        for i in range(n_refs)
    ]
    seqs = [
        encode_sequence("".join("ACGT"[c] for c in rng.integers(0, 4, 40)))
        for _ in range(n_refs)
    ]
    db = build_database(lineages, seqs)
    tax = db.taxonomy
    counts = np.zeros((B, N_PAD), np.int64)
    counts[:, :n_refs] = rng.integers(0, 14, (B, n_refs))
    for b in range(B):
        lo = int(rng.integers(0, n_refs - 40))
        n_hot = int(rng.integers(5, 35))
        counts[b, lo : lo + n_hot] = rng.integers(16, 100, n_hot)
    counts[B - 1, :n_refs] = np.minimum(counts[B - 1, :n_refs], 15)  # no overflow
    planes = encode_planes(counts, P)
    table = np.zeros((B, S_MAX), np.float64)
    for b in range(B):
        w = rng.random(S_MAX) ** 8
        hist = np.bincount(counts[b, :n_refs], minlength=S_MAX)
        table[b] = w / (w * hist).sum()
    return db, tax, counts, planes, table.astype(np.float32)


def _split2(tax, n_refs, sideband: bool):
    ws, we, wp, uptr, _ = tax.unit_wide_arrays()
    has_unit = (uptr[1:] - uptr[:-1]) > 0
    bounds = np.concatenate([ws, we])
    order = np.argsort(bounds, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    sb = (
        (jnp.asarray(bounds[order].astype(np.int32)),
         jnp.asarray(rank[: ws.size].astype(np.int32)),
         jnp.asarray(rank[ws.size :].astype(np.int32)))
        if sideband else (None, None, None)
    )
    j = (jnp.asarray(ws), jnp.asarray(we), jnp.asarray(wp),
         jnp.asarray(has_unit)) + sb
    t = tuple(torch.from_numpy(np.ascontiguousarray(a)).long() for a in (ws, we, wp))
    return j, t + (torch.from_numpy(has_unit),)


def _jax_sets(vals, vals_lo, idx, n_sig):
    vals, vals_lo, idx, n_sig = (np.asarray(a) for a in (vals, vals_lo, idx, n_sig))
    assert (n_sig <= vals.shape[1]).all(), "raise top_k in the test"
    out = []
    for b in range(vals.shape[0]):
        # slots at or past n_sig hold top-k filler, -1 marks padding
        sel = (idx[b] != -1) & (np.arange(idx.shape[1]) < n_sig[b])
        out.append({
            int(c): (int(h), int(l))
            for c, h, l in zip(
                idx[b][sel], vals[b][sel].view(np.uint32),
                vals_lo[b][sel].view(np.uint32),
            )
        })
    return out


def _port_sets(sig):
    off, idx, hi, lo = sig.pull()
    return [
        {
            int(c): (int(h), int(l))
            for c, h, l in zip(
                idx[off[b] : off[b + 1]],
                hi[off[b] : off[b + 1]].view(np.uint32),
                lo[off[b] : off[b + 1]].view(np.uint32),
            )
        }
        for b in range(len(off) - 1)
    ]


MODES = ["split2_sideband", "split2_scatter", "split2_dense", "bm_scan", "plain"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", [31, 32])
def test_significant_nodes_planes_equal_jax(mode, seed):
    db, tax, counts, planes, table = _world(seed)
    n_refs = db.num_tips
    eval_ids = tax.eval_ids
    ns, ne = tax.range_start[eval_ids], tax.range_end[eval_ids]
    jplanes = jnp.asarray(planes)
    wire = jcompress.compress_planes(jplanes, budget=BUDGET, interpret=True)
    t_wire = tcompress.compress_planes(to_i32(planes), budget=BUDGET)
    with_over = mode != "split2_dense"
    jsplit, tsplit = (
        _split2(tax, n_refs, mode != "split2_scatter")
        if mode.startswith("split2") else (None, None)
    )
    got_j = jnc.significant_nodes_planes(
        jplanes, jnp.asarray(table), jnp.asarray(ns), jnp.asarray(ne),
        top_k=2048, interpret=True,
        over_idx=wire[1] if with_over else None,
        over_val=wire[2] if with_over else None,
        bm_scan=mode == "bm_scan", split2=jsplit, num_tips=n_refs,
    )
    sig, cum0 = tnc.significant_nodes_planes(
        to_i32(planes), torch.from_numpy(table),
        torch.from_numpy(ns).long(), torch.from_numpy(ne).long(),
        over_idx=t_wire[1] if with_over else None,
        over_val=t_wire[2] if with_over else None,
        bm_scan=mode == "bm_scan", split2=tsplit,
        sideband=mode != "split2_scatter", num_tips=n_refs,
    )
    want = _jax_sets(*got_j[:4])
    got = _port_sets(sig)
    assert sum(len(w) for w in want) > B  # the case selects something
    assert got == want
    if mode.startswith("split2"):
        assert cum0 is None and got_j[4] is None
        assert any(c < -1 for w in want for c in w)  # unit tips present
        assert any(c >= 0 for w in want for c in w)  # wide nodes present
    else:
        for mine, theirs in zip(cum0, got_j[4]):
            np.testing.assert_array_equal(
                mine.numpy().view(np.uint32), np.asarray(theirs).view(np.uint32)
            )
