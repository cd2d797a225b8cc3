"""The single-tip split on the planes backends (``significant_nodes_planes(
split=...)``, ``RAXTAX_SPLIT_SIG``) against the JAX package's, on the same
planes, tables and overflow lists made from a numpy seed; the JAX Pallas
kernels run in interpret mode.

Tolerance 0: per query the same entry codes (eval positions) with the same
(hi, lo) words, and the same prefix sums bit for bit. Cases: the tip-order
scan in the packed and the flat layout, the bit-major scan (the tip-order
table remapped to bit-major order), each with and without an overflow list,
and the precedence of the unit/wide split on the tip-order scan."""

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
from tests.test_torch_ddsig import _jax_sets, _port_sets, _split2

B, N_PAD, P, S_MAX, BUDGET, N_REFS = 2, 4096, 7, 128, 64, 300
W = N_PAD // 32


def _world(seed: int, overflow: bool, layout: str):
    """A taxonomy with single-tip and inner eval nodes (species of one and
    of two records), counts with a high-count family when ``overflow``,
    planes in ``layout``'s tip order, and a normalised f32 table."""
    rng = np.random.default_rng(seed)
    lineages = [
        f"p:P{i % 3},f:F{i % 11},g:G{i % 40},s:S{i // 2 if i % 5 else i}"
        for i in range(N_REFS)
    ]
    seqs = [
        encode_sequence("".join("ACGT"[c] for c in rng.integers(0, 4, 40)))
        for _ in range(N_REFS)
    ]
    tax = build_database(lineages, seqs).taxonomy
    counts = np.zeros((B, N_PAD), np.int64)
    counts[:, :N_REFS] = rng.integers(0, 14, (B, N_REFS))
    if overflow:
        for b in range(B):
            lo = int(rng.integers(0, N_REFS - 40))
            n_hot = int(rng.integers(5, 35))
            counts[b, lo : lo + n_hot] = rng.integers(16, 100, n_hot)
    table = np.zeros((B, S_MAX), np.float64)
    for b in range(B):
        w = rng.random(S_MAX) ** 8
        table[b] = w / (w * np.bincount(counts[b, :N_REFS], minlength=S_MAX)).sum()
    if layout == "flat":
        # flat: tip t at bit t // W of word t % W; encode_planes packs tip q
        # at bit q % 32 of word q // 32, so hand it the counts in that order
        counts = counts.reshape(B, 32, W).transpose(0, 2, 1).reshape(B, -1)
    return tax, encode_planes(counts, P), table.astype(np.float32)


def _both(tax, planes, table, overflow, layout, bm_scan, with_split2=False):
    eval_ids = tax.eval_ids
    ns, ne = tax.range_start[eval_ids], tax.range_end[eval_ids]
    split = tax.split_sig_arrays()
    jplanes = jnp.asarray(planes)
    wire = jcompress.compress_planes(
        jplanes, budget=BUDGET, interpret=True, layout=layout)
    t_wire = tcompress.compress_planes(to_i32(planes), budget=BUDGET, layout=layout)
    if overflow:
        assert int(np.asarray(wire[3]).max()) > 0  # tips above 15 exist
    jsplit2, tsplit2 = _split2(tax, N_REFS, True) if with_split2 else (None, None)
    got_j = jnc.significant_nodes_planes(
        jplanes, jnp.asarray(table), jnp.asarray(ns), jnp.asarray(ne),
        top_k=2048, interpret=True,
        over_idx=wire[1] if overflow else None,
        over_val=wire[2] if overflow else None,
        bm_scan=bm_scan, split=tuple(jnp.asarray(a) for a in split),
        layout=layout, split2=jsplit2, num_tips=N_REFS,
    )
    sig, cum0 = tnc.significant_nodes_planes(
        to_i32(planes), torch.from_numpy(table),
        torch.from_numpy(ns).long(), torch.from_numpy(ne).long(),
        over_idx=t_wire[1] if overflow else None,
        over_val=t_wire[2] if overflow else None,
        bm_scan=bm_scan, layout=layout, split2=tsplit2, num_tips=N_REFS,
        split=_port_split(split, bm_scan, planes.shape[2]),
    )
    return got_j, sig, cum0, split


def _port_split(split, bm_scan, S):
    """The port's split: on the bit-major scan its tip table is remapped
    once (``convert.device_state``), not on every call."""
    t = tuple(torch.from_numpy(a).long() for a in split)
    return (*t[:3], tnc.bitmajor_evalpos(t[3], S)) if bm_scan else t


@pytest.mark.parametrize(
    "layout,bm_scan,overflow",
    [("packed", False, True), ("packed", False, False), ("flat", False, True),
     ("packed", True, True), ("packed", True, False)],
    ids=["tip-packed-over", "tip-packed", "tip-flat-over", "bm-over", "bm"],
)
def test_split_compaction_on_planes_equals_jax(layout, bm_scan, overflow):
    tax, planes, table = _world(61, overflow, layout)
    got_j, sig, cum0, split = _both(tax, planes, table, overflow, layout, bm_scan)
    want = _jax_sets(*got_j[:4])
    got = _port_sets(sig)
    assert got == want
    single = set(split[3][split[3] >= 0].tolist())
    inner = set(split[2].tolist())
    codes = {c for w in want for c in w}
    # both parts of the split select something; every code is an eval position
    assert codes & single and codes & inner and min(codes) >= 0
    for mine, theirs in zip(cum0, got_j[4]):
        np.testing.assert_array_equal(
            mine.numpy().view(np.uint32), np.asarray(theirs).view(np.uint32)
        )


def test_unit_wide_split_wins_on_the_tip_order_scan():
    """With both splits the tip-order scan takes the unit/wide one (unit
    tips as ``-(tip + 2)`` codes, no prefix sums kept), in both packages."""
    tax, planes, table = _world(62, True, "packed")
    got_j, sig, cum0, _ = _both(
        tax, planes, table, True, "packed", False, with_split2=True)
    want = _jax_sets(*got_j[:4])
    assert _port_sets(sig) == want
    assert cum0 is None and got_j[4] is None
    assert any(c < -1 for w in want for c in w)
