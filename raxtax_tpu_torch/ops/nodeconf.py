"""Significance compaction and the fallback descent.

Two families share this module.

**Exact f64** (``compact_unit_wide``, ``compact_eval_nodes``): the unit/wide
split and the plain eval-node variant on exact f64 prefix sums.

**Double-f32** (``significant_nodes_planes``, ``cum_from_planes``,
``max_descent``): the JAX package's default significance path. Probabilities
are f32 table values, prefix sums are (hi, lo) pairs of f32 from the
TwoSum-compensated scan (K6 / K7, ``ops/planes.py``); ``float64(hi) +
float64(lo)`` lands within a few 1e-9 of the reference's sequential f64
value, and the engine replays on the host whatever sits closer than that to
a rounding boundary. With an overflow list (``ops/compress.py``) the lookup
kernel reads only the low four count bits; tips with a count above 15 are
either patched by a scatter or zeroed and carried in a *sideband*: the
double-f32 prefix of their table values over the short sorted list, added to
every range sum by a search for the range ends in that list.

**Dense counts** (``gather_table``, ``significant_nodes``): the same
double-f32 stage on a ``[B, N]`` count matrix, for the backend that builds no
planes. The JAX package looks the table up with a one-hot contraction at
``Precision.HIGHEST`` because a gather is slow on its chip; each output
selects one f32 exactly, which is ``torch.gather`` by semantics, so that is
what the port uses. ``_compact_split`` (``split`` of ``significant_nodes``,
and of ``significant_nodes_planes`` off the unit/wide path) reads
single-tip eval nodes straight from the probabilities.

What differs from the JAX package: it compacts with ``top_k`` into slots of a
sticky width that widens on overflow, packs the slots into one buffer for
its host link (``pack_significant``) and, for want of a compaction
primitive, selects through ``threshold_set_tiled``. Here the threshold mask
is compacted by ``torch.nonzero``: there is no width to outgrow, no re-run
and no packing, so those functions are replaced, not ported. Entry order
within a query differs (ascending position here, descending value there);
the host evaluation sorts its input and does not depend on it. Every value
is computed by the same elementwise operations in the same order, so unit
and wide confidences match the JAX package bit for bit.

Host contract (unchanged): per query a slice of ``(idx, conf)`` pairs, where
``idx >= 0`` is an eval-node position and ``idx <= -2`` codes a unit tip as
``-(tip + 2)``, to be expanded into all unit eval nodes of that tip.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .compress import OVER_SENTINEL
from .planes import (
    dd_cumsum,
    dd_cumsum_bitmajor,
    planes_probs,
    probs_to_tip_order,
)

#: device-side significance threshold: raw confidence that could round to
#: >= 0.01 at 2 decimals, with a little slack below the 0.005 cutoff. The
#: host re-rounds and prunes, so extras are harmless.
SIG_THRESHOLD = 0.005 - 1e-4


#: Smallest device argmax margin that PROVES agreement with the reference's
#: f64 comparison (src/lineage.rs:154-170). The descent compares child
#: confidences recombined as hi + lo in f32, so the error per confidence is
#: the final f32 rounding (~6e-8) plus the scan's ~4e-9; comparing two
#: children doubles it, and 1e-6 adds a ~4x cushion. Under a mesh the
#: model shards' partial confidences are summed in plain f32 (~log2(shards)
#: roundings more): the MESH bound. Descent steps whose margin falls below
#: the bound replay on the host in exact f64.
DESCENT_MARGIN_SAFE = 1e-6
DESCENT_MARGIN_SAFE_MESH = 1e-5


def _pull_parts(B: int, rows, codes, vals):
    """Sort the concatenated (row, code, value...) entries by query and
    copy them to the host: ``(off int64 [B+1], idx int32, *values)``."""
    rows = torch.cat(rows)
    codes = torch.cat(codes)
    order = torch.argsort(rows, stable=True)
    counts = torch.bincount(rows, minlength=B)
    off = np.zeros(B + 1, np.int64)
    np.cumsum(counts.cpu().numpy(), out=off[1:])
    return (
        off,
        codes[order].to(torch.int32).cpu().numpy(),
        *(torch.cat(v)[order].cpu().numpy() for v in vals),
    )


@dataclass
class SignificantSet:
    """Threshold masks queued on the device; :meth:`pull` compacts them,
    reads the exact values at the selected nodes and copies the result to
    the host (the only host synchronisation of the significance stage)."""

    cum: torch.Tensor  #: [B, Np+1] exact prefix sums
    #: list of (mask [B, n] bool, starts [n], ends [n], codes [n]), int64
    parts: list

    def pull(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(off int64 [B+1], idx int32 [total], conf float64 [total])``:
        query b owns ``[off[b], off[b+1])``; within a query the parts keep
        their order (wide nodes first, then unit tips)."""
        rows, codes, vals = [], [], []
        for mask, starts, ends, code in self.parts:
            r, j = torch.nonzero(mask, as_tuple=True)
            rows.append(r)
            codes.append(code[j])
            vals.append(self.cum[r, ends[j]] - self.cum[r, starts[j]])
        return _pull_parts(self.cum.shape[0], rows, codes, [vals])


def compact_unit_wide(
    cum: torch.Tensor,  # [B, Np+1] zero-prefixed exact tip cumsum
    wide_starts: torch.Tensor,  # [n_w]
    wide_ends: torch.Tensor,  # [n_w]
    wide_pos: torch.Tensor,  # [n_w] eval positions of the wide nodes
    tip_has_unit: torch.Tensor,  # [num_tips] bool: tip hosts >= 1 unit node
    num_tips: int,
) -> SignificantSet:
    """WIDE eval nodes (range > 1) through two boundary gathers of the
    cumsum; UNIT nodes (range 1) through the difference of neighbouring
    prefix sums, once per tip, coded ``-(tip + 2)``. A unit node's
    confidence is ``fl64(cum[t+1] - cum[t])`` as the reference computes it —
    not the tip's own probability, which differs from it by the rounding of
    the running sum."""
    n_p = cum.shape[1] - 1
    dev = cum.device
    ws, we = wide_starts.long(), wide_ends.long()
    conf_w = cum[:, we] - cum[:, ws]
    has_unit = torch.zeros(n_p, dtype=torch.bool, device=dev)
    has_unit[:num_tips] = tip_has_unit
    mask_t = ((cum[:, 1:] - cum[:, :-1]) >= SIG_THRESHOLD) & has_unit[None, :]
    tips = torch.arange(n_p, device=dev)
    return SignificantSet(
        cum=cum,
        parts=[
            (conf_w >= SIG_THRESHOLD, ws, we, wide_pos.long()),
            (mask_t, tips, tips + 1, -(tips + 2)),
        ],
    )


def compact_eval_nodes(
    cum: torch.Tensor,  # [B, Np+1]
    starts: torch.Tensor,  # [J] eval-node range starts
    ends: torch.Tensor,  # [J]
) -> SignificantSet:
    """Every eval node through the two boundary gathers; ``idx`` is the eval
    position."""
    s, e = starts.long(), ends.long()
    conf = cum[:, e] - cum[:, s]
    pos = torch.arange(s.shape[0], device=cum.device)
    return SignificantSet(
        cum=cum, parts=[(conf >= SIG_THRESHOLD, s, e, pos)]
    )


# -- compensated double-f32 arithmetic ---------------------------------


def _two_sum(a, b):
    """Knuth TwoSum: ``s + err == a + b`` exactly (f32)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _dd_add(x, y):
    """``(hi, lo) + (hi, lo)`` double-f32 addition, renormalised."""
    s, e = _two_sum(x[0], y[0])
    return _two_sum(s, e + x[1] + y[1])


def _dd_sub(x_hi, x_lo, y_hi, y_lo):
    """``(hi, lo) - (hi, lo)`` double-f32 subtraction, renormalised."""
    s, e = _two_sum(x_hi, -y_hi)
    return _two_sum(s, e + x_lo - y_lo)


def _dd_assoc_scan(hi, lo):
    """Inclusive double-f32 prefix along dim 1 in the add tree of the JAX
    package's ``jax.lax.associative_scan(_dd_add, ...)``: combine adjacent
    pairs, scan the half-length result recursively (the odd positions), fill
    the even positions from their left neighbour. A left-to-right loop or
    ``torch.cumsum`` would give other low bits."""
    n = hi.shape[1]
    if n < 2:
        return hi, lo
    odd = _dd_assoc_scan(*_dd_add(
        (hi[:, 0:-1:2], lo[:, 0:-1:2]), (hi[:, 1::2], lo[:, 1::2])
    ))
    rest = (hi[:, 2::2], lo[:, 2::2])
    if n % 2 == 0:
        even = _dd_add((odd[0][:, :-1], odd[1][:, :-1]), rest)
    else:
        even = _dd_add(odd, rest)
    out = []
    for first, ev, od in ((hi[:, :1], even[0], odd[0]),
                          (lo[:, :1], even[1], odd[1])):
        o = torch.empty_like(hi)
        o[:, 0::2] = torch.cat([first, ev], dim=1)
        o[:, 1::2] = od
        out.append(o)
    return out[0], out[1]


def tip_prob_cumsum_dd(probs: torch.Tensor):
    """Double-f32 zero-prefixed prefix sum: ``(cum_hi, cum_lo)``, each
    ``[B, N+1]``. Widths that are a multiple of 128 go through K6; others
    through the pairwise tree (as in the JAX package)."""
    if probs.shape[1] % 128 == 0 and probs.shape[1] > 0:
        return dd_cumsum(probs)
    hi, lo = _dd_assoc_scan(probs, torch.zeros_like(probs))
    return F.pad(hi, (1, 0)), F.pad(lo, (1, 0))


def node_conf_dd(cum_hi, cum_lo, starts, ends):
    """Double-f32 node confidences ``(conf_hi, conf_lo)``, ``[B, J]``."""
    return _dd_sub(
        cum_hi[:, ends], cum_lo[:, ends], cum_hi[:, starts], cum_lo[:, starts]
    )


@dataclass
class SignificantSetDD:
    """Double-f32 counterpart of :class:`SignificantSet`: threshold masks
    queued on the device, compacted and copied to the host by :meth:`pull`
    (the only host synchronisation of the stage).

    ``parts`` is a list of ``(mask [B, n] bool, codes, values)`` where
    ``codes(r, j)`` gives the int64 entry codes and ``values(r, j)`` the
    ``(hi, lo)`` f32 confidences at the selected positions."""

    batch: int
    parts: list

    def pull(self):
        """``(off int64 [B+1], idx int32 [total], hi f32 [total], lo f32
        [total])``; query b owns ``[off[b], off[b+1])``."""
        rows, codes, his, los = [], [], [], []
        for mask, code_of, vals_of in self.parts:
            r, j = torch.nonzero(mask, as_tuple=True)
            hi, lo = vals_of(r, j)
            rows.append(r)
            codes.append(code_of(r, j))
            his.append(hi)
            los.append(lo)
        return _pull_parts(self.batch, rows, codes, [his, los])


def _threshold(device) -> torch.Tensor:
    # an f32 scalar, so the comparison is made in f32 as on the JAX side;
    # filled on the device (a host scalar's upload would wait for the stream)
    return torch.full((), SIG_THRESHOLD, dtype=torch.float32, device=device)


def _sideband_pair(ov_hi, ov_lo, over_idx, pos):
    """Double-f32 prefix of the overflow values below tip position ``pos``
    (``[B, m]`` or ``[m]``): ``(hi, lo)`` at ``searchsorted(over_idx,
    pos)`` per row."""
    if pos.ndim == 1:
        pos = pos[None, :].expand(over_idx.shape[0], -1)
    ub = torch.searchsorted(over_idx, pos.to(over_idx.dtype).contiguous())
    return torch.gather(ov_hi, 1, ub), torch.gather(ov_lo, 1, ub)


def _wide_conf_dd(cum_hi, cum_lo, starts, ends, sideband):
    """Double-f32 wide-node confidences with the overflow sideband folded
    in: ``conf = (cum[e] - cum[s]) + (ov[e] - ov[s])`` where ``ov`` is the
    double-f32 prefix over the sorted overflow list's table values (overflow
    tips are 0.0 in the scanned probabilities, so their whole mass rides the
    sideband). ``starts`` / ``ends`` may be ``[n]`` or per-row ``[B, m]``."""
    if starts.ndim == 1:
        base = node_conf_dd(cum_hi, cum_lo, starts, ends)
    else:
        base = _dd_sub(
            torch.gather(cum_hi, 1, ends), torch.gather(cum_lo, 1, ends),
            torch.gather(cum_hi, 1, starts), torch.gather(cum_lo, 1, starts),
        )
    if sideband is None:
        return base
    over_idx, ov_hi, ov_lo = sideband
    s_hi, s_lo = _sideband_pair(ov_hi, ov_lo, over_idx, starts)
    e_hi, e_lo = _sideband_pair(ov_hi, ov_lo, over_idx, ends)
    return _dd_add(base, _dd_sub(e_hi, e_lo, s_hi, s_lo))


def _compact_unit_wide(
    cum_hi, cum_lo,  # [B, Np+1] zero-prefixed double-f32 tip prefix sums
    probs,  # [B, Np] tip-order probs (overflow tips 0 with a sideband)
    sideband,  # (over_idx [B, bud] sorted, ov_hi, ov_lo [B, bud+1]) | None
    over_fixval,  # [B, bud] f32 table[over count] | None (with sideband)
    wide_starts, wide_ends, wide_pos,  # [n_w] int64
    tip_has_unit,  # [num_tips] bool
    num_tips: int,
) -> SignificantSetDD:
    """Unit/wide split on double-f32 values: WIDE eval nodes (range > 1)
    through boundary gathers plus the sideband, significant TIPS straight
    from the probs row (code ``-(tip + 2)``, low word 0), and — with a
    sideband — the overflow tips appended from the list itself, since they
    read 0.0 in the probs row."""
    B, n_p = probs.shape
    dev = probs.device
    thr = _threshold(dev)
    parts = []
    if wide_starts.numel():
        w_hi, w_lo = _wide_conf_dd(
            cum_hi, cum_lo, wide_starts, wide_ends, sideband
        )
        parts.append((
            w_hi >= thr,
            lambda r, j: wide_pos[j],
            lambda r, j: (w_hi[r, j], w_lo[r, j]),
        ))
    has_unit = torch.zeros(n_p, dtype=torch.bool, device=dev)
    has_unit[:num_tips] = tip_has_unit
    parts.append((
        (probs >= thr) & has_unit[None, :],
        lambda r, j: -(j + 2),
        lambda r, j: (probs[r, j], torch.zeros_like(probs[r, j])),
    ))
    if sideband is not None:
        over_idx = sideband[0].long()
        ok = (
            (over_idx < num_tips)
            & has_unit[torch.clamp(over_idx, 0, max(num_tips - 1, 0))]
            & (over_fixval >= thr)
        )
        parts.append((
            ok,
            lambda r, j: -(over_idx[r, j] + 2),
            lambda r, j: (
                over_fixval[r, j], torch.zeros_like(over_fixval[r, j])
            ),
        ))
    return SignificantSetDD(batch=B, parts=parts)


def _compact_dd_from_cum(cum_hi, cum_lo, starts, ends) -> SignificantSetDD:
    """Every eval node through the boundary gathers; the low word is
    computed at the selected positions only, so ``conf_lo [B, J]`` never
    exists."""
    conf_hi = node_conf_dd(cum_hi, cum_lo, starts, ends)[0]

    def vals_of(r, j):
        s, e = starts[j], ends[j]
        return conf_hi[r, j], _dd_sub(
            cum_hi[r, e], cum_lo[r, e], cum_hi[r, s], cum_lo[r, s]
        )[1]

    return SignificantSetDD(
        batch=cum_hi.shape[0],
        parts=[(conf_hi >= _threshold(cum_hi.device), lambda r, j: j, vals_of)],
    )


def _over_fixval(table, over_idx, over_val):
    """``table[count]`` of every overflow slot, 0.0 in unused slots."""
    fix = torch.gather(
        table, 1, torch.clamp(over_val.long(), 0, table.shape[1] - 1)
    )
    return torch.where(over_idx < OVER_SENTINEL, fix, torch.zeros_like(fix))


def _sideband_of(over_idx, fixv):
    ov_hi, ov_lo = _dd_assoc_scan(fixv, torch.zeros_like(fixv))
    return over_idx, F.pad(ov_hi, (1, 0)), F.pad(ov_lo, (1, 0))


def _tip_order_probs(probs_bm, layout: str):
    B = probs_bm.shape[0]
    if layout == "flat":
        # flat postings: the bit-major expansion already enumerates tips in
        # taxonomy order, so the permute disappears
        return probs_bm.reshape(B, -1)
    return probs_to_tip_order(probs_bm).contiguous()


def _scatter_fix(probs, over_idx, fixv):
    """Write the overflow tips' exact table values over the flat probs
    (per-row unique indices; unused slots are skipped)."""
    r, s = torch.nonzero(over_idx < OVER_SENTINEL, as_tuple=True)
    probs[r, over_idx[r, s].long()] = fixv[r, s]
    return probs


def _split2_probs(planes, table, over_idx, over_val, layout, sideband):
    """Tip-order f32 probabilities of the unit/wide path, with the overflow
    tips zeroed and carried in a sideband, patched by a scatter, or (no
    overflow list) read through the full-width lookup. Returns ``(probs,
    sideband | None, over_fixval | None)``."""
    use_sb = sideband and over_idx is not None
    if use_sb:
        probs_bm = planes_probs(planes, table, mux_bits=4, zero_high=True)
    elif over_idx is not None:
        probs_bm = planes_probs(planes, table, mux_bits=4)
    else:
        probs_bm = planes_probs(planes, table)
    probs = _tip_order_probs(probs_bm, layout)
    if over_idx is None:
        return probs, None, None
    fixv = _over_fixval(table, over_idx, over_val)
    if use_sb:
        return probs, _sideband_of(over_idx, fixv), fixv
    return _scatter_fix(probs, over_idx, fixv), None, None


def significant_nodes_planes(
    planes: torch.Tensor,  # [B, P, S, 128] int32 counter planes
    table: torch.Tensor,  # [B, s_max] f32 normalized per-size probabilities
    node_starts: torch.Tensor,  # [J] eval-node range starts
    node_ends: torch.Tensor,  # [J]
    over_idx: torch.Tensor | None = None,  # [B, budget] tips with count > 15
    over_val: torch.Tensor | None = None,  # [B, budget] their counts
    bm_scan: bool = False,
    layout: str = "packed",
    split2: tuple | None = None,  # (ws, we, wpos, tip_has_unit)
    sideband: bool = True,
    num_tips: int = 0,
    split: tuple | None = None,  # (inner_starts, inner_ends, inner_pos, evalpos_of_tip)
):
    """Double-f32 significance from counter planes: f32 table lookup (K4) ->
    compensated scan (K6, or K7 with ``bm_scan``) -> threshold masks.
    Returns ``(sig, cum0)``: ``sig`` a :class:`SignificantSetDD`, ``cum0``
    the ``(cum_hi, cum_lo)`` pair for the descent, or None on the unit/wide
    path, which does not keep the ``[B, N+1]`` pair alive (the rare device
    descent rebuilds it with :func:`cum_from_planes`).

    With overflow lists (they must cover EVERY tip with a count above 15)
    the lookup reads only the low 4 count bits and the listed tips are
    patched. ``sideband`` picks, on the unit/wide path, between the sideband
    and the scatter. ``bm_scan`` assumes the packed layout. Off the
    unit/wide path the eval nodes are compacted plainly, or, with ``split``,
    by :func:`_compact_split` (single-tip eval nodes straight from the
    probabilities, codes are eval positions); with ``bm_scan`` its
    ``evalpos_of_tip`` must be in bit-major flat order
    (:func:`bitmajor_evalpos`, which the JAX package applies here on every
    batch and the port once, at upload). As in the JAX package, the
    unit/wide split wins over ``split`` on the tip-order scan, and the
    bit-major scan never takes the unit/wide split."""
    if split2 is not None and not bm_scan:
        probs, sb, fixv = _split2_probs(
            planes, table, over_idx, over_val, layout, sideband
        )
        cum_hi, cum_lo = tip_prob_cumsum_dd(probs)
        sig = _compact_unit_wide(
            cum_hi, cum_lo, probs, sb, fixv,
            split2[0], split2[1], split2[2], split2[3], num_tips,
        )
        return sig, None
    if over_idx is not None:
        probs_bm = planes_probs(planes, table, mux_bits=4)
        fixv = _over_fixval(table, over_idx, over_val)
    else:
        probs_bm = planes_probs(planes, table)
    if bm_scan:
        if layout != "packed":
            raise ValueError("bm_scan reads the packed postings layout")
        if over_idx is not None:
            # the fixups in bit-major coordinates
            r, s = torch.nonzero(over_idx < OVER_SENTINEL, as_tuple=True)
            tip = over_idx[r, s].long()
            word = tip // 32
            probs_bm[r, tip % 32, word // 128, word % 128] = fixv[r, s]
        cum_hi, cum_lo = dd_cumsum_bitmajor(probs_bm)
        if split is not None:
            # the tip path reads the probabilities where K7 read them, in
            # bit-major flat order (split[3] is already remapped there)
            sig = _compact_split(
                cum_hi, cum_lo, probs_bm.reshape(probs_bm.shape[0], -1), *split
            )
            return sig, (cum_hi, cum_lo)
    else:
        probs = _tip_order_probs(probs_bm, layout)
        if over_idx is not None:
            probs = _scatter_fix(probs, over_idx, fixv)
        cum_hi, cum_lo = tip_prob_cumsum_dd(probs)
        if split is not None:
            return _compact_split(cum_hi, cum_lo, probs, *split), (cum_hi, cum_lo)
    sig = _compact_dd_from_cum(cum_hi, cum_lo, node_starts, node_ends)
    return sig, (cum_hi, cum_lo)


def bitmajor_evalpos(evalpos_of_tip: torch.Tensor, S: int) -> torch.Tensor:
    """``evalpos_of_tip`` moved to the bit-major flat order of ``[32, S,
    128]`` probabilities of the packed layout, where tip ``t`` sits at
    ``(t % 32) * S * 128 + t // 32``; -1 at the padding."""
    t = torch.arange(evalpos_of_tip.shape[0], device=evalpos_of_tip.device)
    out = torch.full(
        (32 * S * 128,), -1, dtype=evalpos_of_tip.dtype,
        device=evalpos_of_tip.device,
    )
    out[(t % 32) * (S * 128) + t // 32] = evalpos_of_tip
    return out


def cum_from_planes(
    planes: torch.Tensor,
    table: torch.Tensor,
    over_idx: torch.Tensor | None = None,
    over_val: torch.Tensor | None = None,
    layout: str = "packed",
    sideband: bool = True,
):
    """``(cum_hi, cum_lo[, over_idx, ov_hi, ov_lo])`` for the fallback
    descent, rebuilt from the retained planes by the construction of the
    unit/wide branch of :func:`significant_nodes_planes` (same ``sideband``
    choice), so the descent's range sums match the compaction's confidences
    bit for bit."""
    probs, sb, _ = _split2_probs(
        planes, table, over_idx, over_val, layout, sideband
    )
    cum = tip_prob_cumsum_dd(probs)
    return cum if sb is None else cum + sb


def max_descent(
    cum0,  # (cum_hi, cum_lo) [B, N+1], or the 5-tuple with a sideband
    b_idx: torch.Tensor,  # [M] query index per descent
    start_nodes: torch.Tensor,  # [M] GLOBAL node id to descend from
    range_start: torch.Tensor,  # [n_nodes]
    range_end: torch.Tensor,
    child_ptr: torch.Tensor,  # [n_nodes+1] CSR pointers
    child_ids: torch.Tensor,
    node_is_inner: torch.Tensor,  # [n_nodes] bool
    merge=None,
):
    """Max-confidence descent on double-f32 prefix sums with certainty
    margins. Returns ``(final GLOBAL node ids [M], min_margin [M] f32)``:
    ``min_margin`` is the smallest best-vs-second-best confidence gap over
    the descent's argmax steps (+inf for single-child steps, 0 for exact f32
    ties). A margin above :data:`DESCENT_MARGIN_SAFE` proves that the f32
    argmax agrees with the reference's f64 one (src/lineage.rs:154-170); the
    engine replays the others on the host. As in Rust's ``max_by`` the LAST
    maximal child wins. All sites advance one tree level per step; a step is
    a segmented arg-max over the flattened (site, child) list.

    ``merge`` (a model-sharded mesh, ``parallel/mesh.py``) takes each step's
    per-(site, child) confidences ``v``, computed on this shard's clipped
    tip ranges, and returns them summed over the model shards before the
    arg-max (the JAX package's ``psum_axis``). Every rank of a model group
    then sees the same merged ``v``, takes the same children and so runs
    the same number of level steps, which the collective needs."""
    if len(cum0) == 5:
        cum_hi, cum_lo, sb_idx, sb_hi, sb_lo = cum0
    else:
        (cum_hi, cum_lo), sb_idx = cum0, None
    dev = cum_hi.device
    cur = start_nodes.long().clone()
    b_idx = b_idx.long()
    child_ptr, child_ids = child_ptr.long(), child_ids.long()
    range_start, range_end = range_start.long(), range_end.long()
    inf = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    margin = inf.expand(cur.shape[0]).clone()
    while True:
        act = torch.nonzero(node_is_inner[cur]).reshape(-1)
        m = act.numel()
        if m == 0:
            return cur, margin
        nodes = cur[act]
        lo = child_ptr[nodes]
        cnt = child_ptr[nodes + 1] - lo
        if bool((cnt == 0).any()):
            raise RuntimeError("descent reached an inner node with no child")
        site = torch.repeat_interleave(torch.arange(m, device=dev), cnt)
        first = torch.cumsum(cnt, 0) - cnt
        within = torch.arange(site.numel(), device=dev) - first[site]
        cid = child_ids[lo[site] + within]
        q = b_idx[act][site]
        e, s = range_end[cid], range_start[cid]
        d_hi, d_err = _two_sum(cum_hi[q, e], -cum_hi[q, s])
        lo_term = d_err + cum_lo[q, e] - cum_lo[q, s]
        if sb_idx is not None:
            rows = sb_idx[q]  # [n, budget]
            ub_e = torch.searchsorted(rows, e.to(rows.dtype)[:, None])[:, 0]
            ub_s = torch.searchsorted(rows, s.to(rows.dtype)[:, None])[:, 0]
            c_hi, c_err = _two_sum(sb_hi[q, ub_e], -sb_hi[q, ub_s])
            d_hi, d_err2 = _two_sum(d_hi, c_hi)
            lo_term = (
                lo_term + d_err2 + c_err + sb_lo[q, ub_e] - sb_lo[q, ub_s]
            )
        v = d_hi + lo_term
        if merge is not None:
            v = merge(v)
        vmax = torch.full((m,), -float("inf"), dtype=v.dtype, device=dev)
        vmax = vmax.scatter_reduce(0, site, v, "amax", include_self=True)
        at_max = v == vmax[site]
        pos = torch.where(at_max, within, -1)
        best = torch.full((m,), -1, dtype=torch.long, device=dev)
        best = best.scatter_reduce(0, site, pos, "amax", include_self=True)
        # the runner-up: a duplicated maximum IS the runner-up
        rest = torch.where(at_max, -inf, v)
        second = torch.full((m,), -float("inf"), dtype=v.dtype, device=dev)
        second = second.scatter_reduce(0, site, rest, "amax", include_self=True)
        dup = torch.zeros(m, dtype=torch.long, device=dev)
        dup = dup.scatter_add(0, site, at_max.long()) > 1
        second = torch.where(dup, vmax, second)
        margin[act] = torch.minimum(margin[act], vmax - second)
        cur[act] = child_ids[lo + best]


# -- dense counts -------------------------------------------------------


def gather_table(counts: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``probs[b, n] = table[b, counts[b, n]]`` exactly; 0.0 for a count
    outside the table (a one-hot that matches no column)."""
    c = counts.long()
    s_max = table.shape[1]
    ok = (c >= 0) & (c < s_max)
    out = torch.gather(table, 1, torch.clamp(c, 0, s_max - 1))
    return torch.where(ok, out, torch.zeros_like(out))


def _compact_split(
    cum_hi, cum_lo, probs,
    inner_starts, inner_ends, inner_pos,  # [J_in] int64
    evalpos_of_tip,  # [num_tips] int64, -1 where the tip has no such node
) -> SignificantSetDD:
    """Split compaction: inner nodes through the boundary gathers,
    single-tip eval nodes straight from ``probs`` (their confidence is
    exactly ``probs[tip]``, low word 0). Codes are eval positions, inner
    entries first."""
    B, n = probs.shape
    thr = _threshold(probs.device)
    inner = _compact_dd_from_cum(cum_hi, cum_lo, inner_starts, inner_ends)
    mask_in, _, vals_in = inner.parts[0]
    evalpos = F.pad(evalpos_of_tip, (0, n - evalpos_of_tip.shape[0]), value=-1)
    return SignificantSetDD(
        batch=B,
        parts=[
            (mask_in, lambda r, j: inner_pos[j], vals_in),
            (
                (probs >= thr) & (evalpos >= 0)[None, :],
                lambda r, j: evalpos[j],
                lambda r, j: (probs[r, j], torch.zeros_like(probs[r, j])),
            ),
        ],
    )


def significant_nodes(
    counts: torch.Tensor,  # [B, N] f32 (exact integer intersection sizes)
    table: torch.Tensor,  # [B, s_max] f32 normalized per-size probabilities
    node_starts: torch.Tensor,  # [J] int64 eval-node range starts
    node_ends: torch.Tensor,  # [J] int64
    split: tuple | None = None,  # (inner_starts, inner_ends, inner_pos, evalpos_of_tip)
):
    """Double-f32 significance from a dense count matrix: table lookup ->
    compensated scan over the ``N`` tips (K6 when ``N`` is a multiple of
    128, else the pairwise tree) -> threshold masks. Returns ``(sig,
    (cum_hi, cum_lo))``: a :class:`SignificantSetDD` whose codes are eval
    positions, and the prefix sums for the descent."""
    probs = gather_table(counts, table)
    cum_hi, cum_lo = tip_prob_cumsum_dd(probs)
    if split is not None:
        sig = _compact_split(cum_hi, cum_lo, probs, *split)
    else:
        sig = _compact_dd_from_cum(cum_hi, cum_lo, node_starts, node_ends)
    return sig, (cum_hi, cum_lo)
