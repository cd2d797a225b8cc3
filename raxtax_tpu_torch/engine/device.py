"""Device classification engine (exact-f64 semantics, one GPU).

Per query batch, three phases:

  A submit   host: distinct 8-mers, exact-match lookup
             device: postings fold (K1) -> counter planes, exact-match tips
             zeroed, intersection-size histogram (K3), async pull
  B prepare  host: histogram in, f64 top-hit probability tables + global
             signal (prob/model.py)
             device: per-tip table lookup (K4), sequential f64 prefix scan
             (K5), threshold masks over wide nodes and unit tips
  C finalize device: compaction of the significant set and its pull, exact
             max-confidence descents
             host: native evaluation and formatting

All O(num_refs) work runs on the device; the host touches histograms,
(K+1)-sized tables and the compacted significant set. Every confidence the
host sees is the reference's exact f64 value (sequential prefix sums,
src/lineage.rs:62-67), so nothing replays on the host except the global
signal of a query that sits on a 5th-decimal rounding boundary.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import native
from ..convert import DeviceState, device_state
from ..db.database import Database
from ..db.taxonomy import NODE_INNER, ROOT
from ..lineage.evaluate import evaluate_significant
from ..models.oracle import (
    QueryResult,
    apply_exact_match_policy,
    log_exact_matches,
)
from ..ops.exactscan import max_descent_exact, significant_nodes_exact
from ..ops.intersect_fold import PAD_ROW, fold_planes
from ..ops.planes import (
    decode_plane_rows,
    planes_histogram,
    zero_tips_in_planes,
)
from ..prob.model import KTableCache, normalized_size_probs
from ..utils.device import resolve_device
from ..utils.encoding import round_half_away, sequence_to_kmers

log = logging.getLogger("raxtax")

#: The engine computes the global signal from the intersection-size
#: HISTOGRAM (per-bucket grouping); the reference accumulates sequentially
#: over tips (src/lineage.rs:86-90). Both are f64 and differ by at most
#: ~2·N·eps64·gs — far below the printed 5-decimal precision UNLESS the
#: value sits essentially on a rounding boundary. Queries whose 5th-decimal
#: fraction is within this margin of 0.5 replay the signal in exact
#: sequential order from their count row, decoded from the planes on the
#: device.
SIGNAL_RISK_MARGIN = 1e-4

#: bytes per tip and query live across the pipeline: counter planes (4 per
#: plane, ~10 planes), the f64 probabilities and their f64 prefix sums, the
#: tip mask; times the batches in flight in the three-deep loop
_LIVE_BYTES_PER_TIP = 150
BATCH_MAX = 256
BATCH_MIN = 32


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def auto_batch_size(
    state: DeviceState, n_padded_tips: int, n_queries_hint: int | None
) -> int:
    """Power-of-two batch that keeps the live set of the three-deep loop
    inside 60 % of the device memory left after the resident state."""
    if state.device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(state.device)
        fit = int(0.6 * free) // max(_LIVE_BYTES_PER_TIP * n_padded_tips, 1)
        batch = max(BATCH_MIN, min(BATCH_MAX, fit))
    else:
        batch = BATCH_MIN
    batch = 1 << (batch.bit_length() - 1)  # floor pow2
    if n_queries_hint:
        hint = 1 << max(0, int(n_queries_hint) - 1).bit_length()
        batch = max(BATCH_MIN, min(batch, hint))
    return batch


@dataclass
class DeviceClassifier:
    """Batched classifier running the fold / histogram / lookup / scan
    pipeline on one device."""

    db: Database
    skip_exact_matches: bool
    raw_confidence: bool
    batch_size: int
    state: DeviceState = field(repr=False)
    #: whether the run emits raxtax.tsv — when False the native evaluator
    #: skips TSV formatting and the sequence decompression that feeds it
    tsv: bool = True
    #: validate device-stage invariants on the (small) pulled artifacts —
    #: mirrors the reference's asserts (src/prob.rs:98, src/raxtax.rs:56,72)
    debug_checks: bool = False
    #: replay every query's global signal sequentially (tests)
    force_signal_replay: bool = False
    _cache: KTableCache = field(default_factory=KTableCache, repr=False)
    _evaluator: object = field(default=None, repr=False)
    #: sticky high-water shape buckets: the pad levels only grow, so a
    #: mixed-length query stream keeps one set of tensor shapes
    _k_pad_hw: int = field(default=0, repr=False)
    _s_max_hw: int = field(default=0, repr=False)
    #: host seconds spent per phase since creation; the three ``finalize_*``
    #: entries split ``finalize`` into the significant-set pull (which waits
    #: for the device), the descents and the host evaluation
    phase_seconds: dict = field(
        default_factory=lambda: dict.fromkeys(
            ("submit", "prepare", "finalize", "finalize_pull",
             "finalize_descend", "finalize_eval"), 0.0,
        ),
        repr=False,
    )

    @classmethod
    def create(
        cls,
        db: Database,
        skip_exact_matches: bool = False,
        raw_confidence: bool = False,
        batch_size: int | None = None,
        device: "str | torch.device | None" = None,
        split2: bool = True,
        debug_checks: bool = False,
        tsv: bool = True,
        n_queries_hint: int | None = None,
    ) -> "DeviceClassifier":
        """Upload the database and build the classifier. ``device`` defaults
        to the GPU and raises when there is none; pass ``"cpu"`` to run the
        kernels' plain versions on the host. ``split2`` picks the unit/wide
        significance split (default) or one boundary pair per eval node."""
        dev = resolve_device(device)
        state = device_state(db, dev, split2=split2)
        n_padded = int(state.kmer_major3.shape[1] * state.kmer_major3.shape[2]) * 32
        if not batch_size:
            batch_size = auto_batch_size(state, n_padded, n_queries_hint)
        self = cls(
            db=db,
            skip_exact_matches=skip_exact_matches,
            raw_confidence=raw_confidence,
            batch_size=int(batch_size),
            state=state,
            tsv=tsv,
            debug_checks=debug_checks,
        )
        self._evaluator = native.NativeEvaluator.create(db)
        return self

    # ------------------------------------------------------------------

    def prewarm(self, max_kmers: int) -> None:
        """Pin the sticky shape buckets to the query stream's global max
        BEFORE the first batch, so a mixed-length stream runs every batch at
        one set of shapes regardless of arrival order."""
        k_max = max(int(max_kmers), 1)
        k_pad = _round_up(k_max, 32 if k_max <= 128 else 128)
        self._k_pad_hw = max(self._k_pad_hw, k_pad)
        self._s_max_hw = max(self._s_max_hw, _round_up(k_max + 1, 128))

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(arr)
        if self.state.device.type == "cuda":
            return t.pin_memory().to(self.state.device, non_blocking=True)
        return t

    def submit_batch(self, chunk: list[tuple[str, np.ndarray]]):
        """Phase A: host prep + device dispatch of the fold and histogram.

        Returns an opaque batch state for :meth:`prepare_batch`. On the GPU
        the device work proceeds in the background (the histogram lands in a
        pinned buffer through a non-blocking copy), so the caller can
        overlap this batch's device compute with the previous batches' host
        stages."""
        t_start = time.perf_counter()
        st = self.state
        n_real = len(chunk)
        B = self.batch_size
        if n_real > B:
            raise ValueError("chunk larger than the batch size")
        labels = [l for l, _ in chunk]
        seqs = [s for _, s in chunk]

        # one native pass extracts every query's sorted distinct 8-mers, one
        # vectorized pass answers every exact-match lookup
        res = native.distinct_kmers_flat(seqs)
        kmer_sets = None
        if res is not None:
            flat_k, off_k = res
            ks_r = np.diff(off_k[: n_real + 1])
        else:
            kmer_sets = [sequence_to_kmers(s) for s in seqs]
            ks_r = np.array([k.size for k in kmer_sets], np.int64)
        assert (
            not n_real or int(ks_r.max(initial=0)) <= 0xFFFF
        ), "too many distinct query k-mers"
        exact = self.db.exact_map.get_batch(seqs)

        k_max = max(int(ks_r.max(initial=0)), 1) if n_real else 1
        k_pad = _round_up(k_max, 32 if k_max <= 128 else 128)
        k_pad = max(k_pad, self._k_pad_hw)
        self._k_pad_hw = k_pad
        kmer_idx = np.full((B, k_pad), PAD_ROW, dtype=np.int32)
        if kmer_sets is not None:
            for i, km in enumerate(kmer_sets):
                kmer_idx[i, : km.size] = km
        elif n_real:
            mask = np.arange(k_pad)[None, :] < ks_r[:, None]
            kmer_idx[:n_real][mask] = flat_k[: off_k[n_real]]

        # pad the batch to the fixed size with empty queries
        ks = [int(x) for x in ks_r] + [0] * (B - n_real)
        s_max = _round_up(max(ks) + 1, 128)
        s_max = max(s_max, self._s_max_hw)
        self._s_max_hw = s_max
        e_pad = (
            max((len(e) for e in exact), default=0)
            if self.skip_exact_matches
            else 0
        )

        planes = fold_planes(
            self._to_device(kmer_idx),
            self._to_device(np.asarray(ks, np.int32)),
            st.kmer_major3,
            max_count=k_pad,
        )
        if e_pad:
            ids = np.full((B, e_pad), -1, dtype=np.int64)
            for i, e in enumerate(exact):
                ids[i, : len(e)] = e
            planes = zero_tips_in_planes(
                planes, self._to_device(ids), layout=st.layout
            )
        hist_dev = planes_histogram(planes, s_max, self.db.num_tips)
        if st.device.type == "cuda":
            # the phase-B sync point: a pinned buffer and a non-blocking
            # copy, so this call returns while the device still works
            hist_host = torch.empty(
                hist_dev.shape, dtype=hist_dev.dtype, pin_memory=True
            )
            hist_host.copy_(hist_dev, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(st.device))
        else:
            hist_host, ready = hist_dev, None
        self.phase_seconds["submit"] += time.perf_counter() - t_start
        return (labels, seqs, exact, ks, s_max, n_real, planes, hist_host, ready)

    def prepare_batch(self, state):
        """Phase B: wait for the histogram, run the host f64 probability
        model, dispatch the table lookup, the exact scan and the threshold
        masks. Nothing else is pulled here, so a following phase-A dispatch
        of the next batch queues right behind this batch's device work."""
        t_start = time.perf_counter()
        labels, seqs, exact, ks, s_max, n_real, planes, hist_host, ready = state
        st = self.state
        B = self.batch_size
        if ready is not None:
            ready.synchronize()
        hist = hist_host.numpy()
        if self.debug_checks:
            # device-stage integrity: every reference lands in exactly one
            # histogram bucket, and no intersection can exceed the query's
            # distinct-k-mer count (src/raxtax.rs:56 bound)
            sums = hist[:n_real].sum(axis=1)
            if not (sums == self.db.num_tips).all():
                raise AssertionError(
                    "debug-checks: histogram mass mismatch "
                    f"(got {sums.tolist()[:4]}..., want {self.db.num_tips})"
                )
            for b in range(n_real):
                if hist[b, ks[b] + 1 :].any():
                    raise AssertionError(
                        "debug-checks: intersection size exceeds the "
                        f"query's {ks[b]} distinct k-mers (query {b})"
                    )

        # host f64 stage: per-size probabilities + global signal
        table64 = np.zeros((B, s_max), dtype=np.float64)
        tables64: list[np.ndarray | None] = [None] * B
        global_signals = np.zeros(B, dtype=np.float64)
        signal_risky: list[int] = []
        inv_n = 1.0 / self.db.num_tips
        for b in range(n_real):
            probs_size, _ = normalized_size_probs(hist[b], ks[b], self._cache)
            h = hist[b, : probs_size.shape[0]].astype(np.float64)
            global_signals[b] = np.sqrt(h @ (probs_size - inv_n) ** 2)
            table64[b, : probs_size.shape[0]] = probs_size
            tables64[b] = probs_size
            frac = (global_signals[b] * 1e5) % 1.0
            if abs(frac - 0.5) < SIGNAL_RISK_MARGIN or self.force_signal_replay:
                signal_risky.append(b)

        sig, cum = significant_nodes_exact(
            planes, self._to_device(table64), st.node_starts, st.node_ends,
            split2=st.split2, layout=st.layout, num_tips=self.db.num_tips,
        )
        self.phase_seconds["prepare"] += time.perf_counter() - t_start
        return (
            labels, seqs, exact, n_real, planes, cum, tables64,
            global_signals, sig, signal_risky,
        )

    def _exact_row(self, b: int, planes) -> np.ndarray:
        """One query's exact count row in tip order, decoded on the device
        from its planes."""
        row = decode_plane_rows(planes, [b], self.state.layout)
        return row[0, : self.db.num_tips].cpu().numpy().astype(np.int64)

    def _descend(self, sites: list[tuple[int, int]], cum) -> dict:
        """Exact max-confidence descents for every (query, GLOBAL node) site
        (src/lineage.rs:151-177), on the device."""
        if not sites:
            return {}
        st = self.state
        arr = np.asarray(sites, dtype=np.int64)
        finals = max_descent_exact(
            cum,
            torch.from_numpy(arr[:, 0].copy()).to(st.device),
            torch.from_numpy(arr[:, 1].copy()).to(st.device),
            st.range_start, st.range_end, st.child_ptr, st.child_ids,
            st.is_inner,
        ).cpu().numpy()
        return {s: int(f) for s, f in zip(sites, finals)}

    def finalize_batch(self, state) -> list[QueryResult]:
        """Phase C: compact and pull the significant set, run the descents,
        evaluate and format on the host."""
        if len(state) == 9:  # phase-A state: run phase B inline
            state = self.prepare_batch(state)
        t_start = time.perf_counter()
        (
            labels, seqs, exact, n_real, planes, cum, tables64,
            global_signals, sig, signal_risky,
        ) = state
        tax = self.db.taxonomy
        eval_ids = tax.eval_ids
        st = self.state

        off, idx_f, conf64_f = sig.pull()
        self.phase_seconds["finalize_pull"] += time.perf_counter() - t_start

        # boundary-risk replay of the global signal in the reference's
        # sequential tip order (src/lineage.rs:86-90)
        if signal_risky:
            inv_n = 1.0 / self.db.num_tips
            for b in signal_risky:
                tipp = tables64[b][self._exact_row(b, planes)]
                global_signals[b] = np.sqrt(
                    np.cumsum((tipp - inv_n) ** 2)[-1]
                )

        # flat views over the REAL queries only (padded rows trail behind)
        total = int(off[n_real]) if n_real else 0
        idx_f = idx_f[:total]
        conf64_f = conf64_f[:total]
        if st.unit_ptr is not None and total:
            # expand unit-tip codes (-(tip+2)) into the tip's unit eval
            # nodes — a 1-record species chain yields one entry per level,
            # all with the tip's confidence
            neg = idx_f < -1
            if neg.any():
                up, uv = st.unit_ptr, st.unit_vals
                tips = np.where(neg, -idx_f - 2, 0)
                cnt = np.where(neg, up[tips + 1] - up[tips], 1)
                ends = np.cumsum(cnt)
                starts_e = ends - cnt
                new_total = int(ends[-1])
                src = np.repeat(np.arange(total), cnt)
                within = np.arange(new_total, dtype=np.int64) - starts_e[src]
                base = np.where(neg, up[tips], 0)[src] + within
                idx_f = np.where(
                    neg[src],
                    uv[np.minimum(base, max(uv.size - 1, 0))],
                    idx_f[src],
                ).astype(np.int32)
                conf64_f = conf64_f[src]
                csum = np.concatenate(([0], ends))
                off = csum[off[: n_real + 1]]
                total = new_total
        nodes_f = eval_ids[idx_f].astype(np.int32)
        off = np.ascontiguousarray(off[: n_real + 1], np.int64)

        if self.debug_checks and total:
            # confidences are range sums of normalized probabilities: they
            # must land in [0, 1] up to summation slack (the reference
            # asserts its normalization at src/prob.rs:98)
            v = conf64_f
            if v.min() < -1e-9 or v.max() > 1.0 + 1e-9:
                raise AssertionError(
                    "debug-checks: node confidence outside [0, 1] "
                    f"(min {v.min()}, max {v.max()})"
                )

        # Fallback sites: Inner significant nodes (plus the root) with no
        # rounded-significant child (mirrors evaluate_significant's pruning:
        # the device threshold keeps slack below the 0.005 cutoff, so a
        # raw-significant child can still round to zero — making its parent
        # a fallback site). One native pass over the packed set.
        sites: list[tuple[int, int]] = []  # (query, GLOBAL node)
        if n_real:
            res = native.find_sites(
                nodes_f, conf64_f, off, tax.parent, tax.node_type,
            )
            if res is not None:
                sites = list(zip(res[0].tolist(), res[1].tolist()))
            else:  # numpy fallback: same semantics, per query
                rounded = round_half_away(conf64_f)
                for b in range(n_real):
                    s, e = int(off[b]), int(off[b + 1])
                    rsig = {
                        int(n)
                        for n, rv in zip(nodes_f[s:e], rounded[s:e])
                        if rv != 0.0 and n != ROOT
                    }
                    parents_of = {int(tax.parent[n]) for n in rsig}
                    for n in sorted(rsig | {ROOT}):
                        if (
                            tax.node_type[n] == NODE_INNER
                            and n not in parents_of
                        ):
                            sites.append((b, n))

        t_descend = time.perf_counter()
        fallback_map = self._descend(sites, cum)
        t_eval = time.perf_counter()
        self.phase_seconds["finalize_descend"] += t_eval - t_descend

        # exact-match logging + single-match override (src/raxtax.rs:42-53,
        # 73-84); one pass, before evaluation, mirroring the reference order
        overrides = np.full(max(n_real, 1), -1, np.int32)
        warned_flags = [False] * n_real
        for b in range(n_real):
            if exact[b]:
                warned_flags[b] = log_exact_matches(
                    labels[b], self.db, exact[b], self.skip_exact_matches
                )
                if (
                    not self.skip_exact_matches
                    and not self.raw_confidence
                    and len(exact[b]) == 1
                ):
                    overrides[b] = exact[b][0]

        # per-query fallback CSR in site order (sites arrive query-sorted)
        n_sites = len(sites)
        fb_s = np.empty(n_sites, np.int32)
        fb_l = np.empty(n_sites, np.int32)
        fb_cnt = np.zeros(max(n_real, 1), np.int64)
        for i, (q, n) in enumerate(sites):
            fb_s[i] = n
            fb_l[i] = fallback_map[(q, n)]
            fb_cnt[q] += 1
        fb_off = np.zeros(n_real + 1, np.int64)
        np.cumsum(fb_cnt[:n_real], out=fb_off[1:])

        outs = tsvs = None
        if self._evaluator is not None and n_real:
            # whole-batch native replay + formatting (the Python path below
            # is the semantics reference)
            outs, tsvs = self._evaluator.evaluate_batch(
                labels[:n_real],
                nodes_f, np.ascontiguousarray(conf64_f), off,
                fb_s, fb_l, fb_off,
                np.ascontiguousarray(global_signals[:n_real]),
                overrides[:n_real],
                seqs, want_tsv=self.tsv,
            )

        out: list[QueryResult] = []
        for b in range(n_real):
            if outs is not None and outs[b] is not None:
                out.append(
                    QueryResult(
                        label=labels[b],
                        results=[],
                        sequence=seqs[b],
                        mislabel_warning=warned_flags[b],
                        out_text=outs[b],
                        tsv_text=tsvs[b],
                    )
                )
                continue
            # Python replay (no native lib, or the native path declined)
            s, e = int(off[b]), int(off[b + 1])
            sig_map = {
                int(n): float(v)
                for n, v in zip(nodes_f[s:e], conf64_f[s:e])
            }
            results = evaluate_significant(
                tax,
                labels[b],
                sig_map,
                float(global_signals[b]),
                lambda node, _b=b: fallback_map[(_b, node)],
            )
            assert results, "evaluation must produce at least one result"
            results, _ = apply_exact_match_policy(
                labels[b],
                self.db,
                exact[b],
                results,
                self.raw_confidence,
                self.skip_exact_matches,
                log_matches=False,  # logged in the pass above
            )
            out.append(
                QueryResult(
                    label=labels[b],
                    results=results,
                    sequence=seqs[b],
                    mislabel_warning=warned_flags[b],
                )
            )
        t_end = time.perf_counter()
        self.phase_seconds["finalize_eval"] += t_end - t_eval
        self.phase_seconds["finalize"] += t_end - t_start
        return out

    def classify_batch(
        self, chunk: list[tuple[str, np.ndarray]]
    ) -> list[QueryResult]:
        return self.finalize_batch(self.submit_batch(chunk))
