"""Device classification engine (one GPU), in two significance modes.

Per query batch, three phases:

  A submit   host: distinct 8-mers, exact-match lookup
             device: postings fold (K1 dense, K2 block-sparse with a sticky
             flip to K1, K9 over gathered rows, or K10 over row-sorted
             pairs) -> counter planes, exact-match tips zeroed,
             intersection-size histogram (K3), async pull
  B prepare  host: histogram in, f64 top-hit probability tables + global
             signal (prob/model.py)
             device: per-tip table lookup (K4), prefix scan, threshold masks
             over wide nodes and unit tips
  C finalize device: compaction of the significant set and its pull,
             max-confidence descents
             host: replays, native evaluation and formatting

``significance="exact"`` (the default): K4 and the scan (K5) work in f64 in
the reference's sequential order (src/lineage.rs:62-67), so every confidence
the host sees is the reference's exact value and nothing replays on the host
except the global signal of a query on a 5th-decimal rounding boundary.

``significance="dd"``: the JAX package's default path. The planes are
compressed into the wire (K8 + compaction, ``ops/compress.py``), K4 reads an
f32 table through the low four count bits, the scan is double-f32 (K6, or K7
with ``bm_scan``), and the host recombines ``float64(hi) + float64(lo)``.
That is within ~4e-9 of the exact value, so confidences inside a half-cent
risk band, and descents whose device margin proves nothing, replay on the
host in exact f64 from the wire. ``"auto"`` starts on that path and flips to
the exact one for the rest of the run when host replays become dense.

``counts="dense"`` is the JAX package's ``xla`` backend: no planes at all. A
``[B, N]`` f32 count matrix comes from a bit-unpack matrix product against the
resident ref-major matrix (``ops/intersect_xla.py``), the histogram is a
per-row bincount, the table lookup a gather, and the significance stage is
always the double-f32 one (the exact-f64 kernels read planes). Host replays
read the nibble wire (``compress_counts``) once replays have been dense, else
gathered u16 count rows.

``descent="device"`` (double-f32 paths only) accepts every device descent as
it ends, with no margin test, no batched host descent and no risk-band
replay: no count row leaves the device, but an exact tie may resolve
otherwise than in the reference's f64 (the JAX package's ``--descent
device``). The exact-f64 path descends on exact values either way.

``mesh=`` (``parallel/mesh.py``) runs the stages on a mesh of ranks, each
holding a stripe of the database: the planes backends fold the rank's
postings columns (K9 for ``pallas``, K10 for ``stream``), ``xla`` counts its
ref-major rows; histograms and confidences are summed over the model axis,
and every rank's host receives the whole batch's results and runs the host
stages on them. Under a mesh the significance stage is the double-f32 one
whatever ``significance`` says, with the full-width lookup (no wire): an
exact f64 scan over sharded tips would need the carry handed from shard to
shard. The wider mesh margins cover the f32 sums of partial confidences;
host replays read count rows gathered over the mesh.

All O(num_refs) work runs on the device; the host touches histograms,
(K+1)-sized tables, the compacted significant set and the replayed rows.
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
from ..db.bitmatrix import pack_query_kmers
from ..ops.compress import (
    compress_counts,
    compress_planes,
    decompress_planes_rows,
    decompress_rows,
)
from ..ops.exactscan import max_descent_exact, significant_nodes_exact
from ..ops.histogram import intersection_histogram
from ..ops.intersect_fold import (
    PAD_ROW,
    build_pairs,
    fold_planes,
    fold_planes_sparse,
    intersection_planes_gathered,
)
from ..ops.intersect_stream import intersection_planes_stream
from ..ops.intersect_xla import intersection_counts_xla, zero_reference_ids
from ..ops.nodeconf import (
    DESCENT_MARGIN_SAFE,
    DESCENT_MARGIN_SAFE_MESH,
    cum_from_planes,
    max_descent,
    significant_nodes,
    significant_nodes_planes,
)
from ..ops.planes import (
    decode_plane_rows,
    planes_histogram,
    zero_tips_in_planes,
)
from ..prob.model import KTableCache, normalized_size_probs
from ..utils.device import resolve_device
from ..utils.encoding import round_half_away, sequence_to_kmers

log = logging.getLogger("raxtax")

#: Half-cent rounding-risk margin (in hundredths-of-confidence fraction
#: units) for device-computed double-f32 confidences: the host recombination
#: float64(hi) + float64(lo) is within ~4e-9 of the reference's exact f64
#: value (scan error only). Values inside the band replay on the host from
#: the exact count row.
CONF_RISK_MARGIN_SINGLE = 1e-6
#: the same under a mesh, where the recombination is within ~1e-6 (the model
#: shards' partial confidences are summed in plain f32)
CONF_RISK_MARGIN_MESH = 1e-4

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
#: the same for the dense-count backend: the f32 counts, the f32
#: probabilities and the double-f32 prefix pair (the JAX package's 32 bytes
#: per tip for two batches in flight, for the three of this loop)
_LIVE_BYTES_PER_TIP_DENSE = 48
BATCH_MAX = 256
BATCH_MIN = 32

#: Pair budget of the sparse fold, the work crossover against the dense one:
#: ``max(SPARSE_BUDGET_MIN, k_pad * S // SPARSE_CROSSOVER_DIV)`` pairs per
#: query. Both constants are carried over from the JAX package and were not
#: measured on the GPU.
SPARSE_BUDGET_MIN = 2048
SPARSE_CROSSOVER_DIV = 24


@dataclass
class _Submitted:
    """Phase-A state of one batch."""

    labels: list
    seqs: list
    exact: list
    ks: list
    s_max: int
    n_real: int
    #: counter planes, or the ``[B, N]`` f32 counts of the dense backend
    planes: torch.Tensor
    hist_host: torch.Tensor
    ready: object


@dataclass
class _Prepared:
    """Phase-B state of one batch. ``exact_mode`` is the batch's own mode:
    under ``significance="auto"`` a batch prepared before the flip still
    finishes on the double-f32 path."""

    labels: list
    seqs: list
    exact: list
    n_real: int
    planes: torch.Tensor
    tables64: list
    global_signals: np.ndarray
    signal_risky: list
    sig: object
    #: exact: [B, Np+1] f64 prefix sums; dd: (cum_hi, cum_lo) or None
    cum0: object
    exact_mode: bool
    #: dd: the wire (lo4, over_idx, over_val, n_over) on the device, or None;
    #: with dense counts the nibble wire (plane, over_idx, over_val, n_over)
    wire: tuple | None = None
    #: dd: the wire whose overflow lists fed the lookup's fix-up (None when
    #: the full-width lookup was used)
    sig_wire: tuple | None = None
    table: torch.Tensor | None = None  #: dd: [B, s_max] f32 on the device


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def auto_batch_size(
    state: DeviceState, n_padded_tips: int, n_queries_hint: int | None,
    dense: bool | None = None,
) -> int:
    """Power-of-two batch that keeps the live set of the three-deep loop
    inside 60 % of the device memory left after the resident state.
    ``dense`` (default: whether ``state`` holds the ref-major matrix) picks
    the dense-count live set."""
    if state.device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(state.device)
        if dense is None:
            dense = state.ref_bits is not None
        per_tip = _LIVE_BYTES_PER_TIP_DENSE if dense else _LIVE_BYTES_PER_TIP
        fit = int(0.6 * free) // max(per_tip * n_padded_tips, 1)
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
    #: "exact", "dd" or "auto" (see the module note)
    significance: str = "exact"
    #: dd path: feed the scan bit-major probabilities (K7) and take the
    #: plain eval-node compaction, as the JAX package's RAXTAX_BM_SCAN does
    bm_scan: bool = False
    #: "exact": the double-f32 paths prove or replay every descent on the
    #: host; "device": they accept the device's f32 descent as it ends
    descent: str = "exact"
    #: the batch being prepared runs the exact-f64 path (sticky once set)
    _exact_mode: bool = field(default=True, repr=False)
    #: which kernel folds the postings: "dense" (K1), "sparse" (K2),
    #: "gathered" (index_select + K9) or "stream" (K10)
    fold: str = "dense"
    #: "planes", or "dense": the ``[B, N]`` count matrix of the JAX package's
    #: xla backend (no fold, double-f32 significance only)
    counts: str = "planes"
    #: the mesh's stages (``parallel/mesh.ShardedPipeline``), or None on one
    #: device
    pipeline: object = field(default=None, repr=False)
    #: block-sparse fold (K2). Sticky: a workload whose pair count exceeds
    #: the crossover budget switches to the dense fold for good
    _sparse: bool = field(default=False, repr=False)
    #: FIXED overflow-list budget of the wire (set once per database)
    _over_budget: int = field(default=4096, repr=False)
    #: sticky dense-count mode of the dd path: conserved-marker data gives
    #: nearly every tip a count above 15, which no overflow budget covers.
    #: When a batch's overflow exceeds the budget, probabilities switch for
    #: good to the full-width lookup (exact for every count, no lists)
    _mux_dense: bool = field(default=False, repr=False)
    #: the last finalized batch replayed at least half of its queries on
    #: the host (the condition that flips "auto" to the exact path)
    _fb_dense: bool = field(default=False, repr=False)
    #: batch positions of the queries the host replayed (a descent or a
    #: risk-band confidence) in the last finalized double-f32 batch
    _replayed_queries: set = field(default_factory=set, repr=False)
    #: queries replayed on the host (risk band or descent) since creation
    host_replays: int = 0
    #: [pairs, queries with a pair, most pairs of one query] folded by the
    #: sparse kernel since creation
    pair_stats: list = field(default_factory=lambda: [0, 0, 0], repr=False)
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

    #: host-work budget of the batched all-host descent (tip decode + add
    #: steps per batch); past it the device descent is the cheaper path
    DESCEND_HOST_WORK = 24_000_000

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
        significance: str = "exact",
        fold: str = "dense",
        bm_scan: bool = False,
        counts: str = "planes",
        split_sig: bool = False,
        descent: str = "exact",
        mesh=None,
    ) -> "DeviceClassifier":
        """Upload the database and build the classifier. ``device`` defaults
        to the GPU and raises when there is none; pass ``"cpu"`` to run the
        kernels' plain versions on the host. ``split2`` picks the unit/wide
        significance split (default) or one boundary pair per eval node.
        ``significance`` is ``"exact"`` (default), ``"dd"`` or ``"auto"``
        (start on dd, flip to exact under dense host replays); ``fold`` is
        ``"dense"`` (default), ``"sparse"``, ``"gathered"`` or ``"stream"``;
        ``bm_scan`` selects K7 on the dd path. ``counts="dense"`` builds the
        count matrix from the ref-major matrix instead of folding planes
        (``fold``, ``split2`` and ``bm_scan`` are then unused and the
        significance stage is the double-f32 one whatever ``significance``
        says). ``split_sig`` reads the single-tip eval nodes of the
        double-f32 stage straight from the probabilities where the unit/wide
        split does not run: with dense counts, with ``split2=False``, or on
        the bit-major scan (the JAX package's ``RAXTAX_SPLIT_SIG`` with
        ``RAXTAX_SPLIT2``); elsewhere it is not uploaded. ``descent="device"`` accepts the double-f32
        paths' device descents without proof (see the module note).
        ``mesh`` (a ``parallel.mesh.Mesh``) shards the database over its
        ranks and runs every stage there: the database is converted to the
        packed layout, ``fold="stream"`` keeps the stream fold and the other
        planes folds become the gathered one, ``device`` is the mesh's,
        significance is double-f32 and the batch a multiple of the data
        axis (see the module note)."""
        if significance not in ("exact", "dd", "auto"):
            raise ValueError(f"unknown significance mode {significance!r}")
        if fold not in ("dense", "sparse", "gathered", "stream"):
            raise ValueError(f"unknown fold {fold!r}")
        if counts not in ("planes", "dense"):
            raise ValueError(f"unknown counts representation {counts!r}")
        dense = counts == "dense"
        if dense and db.ref_major is None:
            raise RuntimeError(
                "the dense-count (xla) backend needs the ref-major matrix, "
                "but this database was built without it; rebuild the "
                "database or pick another backend"
            )
        if descent not in ("exact", "device"):
            raise ValueError(f"unknown descent {descent!r}")
        bm_scan = bm_scan and not dense
        if bm_scan and significance != "exact" and db.kmer_layout != "packed":
            raise ValueError(
                "bm_scan reads the packed postings layout; this database "
                f"holds the {db.kmer_layout} one"
            )
        if mesh is not None:
            return cls._create_mesh(
                db, mesh, dense=dense, fold=fold, split2=split2,
                split_sig=split_sig, skip_exact_matches=skip_exact_matches,
                raw_confidence=raw_confidence, batch_size=batch_size,
                debug_checks=debug_checks, tsv=tsv,
                n_queries_hint=n_queries_hint, descent=descent,
            )
        dev = resolve_device(device)
        # the single-tip split is uploaded only where a compaction reads it
        # (significant_nodes_planes' precedence: split2 wins on the tip-order
        # scan; the exact-f64 path never reads it)
        split_sig = split_sig and (
            dense or (significance != "exact" and (not split2 or bm_scan))
        )
        state = device_state(
            db, dev, split2=split2 and not dense,
            sparse=fold == "sparse" and not dense,
            dense_counts=dense, split_sig=split_sig, bm_scan=bm_scan,
        )
        n_padded = db.num_tips if dense else int(
            state.kmer_major3.shape[1] * state.kmer_major3.shape[2]
        ) * 32
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
            significance=significance,
            bm_scan=bool(bm_scan),
            fold=fold,
            counts=counts,
            descent=descent,
        )
        self._exact_mode = significance == "exact" and not dense
        self._sparse = fold == "sparse" and not dense
        # scale-aware FIXED overflow budget: overflow tips track the size of
        # the closest clade, which grows with the database. Workloads that
        # exceed it switch to the full-width lookup (see _mux_dense)
        self._over_budget = max(512, min(4096, db.num_tips // 256))
        self._evaluator = native.NativeEvaluator.create(db)
        return self

    @classmethod
    def _create_mesh(cls, db, mesh, dense: bool, fold: str, split2: bool,
                     split_sig: bool, batch_size, n_queries_hint, **kw):
        """:meth:`create` under a mesh: the pipeline of this rank's stripe
        (the JAX package's ``backend`` rule: ``stream`` stays, the other
        planes folds take the mesh's gathered fold, dense counts are
        ``xla``)."""
        from ..db.database import ensure_kmer_layout
        from ..parallel.mesh import ShardedPipeline

        # the mesh slices contiguous reference columns per model shard,
        # which only the packed layout has
        ensure_kmer_layout(db, "packed")
        backend = "xla" if dense else ("stream" if fold == "stream" else "pallas")
        pipeline = ShardedPipeline.create(
            db, mesh, backend=backend, split2=split2, split_sig=split_sig
        )
        state = pipeline.state
        if not batch_size:
            batch_size = auto_batch_size(
                state, pipeline.n_local, n_queries_hint, dense=dense
            )
        self = cls(
            db=db, batch_size=_round_up(int(batch_size), mesh.shape["data"]),
            state=state, significance="dd", fold=(
                "dense" if dense else
                "stream" if backend == "stream" else "gathered"
            ),
            counts="dense" if dense else "planes", pipeline=pipeline, **kw,
        )
        self._exact_mode = False
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

    def _sparse_counts(self, kmer_idx: np.ndarray, k_pad: int):
        """Block-sparse fold dispatch, or None after a sticky fallback.

        The pair budget is the work crossover against the dense fold;
        exceeding it once flips the engine to the dense kernel for good —
        conserved-marker k-mers that post in every block would pay the pair
        lists and their regroup for no traffic win."""
        st = self.state
        S = int(st.kmer_major3.shape[1])
        budget = max(SPARSE_BUDGET_MIN, k_pad * S // SPARSE_CROSSOVER_DIV)
        res = build_pairs(kmer_idx, st.blk_ptr, st.blk_ids, budget)
        if res is None:
            self._sparse = False
            log.info(
                "dense postings profile (pair budget %d exceeded): "
                "switching to the dense fold", budget,
            )
            return None
        pair_kmer, pair_blk, max_pairs, totals = res
        self.pair_stats[0] += int(totals.sum())
        self.pair_stats[1] += int(np.count_nonzero(totals))
        self.pair_stats[2] = max(self.pair_stats[2], max_pairs)
        return fold_planes_sparse(
            self._to_device(pair_kmer), self._to_device(pair_blk),
            self._to_device(totals.astype(np.int32)), st.kmer_major3,
            max_count=k_pad,
        )

    def _query_rows(self, seqs, kmer_sets) -> np.ndarray:
        """``[B, 2048]`` int32 packed query presence rows (zero rows pad the
        batch)."""
        q_bits = native.pack_query_rows(seqs) if kmer_sets is None else None
        if q_bits is None:
            if kmer_sets is None:
                kmer_sets = [sequence_to_kmers(s) for s in seqs]
            q_bits = pack_query_kmers(kmer_sets)
        rows = np.zeros((self.batch_size, q_bits.shape[1]), np.int32)
        rows[: q_bits.shape[0]] = q_bits.view(np.int32)
        return rows

    def _dense_counts(self, seqs, kmer_sets) -> torch.Tensor:
        """The ``[B, N]`` f32 count matrix of the dense backend: the packed
        query presence rows against the resident ref-major matrix."""
        return intersection_counts_xla(
            self._to_device(self._query_rows(seqs, kmer_sets)),
            self.state.ref_bits,
        )

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

        ids = None
        if e_pad:
            ids = np.full((B, e_pad), -1, dtype=np.int64)
            for i, e in enumerate(exact):
                ids[i, : len(e)] = e
        if self.pipeline is not None:
            planes, hist_dev = self.pipeline.counts_and_hist(
                kmer_idx, ids, s_max,
                query_bits=self._query_rows(seqs, kmer_sets)
                if self.counts == "dense" else None,
            )
        elif self.counts == "dense":
            planes = self._dense_counts(seqs, kmer_sets)
            if ids is not None:
                planes = zero_reference_ids(planes, self._to_device(ids))
            hist_dev = intersection_histogram(planes, s_max)
        else:
            planes = None
            if self._sparse:
                planes = self._sparse_counts(kmer_idx, k_pad)
            elif self.fold == "stream":
                planes = intersection_planes_stream(
                    self._to_device(kmer_idx), st.kmer_major3, max_count=k_pad
                )
            elif self.fold == "gathered":
                planes = intersection_planes_gathered(
                    self._to_device(kmer_idx), st.kmer_major3, max_count=k_pad
                )
            if planes is None:
                planes = fold_planes(
                    self._to_device(kmer_idx),
                    self._to_device(np.asarray(ks, np.int32)),
                    st.kmer_major3,
                    max_count=k_pad,
                )
            if ids is not None:
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
        return _Submitted(
            labels, seqs, exact, ks, s_max, n_real, planes, hist_host, ready
        )

    def _significant_dd(self, planes, table, wire):
        """The double-f32 significance stage; ``wire`` None selects the
        full-width lookup (no overflow lists)."""
        st = self.state
        over_idx, over_val = (wire[1], wire[2]) if wire is not None else (None, None)
        return significant_nodes_planes(
            planes, table, st.node_starts, st.node_ends,
            over_idx=over_idx, over_val=over_val, bm_scan=self.bm_scan,
            layout=st.layout, split2=st.split2, sideband=st.sideband,
            num_tips=self.db.num_tips, split=st.split_sig,
        )

    def prepare_batch(self, state: _Submitted) -> _Prepared:
        """Phase B: wait for the histogram, run the host f64 probability
        model, dispatch the table lookup, the scan and the threshold masks
        (and, on the double-f32 path, the wire compression before them).
        The significant set is not pulled here, so a following phase-A
        dispatch of the next batch queues right behind this batch's device
        work."""
        t_start = time.perf_counter()
        ks, s_max, n_real, planes = state.ks, state.s_max, state.n_real, state.planes
        st = self.state
        exact_mode = self._exact_mode
        wire = None
        dense = self.counts == "dense"
        if self.pipeline is not None:
            pass  # full-width lookup; replays gather rows over the mesh
        elif dense:
            # the nibble wire, once host replays have been dense; sparse
            # replays gather u16 count rows per query instead. A device
            # descent replays nothing
            if self._fb_dense and self.descent == "exact":
                wire = compress_counts(planes)
        elif not exact_mode and not self._mux_dense:
            # the overflow lists feed the low-bit lookup's fix-up on the
            # device; the lo4 planes are the host wire, gathered per query
            # when a replay asks for them. Skipped in dense-count mode (the
            # full-width lookup needs no fix-up; replays decode the planes)
            wire = compress_planes(
                planes, budget=self._over_budget, layout=st.layout
            )
        if state.ready is not None:
            state.ready.synchronize()
        hist = state.hist_host.numpy()
        if self.pipeline is not None:
            # every tip of every stripe was counted: padded ones at size 0
            hist[:, 0] -= self.pipeline.n_padded - self.db.num_tips
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

        table64, tables64, global_signals, signal_risky = self._host_model(
            hist, ks, n_real, s_max
        )
        sig, cum0, table = self._dispatch_significance(
            planes, table64, exact_mode, wire
        )
        self.phase_seconds["prepare"] += time.perf_counter() - t_start
        return _Prepared(
            labels=state.labels, seqs=state.seqs, exact=state.exact,
            n_real=n_real, planes=planes, tables64=tables64,
            global_signals=global_signals, signal_risky=signal_risky,
            sig=sig, cum0=cum0, exact_mode=exact_mode, wire=wire,
            sig_wire=None if dense else wire, table=table,
        )

    def _host_model(self, hist: np.ndarray, ks: list, n_real: int, s_max: int):
        """The host f64 stage of phase B: ``(table64 [B, s_max], per-query
        tables, global signals, queries whose signal sits on a rounding
        boundary)``."""
        B = self.batch_size
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
        return table64, tables64, global_signals, signal_risky

    def _dispatch_significance(self, planes, table64: np.ndarray,
                               exact_mode: bool, wire):
        """Queue the table lookup, the scan and the threshold masks of phase
        B: ``(sig, cum0, f32 table on the device or None)``."""
        st = self.state
        if exact_mode:
            sig, cum0 = significant_nodes_exact(
                planes, self._to_device(table64), st.node_starts, st.node_ends,
                split2=st.split2, layout=st.layout, num_tips=self.db.num_tips,
            )
            return sig, cum0, None
        table = self._to_device(table64.astype(np.float32))
        if self.pipeline is not None:
            sig, cum0 = self.pipeline.significant(planes, table)
        elif self.counts == "dense":
            sig, cum0 = significant_nodes(
                planes, table, st.node_starts, st.node_ends,
                split=st.split_sig,
            )
        else:
            sig, cum0 = self._significant_dd(planes, table, wire)
        return sig, cum0, table

    def _exact_row(self, b: int, planes) -> np.ndarray:
        """One query's exact count row in tip order, decoded on the device
        from its planes (or cut from the dense count matrix)."""
        return self._plane_rows(planes, [b])[0].astype(np.int64)

    def _plane_rows(self, planes, queries: list[int]) -> np.ndarray:
        """``[len(queries), num_tips]`` exact counts of the given queries:
        decoded on the device from their planes, or, with dense counts, the
        rows of the count matrix narrowed to integers; under a mesh, rows
        gathered from every shard."""
        if self.pipeline is not None:
            return self.pipeline.gather_rows(planes, queries)[:, : self.db.num_tips]
        if self.counts == "dense":
            idx = torch.as_tensor(queries, dtype=torch.long, device=planes.device)
            return planes.index_select(0, idx).to(torch.int32).cpu().numpy()
        rows = decode_plane_rows(planes, queries, self.state.layout)
        return rows[:, : self.db.num_tips].cpu().numpy()

    @property
    def _flat_w(self) -> int:
        """Word count of the flat layout (0 when packed), as the native
        decoders take it."""
        st = self.state
        if st.layout != "flat" or st.kmer_major3 is None:
            return 0
        return int(st.kmer_major3.shape[1] * st.kmer_major3.shape[2])

    @staticmethod
    def _gather_wire_rows(wire, queries: list[int]):
        """The wire rows of the selected queries on the host: ``(lo4 u32
        [m, 4, S, 128], over_idx i32, over_val u16, n_over)``."""
        lo4, over_idx, over_val, n_over = wire
        idx = torch.as_tensor(queries, dtype=torch.long, device=lo4.device)
        return (
            lo4.index_select(0, idx).contiguous().cpu().numpy().view(np.uint32),
            over_idx.index_select(0, idx).cpu().numpy(),
            over_val.index_select(0, idx).cpu().numpy().astype(np.uint16),
            n_over.index_select(0, idx).cpu().numpy(),
        )

    def _ensure_cums(
        self, queries: list[int], st: _Prepared, cum_for: dict[int, np.ndarray]
    ) -> None:
        """Fill ``cum_for[b]`` with the exact f64 tip-probability prefix sum
        of every requested query (src/lineage.rs:62-67): decoded from the
        query's wire rows when its overflow list fits the budget, else from
        its full planes. The native kernel fuses decode + table gather +
        running sum; the numpy fallbacks add left to right in f64 as well."""
        num_tips = self.db.num_tips
        todo = [b for b in queries if b not in cum_for]
        full_needed: list[int] = todo
        if st.wire is not None and todo:
            full_needed = []
            nibble = self.counts == "dense"
            lo4, over_idx, over_val, n_over = self._gather_wire_rows(st.wire, todo)
            budget = over_idx.shape[1]
            for i, b in enumerate(todo):
                n = int(n_over[i])
                if n > budget:  # the overflow list did not fit
                    full_needed.append(b)
                    continue
                if nibble:
                    cum = native.tip_cumsum_nibble(
                        lo4[i], over_idx[i], over_val[i], n, st.tables64[b],
                        num_tips,
                    )
                else:
                    cum = native.tip_cumsum_planes4(
                        lo4[i], over_idx[i], over_val[i], n, st.tables64[b],
                        num_tips, flat_w=self._flat_w,
                    )
                if cum is None and nibble:  # no native library
                    row, over = decompress_rows(
                        lo4, over_idx, over_val, n_over, [i], num_tips,
                        budget=budget,
                    )
                elif cum is None:
                    row, over = decompress_planes_rows(
                        lo4, over_idx, over_val, n_over, [i], num_tips,
                        budget=budget, layout=self.state.layout,
                    )
                if cum is None:  # the numpy decompress path
                    assert not over
                    cum = np.concatenate(
                        ([0.0], np.cumsum(st.tables64[b][row[0]]))
                    )
                cum_for[b] = cum
        if full_needed:
            rows = self._plane_rows(st.planes, full_needed)
            for row, b in zip(rows, full_needed):
                cum = native.tip_cumsum_u16(row, st.tables64[b], num_tips)
                if cum is None:
                    cum = np.concatenate(([0.0], np.cumsum(st.tables64[b][row])))
                cum_for[b] = cum
        self.host_replays += len(todo)

    def _descend_host(self, cum: np.ndarray, node: int) -> int:
        """The reference's descent (src/lineage.rs:151-177) on one query's
        exact f64 prefix sums: range sums on demand, LAST maximal child."""
        tax = self.db.taxonomy
        rs, re = tax.range_start, tax.range_end
        cur = node
        while tax.node_type[cur] == NODE_INNER:
            kids = tax.children(cur)
            v = cum[re[kids]] - cum[rs[kids]]
            cur = int(kids[len(v) - 1 - int(np.argmax(v[::-1]))])
        return cur

    def _descend_host_batch(
        self, sites: list[tuple[int, int]], st: _Prepared, cum_cache: dict
    ) -> dict | None:
        """One native pass resolving every site whose query is not already
        in ``cum_cache``: exact f64 prefix sums + reference descents.
        Returns None when the native library is missing, a query's overflow
        list does not fit the wire, or the decode work exceeds
        :data:`DESCEND_HOST_WORK` — the caller then descends on the
        device."""
        if native.get_lib() is None:
            return None
        tax = self.db.taxonomy
        uq = sorted({b for b, _ in sites if b not in cum_cache})
        if not uq:
            return {}
        if len(uq) * self.db.num_tips > self.DESCEND_HOST_WORK:
            return None
        lo4, over_idx, over_val, n_over = self._gather_wire_rows(st.wire, uq)
        if (n_over > over_idx.shape[1]).any():
            return None  # the wire cannot reproduce some query's counts
        row_of = {b: i for i, b in enumerate(uq)}
        keys = [(b, node) for b, node in sites if b not in cum_cache]
        finals = native.descend_planes4_batch(
            lo4, over_idx, over_val, n_over, [st.tables64[b] for b in uq],
            np.asarray([row_of[b] for b, _ in keys], np.int32),
            np.asarray([node for _, node in keys], np.int32),
            self.db.num_tips, tax.range_start, tax.range_end,
            tax.child_ptr, tax.child_ids, tax.node_type,
            flat_w=self._flat_w,
        )
        if finals is None:
            return None
        self._replayed_queries = set(uq)
        self.host_replays += len(uq)
        return {k: int(f) for k, f in zip(keys, finals)}

    def _site_tensors(self, sites):
        arr = np.asarray(sites, dtype=np.int64)
        dev = self.state.device
        return (
            torch.from_numpy(arr[:, 0].copy()).to(dev),
            torch.from_numpy(arr[:, 1].copy()).to(dev),
        )

    def _resolve_fallbacks(
        self, sites: list[tuple[int, int]], st: _Prepared, cum_cache: dict
    ) -> dict:
        """Max-confidence descents for every (query, GLOBAL node) site
        (src/lineage.rs:151-177): ``{site -> final Taxon/Sequence node}``.

        Exact mode descends on the device on exact f64 values, bit for bit
        the reference's recursion; nothing is marginal. On the double-f32
        path the sites first try one batched all-host pass over the wire
        (tie-dense workloads fail the device margin for most sites, so the
        device descent would be pure overhead); past its work budget they
        descend on the device with certainty margins, and a result is
        accepted only when its margin PROVES the f32 argmax equals the
        reference's f64 one. Marginal sites — exact ties, near-ties — and
        sites of queries whose f64 prefix sums are in ``cum_cache`` already
        replay on the host. ``descent="device"`` skips the host pass and
        accepts every device result."""
        self._replayed_queries = set()
        if not sites:
            return {}
        ds = self.state
        if st.exact_mode:
            finals = max_descent_exact(
                st.cum0, *self._site_tensors(sites),
                ds.range_start, ds.range_end, ds.child_ptr, ds.child_ids,
                ds.is_inner,
            ).cpu().numpy()
            return {s: int(f) for s, f in zip(sites, finals)}

        fallback_map: dict = {}
        exact_descent = self.descent == "exact"
        if exact_descent and st.wire is not None and self.counts == "planes":
            resolved = self._descend_host_batch(sites, st, cum_cache)
            if resolved is not None:
                fallback_map.update(resolved)
                rest = [(b, n) for b, n in sites if b in cum_cache]
                for b, node in rest:
                    fallback_map[(b, node)] = self._descend_host(cum_cache[b], node)
                self._replayed_queries |= {b for b, _ in rest}
                return fallback_map

        cum0 = st.cum0
        if cum0 is None:
            # the unit/wide path does not keep the [B, N+1] pair across the
            # pipeline; rebuild it from the retained planes — same
            # construction, same double-f32 rounding as the compaction
            sw = st.sig_wire
            cum0 = cum_from_planes(
                st.planes, st.table,
                sw[1] if sw is not None else None,
                sw[2] if sw is not None else None,
                layout=ds.layout,
                sideband=ds.split2 is not None and ds.sideband,
            )
        if self.pipeline is not None:
            arr = np.asarray(sites, dtype=np.int64)
            finals, margins = self.pipeline.descend(cum0, arr[:, 0], arr[:, 1])
            margin_safe = DESCENT_MARGIN_SAFE_MESH
        else:
            finals, margins = max_descent(
                cum0, *self._site_tensors(sites),
                ds.range_start, ds.range_end, ds.child_ptr, ds.child_ids,
                ds.is_inner,
            )
            finals = finals.cpu().numpy()
            margins = margins.cpu().numpy()
            margin_safe = DESCENT_MARGIN_SAFE
        host_sites: list[tuple[int, int]] = []
        for i, (b, node) in enumerate(sites):
            if not exact_descent or (
                margins[i] > margin_safe and b not in cum_cache
            ):
                fallback_map[(b, node)] = int(finals[i])
            else:
                host_sites.append((b, node))
        if not host_sites:
            return fallback_map
        # exact replay of the marginal sites on the host
        fb_queries = sorted({b for b, _ in host_sites})
        self._replayed_queries = set(fb_queries)
        self._ensure_cums(fb_queries, st, cum_cache)
        for b, node in host_sites:
            fallback_map[(b, node)] = self._descend_host(cum_cache[b], node)
        return fallback_map

    def _pull_significant(self, st: _Prepared):
        """Compact and pull the batch's significant set: ``(off, idx,
        conf64)``. On the double-f32 path the overflow-adequacy check comes
        first, keyed on the batch's OWN wire, not on the sticky flag — a
        batch prepared with the low-bit lookup just before a sibling batch
        flipped the flag still needs its own redo. A query whose tips with a
        count above 15 exceed the fixed budget got WRONG device
        probabilities from the fix-up: redo the batch's significance with
        the full-width lookup and stay in dense-count mode. Then the f64
        recombination, within ~4e-9 of the reference's sequential f64
        confidences (see CONF_RISK_MARGIN_SINGLE)."""
        if st.exact_mode:
            return st.sig.pull()
        if st.wire is not None and st.n_real and self.counts == "planes":
            n_over = st.wire[3].cpu().numpy()[: st.n_real]
            budget = st.wire[1].shape[1]
            if (n_over > budget).any():
                if not self._mux_dense:
                    self._mux_dense = True
                    log.info(
                        "dense intersection profile (max %d tips over the "
                        "%d-slot overflow budget): switching to the "
                        "full-width probability lookup",
                        int(n_over.max(initial=0)), budget,
                    )
                st.sig_wire = None  # an inadequate wire must not feed the lookup
                st.sig, st.cum0 = self._significant_dd(st.planes, st.table, None)
        off, idx_f, hi_f, lo_f = st.sig.pull()
        return off, idx_f, hi_f.astype(np.float64) + lo_f.astype(np.float64)

    def finalize_batch(self, state) -> list[QueryResult]:
        """Phase C: compact and pull the significant set, replay what the
        double-f32 path cannot prove, run the descents, evaluate and format
        on the host."""
        if isinstance(state, _Submitted):  # run phase B inline
            state = self.prepare_batch(state)
        t_start = time.perf_counter()
        st = state
        labels, seqs, exact, n_real = st.labels, st.seqs, st.exact, st.n_real
        planes, tables64, global_signals = st.planes, st.tables64, st.global_signals
        tax = self.db.taxonomy
        eval_ids = tax.eval_ids
        ds = self.state

        off, idx_f, conf64_f = self._pull_significant(st)
        self.phase_seconds["finalize_pull"] += time.perf_counter() - t_start

        # boundary-risk replay of the global signal in the reference's
        # sequential tip order (src/lineage.rs:86-90)
        if st.signal_risky:
            inv_n = 1.0 / self.db.num_tips
            for b in st.signal_risky:
                tipp = tables64[b][self._exact_row(b, planes)]
                global_signals[b] = np.sqrt(
                    np.cumsum((tipp - inv_n) ** 2)[-1]
                )

        # flat views over the REAL queries only (padded rows trail behind)
        total = int(off[n_real]) if n_real else 0
        idx_f = idx_f[:total]
        conf64_f = conf64_f[:total]
        if ds.unit_ptr is not None and total:
            # expand unit-tip codes (-(tip+2)) into the tip's unit eval
            # nodes — a 1-record species chain yields one entry per level,
            # all with the tip's confidence
            neg = idx_f < -1
            if neg.any():
                up, uv = ds.unit_ptr, ds.unit_vals
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
            slack = 1e-9 if st.exact_mode else 1e-3
            v = conf64_f
            if v.min() < -slack or v.max() > 1.0 + slack:
                raise AssertionError(
                    "debug-checks: node confidence outside [0, 1] "
                    f"(min {v.min()}, max {v.max()})"
                )

        # Boundary-risk correction: double-f32 confidences within the
        # recombination error of a half-cent rounding boundary (x.xx5, incl.
        # the 0.005 significance cutoff) could round differently than the
        # reference's f64 prefix sums. Recompute those queries' significant
        # confidences exactly on the host (not under a device descent).
        cum_cache: dict[int, np.ndarray] = {}
        if total and not st.exact_mode and self.descent == "exact":
            margin = (
                CONF_RISK_MARGIN_SINGLE if self.pipeline is None
                else CONF_RISK_MARGIN_MESH
            )
            near = np.abs(((conf64_f * 100.0) % 1.0) - 0.5) < margin
            if near.any():
                qid = np.repeat(np.arange(n_real), np.diff(off))
                risky = sorted(set(qid[near].tolist()))
                self._ensure_cums(risky, st, cum_cache)
                rs_all, re_all = tax.range_start, tax.range_end
                for b in risky:
                    s, e = int(off[b]), int(off[b + 1])
                    nb = nodes_f[s:e]
                    cum = cum_cache[b]
                    conf64_f[s:e] = cum[re_all[nb]] - cum[rs_all[nb]]

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
        fallback_map = self._resolve_fallbacks(sites, st, cum_cache)
        if not st.exact_mode:
            # only queries whose descent margin proved nothing, or whose
            # confidences sat on a rounding boundary, needed the host. When
            # they are dense the double-f32 path ships count rows every
            # batch: "auto" then switches the run to the exact-f64 path,
            # which needs no wire at all
            need_host = self._replayed_queries | set(cum_cache)
            self._replayed_queries = need_host
            self._fb_dense = len(need_host) * 2 >= max(n_real, 1)
            if (
                self._fb_dense
                and not self._exact_mode
                and self.significance == "auto"
                and self.counts == "planes"
            ):
                self._exact_mode = True
                log.info(
                    "dense host-replay pressure (%d/%d queries): switching "
                    "to the exact-f64 path", len(need_host), n_real,
                )
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
