"""End-to-end oracle classifier (exact f64, host numpy).

Reference-faithful implementation of the per-query pipeline
(reference: src/raxtax.rs:36-89) used as the correctness oracle for the
device engines and as the zero-dependency fallback backend:

  exact-match lookup -> distinct 8-mers -> per-reference intersection counts
  -> analytic top-hit probabilities -> lineage aggregation -> formatting.

Intersection counts are computed from the packed kmer-major bit matrix
(popcount of gathered postings bitvectors) rather than the reference's
scatter-add loop — identical integers, vector-friendly layout.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

from ..db.database import Database
from ..lineage.evaluate import EvaluationResult, evaluate_dense
from ..prob.model import normalized_size_probs
from ..utils.encoding import decompress_sequence, sequence_to_kmers

log = logging.getLogger("raxtax")


@dataclass
class QueryResult:
    label: str
    results: list[EvaluationResult]
    sequence: np.ndarray
    mislabel_warning: bool = False
    #: pre-formatted text from the native evaluator (engine fast path)
    out_text: str | None = None
    tsv_text: str | None = None

    def out_string(self) -> str:
        if self.out_text is not None:
            return self.out_text
        return "\n".join(r.out_line() for r in self.results)

    def tsv_string(self) -> str:
        if self.tsv_text is not None:
            return self.tsv_text
        seq = decompress_sequence(self.sequence)
        return "\n".join(r.tsv_line(seq) for r in self.results)


def intersection_counts(db: Database, kmers: np.ndarray) -> np.ndarray:
    """|query kmers ∩ ref kmers| for every reference (src/raxtax.rs:58-64)."""
    if kmers.size == 0:
        return np.zeros(db.num_tips, dtype=np.uint16)
    rows = np.asarray(db.kmer_major[kmers.astype(np.int64)])  # [K, W] uint32
    bits = np.unpackbits(rows.view(np.uint8), axis=1, bitorder="little")
    if db.kmer_layout == "flat":
        # flat layout: ref q at word q%W, bit q/W (bitmatrix.build_kmer_major)
        W = rows.shape[1]
        bits = np.ascontiguousarray(
            bits.reshape(-1, W, 32).transpose(0, 2, 1)
        ).reshape(-1, 32 * W)
    return bits.sum(axis=0, dtype=np.uint32)[: db.num_tips].astype(np.uint16)


def log_exact_matches(
    query_label: str, db: Database, exact: list[int],
    skip_exact_matches: bool,
) -> bool:
    """Exact-match logging + mislabel warning (src/raxtax.rs:42-53).
    Returns whether the aggregated warning fired."""
    if skip_exact_matches or not exact:
        return False
    lineages = db.taxonomy.lineages
    for idx in exact:
        log.info(
            "Exact sequence match for query %s: %s",
            query_label,
            lineages[idx],
        )
    parents = {lineages[i].rsplit(",", 1)[0] for i in exact}
    if len(parents) > 1:
        log.warning(
            "Exact matches for %s differ above the leafs of the lineage tree!",
            query_label,
        )
        return True
    return False


def apply_exact_match_policy(
    query_label: str,
    db: Database,
    exact: list[int],
    results: list[EvaluationResult],
    raw_confidence: bool,
    skip_exact_matches: bool,
    log_matches: bool = True,
) -> tuple[list[EvaluationResult], bool]:
    """Mislabel warning + single-exact-match confidence override
    (src/raxtax.rs:42-53, 73-84). Returns (results, warned). Pass
    log_matches=False when the caller already emitted the per-match log
    lines (one line per exact match is the reference's contract)."""
    warned = False
    if log_matches:
        warned = log_exact_matches(query_label, db, exact, skip_exact_matches)
    if not skip_exact_matches:
        lineages = db.taxonomy.lineages
        if not raw_confidence and len(exact) == 1:
            idx = exact[0]
            lineage = lineages[idx]
            results = [
                EvaluationResult(
                    query_label=query_label,
                    lineage=lineage,
                    confidence_values=[1.0] * (lineage.count(",") + 1),
                    local_signal=results[0].local_signal,
                    global_signal=results[0].global_signal,
                )
            ]
    return results, warned


@dataclass
class OracleClassifier:
    """Slow exact classifier; the semantics oracle for the device engines."""

    db: Database
    skip_exact_matches: bool = False
    raw_confidence: bool = False

    def classify(self, label: str, sequence: np.ndarray) -> QueryResult:
        db = self.db
        exact = db.exact_matches(sequence)
        kmers = sequence_to_kmers(sequence)
        assert kmers.size <= 0xFFFF, "too many distinct query k-mers"
        counts = intersection_counts(db, kmers)
        if self.skip_exact_matches and exact:
            counts[np.asarray(exact)] = 0  # src/raxtax.rs:65-68
        # The same memoized hist-based f64 computation the device engine
        # uses (prob/model.py), so oracle and device agree BIT-exactly —
        # including near-tie fallback descents. The reference-structured
        # per-reference loop (prob/oracle.py) is validated against this
        # path to f64 tolerance in tests; at the last-ulp level the
        # reference itself is indeterminate (its `prod` accumulates over a
        # hash map's arbitrary iteration order, src/prob.rs:62-73).
        K = int(kmers.size)
        hist = np.bincount(
            counts.astype(np.int64), minlength=K + 1
        ).astype(np.int64)
        probs_size, _ = normalized_size_probs(hist, K)
        probs = probs_size[counts.astype(np.int64)]
        inv_n = 1.0 / db.num_tips
        # global signal accumulated SEQUENTIALLY over tips in tip order —
        # the reference's exact f64 grouping (src/lineage.rs:86-90,
        # src/utils.rs:107-116); np.cumsum is a sequential f64 scan
        global_signal = float(
            np.sqrt(np.cumsum((probs - inv_n) ** 2)[-1])
        )
        results = evaluate_dense(
            db.taxonomy, label, probs, global_signal=global_signal
        )
        assert results, "evaluation must produce at least one result"
        results, warned = apply_exact_match_policy(
            label, db, exact, results, self.raw_confidence, self.skip_exact_matches
        )
        return QueryResult(
            label=label, results=results, sequence=sequence, mislabel_warning=warned
        )
