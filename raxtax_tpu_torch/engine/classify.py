"""Query engine: batching loop, backend dispatch, result streaming.

Counterpart of the reference's rayon engine (reference:
src/raxtax.rs:13-97): instead of work-stealing CPU threads, queries stream
through device-sized batches; per-query results are sent to the single
writer thread in query order, preserving the progress-file commit protocol.
"""

from __future__ import annotations

import logging

import numpy as np

from ..db.database import Database
from ..io.outputs import ResultWriter
from ..models.oracle import OracleClassifier, QueryResult
from ..utils.logging import Progress, phase_timer, report_warning

log = logging.getLogger("raxtax")


def make_classifier(db: Database, args, n_queries_hint: int | None = None):
    """Backend dispatch: 'oracle' (host numpy, exact) or 'auto' (the device
    engine, on ``args.device``: the GPU unless the CPU is asked for)."""
    backend = getattr(args, "backend", "auto")
    if backend == "oracle":
        return OracleClassifier(
            db,
            skip_exact_matches=args.skip_exact_matches,
            raw_confidence=args.raw_confidence,
        )
    if backend != "auto":
        raise ValueError(f"backend {backend!r} is not ported yet")
    from .device import DeviceClassifier  # deferred: uploads the database

    return DeviceClassifier.create(
        db,
        skip_exact_matches=args.skip_exact_matches,
        raw_confidence=args.raw_confidence,
        batch_size=getattr(args, "batch_size", 0) or None,
        device=getattr(args, "device", None),
        debug_checks=getattr(args, "debug_checks", False),
        tsv=getattr(args, "tsv", True),
        n_queries_hint=n_queries_hint,
    )


def run_queries(
    db: Database,
    queries: list[tuple[str, np.ndarray]],
    args,
    writer: ResultWriter,
    classifier=None,
) -> bool:
    """Classify all queries, streaming results to the writer thread.

    Returns True if any mislabel warning fired (src/raxtax.rs:23, 93-95).
    ``classifier`` lets a caller that already uploaded the database reuse
    its classifier; by default one is made from ``args``.
    """
    if classifier is None:
        classifier = make_classifier(db, args, n_queries_hint=len(queries))
    warnings = False
    progress = Progress(len(queries), "Running Queries...")
    tsv = args.tsv
    batch_size = getattr(classifier, "batch_size", 1)

    def emit(results: list[QueryResult]):
        nonlocal warnings
        for qr in results:
            warnings |= qr.mislabel_warning
            writer.send(
                qr.label,
                qr.out_string(),
                qr.tsv_string() if tsv else None,
            )
        progress.inc(len(results))

    if queries and hasattr(classifier, "prewarm"):
        # one cheap native pass over the whole stream pins the sticky shape
        # buckets to the global max BEFORE batch 1
        from .. import native

        counts = native.distinct_kmer_counts([s for _, s in queries])
        if counts is None:
            from ..utils.encoding import sequence_to_kmers

            counts = [sequence_to_kmers(s).size for _, s in queries]
        classifier.prewarm(int(max(counts)))

    with phase_timer("raxtax"):
        if hasattr(classifier, "submit_batch"):
            # three-deep software pipeline, three phases per batch:
            #   A submit   — host prep + fold/histogram dispatch
            #   B prepare  — histogram in, prob model, lookup/scan dispatch
            #   C finalize — compaction, pulls, descents, evaluation
            # Batch k's results are consumed two iterations after its
            # device work starts, so it hides behind a full iteration of
            # host work.
            from collections import deque

            prepared: deque = deque()
            for start in range(0, len(queries), batch_size):
                chunk = queries[start : start + batch_size]
                a_state = classifier.submit_batch(chunk)
                if len(prepared) >= 2:
                    emit(classifier.finalize_batch(prepared.popleft()))
                prepared.append(classifier.prepare_batch(a_state))
            while prepared:
                emit(classifier.finalize_batch(prepared.popleft()))
        else:
            for start in range(0, len(queries), batch_size):
                chunk = queries[start : start + batch_size]
                emit([classifier.classify(l, s) for l, s in chunk])
    progress.finish()
    if warnings:
        report_warning(
            "Exact matches for some queries differ above the species level! "
            "Check the log file for more information!"
        )
    return warnings
