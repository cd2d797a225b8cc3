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
from ..utils.trace import span

log = logging.getLogger("raxtax")


def make_classifier(db: Database, args, n_queries_hint: int | None = None,
                    mesh=None):
    """Backend dispatch: 'oracle' (host numpy, exact) or the device engine
    on ``args.device`` (the GPU unless the CPU is asked for). 'auto' and
    'pallas' fold counter planes in the mode ``args.significance`` /
    ``args.fold`` / ``args.bm_scan`` name (the engine's defaults where they
    are absent); 'stream' takes the stream fold; 'xla' builds dense counts
    from the ref-major matrix. ``args.split2`` / ``args.split_sig`` pick the
    double-f32 stage's compaction, ``args.descent`` its descent.

    A mesh forms when ``args.mesh`` is set, or under ``args.global_mesh`` in
    a world of several ranks (``parallel/mesh.mesh_plan``): the JAX rule
    "``--mesh`` or several local devices", with one device per rank. Every
    rank of the world makes its mesh here, at the same point. Otherwise the
    rank runs the single-device engine on its own device. A caller that
    classifies many databases on one mesh passes it as ``mesh``."""
    backend = getattr(args, "backend", "auto")
    if backend == "oracle":
        return OracleClassifier(
            db,
            skip_exact_matches=args.skip_exact_matches,
            raw_confidence=args.raw_confidence,
        )
    if backend not in ("auto", "pallas", "stream", "xla"):
        raise ValueError(f"unknown backend {backend!r}")
    fold = "stream" if backend == "stream" else getattr(args, "fold", "dense")
    import torch.distributed as dist

    from ..parallel.mesh import make_mesh, mesh_plan
    from ..parallel.multihost import rank_device
    from .device import DeviceClassifier  # deferred: uploads the database

    device = rank_device(getattr(args, "device", None))
    spec = getattr(args, "mesh", "")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if mesh is None and mesh_plan(
        spec, world, getattr(args, "global_mesh", False)
    ) is not None:
        mesh = make_mesh(spec, device=device)
        log.info("mesh %s of ranks %s", mesh.shape, mesh.ranks.tolist())

    return DeviceClassifier.create(
        db,
        skip_exact_matches=args.skip_exact_matches,
        raw_confidence=args.raw_confidence,
        batch_size=getattr(args, "batch_size", 0) or None,
        device=device,
        debug_checks=getattr(args, "debug_checks", False),
        tsv=getattr(args, "tsv", True),
        n_queries_hint=n_queries_hint,
        significance=getattr(args, "significance", "exact"),
        fold=fold,
        bm_scan=getattr(args, "bm_scan", False),
        counts="dense" if backend == "xla" else "planes",
        split2=getattr(args, "split2", True),
        split_sig=getattr(args, "split_sig", False),
        descent=getattr(args, "descent", "exact"),
        mesh=mesh,
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
    with span("query.run"):
        warnings = _run(queries, args, writer, classifier)
    if warnings:
        report_warning(
            "Exact matches for some queries differ above the species level! "
            "Check the log file for more information!"
        )
    return warnings


def _run(queries, args, writer: ResultWriter, classifier) -> bool:
    """The batch loop of :func:`run_queries`; returns its warning flag."""
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

        with span("query.prewarm"):
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
    return warnings
