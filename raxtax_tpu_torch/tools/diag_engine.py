"""Where a batch's time goes in the engine as the benchmark would run it:
serialized phase times, the helpers inside them, and the sticky mode flips.

    python -m raxtax_tpu_torch.tools.diag_engine [--refs 1000000] [--queries 2048]
        [--device cuda]

The counterpart of the JAX package's ``scripts/diag_engine.py``. On a
synthetic world (``tools/synth.build_world``) an engine in the JAX package's
default mode (``significance="auto"``, block-sparse fold: the mode whose
sticky flips this reads) runs two warm-up batches, then
``RAXTAX_PROFILE_REPS`` (default 4) batches one phase at a time — submit,
prepare, finalize — with the device synchronised after each, so each median
is the phase's whole cost; then two passes of the pipelined three-phase loop
over all queries. The helpers that
the adaptive modes make expensive are wrapped and timed: ``_resolve_fallbacks``,
``_ensure_cums``, ``_significant_dd`` (the double-f32 significance, also the
overflow redo) and the native evaluator's ``evaluate_batch``. The sticky
flips are read before and after: the sparse fold falling back to the dense one,
``_mux_dense`` (the full-width lookup), and ``auto`` turning exact.

Fields of the JAX engine that have no counterpart here are named in the line
(``not_in_port``). Prints one JSON line; host-clock times. Runs on the GPU
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import sys
import time
from types import SimpleNamespace

REPS = int(os.environ.get("RAXTAX_PROFILE_REPS", 4))

NOT_IN_PORT = {
    "_top_k": "the significant set is compacted by nonzero: no width to widen",
    "_split": "split_sig belongs to the dense-count backend (its own flag)",
    "_significant": "named _significant_dd here (the exact path has no redo)",
}


def modes(clf) -> dict:
    """The engine's sticky flags."""
    return {
        "sparse_fold": bool(clf._sparse), "mux_dense": bool(clf._mux_dense),
        "exact_mode": bool(clf._exact_mode), "fb_dense": bool(clf._fb_dense),
        "bm_scan": bool(clf.bm_scan), "split2": clf.state.split2 is not None,
        "over_budget": int(clf._over_budget), "host_replays": int(clf.host_replays),
    }


def wrap(obj, name: str, sink: dict) -> None:
    """Time every call of ``obj.name`` into ``sink[name]``."""
    fn = getattr(obj, name)

    @functools.wraps(fn)
    def timed(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            sink.setdefault(name, []).append(time.perf_counter() - t0)

    setattr(obj, name, timed)


def sub_summary(sub: dict, n_batches: int) -> dict:
    return {
        k: {"calls": len(v), "total_ms": sum(v) * 1e3,
            "ms_per_batch": sum(v) * 1e3 / max(n_batches, 1)}
        for k, v in sorted(sub.items())
    }


def diagnose(n_refs: int, n_queries: int, batch: int, device: str) -> dict:
    import torch

    from .. import native
    from ..engine.classify import make_classifier
    from ..utils.device import resolve_device
    from ..utils.encoding import sequence_to_kmers
    from .profile_path import drive
    from .synth import build_world

    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    db, queries, build_s = build_world(n_refs, n_queries)
    args = SimpleNamespace(
        backend="auto", device=str(dev), batch_size=batch, debug_checks=False,
        tsv=True, skip_exact_matches=False, raw_confidence=False,
        significance="auto", fold="sparse", bm_scan=False, split_sig=False,
    )
    clf = make_classifier(db, args, n_queries_hint=len(queries))
    B = clf.batch_size
    counts = native.distinct_kmer_counts([s for _, s in queries])
    if counts is None:
        counts = [sequence_to_kmers(s).size for _, s in queries]
    clf.prewarm(int(max(counts)))
    t0 = time.perf_counter()
    for lo in (0, B):
        clf.finalize_batch(clf.prepare_batch(clf.submit_batch(queries[lo : lo + B])))
    sync()
    warmup_s = time.perf_counter() - t0
    before = modes(clf)

    sub: dict = {}
    for name in ("_resolve_fallbacks", "_ensure_cums", "_significant_dd"):
        wrap(clf, name, sub)
    if clf._evaluator is not None:
        wrap(clf._evaluator, "evaluate_batch", sub)

    phases = {"submit": [], "prepare": [], "finalize": [], "total": []}
    n_chunks = max(1, len(queries) // B)
    for r in range(REPS):
        lo = (r % n_chunks) * B
        chunk = queries[lo : lo + B]
        t0 = time.perf_counter()
        a = clf.submit_batch(chunk)
        sync()
        t1 = time.perf_counter()
        p = clf.prepare_batch(a)
        sync()
        t2 = time.perf_counter()
        clf.finalize_batch(p)
        t3 = time.perf_counter()
        for k, v in (("submit", t1 - t0), ("prepare", t2 - t1),
                     ("finalize", t3 - t2), ("total", t3 - t0)):
            phases[k].append(v)
    serialized = {
        k: {"median_ms": statistics.median(v) * 1e3} for k, v in phases.items()
    }
    serialized_sub = sub_summary(sub, REPS)
    sub.clear()

    passes = []
    for _ in range(2):
        t0 = time.perf_counter()
        done = len(drive(clf, queries, B))
        sync()
        dt = time.perf_counter() - t0
        passes.append({"queries": done, "seconds": dt, "queries_per_s": done / dt,
                       "helpers": sub_summary(sub, -(-len(queries) // B))})
        sub.clear()
    return {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "refs": n_refs, "queries": len(queries), "batch": B,
        "significance": "auto", "fold": "sparse", "db_build_s": build_s,
        "warmup_s": warmup_s, "reps": REPS, "modes_before": before,
        "serialized": serialized, "serialized_helpers": serialized_sub,
        "pipelined_passes": passes, "modes_after": modes(clf),
        "not_in_port": NOT_IN_PORT,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--refs", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=2048)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    a = ap.parse_args(argv)
    print(json.dumps(diagnose(a.refs, a.queries, a.batch_size, a.device)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
