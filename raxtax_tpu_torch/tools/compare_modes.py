"""The engine's modes against each other on one GPU, in one process, on the
same synthetic world and the same queries.

    python -m raxtax_tpu_torch.tools.compare_modes --refs 1000000 --rounds 6
    python -m raxtax_tpu_torch.tools.compare_modes \\
        --modes exact:dense,exact:stream,exact:gathered,dd:xla

A mode is ``significance:fold`` (``exact:dense`` is the default engine,
``dd:sparse`` the JAX package's default path, ``stream`` and ``gathered`` the
other folds) or ``dd:xla`` for the dense-count backend. The planes engines
share one resident copy of the postings matrix.

Host-clock pass times spread widely on a machine whose host cores are
shared, so every round runs each mode once, the order rotates from round to
round, and every pass is reported. Prints one JSON object: queries/s of every
pass in run order, each mode's median and quartiles, how often each mode was
the fastest of its round, and host milliseconds per batch and phase. Needs a
GPU; there is no CPU mode.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

from .profile_path import drive, gpu_line, warm_classifier

FOLDS = ("dense", "sparse", "gathered", "stream")


def parse_modes(text: str) -> list[tuple[str, str, str]]:
    """``[(name, significance, fold or "xla")]`` from ``a:b,c:d``."""
    modes = []
    for name in text.split(","):
        sig, _, fold = name.partition(":")
        if sig not in ("exact", "dd", "auto") or fold not in FOLDS + ("xla",):
            raise ValueError(f"unknown mode {name!r}")
        modes.append((name, sig, fold))
    return modes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--refs", type=int, default=1_000_000)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--rounds", type=int, default=6,
                    help="passes per mode; the order within a round rotates")
    ap.add_argument("--modes", default="exact:dense,dd:sparse",
                    help="comma-separated significance:fold names, or dd:xla")
    a = ap.parse_args(argv)
    modes = parse_modes(a.modes)

    import torch

    if not torch.cuda.is_available():
        print("compare_modes: no CUDA device available", file=sys.stderr)
        return 1
    from .synth import build_world

    gpu = gpu_line()
    B = a.batch_size
    db, queries, build_s = build_world(
        a.refs, B * a.batches,
        with_ref_major=any(fold == "xla" for _, _, fold in modes),
    )
    clfs = {}
    shared = None  # the postings matrix of the first planes engine
    for name, sig, fold in modes:
        if fold == "xla":
            clfs[name] = warm_classifier(db, queries, B, sig, "dense",
                                         counts="dense")
            continue
        clf = warm_classifier(db, queries, B, sig, fold)
        if shared is not None and shared.shape == clf.state.kmer_major3.shape:
            clf.state.kmer_major3 = shared
            torch.cuda.empty_cache()
        else:
            shared = clf.state.kmer_major3
        clfs[name] = clf

    names = [name for name, _, _ in modes]
    passes = []  # (mode, queries/s) in run order
    fastest = dict.fromkeys(names, 0)
    for r in range(a.rounds):
        k = r % len(names)
        seen = {}
        for name in names[k:] + names[:k]:
            t0 = time.time()
            done = len(drive(clfs[name], queries, B))
            torch.cuda.synchronize()
            seen[name] = done / (time.time() - t0)
            passes.append((name, seen[name]))
        fastest[max(seen, key=seen.get)] += 1

    out = {
        "gpu": gpu, "refs": a.refs, "batch": B, "batches": a.batches,
        "rounds": a.rounds, "db_build_s": round(build_s, 2),
        "passes_queries_per_s": [[n, round(q, 1)] for n, q in passes],
        "fastest_in_rounds": fastest,
    }
    for name, clf in clfs.items():
        qps = [q for n, q in passes if n == name]
        q1, med, q3 = (
            statistics.quantiles(qps, n=4) if len(qps) > 1 else (qps[0],) * 3
        )
        out[name] = {
            "queries_per_s_median": med, "queries_per_s_quartiles": [q1, q3],
            "phase_ms_per_batch": {
                k: round(v * 1e3 / (a.rounds * a.batches), 2)
                for k, v in clf.phase_seconds.items()
            },
            "host_replays": clf.host_replays,
            "fold_still_sparse": bool(clf._sparse),
        }
    if len(names) > 1:
        out["median_over_first_mode"] = {
            n: out[n]["queries_per_s_median"]
            / out[names[0]]["queries_per_s_median"]
            for n in names[1:]
        }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
