"""The engine's two modes against each other on one GPU, in one process:
exact f64 with the dense fold, and double-f32 with the sparse fold, on the
same synthetic world and the same queries.

    python -m raxtax_tpu_torch.tools.compare_modes --refs 1000000 --rounds 6

Host-clock pass times spread widely on a machine whose host cores are
shared, so the passes alternate (exact, dd, dd, exact, ...) and every pass is
reported. Prints one JSON object: queries/s of every pass in run order, each
mode's median and quartiles, in how many of the rounds the double-f32 pass
was the faster of the pair, and host milliseconds per batch and phase. Needs
a GPU; there is no CPU mode.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

from .profile_path import drive, gpu_line, warm_classifier


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--refs", type=int, default=1_000_000)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--rounds", type=int, default=6,
                    help="pairs of passes; the order within a pair alternates")
    a = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("compare_modes: no CUDA device available", file=sys.stderr)
        return 1
    from .synth import build_world

    gpu = gpu_line()
    B = a.batch_size
    db, queries, build_s = build_world(a.refs, B * a.batches)
    clfs = {
        "exact": warm_classifier(db, queries, B, "exact", "dense"),
        "dd": warm_classifier(db, queries, B, "dd", "sparse"),
    }

    passes = []  # (mode, queries/s) in run order
    dd_wins = 0
    for r in range(a.rounds):
        pair = {}
        for name in (("exact", "dd") if r % 2 == 0 else ("dd", "exact")):
            t0 = time.time()
            done = drive(clfs[name], queries, B)
            torch.cuda.synchronize()
            pair[name] = done / (time.time() - t0)
            passes.append((name, pair[name]))
        dd_wins += pair["dd"] > pair["exact"]

    out = {
        "gpu": gpu, "refs": a.refs, "batch": B, "batches": a.batches,
        "rounds": a.rounds, "db_build_s": round(build_s, 2),
        "passes_queries_per_s": [[n, round(q, 1)] for n, q in passes],
        "dd_faster_in_rounds": int(dd_wins),
    }
    for name, clf in clfs.items():
        qps = [q for n, q in passes if n == name]
        q1, med, q3 = statistics.quantiles(qps, n=4)
        out[name] = {
            "queries_per_s_median": med, "queries_per_s_quartiles": [q1, q3],
            "phase_ms_per_batch": {
                k: round(v * 1e3 / (a.rounds * a.batches), 2)
                for k, v in clf.phase_seconds.items()
            },
            "host_replays": clf.host_replays,
            "fold_still_sparse": bool(clf._sparse),
        }
    out["dd_over_exact_median"] = (
        out["dd"]["queries_per_s_median"] / out["exact"]["queries_per_s_median"]
    )
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
