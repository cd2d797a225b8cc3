"""Large-scale single-GPU benchmark: a synthetic COI-like database of any
size, sequence length and family count.

Companion to ``tools/bench.py`` (its two fixed sizes): this one builds the
world of the JAX package's ``scripts/bench_scale.py`` (``--families``
consensus sequences of ``--seq-len`` bp, seed 42, 30 mutations a reference,
10 a query, the queries drawn after the references from the same generator)
and times it with ``tools/bench.py``'s loop (four warm-up batches, then
``RAXTAX_BENCH_REPS`` timed passes of the three-deep loop).

    python -m raxtax_tpu_torch.tools.bench_scale --refs 1000000 --queries 2048
    python -m raxtax_tpu_torch.tools.bench_scale --refs 2000 --queries 64 --device cpu

The engine's mode comes from the environment names the CLI reads
(``RAXTAX_EXACT``, ``RAXTAX_SPARSE_FOLD``, ...). Progress lines go to
stdout; the last one is the throughput of the best pass.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ENC = np.array([1, 2, 4, 8], dtype=np.uint8)


def scale_world(n_refs: int, n_queries: int, seq_len: int, families: int):
    """``(lineages, [n_refs] 4-bit sequences, queries)``: the JAX script's
    generator, draw for draw."""
    rng = np.random.default_rng(42)
    fam = rng.integers(0, 4, size=(families, seq_len), dtype=np.int8)
    mat = fam[np.arange(n_refs) % families]
    pos = rng.integers(0, seq_len, size=(n_refs, 30))
    np.put_along_axis(
        mat, pos, rng.integers(0, 4, size=(n_refs, 30), dtype=np.int8), axis=1
    )
    seqs = list(ENC[mat])
    lineages = [
        f"p:P{i % 8},c:C{i % 64},o:O{i % 512},f:F{i % families},"
        f"g:G{i % max(n_refs // 8, 1)},s:S{i}"
        for i in range(n_refs)
    ]
    queries = []
    for i in range(n_queries):
        s = fam[i % families].copy()
        p = rng.integers(0, seq_len, 10)
        s[p] = rng.integers(0, 4, 10)
        queries.append((f"q{i}", ENC[s]))
    return lineages, seqs, queries


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--refs", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=2048)
    ap.add_argument("--backend", default="pallas",
                    choices=["auto", "pallas", "stream", "xla"])
    ap.add_argument("--batch-size", type=int, default=0)
    ap.add_argument("--seq-len", type=int, default=400)
    ap.add_argument("--families", type=int, default=4096)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default; fails without a GPU) or cpu")
    args = ap.parse_args(argv)

    from ..utils.device import resolve_device

    resolve_device(args.device)
    N = args.refs
    t0 = time.time()
    lineages, seqs, queries = scale_world(
        N, args.queries, args.seq_len, args.families
    )
    print(f"generate: {time.time() - t0:.1f}s", flush=True)

    from ..db.database import build_database
    from .bench import make_bench_classifier, timed_passes

    t0 = time.time()
    db = build_database(
        lineages, seqs, with_ref_major=args.backend in ("auto", "xla")
    )
    print(f"build_database({N}): {time.time() - t0:.1f}s", flush=True)
    del lineages, seqs

    t0 = time.time()
    clf = make_bench_classifier(
        db, args.backend, args.batch_size, args.device, len(queries)
    )
    print(
        f"create(+upload): {time.time() - t0:.1f}s batch={clf.batch_size}",
        flush=True,
    )
    reps = max(1, int(os.environ.get("RAXTAX_BENCH_REPS", 3)))
    m = timed_passes(clf, queries, reps)
    print(f"warmup: {m['warmup_s']:.1f}s", flush=True)
    best = min(m["pass_s"])
    print(
        f"passes: {m['pass_s']} s (median {m['median']:.1f} q/s)", flush=True
    )
    print(
        f"{N}-ref DB: {len(queries)} queries in {best:.1f}s = "
        f"{m['best']:.1f} q/s/gpu"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
