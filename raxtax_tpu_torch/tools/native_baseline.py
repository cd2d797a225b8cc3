"""Native per-core CPU baseline of the reference architecture, the port of
the JAX package's ``scripts/native_baseline.py``.

The reference's Rust binary cannot be built here, so this bounds what its
ARCHITECTURE costs per core on the host instead:

1. re-creates the reference's inverted index (k-mer -> sorted postings list,
   reference: src/tree.rs:114-137) as a CSR pair from the k-mer-major bit
   matrix,
2. runs the reference's per-query hot loop — zero a ``num_tips`` scatter
   buffer, scatter-add over each query k-mer's postings, histogram the
   intersection sizes (src/raxtax.rs:38-64, src/prob.rs:13-19) — in C++
   (``rx_baseline_intersect`` of ``native/rx_host.cpp`` through the port's
   ``native.py`` binding; single core), and
3. times the downstream (probability model, lineage evaluation, formatting)
   with the port's host implementations.

Reported (one JSON line on stdout): the hot loop's q/s on one core (an upper
bound on the reference's per-core rate on this CPU), the full per-query q/s
(hot loop + downstream with memoized probability tables), and a 64-core
extrapolation at perfect scaling. The world is ``tools/bench.py``'s (and its
database cache). Host only: no GPU is used.

    RAXTAX_BENCH_REFS=1000000 python -m raxtax_tpu_torch.tools.native_baseline
    RAXTAX_BENCH_REFS=300 RAXTAX_BASELINE_QUERIES=4 python -m raxtax_tpu_torch.tools.native_baseline
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

from . import bench


def build_csr(db) -> tuple[np.ndarray, np.ndarray]:
    """CSR postings (reference src/tree.rs:52, 114-137: k-mer -> sorted
    distinct reference ids) from the k-mer-major bit matrix, in either
    postings layout."""
    t0 = time.time()
    km = db.kmer_major[: 1 << 16]  # drop the zero-pad sentinel row
    n = db.num_tips
    W = km.shape[1]
    counts = np.zeros(1 << 16, dtype=np.int64)
    offsets = np.zeros((1 << 16) + 1, dtype=np.int64)
    chunk = 2048

    def bits_of(lo):
        w = np.ascontiguousarray(km[lo : lo + chunk]).astype("<u4")
        bits = np.unpackbits(w.view(np.uint8), axis=1, bitorder="little")
        if db.kmer_layout == "flat":
            # flat: tip t sits at bit t // W of word t % W
            bits = bits.reshape(-1, W, 32).transpose(0, 2, 1).reshape(-1, 32 * W)
        return bits[:, :n]

    for lo in range(0, 1 << 16, chunk):
        counts[lo : lo + chunk] = bits_of(lo).sum(axis=1)
    offsets[1:] = np.cumsum(counts)
    postings = np.empty(offsets[-1], dtype=np.int32)
    for lo in range(0, 1 << 16, chunk):
        rows, cols = np.nonzero(bits_of(lo))
        # rows ascending, cols ascending within a row: CSR order for free
        postings[offsets[lo] : offsets[lo] + rows.size] = cols
    bench.log(
        f"CSR postings built in {time.time() - t0:.1f}s: "
        f"{offsets[-1]:,} entries ({postings.nbytes / 1e9:.2f} GB)"
    )
    return postings, offsets


def main(argv=None) -> int:
    from .. import native
    from ..lineage.evaluate import evaluate_dense
    from ..models.oracle import apply_exact_match_policy
    from ..prob.model import normalized_size_probs
    from ..utils.encoding import sequence_to_kmers

    lib = native.get_lib()
    if lib is None:
        bench.log("native library unavailable; cannot measure")
        return 1
    n_timed = int(os.environ.get("RAXTAX_BASELINE_QUERIES", 64))
    cfg = bench.config()
    n_refs = cfg.configs[-1]
    fam, rng = bench.synth_fam()
    db, _, saver = bench.get_database(cfg, n_refs, fam, rng)
    queries = bench.synth_queries(fam, max(n_timed, 16))
    postings, offsets = build_csr(db)
    bench.join_saver(saver)

    num_tips = db.num_tips
    buffer = np.zeros(num_tips, dtype=np.uint16)
    t_hot, t_full = [], []
    for label, seq in queries[:n_timed]:
        t0 = time.time()
        exact = db.exact_matches(seq)
        kmers = np.ascontiguousarray(sequence_to_kmers(seq), np.uint16)
        K = int(kmers.size)
        hist = np.zeros(K + 1, dtype=np.int64)
        t1 = time.time()
        lib.rx_baseline_intersect(
            postings, offsets, kmers, K, buffer, num_tips, hist
        )
        t2 = time.time()
        probs_size, _ = normalized_size_probs(hist, K)
        probs = probs_size[buffer[:num_tips].astype(np.int64)]
        inv_n = 1.0 / num_tips
        global_signal = float(np.sqrt(np.cumsum((probs - inv_n) ** 2)[-1]))
        results = evaluate_dense(
            db.taxonomy, label, probs, global_signal=global_signal
        )
        results, _ = apply_exact_match_policy(
            label, db, exact, results, False, False
        )
        for r in results:
            r.out_line()
        t3 = time.time()
        t_hot.append(t2 - t1)
        t_full.append(t3 - t0)
    t_hot.sort()
    t_full.sort()
    med_hot = t_hot[len(t_hot) // 2]
    med_full = t_full[len(t_full) // 2]
    print(json.dumps({
        "n_refs": n_refs,
        "postings_entries": int(offsets[-1]),
        "hot_loop_ms": round(med_hot * 1e3, 3),
        "hot_loop_qps_1core": round(1.0 / med_hot, 1),
        "full_query_ms": round(med_full * 1e3, 3),
        "full_query_qps_1core": round(1.0 / med_full, 1),
        "upper_bound_qps_64core": round(64.0 / med_hot, 1),
        "n_timed": len(t_hot),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
