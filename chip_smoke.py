#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``raxtax_tpu_torch``).

Run ``python3 chip_smoke.py`` from the repository root on a machine with one
NVIDIA Hopper GPU, the CUDA toolkit (``nvcc``) and PyTorch built for CUDA.
It needs no arguments, no network and no JAX. It

1. builds the seven CUDA sources (eight kernels) from
   ``raxtax_tpu_torch/csrc`` (``env``),
2. drives the exact-f64 classify path end to end on a 65,536-reference
   synthetic database through ``run_queries`` and checks the output files
   against the host oracle, for every flag combination (``path_65k``),
3. drives the double-f32 path with the sparse fold on the same database the
   same way, plus one short run each with the bit-major scan and with
   ``significance="auto"`` (``path_65k_dd``),
4. builds the 1,000,000-reference database (or the largest of 1M / 500k /
   200k that fits the time budget) and drives the exact path at that size
   against the oracle (``path_1m``),
5. runs each kernel at that size against its plain PyTorch version, bit for
   bit, and times both (``kernels``),
6. drives the double-f32 path at that size, checks it against the oracle and
   reports throughput, phase times, peak memory, pairs per query, host
   replays and whether the fold flipped to dense (``path_1m_dd``).

Each phase prints one JSON line; the ``kernels`` line carries, per kernel,
its launches on the main path that runs it, its time, its plain version's
time and its bound on this card. Any failed phase raises, so the exit code is non-zero
and the final ``{"ok": true, ...}`` line is not printed. There is no CPU
path: without a GPU the script exits at once with code 1.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

T_START = time.time()
#: the script aims to end well inside its 1200 s limit; the database size of
#: the large phase is cut to what fits this budget
BUDGET_S = 900.0

#: published peaks of one H100 SXM (NVIDIA data sheet), for the bounds
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS = 33.5e12  # int32 issues on half the f32 lanes (67 TFLOP/s / 2)
PEAK_F64_ADDS = 16.75e12  # 33.5 TFLOP/s f64 counts an FMA as two operations
PEAK_F32_ADDS = 33.5e12  # 67 TFLOP/s f32 counts an FMA as two operations

N_QUERIES = 2048
BATCH = 256


def say(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def note(msg: str) -> None:
    print(f"[{time.time() - T_START:7.1f}s] {msg}", file=sys.stderr, flush=True)


def remaining() -> float:
    return BUDGET_S - (time.time() - T_START)


def build_world(n_refs: int):
    from raxtax_tpu_torch.tools.synth import build_world as build

    return build(n_refs, N_QUERIES)


# -- helpers ---------------------------------------------------------------

def cuda_ms(fn, reps: int = 3) -> float:
    """Mean milliseconds of ``fn()`` on the device over ``reps`` runs, after
    one warm-up run, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bits_equal(a, b) -> bool:
    if a.dtype.is_floating_point:
        it = torch.int64 if a.dtype == torch.float64 else torch.int32
        a, b = a.view(it), b.view(it)
    return a.shape == b.shape and bool(torch.equal(a, b))


def max_abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max().item()) if a.numel() else 0.0


def args_for(skip: bool = False, raw: bool = False, dd: bool = False,
             significance: str | None = None, bm_scan: bool = False):
    """The parsed command line of ``raxtax-torch --tsv --batch-size 256
    --debug-checks`` (output prefix and database path are set per run).
    ``dd`` is what ``RAXTAX_EXACT=0 RAXTAX_SPARSE_FOLD=1`` select."""
    return SimpleNamespace(
        backend="auto", device="cuda", batch_size=BATCH, debug_checks=True,
        tsv=True, skip_exact_matches=skip, raw_confidence=raw, redo=True,
        significance=significance or ("dd" if dd else "exact"),
        fold="sparse" if dd else "dense", bm_scan=bm_scan,
    )


def run_path(db, queries, args, classifier=None):
    """Drive ``run_queries`` into real output files; returns ({label: out
    block}, {label: tsv block}, seconds)."""
    from raxtax_tpu_torch.engine.classify import run_queries
    from raxtax_tpu_torch.io.outputs import ResultWriter, get_output

    with tempfile.TemporaryDirectory() as tmp:
        marker = Path(tmp) / "db.marker"  # the checkpoint fingerprints a file
        marker.write_text("synthetic\n")
        args.prefix = str(Path(tmp) / "out")
        args.database_path = str(marker)
        writers, _ = get_output(args)
        writer = ResultWriter(writers)
        t0 = time.time()
        run_queries(db, queries, args, writer, classifier=classifier)
        writer.join()
        dt = time.time() - t0
        writers.close()

        def blocks(path):
            got: dict[str, list[str]] = {}
            for line in Path(path).read_text().splitlines():
                got.setdefault(line.split("\t", 1)[0], []).append(line)
            return {k: "\n".join(v) for k, v in got.items()}

        outs = blocks(Path(args.prefix) / "raxtax.out")
        tsvs = blocks(Path(args.prefix) / "raxtax.tsv") if args.tsv else {}
    return outs, tsvs, dt


def check_oracle(db, queries, outs, tsvs, n: int, skip=False, raw=False):
    from raxtax_tpu_torch.models.oracle import OracleClassifier

    orc = OracleClassifier(db, skip_exact_matches=skip, raw_confidence=raw)
    for label, seq in queries[:n]:
        want = orc.classify(label, seq)
        if outs[label] != want.out_string():
            raise AssertionError(f"raxtax.out differs from the oracle: {label}")
        if tsvs and tsvs[label] != want.tsv_string():
            raise AssertionError(f"raxtax.tsv differs from the oracle: {label}")
    return n


def launch_counts():
    from raxtax_tpu_torch.ops.exactscan import exact_cumsum
    from raxtax_tpu_torch.ops.intersect_fold import fold_planes, fold_planes_sparse
    from raxtax_tpu_torch.ops.planes import (
        dd_cumsum,
        dd_cumsum_bitmajor,
        planes_high_counts,
        planes_histogram,
        planes_probs,
    )

    return {
        "fold_planes": fold_planes, "planes_hist": planes_histogram,
        "planes_probs": planes_probs, "exact_cumsum": exact_cumsum,
        "fold_planes_sparse": fold_planes_sparse,
        "planes_high": planes_high_counts, "dd_cumsum": dd_cumsum,
        "dd_cumsum_bitmajor": dd_cumsum_bitmajor,
    }


#: the kernels each mode's main path runs
EXACT_PATH = ("fold_planes", "planes_hist", "planes_probs", "exact_cumsum")
DD_PATH = ("planes_hist", "planes_probs", "planes_high", "dd_cumsum")


def reset_counts() -> None:
    for fn in launch_counts().values():
        fn.launches = 0


def read_counts() -> dict:
    return {k: int(fn.launches) for k, fn in launch_counts().items()}


# -- phases ------------------------------------------------------------------

def phase_env() -> dict:
    from raxtax_tpu_torch import native
    from raxtax_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    build_s = _build.build_all()
    for stem in _build.KERNEL_SOURCES:
        _build.load(stem)
    return {
        "phase": "env", "gpu": smi, "torch": torch.__version__,
        "cuda": torch.version.cuda, "kernel_build_s": round(build_s, 2),
        "native_host_library": native.get_lib() is not None,
    }


def flag_combos(db, queries, dd: bool) -> list[dict]:
    """Every flag combination on one batch; half of the compared queries are
    exact copies of references, so the exact-match policy is exercised."""
    from raxtax_tpu_torch.engine.classify import make_classifier

    combos = []
    for skip in (False, True):
        for raw in (False, True):
            batch = list(queries[:BATCH])
            for j in range(4):
                tip = (j * 7919) % db.num_tips
                batch[j] = (f"x{j}", np.array(db.sequence(tip)))
            a = args_for(skip=skip, raw=raw, dd=dd)
            clf = make_classifier(db, a, n_queries_hint=len(batch))
            res = clf.classify_batch(batch)
            o = {r.label: r.out_string() for r in res}
            t = {r.label: r.tsv_string() for r in res}
            check_oracle(db, batch, o, t, 8, skip=skip, raw=raw)
            combos.append({"skip_exact": skip, "raw_conf": raw, "checked": 8})
            del clf
    torch.cuda.empty_cache()
    return combos


def phase_path_65k(db, queries, build_s: float) -> dict:
    reset_counts()
    outs, tsvs, dt = run_path(db, queries, args_for())
    counts = read_counts()
    if set(outs) != {l for l, _ in queries}:
        raise AssertionError("path_65k: not every query has output lines")
    checked = check_oracle(db, queries, outs, tsvs, 16)
    if min(counts[k] for k in EXACT_PATH) <= 0:
        raise AssertionError(f"path_65k: a kernel was never launched: {counts}")
    combos = flag_combos(db, queries, dd=False)
    return {
        "phase": "path_65k", "refs": 65536, "queries": len(queries),
        "batch": BATCH, "db_build_s": round(build_s, 2),
        "pass_s": round(dt, 3), "queries_per_s": round(len(queries) / dt, 2),
        "oracle_checked": checked, "flag_combos": combos, "launches": counts,
        "build_s_per_ref": build_s / 65536,
    }


def batch_inputs(queries):
    """Host arrays of one batch of B = 256 queries: ``(kmer_idx, ks, k_pad,
    s_max, flat_k, off_k)``."""
    from raxtax_tpu_torch import native
    from raxtax_tpu_torch.ops.intersect_fold import PAD_ROW

    seqs = [s for _, s in queries[:BATCH]]
    flat_k, off_k = native.distinct_kmers_flat(seqs)
    ks = np.diff(off_k[: BATCH + 1]).astype(np.int32)
    k_pad = -(-int(ks.max()) // 128) * 128
    s_max = -(-(int(ks.max()) + 1) // 128) * 128
    kmer_idx = np.full((BATCH, k_pad), PAD_ROW, np.int32)
    mask = np.arange(k_pad)[None, :] < ks[:, None]
    kmer_idx[mask] = flat_k[: off_k[BATCH]]
    return kmer_idx, ks, k_pad, s_max, flat_k, off_k


def fold_compare(state, queries, with_plain: bool) -> dict:
    """K2 against K1 on the same batch (bit for bit) and, with
    ``with_plain``, against its plain version; both kernels' times. The
    pair budget is lifted here so K2 runs at any pair count: the numbers are
    what a later choice of the sparse/dense crossover needs."""
    from raxtax_tpu_torch.engine.device import (
        SPARSE_BUDGET_MIN,
        SPARSE_CROSSOVER_DIV,
    )
    from raxtax_tpu_torch.ops import intersect_fold as fo

    dev = state.device
    kmer_idx, ks, k_pad, _, _, _ = batch_inputs(queries)
    km3 = state.kmer_major3
    S = int(km3.shape[1])
    pair_kmer, pair_blk, max_pairs, totals = fo.build_pairs(
        kmer_idx, state.blk_ptr, state.blk_ids, budget=1 << 40
    )
    d_idx = torch.from_numpy(kmer_idx).to(dev)
    d_ks = torch.from_numpy(ks).to(dev)
    d_pk = torch.from_numpy(pair_kmer).to(dev)
    d_pb = torch.from_numpy(pair_blk).to(dev)
    d_tot = torch.from_numpy(totals.astype(np.int32)).to(dev)
    sparse = fo.fold_planes_sparse(d_pk, d_pb, d_tot, km3, max_count=k_pad)
    dense = fo.fold_planes(d_idx, d_ks, km3, max_count=k_pad)
    torch.cuda.synchronize()
    if not bits_equal(sparse, dense):
        raise AssertionError("fold_planes_sparse differs from fold_planes")
    P = int(sparse.shape[1])
    plain_ms = err = None
    if with_plain:
        t0 = time.time()
        plain = fo.fold_planes_sparse_plain(d_pk, d_pb, d_tot, km3, P)
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        if not bits_equal(sparse, plain):
            raise AssertionError(
                "fold_planes_sparse differs from its plain version"
            )
        err = max_abs_err(sparse, plain)
        del plain
    del dense
    k2_ms = cuda_ms(lambda: fo.fold_planes_sparse(
        d_pk, d_pb, d_tot, km3, max_count=k_pad))
    k1_ms = cuda_ms(lambda: fo.fold_planes(d_idx, d_ks, km3, max_count=k_pad))
    W = S * 128
    n_pairs = int(totals.sum())
    # a 4 KB sub-row that several queries of the batch fold has to leave
    # memory once: the bound counts the distinct (k-mer, block) pairs
    valid = np.arange(pair_kmer.shape[1])[None, :] < totals[:, None]
    uniq_pairs = int(np.unique(
        pair_kmer[valid].astype(np.int64) * (S // fo.BLOCK_SUB) + pair_blk[valid]
    ).size)
    out_bytes = BATCH * P * W * 4
    in_small = 2 * pair_kmer.nbytes + totals.size * 4
    t_bytes = (
        uniq_pairs * fo.BLOCK_WORDS * 4 + out_bytes + in_small
    ) / PEAK_BYTES_PER_S
    t_ops = n_pairs * fo.BLOCK_WORDS * 2 * P / PEAK_INT32_OPS
    return {
        "sparse_ms": k2_ms, "dense_ms": k1_ms, "plain_ms": plain_ms,
        "max_abs_err": err, "bits_equal_dense": True,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        # every (query, pair) sub-row streamed from memory, no reuse between
        # queries: what the kernel's access pattern asks of the card
        "stream_bound_ms": (n_pairs * fo.BLOCK_WORDS * 4 + out_bytes + in_small)
        / PEAK_BYTES_PER_S * 1e3,
        "pairs": n_pairs, "unique_pairs": uniq_pairs,
        "pairs_per_query_mean": n_pairs / BATCH, "pairs_per_query_max": max_pairs,
        "pair_budget": max(SPARSE_BUDGET_MIN, k_pad * S // SPARSE_CROSSOVER_DIV),
        "shape": {"B": BATCH, "k_pad": k_pad, "W": W, "P": P,
                  "blocks": S // fo.BLOCK_SUB, "p_pad": int(pair_kmer.shape[1])},
    }


def host_table(hist: torch.Tensor, ks: np.ndarray, s_max: int) -> np.ndarray:
    """The host model's ``[B, s_max]`` f64 probability table of a batch,
    from its intersection-size histograms."""
    from raxtax_tpu_torch.prob.model import KTableCache, normalized_size_probs

    hist_h = hist.cpu().numpy()
    cache = KTableCache()
    table64 = np.zeros((hist_h.shape[0], s_max), np.float64)
    for b in range(hist_h.shape[0]):
        ps, _ = normalized_size_probs(hist_h[b], int(ks[b]), cache)
        table64[b, : ps.shape[0]] = ps
    return table64


def batch_probs32(db, queries, state) -> torch.Tensor:
    """``[B, 32, S, 128]`` f32 bit-major tip probabilities of one batch on
    ``state``'s database: what the double-f32 path hands its scan."""
    from raxtax_tpu_torch.ops import intersect_fold, planes as pl

    kmer_idx, ks, k_pad, s_max, _, _ = batch_inputs(queries)
    d_idx = torch.from_numpy(kmer_idx).to(state.device)
    d_ks = torch.from_numpy(ks).to(state.device)
    planes = intersect_fold.fold_planes(
        d_idx, d_ks, state.kmer_major3, max_count=k_pad)
    hist = pl.planes_histogram(planes, s_max, db.num_tips)
    d_tab = torch.from_numpy(host_table(hist, ks, s_max)).to(state.device)
    return pl.planes_probs(planes, d_tab.float())


def scan_compare(name: str, probs32: torch.Tensor, packed: bool) -> dict:
    """K6 (``dd_cumsum``) or K7 (``dd_cumsum_bitmajor``) called as the engine
    calls it, on ``[B, 32, S, 128]`` f32 probabilities: the zero-prefixed
    ``[B, N + 1]`` pair against the plain version on the same tips (both
    words bit for bit, column 0 zero), ``hi + lo`` of four rows against
    ``np.cumsum`` in f64, the call's time and its bound. ``packed`` says
    which tip order the bit-major array holds."""
    from raxtax_tpu_torch.ops import planes as pl

    B = int(probs32.shape[0])
    if name == "dd_cumsum":
        # the engine scans tip-order probabilities: a reshape of the flat
        # layout, a permute of the packed one
        flat = (pl.probs_to_tip_order(probs32).contiguous() if packed
                else probs32.reshape(B, -1))
        tile_rows = pl.DD_TILE_ROWS
        replaces = "raxtax_tpu/ops/planes.py:346"

        def fn():
            return pl.dd_cumsum(flat)
    else:
        flat = pl.probs_to_tip_order(probs32).contiguous()
        tile_rows = pl.DD_TILE_ROWS_BITMAJOR
        replaces = "raxtax_tpu/ops/planes.py:400"

        def fn():
            return pl.dd_cumsum_bitmajor(probs32)
    N = int(flat.shape[1])
    hi, lo = fn()
    torch.cuda.synchronize()
    if hi.shape != (B, N + 1) or lo.shape != (B, N + 1):
        raise AssertionError(f"{name}: output is not [B, N + 1]")
    if bool(hi[:, 0].any()) or bool(lo[:, 0].any()):
        raise AssertionError(f"{name}: column 0 is not zero")
    t0 = time.time()
    p_hi, p_lo = pl.dd_cumsum_plain(flat, tile_rows)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    if not (bits_equal(hi[:, 1:], p_hi) and bits_equal(lo[:, 1:], p_lo)):
        raise AssertionError(f"{name} differs from its plain version")
    err = max(max_abs_err(hi[:, 1:], p_hi), max_abs_err(lo[:, 1:], p_lo))
    del p_hi, p_lo
    rows = [0, 1, B // 2, B - 1]
    host_p = flat[rows].cpu().numpy().astype(np.float64)
    host_c = hi[rows, 1:].cpu().numpy().astype(np.float64) \
        + lo[rows, 1:].cpu().numpy().astype(np.float64)
    f64_err = float(np.abs(host_c - np.cumsum(host_p, axis=1)).max())
    if f64_err > 1e-9:
        raise AssertionError(f"{name}: hi + lo is {f64_err} off np.cumsum")
    del hi, lo
    flat64 = flat.double()
    lib_ms = cuda_ms(lambda: torch.cumsum(flat64, dim=1))
    del flat64
    ms = cuda_ms(fn)
    # 4 bytes read and 8 written per tip, and the zero column; one
    # compensated add is 8 f32 operations: 7 lane steps plus the offset and
    # the carry per tip
    t_bytes = (B * N * 12 + B * 8) / PEAK_BYTES_PER_S
    t_ops = B * N * 9 * 8 / PEAK_F32_ADDS
    n_rows = N // 128
    return {
        "name": name, "route": "cuda",
        "source": "raxtax_tpu_torch/csrc/dd_cumsum.cu",
        "replaces": replaces,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib_ms,
        "library": "torch.cumsum in f64 (another add order: a yardstick, "
                   "not a substitute)",
        "f64_max_abs_err_vs_np_cumsum": f64_err,
        "np_cumsum_rows_checked": len(rows),
        "shape": {"B": B, "N": N, "tile_rows": tile_rows,
                  "tiles": -(-n_rows // min(n_rows, tile_rows)),
                  "out": [B, N + 1]},
    }


def phase_path_65k_dd(db, queries):
    """The double-f32 path with the sparse fold at 65,536 references:
    ``(the phase's line, K7's comparison at the packed shape)``."""
    from raxtax_tpu_torch.db.database import ensure_kmer_layout
    from raxtax_tpu_torch.engine.classify import make_classifier

    n_batches = -(-len(queries) // BATCH)
    a = args_for(dd=True)
    clf = make_classifier(db, a, n_queries_hint=len(queries))
    reset_counts()
    outs, tsvs, dt = run_path(db, queries, a, classifier=clf)
    counts = read_counts()
    if set(outs) != {l for l, _ in queries}:
        raise AssertionError("path_65k_dd: not every query has output lines")
    checked = check_oracle(db, queries, outs, tsvs, 16)
    if not clf._sparse:
        raise AssertionError("path_65k_dd: the sparse fold flipped to dense")
    for k in DD_PATH + ("fold_planes_sparse",):
        if counts[k] < n_batches:
            raise AssertionError(
                f"path_65k_dd: {k} launched {counts[k]} times in "
                f"{n_batches} batches"
            )
    folds = fold_compare(clf.state, queries, with_plain=True)
    line = {
        "phase": "path_65k_dd", "refs": db.num_tips, "queries": len(queries),
        "batch": BATCH, "pass_s": round(dt, 3),
        "queries_per_s": round(len(queries) / dt, 2),
        "oracle_checked": checked, "launches": counts,
        "host_replays": clf.host_replays, "mux_dense": clf._mux_dense,
        "pairs_per_query_mean": clf.pair_stats[0] / max(clf.pair_stats[1], 1),
        "pairs_per_query_max": clf.pair_stats[2],
        "fold_same_batch": folds,
    }
    del clf
    line["flag_combos"] = flag_combos(db, queries, dd=True)

    # the bit-major scan (K7) reads the packed layout: one short run
    import copy

    packed = ensure_kmer_layout(copy.copy(db), "packed")
    short = queries[: 2 * BATCH]
    a = args_for(dd=True, bm_scan=True)
    clf = make_classifier(packed, a, n_queries_hint=len(short))
    reset_counts()
    outs, tsvs, _ = run_path(packed, short, a, classifier=clf)
    counts = read_counts()
    check_oracle(packed, short, outs, tsvs, 8)
    if counts["dd_cumsum_bitmajor"] < 2 or counts["dd_cumsum"] != 0:
        raise AssertionError(f"path_65k_dd bm_scan: launches {counts}")
    line["bm_scan"] = {"queries": len(short), "checked": 8, "launches": counts}
    # K7 against its plain version at the shape this run gave it
    k7 = scan_compare(
        "dd_cumsum_bitmajor", batch_probs32(packed, short, clf.state), packed=True
    )
    del packed, clf

    # "auto": starts on the double-f32 path; flips only under dense replays
    a = args_for(dd=True, significance="auto")
    clf = make_classifier(db, a, n_queries_hint=len(short))
    reset_counts()
    outs, tsvs, _ = run_path(db, short, a, classifier=clf)
    counts = read_counts()
    check_oracle(db, short, outs, tsvs, 8)
    if counts["dd_cumsum"] + counts["exact_cumsum"] < 2:
        raise AssertionError(f"path_65k_dd auto: launches {counts}")
    line["auto"] = {
        "queries": len(short), "checked": 8, "launches": counts,
        "flipped_to_exact": bool(clf._exact_mode),
        "host_replays": clf.host_replays,
    }
    del clf
    torch.cuda.empty_cache()
    return line, k7


def phase_kernels(db, queries, state) -> list[dict]:
    """Each kernel at the large database's shapes, B = 256, against its
    plain version on the same inputs (tolerance 0: integers and f32 / f64
    bit patterns), with times and bounds. ``state`` carries the block CSR of
    the sparse fold."""
    from raxtax_tpu_torch.ops import exactscan, intersect_fold, planes as pl
    dev = state.device
    kmer_idx, ks, k_pad, s_max, flat_k, off_k = batch_inputs(queries)
    d_idx = torch.from_numpy(kmer_idx).to(dev)
    d_ks = torch.from_numpy(ks).to(dev)
    km3 = state.kmer_major3
    W = int(km3.shape[1] * km3.shape[2])
    n_tips = db.num_tips
    out = []

    # K1 ------------------------------------------------------------------
    planes = intersect_fold.fold_planes(d_idx, d_ks, km3, max_count=k_pad)
    torch.cuda.synchronize()
    P = int(planes.shape[1])
    t0 = time.time()
    plain = intersect_fold.fold_planes_plain(d_idx, d_ks, km3, P - 4)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    if not bits_equal(planes, plain):
        raise AssertionError("fold_planes differs from its plain version")
    err = max_abs_err(planes, plain)
    del plain
    ms = cuda_ms(lambda: intersect_fold.fold_planes(
        d_idx, d_ks, km3, max_count=k_pad))
    uniq_rows = int(np.unique(flat_k[: off_k[BATCH]]).size)
    total_rows = int(ks.sum())
    out_bytes = BATCH * P * W * 4
    bytes_once = uniq_rows * W * 4 + kmer_idx.nbytes + ks.nbytes + out_bytes
    t_bytes = bytes_once / PEAK_BYTES_PER_S
    t_ops = total_rows * W * 6 / PEAK_INT32_OPS
    out.append({
        "name": "fold_planes", "route": "cuda",
        "source": "raxtax_tpu_torch/csrc/fold_planes.cu",
        "replaces": "raxtax_tpu/ops/intersect_pallas.py:144",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "shape": {"B": BATCH, "k_pad": k_pad, "W": W, "P": P},
        "rows_folded": total_rows, "unique_rows": uniq_rows,
        # every (query, k-mer) row streamed from memory, no reuse between
        # queries: what the kernel's access pattern asks of the card
        "stream_bound_ms": (total_rows * W * 4 + out_bytes)
        / PEAK_BYTES_PER_S * 1e3,
    })

    # K3 ------------------------------------------------------------------
    hist = pl.planes_histogram(planes, s_max, n_tips)
    torch.cuda.synchronize()
    t0 = time.time()
    plain = torch.cat([
        pl.planes_histogram_plain(planes[i : i + 32], s_max, n_tips)
        for i in range(0, BATCH, 32)
    ])
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    if not bits_equal(hist, plain):
        raise AssertionError("planes_histogram differs from its plain version")
    if not bool((hist.sum(dim=1) == n_tips).all()):
        raise AssertionError("planes_histogram: mass is not num_tips")
    err = max_abs_err(hist, plain)
    ms = cuda_ms(lambda: pl.planes_histogram(planes, s_max, n_tips))
    t_bytes = (BATCH * P * W * 4 + BATCH * s_max * 4) / PEAK_BYTES_PER_S
    t_ops = BATCH * W * 32 * (3 * P + 1) / PEAK_INT32_OPS
    out.append({
        "name": "planes_hist", "route": "cuda",
        "source": "raxtax_tpu_torch/csrc/planes_hist.cu",
        "replaces": "raxtax_tpu/ops/planes.py:74",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "shape": {"B": BATCH, "P": P, "W": W, "s_max": s_max},
    })

    # K4 ------------------------------------------------------------------
    table64 = host_table(hist, ks, s_max)
    d_tab = torch.from_numpy(table64).to(dev)
    probs = pl.planes_probs(planes, d_tab)
    torch.cuda.synchronize()
    t0 = time.time()
    eq, err = True, 0.0
    for i in range(0, BATCH, 16):
        ref = pl.planes_probs_plain(planes[i : i + 16], d_tab[i : i + 16])
        eq = eq and bits_equal(probs[i : i + 16], ref)
        err = max(err, max_abs_err(probs[i : i + 16], ref))
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    if not eq:
        raise AssertionError("planes_probs differs from its plain version")
    # the float / narrow-mux / zero_high variants, at a few queries
    tab32 = d_tab[:8].float()
    for mux, zh in ((None, False), (4, False), (4, True), (P - 1, True)):
        a = pl.planes_probs(planes[:8], tab32, mux_bits=mux, zero_high=zh)
        b_ = pl.planes_probs_plain(planes[:8], tab32, mux_bits=mux, zero_high=zh)
        if not bits_equal(a, b_):
            raise AssertionError(f"planes_probs f32 mux={mux} zero_high={zh}")
    ms = cuda_ms(lambda: pl.planes_probs(planes, d_tab))
    t_bytes = (BATCH * P * W * 4 + BATCH * s_max * 8 + BATCH * 32 * W * 8) \
        / PEAK_BYTES_PER_S
    t_ops = BATCH * W * 32 * (3 * P + 2) / PEAK_INT32_OPS
    out.append({
        "name": "planes_probs", "route": "cuda",
        "source": "raxtax_tpu_torch/csrc/planes_probs.cu",
        "replaces": "raxtax_tpu/ops/planes.py:161",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "shape": {"B": BATCH, "P": P, "W": W, "s_max": s_max, "dtype": "f64"},
    })

    # K5 ------------------------------------------------------------------
    p = probs.reshape(BATCH, -1)
    N = int(p.shape[1])
    cum = exactscan.exact_cumsum(p)
    torch.cuda.synchronize()
    t0 = time.time()
    plain = exactscan.exact_cumsum_plain(p)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    if not bits_equal(cum, plain):
        raise AssertionError("exact_cumsum differs from its plain version")
    err = max_abs_err(cum, plain)
    del plain
    rows = [0, 1, BATCH // 2, BATCH - 1]
    host_p = p[rows].cpu().numpy()
    host_c = cum[rows].cpu().numpy()
    for r in range(len(rows)):
        want = np.concatenate(([0.0], np.cumsum(host_p[r])))
        if not np.array_equal(want.view(np.uint64), host_c[r].view(np.uint64)):
            raise AssertionError("exact_cumsum differs from np.cumsum")
    ms = cuda_ms(lambda: exactscan.exact_cumsum(p))
    lib_ms = cuda_ms(lambda: torch.cumsum(p, dim=1))
    lib = torch.cumsum(p, dim=1)
    lib_same = bits_equal(lib, cum[:, 1:].contiguous())
    del lib
    t_bytes = (BATCH * N * 8 + BATCH * (N + 1) * 8) / PEAK_BYTES_PER_S
    t_ops = BATCH * N / PEAK_F64_ADDS
    out.append({
        "name": "exact_cumsum", "route": "cuda",
        "source": "raxtax_tpu_torch/csrc/exact_cumsum.cu",
        "replaces": "raxtax_tpu/ops/exactscan.py:46",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib_ms,
        "library": "torch.cumsum (a parallel scan: a yardstick, not a "
                   "substitute)",
        "library_bits_equal": lib_same,
        "np_cumsum_rows_checked": len(rows),
        "shape": {"B": BATCH, "N": N},
        "chain_adds": N, "ns_per_chain_step": ms * 1e6 / N,
    })
    # K2 ------------------------------------------------------------------
    f = fold_compare(state, queries, with_plain=True)
    out.append({
        "name": "fold_planes_sparse", "route": "cuda",
        "source": "raxtax_tpu_torch/csrc/fold_sparse.cu",
        "replaces": "raxtax_tpu/ops/intersect_pallas.py:258",
        "max_abs_err": f["max_abs_err"], "ms": f["sparse_ms"],
        "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
        "bound_by": f["bound_by"], "library_ms": None,
        "stream_bound_ms": f["stream_bound_ms"], "pairs": f["pairs"],
        "unique_pairs": f["unique_pairs"],
        "shape": f["shape"], "bits_equal_fold_planes": True,
        "fold_planes_ms_same_batch": f["dense_ms"],
        "pairs_per_query_mean": f["pairs_per_query_mean"],
        "pairs_per_query_max": f["pairs_per_query_max"],
        "pair_budget": f["pair_budget"],
    })

    # K8 ------------------------------------------------------------------
    del cum
    high = pl.planes_high_counts(planes)
    torch.cuda.synchronize()
    t0 = time.time()
    eq, err = True, 0.0
    for i in range(0, BATCH, 32):
        ref = pl.planes_high_counts_plain(planes[i : i + 32])
        eq = eq and bits_equal(high[i : i + 32], ref)
        err = max(err, max_abs_err(high[i : i + 32], ref))
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    if not eq:
        raise AssertionError("planes_high_counts differs from its plain version")
    n_high_tips = int((high > 0).sum().item())
    del high, ref
    ms = cuda_ms(lambda: pl.planes_high_counts(planes))
    t_bytes = (BATCH * P * W * 4 + BATCH * 32 * W * 4) / PEAK_BYTES_PER_S
    t_ops = BATCH * W * (P + 32) / PEAK_INT32_OPS
    out.append({
        "name": "planes_high", "route": "cuda",
        "source": "raxtax_tpu_torch/csrc/planes_high.cu",
        "replaces": "raxtax_tpu/ops/planes.py:503",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "shape": {"B": BATCH, "P": P, "W": W},
        "tips_over_15_per_query": n_high_tips / BATCH,
    })

    # K6, K7 ----------------------------------------------------------------
    del p, probs
    probs32 = pl.planes_probs(planes, d_tab.float())  # [B, 32, S, 128] f32
    del planes
    out.append(scan_compare("dd_cumsum", probs32, packed=False))
    # the bit-major scan is launched only on a packed database (the
    # 65,536-reference run holds it there); this is its time at this size
    out.append(scan_compare("dd_cumsum_bitmajor", probs32, packed=True))
    return out


def timed_pass(db, queries, a, clf, phase: str):
    """One warm-up batch, then a timed pass of ``queries`` through
    ``run_queries`` with the launch counts and phase clocks read around it:
    ``(outs, tsvs, seconds, launches, phase ms per batch)``."""
    clf.classify_batch(queries[:BATCH])  # warm-up batch: allocator, tables
    torch.cuda.synchronize()
    for k in clf.phase_seconds:
        clf.phase_seconds[k] = 0.0
    reset_counts()
    outs, tsvs, dt = run_path(db, queries, a, classifier=clf)
    torch.cuda.synchronize()
    counts = read_counts()
    if set(outs) != {l for l, _ in queries}:
        raise AssertionError(f"{phase}: not every query has output lines")
    n_batches = -(-len(queries) // clf.batch_size)
    phase_ms = {
        k: round(v * 1e3 / n_batches, 2) for k, v in clf.phase_seconds.items()
    }
    return outs, tsvs, dt, counts, phase_ms


def phase_path_large(per_ref_s: float):
    from raxtax_tpu_torch.engine.classify import make_classifier

    # DB build + both classify passes + kernels phase (plain versions
    # included) + oracle: keep what is left of the budget for all of them
    n_refs = 200_000
    for cand in (1_000_000, 500_000):
        est = 3.0 * per_ref_s * cand + 210.0 + 2.5e-4 * cand
        if est < remaining():
            n_refs = cand
            break
    note(f"large phase: {n_refs} references ({remaining():.0f}s of budget left)")
    db, queries, build_s = build_world(n_refs)
    note(f"{n_refs} world built in {build_s:.1f}s")

    # -- the exact-f64 path, dense fold: half the queries --------------------
    torch.cuda.reset_peak_memory_stats()
    a = args_for()
    t0 = time.time()
    clf = make_classifier(db, a, n_queries_hint=len(queries))
    torch.cuda.synchronize()
    upload_s = time.time() - t0
    half = queries[: len(queries) // 2]
    outs, tsvs, dt, exact_counts, phase_ms = timed_pass(db, half, a, clf, "path_1m")
    for k in EXACT_PATH:
        if exact_counts[k] <= 0:
            raise AssertionError(f"path_1m never launched {k}")
    checked = check_oracle(db, half, outs, tsvs, 5)
    p1m = {
        "phase": "path_1m", "refs": n_refs, "queries": len(half),
        "batch": clf.batch_size, "db_build_s": round(build_s, 2),
        "upload_s": round(upload_s, 2), "pass_s": round(dt, 3),
        "queries_per_s": round(len(half) / dt, 2),
        "phase_ms_per_batch": phase_ms, "oracle_checked": checked,
        "peak_gpu_bytes": int(torch.cuda.max_memory_allocated()),
        "launches": exact_counts,
    }
    del clf
    torch.cuda.empty_cache()
    note("exact path driven; uploading the block-padded matrix")

    # -- the double-f32 path, sparse fold: all queries -----------------------
    a = args_for(dd=True)
    t0 = time.time()
    clf = make_classifier(db, a, n_queries_hint=len(queries))
    torch.cuda.synchronize()
    upload_dd_s = time.time() - t0
    kernels = phase_kernels(db, queries, clf.state)
    torch.cuda.empty_cache()
    note("kernels compared; driving the double-f32 path")
    torch.cuda.reset_peak_memory_stats()
    outs, tsvs, dt, dd_counts, phase_ms = timed_pass(db, queries, a, clf, "path_1m_dd")
    n_batches = -(-len(queries) // clf.batch_size)
    flipped = not clf._sparse
    for k in DD_PATH:
        if dd_counts[k] < n_batches:
            raise AssertionError(f"path_1m_dd launched {k} {dd_counts[k]} times")
    if dd_counts["fold_planes_sparse"] + dd_counts["fold_planes"] < n_batches or (
        dd_counts["fold_planes_sparse"] <= 0 and not flipped
    ):
        raise AssertionError(f"path_1m_dd: fold launches {dd_counts}")
    checked = check_oracle(db, queries, outs, tsvs, 5)
    k2 = next(k for k in kernels if k["name"] == "fold_planes_sparse")
    p1m_dd = {
        "phase": "path_1m_dd", "refs": n_refs, "queries": len(queries),
        "batch": clf.batch_size, "upload_s": round(upload_dd_s, 2),
        "pass_s": round(dt, 3), "queries_per_s": round(len(queries) / dt, 2),
        "phase_ms_per_batch": phase_ms, "oracle_checked": checked,
        "peak_gpu_bytes": int(torch.cuda.max_memory_allocated()),
        "launches": dd_counts, "host_replays": clf.host_replays,
        "mux_dense": clf._mux_dense, "fold_flipped_to_dense": flipped,
        # pairs the timed pass folded itself: 0 once the fold has flipped
        "pairs_folded_on_path": clf.pair_stats[0],
        # of the kernels phase's batch (the first 256 queries, pair budget
        # lifted), not of the timed pass
        "pairs_per_query_mean_first_batch": k2["pairs_per_query_mean"],
        "pairs_per_query_max_first_batch": k2["pairs_per_query_max"],
        "pair_budget": k2["pair_budget"],
    }
    return kernels, p1m, p1m_dd


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    env = phase_env()
    say(env)
    db, queries, build_s = build_world(65536)
    note(f"65k world built in {build_s:.1f}s")
    p65 = phase_path_65k(db, queries, build_s)
    per_ref_s = p65.pop("build_s_per_ref")
    say(p65)
    p65_dd, k7_on_path = phase_path_65k_dd(db, queries)
    say(p65_dd)
    del db
    kernels, p1m, p1m_dd = phase_path_large(per_ref_s)
    say(p1m)
    say(p1m_dd)
    # launches: from the main path that runs the kernel — the exact path at
    # full size, the double-f32 path at full size, and for what only a
    # 65,536-reference run launches (the bit-major scan; the sparse fold when
    # the full-size run flipped to dense on its pair budget) that run
    sources = (
        ("path_1m", p1m["launches"], EXACT_PATH),
        ("path_1m_dd", p1m_dd["launches"],
         ("planes_high", "dd_cumsum", "fold_planes_sparse")),
        ("path_65k_dd", p65_dd["launches"], ("fold_planes_sparse",)),
        ("path_65k_dd bm_scan", p65_dd["bm_scan"]["launches"],
         ("dd_cumsum_bitmajor",)),
    )
    # K7's entry is the comparison at the packed 65,536-reference shape, the
    # one its path launches; its numbers at the large size ride along
    i7 = next(i for i, k in enumerate(kernels) if k["name"] == "dd_cumsum_bitmajor")
    k7_on_path["at_large_size"] = {
        k: kernels[i7][k] for k in
        ("ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err", "shape")
    }
    kernels[i7] = k7_on_path
    for k in kernels:
        for phase, counts, names in sources:
            if k["name"] in names and counts[k["name"]] > 0:
                k["launches"], k["launches_in"] = counts[k["name"]], phase
                break
        else:
            raise AssertionError(f"no main path launched {k['name']}")
    say({"kernels": kernels})
    print(env["gpu"], flush=True)
    say({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())
