#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``raxtax_tpu_torch``).

Run ``python3 chip_smoke.py`` from the repository root on a machine with one
NVIDIA Hopper GPU, the CUDA toolkit (``nvcc``) and PyTorch built for CUDA.
It needs no arguments, no network and no JAX. It

1. builds the eleven CUDA sources (thirteen kernels) from
   ``raxtax_tpu_torch/csrc`` (``env``),
2. drives the exact-f64 classify path end to end on a 65,536-reference
   synthetic database through ``run_queries`` and checks the output files
   against the host oracle, for every flag combination (``path_65k``),
3. drives the double-f32 path with the sparse fold on the same database the
   same way, plus one short run each with the bit-major scan and with
   ``significance="auto"`` (``path_65k_dd``),
4. drives the other ways to make the counts on that database, each against
   the oracle and through every flag combination: the stream fold
   (``path_65k_stream``), the gathered-rows fold (``path_65k_gathered``) and
   the dense count matrix of the ``xla`` backend, once more with its
   single-tip split (``path_65k_xla``),
5. builds the 1,000,000-reference database (or the largest of 1M / 500k /
   200k that fits the time budget) and drives the exact path at that size
   against the oracle (``path_1m``), then the same path with the stream fold
   (``path_1m_stream``) and, for two batches, with the gathered fold
   (``path_1m_gathered``),
6. runs each kernel at that size against its plain PyTorch version, bit for
   bit — the gathered and the stream fold also against the dense fold — and
   times both (``kernels``),
7. drives the double-f32 path at that size, checks it against the oracle and
   reports throughput, phase times, peak memory, pairs per query, host
   replays and whether the fold flipped to dense (``path_1m_dd``),
8. drives the dense-count backend at that size for two batches, where its
   scan takes the pairwise tree (``path_1m_xla``),
9. runs the software-f64 probes through ``tools/probe_f64.py``: K11 on
   about 16.7M adversarial pairs against its plain version and against the
   card's own f64 add and subtract, K12 at 256 queries over 65,536 and
   1,048,576 tips against K5 on the same values (``probe_f64``),
10. times K13's seven operation chains at 5,000,000 steps after holding their
    bits against the plain version (``probe_ops``),
11. fuzzes the engine against the oracle through ``tools/fuzz_hardware.py``
    for about a minute, at least 24 trials (``fuzz``),
12. sweeps whole CLI runs through ``tools/runtime_memory.py`` on a synthetic
    FASTA from ``tools/make_synth_fasta.py``, one rep at 50,000 records and
    one at the largest of 1M / 500k / 200k the budget allows: runtime, peak
    host RSS, steady queries/s, exit code (``runtime_memory``).

Each phase prints one JSON line; the ``kernels`` line carries, per kernel,
its launches on the main path that runs it, its time, its plain version's
time and its bound on this card. Any failed phase raises, so the exit code is non-zero
and the final ``{"ok": true, ...}`` line is not printed. There is no CPU
path: without a GPU the script exits at once with code 1.
"""

from __future__ import annotations

import json
import os
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
from raxtax_tpu_torch.tools.kernel_batch import (  # noqa: E402
    PEAK_BYTES_PER_S,
    PEAK_F32_ADDS,
    PEAK_F64_ADDS,
    PEAK_INT32_OPS,
    batch_inputs,
)

N_QUERIES = 2048
BATCH = 256


def say(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def note(msg: str) -> None:
    print(f"[{time.time() - T_START:7.1f}s] {msg}", file=sys.stderr, flush=True)


def remaining() -> float:
    return BUDGET_S - (time.time() - T_START)


def build_world(n_refs: int):
    """The synthetic world with both bit matrices: the folds read the
    k-mer-major one, the dense-count backend the ref-major one."""
    from raxtax_tpu_torch.tools.synth import build_world as build

    return build(n_refs, N_QUERIES, with_ref_major=True)


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
             significance: str | None = None, bm_scan: bool = False,
             backend: str = "auto", fold: str | None = None,
             split_sig: bool = False):
    """The parsed command line of ``raxtax-torch --tsv --batch-size 256
    --debug-checks`` (output prefix and database path are set per run).
    ``dd`` is what ``RAXTAX_EXACT=0 RAXTAX_SPARSE_FOLD=1`` select, ``fold``
    what ``RAXTAX_FUSED_GATHER=0`` or ``--backend stream`` select,
    ``backend="xla"`` the dense-count backend."""
    return SimpleNamespace(
        backend=backend, device="cuda", batch_size=BATCH, debug_checks=True,
        tsv=True, skip_exact_matches=skip, raw_confidence=raw, redo=True,
        significance=significance or ("dd" if dd else "exact"),
        fold=fold or ("sparse" if dd else "dense"), bm_scan=bm_scan,
        split_sig=split_sig,
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


#: the oracle's answers, kept per (database, query, flags): several paths
#: are held to the same queries
_ORACLE: dict = {}


def check_oracle(db, queries, outs, tsvs, n: int, skip=False, raw=False):
    from raxtax_tpu_torch.models.oracle import OracleClassifier

    orc = OracleClassifier(db, skip_exact_matches=skip, raw_confidence=raw)
    for label, seq in queries[:n]:
        key = (db.num_tips, label, seq.tobytes(), skip, raw)
        if key not in _ORACLE:
            want = orc.classify(label, seq)
            _ORACLE[key] = (want.out_string(), want.tsv_string())
        want_out, want_tsv = _ORACLE[key]
        if outs[label] != want_out:
            raise AssertionError(f"raxtax.out differs from the oracle: {label}")
        if tsvs and tsvs[label] != want_tsv:
            raise AssertionError(f"raxtax.tsv differs from the oracle: {label}")
    return n


def launch_counts():
    from raxtax_tpu_torch.ops.exactf64 import probe_f64_ew, probe_f64_scan
    from raxtax_tpu_torch.ops.exactscan import exact_cumsum
    from raxtax_tpu_torch.ops.intersect_fold import (
        fold_planes,
        fold_planes_gathered,
        fold_planes_sparse,
    )
    from raxtax_tpu_torch.ops.intersect_stream import fold_planes_stream
    from raxtax_tpu_torch.ops.opchain import probe_op_chain
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
        "fold_planes_gathered": fold_planes_gathered,
        "fold_planes_stream": fold_planes_stream,
        "probe_f64_ew": probe_f64_ew, "probe_f64_scan": probe_f64_scan,
        "probe_op_chain": probe_op_chain,
    }


#: the kernels each mode's main path runs
EXACT_PATH = ("fold_planes", "planes_hist", "planes_probs", "exact_cumsum")
DD_PATH = ("planes_hist", "planes_probs", "planes_high", "dd_cumsum")
AFTER_FOLD = EXACT_PATH[1:]
#: every kernel that folds postings or reads counter planes: the dense-count
#: backend launches none of them
PLANES_KERNELS = (
    "fold_planes", "fold_planes_sparse", "fold_planes_gathered",
    "fold_planes_stream", "planes_hist", "planes_probs", "planes_high",
    "exact_cumsum", "dd_cumsum_bitmajor",
)


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


def flag_combos(db, queries, **mode) -> list[dict]:
    """Every flag combination on one batch, in the engine mode ``mode``
    (arguments of :func:`args_for`); half of the compared queries are exact
    copies of references, so the exact-match policy is exercised."""
    from raxtax_tpu_torch.engine.classify import make_classifier

    combos = []
    for skip in (False, True):
        for raw in (False, True):
            batch = list(queries[:BATCH])
            for j in range(4):
                tip = (j * 7919) % db.num_tips
                batch[j] = (f"x{j}", np.array(db.sequence(tip)))
            a = args_for(skip=skip, raw=raw, **mode)
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
    combos = flag_combos(db, queries)
    return {
        "phase": "path_65k", "refs": 65536, "queries": len(queries),
        "batch": BATCH, "db_build_s": round(build_s, 2),
        "pass_s": round(dt, 3), "queries_per_s": round(len(queries) / dt, 2),
        "oracle_checked": checked, "flag_combos": combos, "launches": counts,
        "build_s_per_ref": build_s / 65536,
    }


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
    kmer_idx, ks, k_pad, _, _, _ = batch_inputs(queries, BATCH)
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


def batch_probs32(db, queries, state) -> torch.Tensor:
    """``[B, 32, S, 128]`` f32 bit-major tip probabilities of one batch on
    ``state``'s database: what the double-f32 path hands its scan."""
    from raxtax_tpu_torch.ops import intersect_fold, planes as pl
    from raxtax_tpu_torch.tools.profile_stages import host_tables

    kmer_idx, ks, k_pad, s_max, _, _ = batch_inputs(queries, BATCH)
    d_idx = torch.from_numpy(kmer_idx).to(state.device)
    d_ks = torch.from_numpy(ks).to(state.device)
    planes = intersect_fold.fold_planes(
        d_idx, d_ks, state.kmer_major3, max_count=k_pad)
    hist = pl.planes_histogram(planes, s_max, db.num_tips)
    d_tab = torch.from_numpy(host_tables(hist, ks, s_max)).to(state.device)
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


def phase_path_65k_fold(db, queries, fold: str) -> dict:
    """The exact-f64 path with the stream or the gathered fold at 65,536
    references: all queries against the oracle, every flag combination, and
    the launch counts (the fold's kernel every batch, K1 never)."""
    kernel = {"stream": "fold_planes_stream", "gathered": "fold_planes_gathered"}[fold]
    phase = f"path_65k_{fold}"
    n_batches = -(-len(queries) // BATCH)
    reset_counts()
    outs, tsvs, dt = run_path(db, queries, args_for(fold=fold))
    counts = read_counts()
    if set(outs) != {l for l, _ in queries}:
        raise AssertionError(f"{phase}: not every query has output lines")
    checked = check_oracle(db, queries, outs, tsvs, 16)
    if counts[kernel] < n_batches or counts["fold_planes"] or counts["fold_planes_sparse"]:
        raise AssertionError(f"{phase}: fold launches {counts}")
    if min(counts[k] for k in AFTER_FOLD) < n_batches:
        raise AssertionError(f"{phase}: a kernel was never launched: {counts}")
    combos = flag_combos(db, queries, fold=fold)
    return {
        "phase": phase, "refs": db.num_tips, "queries": len(queries),
        "batch": BATCH, "pass_s": round(dt, 3),
        "queries_per_s": round(len(queries) / dt, 2),
        "oracle_checked": checked, "flag_combos": combos, "launches": counts,
    }


def check_dense_launches(phase: str, counts: dict, n_batches: int, scan: bool):
    """The dense-count backend builds no planes: none of their kernels may
    run, and its scan is K6 exactly when the tip count is a multiple of
    128."""
    ran = {k: counts[k] for k in PLANES_KERNELS if counts[k]}
    if ran:
        raise AssertionError(f"{phase}: planes kernels launched: {ran}")
    if scan and counts["dd_cumsum"] < n_batches:
        raise AssertionError(f"{phase}: dd_cumsum launched {counts['dd_cumsum']} times")
    if not scan and counts["dd_cumsum"]:
        raise AssertionError(f"{phase}: dd_cumsum launched on an unaligned width")


def phase_path_65k_xla(db, queries) -> dict:
    """The dense-count backend at 65,536 references (a multiple of 128, so
    its scan is K6): all queries, every flag combination, and a short run
    with the single-tip split."""
    from raxtax_tpu_torch.engine.classify import make_classifier

    n_batches = -(-len(queries) // BATCH)
    a = args_for(backend="xla")
    clf = make_classifier(db, a, n_queries_hint=len(queries))
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    outs, tsvs, dt = run_path(db, queries, a, classifier=clf)
    counts = read_counts()
    if set(outs) != {l for l, _ in queries}:
        raise AssertionError("path_65k_xla: not every query has output lines")
    checked = check_oracle(db, queries, outs, tsvs, 16)
    check_dense_launches("path_65k_xla", counts, n_batches, scan=True)
    line = {
        "phase": "path_65k_xla", "refs": db.num_tips, "queries": len(queries),
        "batch": BATCH, "pass_s": round(dt, 3),
        "queries_per_s": round(len(queries) / dt, 2),
        "oracle_checked": checked, "launches": counts,
        "host_replays": clf.host_replays, "nibble_wire": bool(clf._fb_dense),
        "peak_gpu_bytes": int(torch.cuda.max_memory_allocated()),
        "phase_ms_per_batch": {
            k: round(v * 1e3 / n_batches, 2) for k, v in clf.phase_seconds.items()
        },
    }
    del clf
    line["flag_combos"] = flag_combos(db, queries, backend="xla")
    short = queries[: 2 * BATCH]
    a = args_for(backend="xla", split_sig=True)
    clf = make_classifier(db, a, n_queries_hint=len(short))
    if clf.state.split_sig is None:
        raise AssertionError("path_65k_xla: split_sig did not reach the engine")
    reset_counts()
    outs, tsvs, _ = run_path(db, short, a, classifier=clf)
    counts = read_counts()
    check_oracle(db, short, outs, tsvs, 8)
    check_dense_launches("path_65k_xla split_sig", counts, 2, scan=True)
    line["split_sig"] = {"queries": len(short), "checked": 8, "launches": counts}
    del clf
    torch.cuda.empty_cache()
    return line


def fold_variants(state, queries, k1_planes, inputs) -> list[dict]:
    """K9 and K10 at the large database's shapes against their plain
    versions and against K1's planes of the same batch, bit for bit, with
    times and bounds; the gather and the pair sort are timed beside them."""
    from raxtax_tpu_torch.ops import intersect_fold as fo
    from raxtax_tpu_torch.ops import intersect_stream as st

    kmer_idx, ks, k_pad, flat_k, off_k = inputs
    dev = state.device
    km3 = state.kmer_major3
    S = int(km3.shape[1])
    W = S * 128
    P = int(k1_planes.shape[1])
    d_idx = torch.from_numpy(kmer_idx).to(dev)
    out = []

    # K9: one launch is one chunk of the batch under the gather budget ------
    b_sub = fo.gather_chunk(BATCH, k_pad, W * 4)
    n_chunks = -(-BATCH // b_sub)
    for lo in range(0, BATCH, b_sub):  # every chunk against K1's planes
        rows = km3.index_select(0, d_idx[lo : lo + b_sub].reshape(-1).long())
        got = fo.fold_planes_gathered(rows, rows.shape[0] // k_pad, P - 4)
        if not bits_equal(got, k1_planes[lo : lo + b_sub]):
            raise AssertionError("fold_planes_gathered differs from fold_planes")
        del got
    torch.cuda.synchronize()
    ids = d_idx[:b_sub].reshape(-1).long()
    rows = km3.index_select(0, ids)
    t0 = time.time()
    plain = fo.fold_planes_gathered_plain(rows, b_sub, P - 4)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    got = fo.fold_planes_gathered(rows, b_sub, P - 4)
    if not bits_equal(got, plain):
        raise AssertionError("fold_planes_gathered differs from its plain version")
    err = max_abs_err(got, plain)
    del plain, got
    ms = cuda_ms(lambda: fo.fold_planes_gathered(rows, b_sub, P - 4))
    del rows
    gather_ms = cuda_ms(lambda: km3.index_select(0, ids))
    batch_ms = cuda_ms(lambda: fo.intersection_planes_gathered(
        d_idx, km3, max_count=k_pad))
    launch_bytes = b_sub * k_pad * W * 4 + b_sub * P * W * 4
    t_bytes = launch_bytes / PEAK_BYTES_PER_S
    t_ops = b_sub * k_pad * W * 6 / PEAK_INT32_OPS
    out.append({
        "name": "fold_planes_gathered", "route": "cuda",
        "source": "raxtax_tpu_torch/csrc/fold_rows.cu",
        "replaces": "raxtax_tpu/ops/intersect_pallas.py:57",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "shape": {"rows": [b_sub * k_pad, S, 128], "queries": b_sub,
                  "k_pad": k_pad, "W": W, "P": P},
        "bits_equal_fold_planes": True,
        "launches_per_batch": n_chunks,
        "index_select_ms": gather_ms,  # beside the kernel, not inside it
        "batch_ms_gather_and_fold": batch_ms,
        "batch_bound_ms": n_chunks * max(t_bytes, t_ops) * 1e3,
        "gathered_bytes_per_launch": b_sub * k_pad * W * 4,
    })

    # K10 --------------------------------------------------------------------
    group = st.stream_group_size(BATCH, P)
    if st.n_planes_for(k_pad) != P:
        raise AssertionError("the stream fold sizes another plane count")
    pairs = st.build_pairs(d_idx, group)
    got = st.fold_planes_stream(*pairs, km3, BATCH, group, P)
    torch.cuda.synchronize()
    if not bits_equal(got, k1_planes):
        raise AssertionError("fold_planes_stream differs from fold_planes")
    t0 = time.time()
    plain = st.fold_planes_stream_plain(pairs[0], pairs[1], km3, BATCH, P)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    if not bits_equal(got, plain):
        raise AssertionError("fold_planes_stream differs from its plain version")
    err = max_abs_err(got, plain)
    del plain, got
    ms = cuda_ms(lambda: st.fold_planes_stream(*pairs, km3, BATCH, group, P))
    sort_ms = cuda_ms(lambda: st.build_pairs(d_idx, group))
    # the same batch with fewer and with more queries per CTA: the walk of a
    # group's pairs is serial, so the time grows with the group, while a
    # smaller group re-reads more rows from L2
    by_group = {}
    for g in sorted({1, 2, group, 2 * group, 4 * group}):
        alt = st.build_pairs(d_idx, g)
        if not bits_equal(st.fold_planes_stream(*alt, km3, BATCH, g, P), k1_planes):
            raise AssertionError(f"fold_planes_stream, groups of {g}: wrong planes")
        by_group[g] = cuda_ms(
            lambda: st.fold_planes_stream(*alt, km3, BATCH, g, P))
    uniq_rows = int(np.unique(flat_k[: off_k[BATCH]]).size)
    n_pairs = int(ks.sum())
    out_bytes = BATCH * P * W * 4
    small = 2 * pairs[0].numel() * 4 + 2 * pairs[2].numel() * 4
    t_bytes = (uniq_rows * W * 4 + out_bytes + small) / PEAK_BYTES_PER_S
    # a pair ripples only where its row word is set; the zero test alone is
    # one operation per word and pair
    t_ops = n_pairs * W / PEAK_INT32_OPS
    out.append({
        "name": "fold_planes_stream", "route": "cuda",
        "source": "raxtax_tpu_torch/csrc/fold_stream.cu",
        "replaces": "raxtax_tpu/ops/intersect_stream.py:38",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "shape": {"B": BATCH, "k_pad": k_pad, "W": W, "P": P,
                  "pairs": n_pairs, "group_size": group,
                  "ctas": [-(-W // st.TILE), -(-BATCH // group)]},
        "bits_equal_fold_planes": True,
        "unique_rows": uniq_rows,
        "build_pairs_ms": sort_ms,  # the sort beside the kernel
        "ms_by_group_size": by_group,
        "whole_matrix_bound_ms": (int(km3.shape[0]) * W * 4 + out_bytes)
        / PEAK_BYTES_PER_S * 1e3,
        "stream_bound_ms": (n_pairs * W * 4 + out_bytes) / PEAK_BYTES_PER_S * 1e3,
    })
    return out


def phase_kernels(db, queries, state) -> list[dict]:
    """Each kernel at the large database's shapes, B = 256, against its
    plain version on the same inputs (tolerance 0: integers and f32 / f64
    bit patterns), with times and bounds. ``state`` carries the block CSR of
    the sparse fold."""
    from raxtax_tpu_torch.ops import exactscan, intersect_fold, planes as pl
    from raxtax_tpu_torch.tools.kernel_batch import (
        dadd_latency,
        exact_cumsum_bounds,
        fold_planes_bounds,
    )
    from raxtax_tpu_torch.tools.profile_stages import host_tables

    dev = state.device
    kmer_idx, ks, k_pad, s_max, flat_k, off_k = batch_inputs(queries, BATCH)
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
    # bound_ms reads each unique row once; stream_bound_ms streams every
    # (query, k-mer) row, no reuse between queries
    fb = fold_planes_bounds(kmer_idx, ks, flat_k, off_k, W, P)
    out.append({
        "name": "fold_planes", "route": "cuda",
        "source": "raxtax_tpu_torch/csrc/fold_planes.cu",
        "replaces": "raxtax_tpu/ops/intersect_pallas.py:144",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": fb["bound_ms"], "bound_by": fb["bound_by"],
        "library_ms": None,
        "shape": {"B": BATCH, "k_pad": k_pad, "W": W, "P": P},
        "rows_folded": fb["rows_folded"], "unique_rows": fb["unique_rows"],
        "stream_bound_ms": fb["stream_bound_ms"],
    })
    # the achieved rate against both bounds: the share of the time that
    # reading each unique row once, or every row streamed, would take
    out[-1]["bound_share"] = out[-1]["bound_ms"] / ms
    out[-1]["stream_bound_share"] = out[-1]["stream_bound_ms"] / ms

    # K9, K10 (appended behind K8 so the first eight keep their order) -------
    variants = fold_variants(
        state, queries, planes, (kmer_idx, ks, k_pad, flat_k, off_k)
    )
    k1_again = cuda_ms(lambda: intersect_fold.fold_planes(
        d_idx, d_ks, km3, max_count=k_pad))
    for v in variants:
        v["fold_planes_ms_same_batch"] = k1_again

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
    table64 = host_tables(hist, ks, s_max)
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
    # ragged shapes: one chain alone, and 133 chains (a CTA with one chain
    # left over) over a tip count that wraps the tile ring and ends in a
    # partial tile
    rng = np.random.default_rng(5)
    ragged = [(1, 1), (BATCH // 2 + 5, 6 * 1024 + 7)]
    for b_, n_ in ragged:
        x = torch.from_numpy(rng.random((b_, n_)) * 1e-3).to(dev)
        if not bits_equal(exactscan.exact_cumsum(x),
                          exactscan.exact_cumsum_plain(x)):
            raise AssertionError(f"exact_cumsum differs at {b_} x {n_}")
    ms = cuda_ms(lambda: exactscan.exact_cumsum(p))
    lib_ms = cuda_ms(lambda: torch.cumsum(p, dim=1))
    lib = torch.cumsum(p, dim=1)
    lib_same = bits_equal(lib, cum[:, 1:].contiguous())
    del lib
    lat = dadd_latency(dev)
    out.append({
        "name": "exact_cumsum", "route": "cuda",
        "source": "raxtax_tpu_torch/csrc/exact_cumsum.cu",
        "replaces": "raxtax_tpu/ops/exactscan.py:46",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        **exact_cumsum_bounds(BATCH, N),
        "library_ms": lib_ms,
        "library": "torch.cumsum (a parallel scan: a yardstick, not a "
                   "substitute)",
        "library_bits_equal": lib_same,
        "np_cumsum_rows_checked": len(rows),
        "shape": {"B": BATCH, "N": N},
        "ragged_shapes_checked": ragged,
        "chain_adds": N, "ns_per_chain_step": ms * 1e6 / N,
        # the dependent adds one chain must make, one after the other, at
        # the latency this run measured: the floor of a kernel that keeps
        # the reference's order of adds
        **lat, "chain_floor_ms": N * lat["dadd_latency_ns"] * 1e-6,
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
    return out + variants


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
        est = 3.0 * per_ref_s * cand + 330.0 + 2.5e-4 * cand
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
    note("exact path driven; the same path with the stream fold")

    # -- this slice's path: the exact-f64 path on the stream fold, all queries
    a = args_for(fold="stream")
    clf = make_classifier(db, a, n_queries_hint=len(queries))
    torch.cuda.reset_peak_memory_stats()
    outs, tsvs, dt, counts, phase_ms = timed_pass(db, queries, a, clf, "path_1m_stream")
    n_batches = -(-len(queries) // clf.batch_size)
    if counts["fold_planes_stream"] != n_batches or counts["fold_planes"]:
        raise AssertionError(f"path_1m_stream: fold launches {counts}")
    for k in AFTER_FOLD:
        if counts[k] < n_batches:
            raise AssertionError(f"path_1m_stream launched {k} {counts[k]} times")
    checked = check_oracle(db, queries, outs, tsvs, 5)
    p1m_stream = {
        "phase": "path_1m_stream", "refs": n_refs, "queries": len(queries),
        "batch": clf.batch_size, "pass_s": round(dt, 3),
        "queries_per_s": round(len(queries) / dt, 2),
        "phase_ms_per_batch": phase_ms, "oracle_checked": checked,
        "peak_gpu_bytes": int(torch.cuda.max_memory_allocated()),
        "launches": counts,
    }
    del clf
    torch.cuda.empty_cache()

    # -- the gathered fold: two batches, one chunk launch per gather budget --
    from raxtax_tpu_torch.ops.intersect_fold import gather_chunk

    a = args_for(fold="gathered")
    clf = make_classifier(db, a, n_queries_hint=len(queries))
    short = queries[: 2 * BATCH]
    torch.cuda.reset_peak_memory_stats()
    outs, tsvs, dt, counts, phase_ms = timed_pass(db, short, a, clf, "path_1m_gathered")
    km3 = clf.state.kmer_major3
    chunks = -(-BATCH // gather_chunk(
        BATCH, clf._k_pad_hw, int(km3.shape[1] * km3.shape[2]) * 4))
    if counts["fold_planes_gathered"] != 2 * chunks or counts["fold_planes"]:
        raise AssertionError(
            f"path_1m_gathered: {chunks} chunks per batch, launches {counts}")
    checked = check_oracle(db, short, outs, tsvs, 5)
    p1m_gathered = {
        "phase": "path_1m_gathered", "refs": n_refs, "queries": len(short),
        "batch": clf.batch_size, "pass_s": round(dt, 3),
        "queries_per_s": round(len(short) / dt, 2),
        "phase_ms_per_batch": phase_ms, "oracle_checked": checked,
        "chunk_launches_per_batch": chunks,
        "peak_gpu_bytes": int(torch.cuda.max_memory_allocated()),
        "launches": counts,
    }
    del clf, km3
    torch.cuda.empty_cache()
    note("stream and gathered folds driven; uploading the block-padded matrix")

    # -- the double-f32 path, sparse fold: half the queries ------------------
    a = args_for(dd=True)
    t0 = time.time()
    clf = make_classifier(db, a, n_queries_hint=len(queries))
    torch.cuda.synchronize()
    upload_dd_s = time.time() - t0
    kernels = phase_kernels(db, queries, clf.state)
    torch.cuda.empty_cache()
    note("kernels compared; driving the double-f32 path")
    torch.cuda.reset_peak_memory_stats()
    outs, tsvs, dt, dd_counts, phase_ms = timed_pass(db, half, a, clf, "path_1m_dd")
    n_batches = -(-len(half) // clf.batch_size)
    flipped = not clf._sparse
    for k in DD_PATH:
        if dd_counts[k] < n_batches:
            raise AssertionError(f"path_1m_dd launched {k} {dd_counts[k]} times")
    if dd_counts["fold_planes_sparse"] + dd_counts["fold_planes"] < n_batches or (
        dd_counts["fold_planes_sparse"] <= 0 and not flipped
    ):
        raise AssertionError(f"path_1m_dd: fold launches {dd_counts}")
    checked = check_oracle(db, half, outs, tsvs, 5)
    k2 = next(k for k in kernels if k["name"] == "fold_planes_sparse")
    p1m_dd = {
        "phase": "path_1m_dd", "refs": n_refs, "queries": len(half),
        "batch": clf.batch_size, "upload_s": round(upload_dd_s, 2),
        "pass_s": round(dt, 3), "queries_per_s": round(len(half) / dt, 2),
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
    del clf
    torch.cuda.empty_cache()
    note("double-f32 path driven; uploading the ref-major matrix")

    # -- the dense-count backend: two batches. The tip count is no multiple
    # of 128 at 1,000,000 references, so its scan is the pairwise tree. A
    # failure here (memory, time) raises like any other
    a = args_for(backend="xla")
    t0 = time.time()
    clf = make_classifier(db, a, n_queries_hint=len(queries))
    torch.cuda.synchronize()
    upload_xla_s = time.time() - t0
    torch.cuda.reset_peak_memory_stats()
    outs, tsvs, dt, counts, phase_ms = timed_pass(db, short, a, clf, "path_1m_xla")
    check_dense_launches("path_1m_xla", counts, 2, scan=db.num_tips % 128 == 0)
    checked = check_oracle(db, short, outs, tsvs, 5)
    p1m_xla = {
        "phase": "path_1m_xla", "refs": n_refs, "queries": len(short),
        "batch": clf.batch_size, "upload_s": round(upload_xla_s, 2),
        "pass_s": round(dt, 3), "queries_per_s": round(len(short) / dt, 2),
        "phase_ms_per_batch": phase_ms, "oracle_checked": checked,
        "scan": "dd_cumsum" if db.num_tips % 128 == 0 else "pairwise tree",
        "peak_gpu_bytes": int(torch.cuda.max_memory_allocated()),
        "launches": counts, "host_replays": clf.host_replays,
    }
    note(f"dense-count backend driven in {time.time() - t0:.1f}s")
    return kernels, p1m, p1m_dd, p1m_stream, p1m_gathered, p1m_xla

# -- the scripts path: probes, fuzz, sweep -----------------------------------

#: adversarial pairs drawn for K11 (about 16.7M survive the overflow cut)
PROBE_PAIRS = 17_000_000
PROBE_ITERS = 5_000_000  # the TPU probe's step count
PROBE_CHECK_ITERS = 256  # steps at which the chains meet their plain version


def phase_probe_f64():
    """K11 and K12 through ``tools/probe_f64.py`` at its shapes, every check
    bit for bit: ``(the phase's line, [K11 entry, K12 entry])``."""
    from raxtax_tpu_torch.ops.exactf64 import OPS_PER_ADD, OPS_PER_SUB
    from raxtax_tpu_torch.tools import probe_f64 as pf

    dev = torch.device("cuda")
    reset_counts()
    lines = pf.run(dev, PROBE_PAIRS, pf.SCRIPT_TIPS, BATCH,
                   plain_pairs=PROBE_PAIRS, plain_tips=512)
    counts = read_counts()
    for line in lines:
        if not pf.passed(line):
            raise AssertionError(f"probe_f64: {json.dumps(line)}")
    ew = next(l for l in lines if l["probe"] == "ew_adversarial")
    if ew["pairs"] < 16_000_000 or ew["plain_pairs"] != ew["pairs"]:
        raise AssertionError(f"probe_f64: {ew['pairs']} pairs checked")
    scans = [l for l in lines if l["probe"] == "scan"]
    if [l["N"] for l in scans] != list(pf.SCRIPT_TIPS):
        raise AssertionError("probe_f64: a scan size is missing")
    for k in ("probe_f64_ew", "probe_f64_scan"):
        if counts[k] < 2:
            raise AssertionError(f"probe_f64: {k} launched {counts[k]} times")
    n = ew["pairs"]
    t_bytes = n * 32 / PEAK_BYTES_PER_S
    t_ops = n * (OPS_PER_ADD + OPS_PER_SUB) / PEAK_INT32_OPS
    k11 = {
        "name": "probe_f64_ew", "route": "cuda",
        "source": "raxtax_tpu_torch/csrc/probe_f64.cu",
        "replaces": "scripts/probe_mosaic_f64.py:62",
        "max_abs_err": 0.0, "ms": ew["ms"], "plain_ms": ew["plain_ms_host_clock"],
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": ew["hardware_add_ms"],
        "library": "torch add in float64 (a + b only; the card's f64 unit)",
        "pairs": n, "bits_equal_hardware_f64": True,
        "ms_8x128": next(l for l in lines if l["probe"] == "ew_8x128")["ms"],
    }
    big = scans[-1]
    B, N = big["B"], big["N"]
    t_bytes = B * N * 16 / PEAK_BYTES_PER_S
    t_ops = B * N * OPS_PER_ADD / PEAK_INT32_OPS
    p = pf.scan_inputs(B, N, dev, seed=N)
    yard_ms = cuda_ms(lambda: torch.cumsum(p, dim=1))
    del p
    torch.cuda.empty_cache()
    k12 = {
        "name": "probe_f64_scan", "route": "cuda",
        "source": "raxtax_tpu_torch/csrc/probe_f64.cu",
        "replaces": "scripts/probe_mosaic_f64.py:125",
        "max_abs_err": 0.0, "ms": big["ms"],
        "plain_ms": big["plain_ms_host_clock"], "plain_tips": big["plain_tips"],
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "cumsum_yardstick_ms": yard_ms,  # other rounding: not the function
        "shape": {"G": B // 128, "N": N, "lanes": 128},
        "chain_adds": N, "ns_per_chain_step": big["ns_per_chain_step"],
        "k5_ms_same_values": big["k5_ms"],
        "ms_by_tips": {l["N"]: l["ms"] for l in scans},
        "k5_ms_by_tips": {l["N"]: l["k5_ms"] for l in scans},
        "bits_equal_k5": True,
    }
    line = {"phase": "probe_f64", "checks": lines, "launches": counts}
    return line, [k11, k12]


def phase_probe_ops():
    """K13's seven chains through ``tools/probe_ops.py``: ``(the phase's
    line, K13 entry)``."""
    from raxtax_tpu_torch.ops.opchain import CHAINS, OPS_PER_STEP
    from raxtax_tpu_torch.tools import probe_ops as po

    dev = torch.device("cuda")
    reset_counts()
    lines = [po.chain_line(c, dev, PROBE_ITERS, PROBE_CHECK_ITERS) for c in CHAINS]
    counts = read_counts()
    bad = [l["chain"] for l in lines if not l["bits_equal_plain"]]
    if bad:
        raise AssertionError(f"probe_ops: chains differ from the plain version: {bad}")
    if counts["probe_op_chain"] < len(CHAINS):
        raise AssertionError(f"probe_ops: launches {counts['probe_op_chain']}")
    ops = 8 * 128 * PROBE_ITERS * sum(OPS_PER_STEP.values())
    t_ops = ops / PEAK_INT32_OPS
    t_bytes = 8 * 128 * 12 * len(CHAINS) / PEAK_BYTES_PER_S
    k13 = {
        "name": "probe_op_chain", "route": "cuda",
        "source": "raxtax_tpu_torch/csrc/probe_ops.cu",
        "replaces": "scripts/probe_mosaic_perf.py:55",
        "max_abs_err": 0.0,
        # the seven chains, one launch each at PROBE_ITERS steps
        "ms": sum(l["ms"] for l in lines),
        # the plain version at PROBE_CHECK_ITERS steps (a torch loop)
        "plain_ms": sum(l["plain_ms_host_clock"] for l in lines),
        "plain_iters": PROBE_CHECK_ITERS,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "iters": PROBE_ITERS,
        "ns_per_iter": {l["chain"]: l["ns_per_iter"] for l in lines},
    }
    return {"phase": "probe_ops", "chains": lines, "launches": counts}, k13


def phase_fuzz() -> dict:
    """``tools/fuzz_hardware.py`` on the card for about a minute (never under
    24 trials): 0 mismatches against the oracle."""
    from raxtax_tpu_torch.tools import fuzz_hardware as fz

    out: list[str] = []
    reset_counts()
    tally = fz.run(trials=10_000, seed0=2000, device="cuda", seconds=60.0,
                   out=out.append)
    counts = read_counts()
    if tally["mismatches"] or tally["trials"] < fz.MIN_TRIALS:
        raise AssertionError(
            "fuzz: " + json.dumps(tally) + "\n" + "\n".join(out[-20:]))
    torch.cuda.empty_cache()
    return {"phase": "fuzz", **tally, "not_drawn": fz.NOT_DRAWN,
            "launches": counts}


def phase_runtime_memory(per_ref_s: float) -> dict:
    """``tools/runtime_memory.py``, one rep, at 50,000 records and at the
    largest of 1M / 500k / 200k records that the budget left allows (judged
    from the large phase's build rate per reference and the 50,000-record
    run). Every row's CLI run must exit 0."""
    from raxtax_tpu_torch.tools import make_synth_fasta, runtime_memory as rm

    torch.cuda.empty_cache()  # the CLI runs in a child with its own context
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        def sweep_at(n: int) -> dict:
            fasta = os.path.join(tmp, f"synth_{n}.fasta")
            t0 = time.time()
            make_synth_fasta.write_synth_fasta(n, fasta)
            records = rm.read_fasta_records(fasta)
            host_s = time.time() - t0
            row = rm.sweep(records, [n], 1, os.path.join(tmp, "rm.csv"),
                           "auto", "cuda", log=note)[0]
            del records
            os.unlink(fasta)
            if row["returncode"] != 0:
                raise AssertionError(f"runtime_memory: {json.dumps(row)}")
            row["fasta_write_read_s"] = host_s
            return row

        rows.append(sweep_at(50_000))
        small = rows[0]
        per_query = small["classify_s"] / small["queries"]
        per_rec_host = small["fasta_write_read_s"] / 50_000
        n_large = 200_000
        for cand in (1_000_000, 500_000):
            # start-up, the FASTA written and read, parse + build + save at
            # three times the large phase's build rate per reference, and a
            # tenth of the records classified at 2.5 times the 50k cost per
            # query (a larger database slows the classify phase)
            est = 60.0 + cand * (per_rec_host + 3.0 * per_ref_s) \
                + 0.1 * cand * 2.5 * per_query
            if est < remaining():
                n_large = cand
                break
        note(f"runtime_memory: {n_large} records ({remaining():.0f}s left)")
        rows.append(sweep_at(n_large))
    return {
        "phase": "runtime_memory", "reps": 1, "backend": "auto",
        "rows": [{k: r[k] for k in ("size", "runtime_s", "peak_rss_mb",
                                    "hwm_peak_mb", "rss_peak_mb",
                                    "child_maxrss_mb",
                                    "qps_steady", "classify_s", "queries",
                                    "returncode", "fasta_write_read_s")}
                 for r in rows],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    env = phase_env()
    say(env)
    probe_line, probe_kernels = phase_probe_f64()
    say(probe_line)
    ops_line, k13 = phase_probe_ops()
    say(ops_line)
    note("probes done")
    db, queries, build_s = build_world(65536)
    note(f"65k world built in {build_s:.1f}s")
    p65 = phase_path_65k(db, queries, build_s)
    per_ref_s = p65.pop("build_s_per_ref")
    say(p65)
    p65_dd, k7_on_path = phase_path_65k_dd(db, queries)
    say(p65_dd)
    say(phase_path_65k_fold(db, queries, "stream"))
    say(phase_path_65k_fold(db, queries, "gathered"))
    say(phase_path_65k_xla(db, queries))
    del db
    kernels, p1m, p1m_dd, p1m_stream, p1m_gathered, p1m_xla = phase_path_large(
        per_ref_s)
    per_ref_s_large = p1m["db_build_s"] / p1m["refs"]
    say(p1m)
    say(p1m_stream)
    say(p1m_gathered)
    say(p1m_dd)
    say(p1m_xla)
    say(phase_fuzz())
    note("fuzz done; the runtime / memory sweep")
    say(phase_runtime_memory(per_ref_s_large))
    # launches: from the main path that runs the kernel — the exact path at
    # full size (with the dense, the stream and the gathered fold), the
    # double-f32 path at full size, and for what only a
    # 65,536-reference run launches (the bit-major scan; the sparse fold when
    # the full-size run flipped to dense on its pair budget) that run
    sources = (
        ("path_1m", p1m["launches"], EXACT_PATH),
        ("path_1m_stream", p1m_stream["launches"], ("fold_planes_stream",)),
        ("path_1m_gathered", p1m_gathered["launches"], ("fold_planes_gathered",)),
        ("path_1m_dd", p1m_dd["launches"],
         ("planes_high", "dd_cumsum", "fold_planes_sparse")),
        ("path_65k_dd", p65_dd["launches"], ("fold_planes_sparse",)),
        ("path_65k_dd bm_scan", p65_dd["bm_scan"]["launches"],
         ("dd_cumsum_bitmajor",)),
        ("probe_f64", probe_line["launches"], ("probe_f64_ew", "probe_f64_scan")),
        ("probe_ops", ops_line["launches"], ("probe_op_chain",)),
    )
    # K7's entry is the comparison at the packed 65,536-reference shape, the
    # one its path launches; its numbers at the large size ride along
    i7 = next(i for i, k in enumerate(kernels) if k["name"] == "dd_cumsum_bitmajor")
    k7_on_path["at_large_size"] = {
        k: kernels[i7][k] for k in
        ("ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err", "shape")
    }
    kernels[i7] = k7_on_path
    kernels += probe_kernels + [k13]
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
