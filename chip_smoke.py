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
   ``significance="auto"`` (``path_65k_dd``); then two batches each without
   the unit/wide split (``RAXTAX_SPLIT2=0``, ``path_65k_split2_off``), with
   the single-tip split on the tip-order and on the bit-major scan
   (``RAXTAX_SPLIT_SIG=1``, ``path_65k_split_sig``), both against the oracle,
   and with ``--descent device``, held against the exact descent on every
   query that one did not replay on the host (``path_65k_descent_device``),
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
   bit — the sparse, the gathered and the stream fold also against the dense
   fold, the histogram also on random planes whose tips nearly all count 16
   or more — and times both (``kernels``; K2 and K3 also at 65,536
   references, from ``path_65k_dd``),
7. drives the double-f32 path at that size, checks it against the oracle and
   reports throughput, phase times, peak memory, pairs per query, host
   replays and whether the fold flipped to dense (``path_1m_dd``),
8. drives the dense-count backend at that size for two batches, where its
   scan takes the pairwise tree (``path_1m_xla``), then the sharded pipeline
   of ``parallel/mesh.py`` on a mesh ``1,1`` (a world of one rank on NCCL)
   at that size, one pass of every query each for ``pallas`` (K9, K3, K4,
   K6 on the rank's stripe), ``stream`` (K10, K3, K4, K6) and ``xla`` (dense
   counts, the pairwise scan tree): byte-equal to the oracle and to the
   double-f32 run's lines, with each backend's launches by kernel
   (``path_1m_mesh``),
9. times K13's seven operation chains at 5,000,000 steps after holding their
   bits against the plain version, holds every chain at step counts around
   its unrolled loop on whole-space words too, reads the chains' dependent
   instructions from the SASS and the software add's latency for the
   chains' floors (``probe_ops``),
10. runs the software-f64 probes through ``tools/probe_f64.py``: K11 on
    about 16.7M adversarial pairs against its plain version and against the
    card's own f64 add and subtract, K12 at 256 queries over 65,536 and
    1,048,576 tips against K5 on the same values, and both on whole-space
    words against their plain versions, K12 at ragged tip counts
    (``probe_f64``),
11. fuzzes the engine against the oracle through ``tools/fuzz_hardware.py``
    for about a minute, at least 24 trials (``fuzz``), then runs the CLI in
    two child ranks (``parallel/launch.py``) that share the card over gloo,
    on a 65,536-record synthetic FASTA: ``--global-mesh --mesh 1,2``,
    ``--global-mesh --mesh 2,1`` and two independent ranks, each merged
    ``raxtax.out``/``.tsv`` byte-equal to the single-process run and no
    ``.shard*`` file left, with the gloo host-copy count, and a
    ``tools/speedup.py --devices 1 2`` sweep (``mesh_ranks_65k``), then the
    graft entry points of ``tools/dryrun.py``: ``entry()`` eager and
    compiled against the CPU, ``dryrun_multichip(8)`` on eight ranks sharing
    the card over gloo (mesh ``2,4``, launches by kernel from rank 0) and
    ``dryrun_multiprocess(2)`` (``dryrun``),
12. runs the CLI with ``--trace DIR`` on a 20,000-record synthetic FASTA in
    a child and finds K1's kernel in the trace (``trace``, after the 65,536
    phases), and the bench ``tools/bench.py`` in a child under what is left
    of the budget, echoing its JSON lines: the 65,536-reference line with
    every pass, the 1,000,000-reference line when the budget allows
    (``bench``),
13. sweeps whole CLI runs through ``tools/runtime_memory.py`` on a synthetic
    FASTA from ``tools/make_synth_fasta.py``, one rep at 50,000 records and
    one at the largest of 1M / 500k / 200k the budget allows: runtime, peak
    host RSS, steady queries/s, exit code (``runtime_memory``).

Each phase prints one JSON line; the ``kernels`` line carries, per kernel,
its launches on the single-device path that runs it (the mesh phase prints
its own launches by kernel), its time, its plain version's
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
    PEAK_F64_ADDS,
    PEAK_INT32_OPS,
    batch_inputs,
    batch_probs32,
    dd_cumsum_bounds,
    fold_sparse_bounds,
    fold_stream_bounds,
    planes_hist_bounds,
    tail_tips,
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
             split_sig: bool = False, split2: bool = True,
             descent: str = "exact"):
    """The parsed command line of ``raxtax-torch --tsv --batch-size 256
    --debug-checks`` (output prefix and database path are set per run).
    ``dd`` is what ``RAXTAX_EXACT=0 RAXTAX_SPARSE_FOLD=1`` select, ``fold``
    what ``RAXTAX_FUSED_GATHER=0`` or ``--backend stream`` select,
    ``backend="xla"`` the dense-count backend, ``split2=False`` what
    ``RAXTAX_SPLIT2=0`` selects, ``descent`` the ``--descent`` flag."""
    return SimpleNamespace(
        backend=backend, device="cuda", batch_size=BATCH, debug_checks=True,
        tsv=True, skip_exact_matches=skip, raw_confidence=raw, redo=True,
        significance=significance or ("dd" if dd else "exact"),
        fold=fold or ("sparse" if dd else "dense"), bm_scan=bm_scan,
        split_sig=split_sig, split2=split2, descent=descent,
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
    from raxtax_tpu_torch.ops._build import kernel_wrappers

    return kernel_wrappers()


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
    ``with_plain``, against its plain version; both kernels' times and the
    device time of the regroup by block that the wrapper runs before K2.
    The pair budget is lifted here so K2 runs at any pair count: the numbers
    are what a later choice of the sparse/dense crossover needs."""
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
    regroup_ms = cuda_ms(lambda: fo.group_pairs_by_block(
        d_pk, d_pb, d_tot, S // fo.BLOCK_SUB))
    W = S * 128
    return {
        "sparse_ms": k2_ms, "dense_ms": k1_ms, "plain_ms": plain_ms,
        # the wrapper's regroup (sort, gather, searchsorted) before K2; it is
        # inside sparse_ms too
        "regroup_ms": regroup_ms,
        "max_abs_err": err, "bits_equal_dense": True,
        **fold_sparse_bounds(pair_kmer, pair_blk, totals, W, P),
        "pairs_per_query_mean": int(totals.sum()) / BATCH,
        "pairs_per_query_max": max_pairs,
        "pair_budget": max(SPARSE_BUDGET_MIN, k_pad * S // SPARSE_CROSSOVER_DIV),
        "shape": {"B": BATCH, "k_pad": k_pad, "W": W, "P": P,
                  "blocks": S // fo.BLOCK_SUB, "p_pad": int(pair_kmer.shape[1])},
    }


def hist_compare(planes, s_max: int, n_tips: int):
    """K3 on ``planes`` against its plain version (bit for bit, 32 queries
    at a time): ``(its time, bound and share of tips of 16 or more -- the
    ones it decodes one by one --, the histogram)``."""
    from raxtax_tpu_torch.ops import planes as pl

    B, P = int(planes.shape[0]), int(planes.shape[1])
    W = int(planes.shape[2] * planes.shape[3])
    hist = pl.planes_histogram(planes, s_max, n_tips)
    torch.cuda.synchronize()
    t0 = time.time()
    plain = torch.cat([
        pl.planes_histogram_plain(planes[i : i + 32], s_max, n_tips)
        for i in range(0, B, 32)
    ])
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    if not bits_equal(hist, plain):
        raise AssertionError("planes_histogram differs from its plain version")
    ms = cuda_ms(lambda: pl.planes_histogram(planes, s_max, n_tips))
    return {
        "ms": ms, "plain_ms": plain_ms, "max_abs_err": max_abs_err(hist, plain),
        **planes_hist_bounds(B, P, W, s_max, tail_tips(planes)),
        "shape": {"B": B, "P": P, "W": W, "s_max": s_max},
    }, hist


def world_probs32(db, queries, state) -> torch.Tensor:
    """``[B, 32, S, 128]`` f32 bit-major tip probabilities of one batch on
    ``state``'s database: what the double-f32 path hands its scan."""
    from raxtax_tpu_torch.ops import intersect_fold, planes as pl

    kmer_idx, ks, k_pad, s_max, _, _ = batch_inputs(queries, BATCH)
    d_idx = torch.from_numpy(kmer_idx).to(state.device)
    d_ks = torch.from_numpy(ks).to(state.device)
    planes = intersect_fold.fold_planes(
        d_idx, d_ks, state.kmer_major3, max_count=k_pad)
    hist = pl.planes_histogram(planes, s_max, db.num_tips)
    return batch_probs32(planes, hist, ks, s_max)


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
    db = dd_cumsum_bounds(B, N)
    n_rows = N // 128
    return {
        "name": name, "route": "cuda",
        "source": "raxtax_tpu_torch/csrc/dd_cumsum.cu",
        "replaces": replaces,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": db["bound_ms"], "bound_by": db["bound_by"],
        "bound_share": db["bound_ms"] / ms,
        "reload_bound_ms": db["reload_bound_ms"],
        "library_ms": lib_ms,
        "library": "torch.cumsum in f64 (another add order: a yardstick, "
                   "not a substitute)",
        "f64_max_abs_err_vs_np_cumsum": f64_err,
        "np_cumsum_rows_checked": len(rows),
        "shape": {"B": B, "N": N, "tile_rows": tile_rows,
                  "tiles": -(-n_rows // min(n_rows, tile_rows)),
                  "out": [B, N + 1]},
    }


def phase_path_65k_dd(db, packed, queries):
    """The double-f32 path with the sparse fold at 65,536 references
    (``packed``: the same database in the packed layout, for the bit-major
    scan): ``(the phase's line, K7's comparison at the packed shape)``."""
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
    # K3 at this size, on K1's planes of the first batch
    from raxtax_tpu_torch.ops.intersect_fold import fold_planes

    idx, ks, k_pad, s_max, _, _ = batch_inputs(queries, BATCH)
    dev = clf.state.device
    planes = fold_planes(torch.from_numpy(idx).to(dev),
                         torch.from_numpy(ks).to(dev), clf.state.kmer_major3,
                         max_count=k_pad)
    hist, _ = hist_compare(planes, s_max, db.num_tips)
    del planes
    line = {
        "phase": "path_65k_dd", "refs": db.num_tips, "queries": len(queries),
        "batch": BATCH, "pass_s": round(dt, 3),
        "queries_per_s": round(len(queries) / dt, 2),
        "oracle_checked": checked, "launches": counts,
        "host_replays": clf.host_replays, "mux_dense": clf._mux_dense,
        "pairs_per_query_mean": clf.pair_stats[0] / max(clf.pair_stats[1], 1),
        "pairs_per_query_max": clf.pair_stats[2],
        "fold_same_batch": folds, "planes_hist_same_batch": hist,
    }
    del clf
    line["flag_combos"] = flag_combos(db, queries, dd=True)

    # the bit-major scan (K7) reads the packed layout: one short run
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
        "dd_cumsum_bitmajor", world_probs32(packed, short, clf.state), packed=True
    )
    del clf

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


class _CountSplit:
    """Counts the calls of the single-tip split compaction
    (``nodeconf._compact_split``) inside the ``with`` block."""

    def __enter__(self):
        from raxtax_tpu_torch.ops import nodeconf

        self.calls, self._orig = 0, nodeconf._compact_split

        def counted(*a):
            self.calls += 1
            return self._orig(*a)

        nodeconf._compact_split = counted
        return self

    def __exit__(self, *exc):
        from raxtax_tpu_torch.ops import nodeconf

        nodeconf._compact_split = self._orig


def option_run(phase: str, db, queries, a, n_check: int = 16):
    """One run of ``run_queries`` in the mode ``a`` with the launch counts
    read around it; every query has output lines and the first ``n_check``
    are the oracle's: ``(the classifier, its line)``."""
    from raxtax_tpu_torch.engine.classify import make_classifier

    clf = make_classifier(db, a, n_queries_hint=len(queries))
    reset_counts()
    with _CountSplit() as split:
        outs, tsvs, dt = run_path(db, queries, a, classifier=clf)
    counts = read_counts()
    if set(outs) != {l for l, _ in queries}:
        raise AssertionError(f"{phase}: not every query has output lines")
    checked = check_oracle(db, queries, outs, tsvs, n_check)
    n_batches = -(-len(queries) // BATCH)
    scan = "dd_cumsum_bitmajor" if a.bm_scan else "dd_cumsum"
    for k in ("planes_hist", "planes_probs", "planes_high", scan,
              "fold_planes_sparse"):
        if counts[k] < n_batches:
            raise AssertionError(
                f"{phase}: {k} launched {counts[k]} times in {n_batches} batches")
    return clf, {
        "queries": len(queries), "layout": clf.state.layout,
        "pass_s": round(dt, 3), "queries_per_s": round(len(queries) / dt, 2),
        "oracle_checked": checked, "launches": counts,
        "split_compactions": split.calls, "host_replays": clf.host_replays,
    }


def phase_path_65k_split2_off(db, queries) -> dict:
    """``RAXTAX_SPLIT2=0`` on the double-f32 path with the sparse fold: no
    unit/wide split, every eval node through the plain compaction."""
    a = args_for(dd=True, split2=False)
    clf, line = option_run("path_65k_split2_off", db, queries, a)
    if clf.state.split2 is not None or line["split_compactions"]:
        raise AssertionError("path_65k_split2_off: a split compaction ran")
    del clf
    return {"phase": "path_65k_split2_off", "refs": db.num_tips,
            "batch": BATCH, **line}


def phase_path_65k_split_sig(db, packed, queries) -> dict:
    """``RAXTAX_SPLIT2=0 RAXTAX_SPLIT_SIG=1`` on the double-f32 path: the
    single-tip split on the tip-order scan (K6) of the flat database, then on
    the bit-major scan (K7) of its packed copy."""
    line = {"phase": "path_65k_split_sig", "refs": db.num_tips, "batch": BATCH}
    n_batches = -(-len(queries) // BATCH)
    for name, world, bm in (("tip_order", db, False), ("bm_scan", packed, True)):
        a = args_for(dd=True, split2=False, split_sig=True, bm_scan=bm)
        clf, run = option_run(f"path_65k_split_sig {name}", world, queries, a)
        if clf.state.split_sig is None or run["split_compactions"] < n_batches:
            raise AssertionError(
                f"path_65k_split_sig {name}: {run['split_compactions']} split "
                f"compactions in {n_batches} batches")
        if bm and run["launches"]["dd_cumsum"]:
            raise AssertionError("path_65k_split_sig bm_scan: K6 launched")
        line[name] = run
        del clf
    return line


def phase_path_65k_descent_device(db, queries) -> dict:
    """``--descent device`` on the double-f32 path through ``run_queries``
    (no host replay), then both descents on the same batches: their lines
    are equal on every query the exact run did not replay on the host."""
    from raxtax_tpu_torch.engine.classify import make_classifier
    from raxtax_tpu_torch.tools.compare_descents import compare_descents

    a = args_for(dd=True, descent="device")
    clf = make_classifier(db, a, n_queries_hint=len(queries))
    reset_counts()
    outs, _, dt = run_path(db, queries, a, classifier=clf)
    counts = read_counts()
    if set(outs) != {l for l, _ in queries}:
        raise AssertionError("path_65k_descent_device: missing output lines")
    if clf.host_replays:
        raise AssertionError(
            f"path_65k_descent_device: {clf.host_replays} host replays")
    n_batches = -(-len(queries) // BATCH)
    for k in DD_PATH + ("fold_planes_sparse",):
        if counts[k] < n_batches:
            raise AssertionError(f"path_65k_descent_device: launches {counts}")
    del clf
    cmp = compare_descents(db, queries, BATCH, "cuda", fold="sparse")
    if cmp["differ"] or cmp["host_replays_device"]:
        raise AssertionError(f"path_65k_descent_device: {json.dumps(cmp)}")
    if cmp["compared"] + cmp["replayed_by_exact"] != len(queries):
        raise AssertionError(f"path_65k_descent_device: {json.dumps(cmp)}")
    torch.cuda.empty_cache()
    return {"phase": "path_65k_descent_device", "refs": db.num_tips,
            "batch": BATCH, "queries": len(queries), "pass_s": round(dt, 3),
            "queries_per_s": round(len(queries) / dt, 2), "launches": counts,
            "same_batches": cmp}


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
    # the same batch at every group size the kernel takes: a larger group
    # shares more row loads and keeps more planes in registers
    by_group = {}
    for g in range(1, st.MAX_GROUP + 1):
        alt = st.build_pairs(d_idx, g)
        if not bits_equal(st.fold_planes_stream(*alt, km3, BATCH, g, P),
                          k1_planes):
            raise AssertionError(f"fold_planes_stream, groups of {g}: wrong")
        by_group[g] = cuda_ms(
            lambda: st.fold_planes_stream(*alt, km3, BATCH, g, P))
    fb = fold_stream_bounds(kmer_idx, ks, flat_k, off_k, W, P,
                            pairs[0].numel(), pairs[2].numel())
    out.append({
        "name": "fold_planes_stream", "route": "cuda",
        "source": "raxtax_tpu_torch/csrc/fold_stream.cu",
        "replaces": "raxtax_tpu/ops/intersect_stream.py:38",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": fb["bound_ms"], "bound_by": fb["bound_by"],
        "bound_share": fb["bound_ms"] / ms,
        "library_ms": None,
        "shape": {"B": BATCH, "k_pad": k_pad, "W": W, "P": P,
                  "pairs": fb["rows_folded"], "group_size": group,
                  "slice_bytes": 512,
                  "ctas": [-(-BATCH // group), -(-W // 128)]},
        "bits_equal_fold_planes": True,
        "unique_rows": fb["unique_rows"],
        "build_pairs_ms": sort_ms,  # the sort beside the kernel
        "ms_by_group_size": by_group,
        "whole_matrix_bound_ms": (int(km3.shape[0]) * W * 4 + BATCH * P * W * 4)
        / PEAK_BYTES_PER_S * 1e3,
        "stream_bound_ms": fb["stream_bound_ms"],
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
    h, hist = hist_compare(planes, s_max, n_tips)
    if not bool((hist.sum(dim=1) == n_tips).all()):
        raise AssertionError("planes_histogram: mass is not num_tips")
    # a tail-heavy input at the same shape: random planes, so nearly every
    # tip counts 16 or more and goes through the kernel's one-by-one decode;
    # s_max = 2^P keeps every count, and there are no pad tips
    gen = torch.Generator(device=dev).manual_seed(7)
    rand = torch.randint(-(2**31), 2**31, tuple(planes.shape),
                         dtype=torch.int32, device=dev, generator=gen)
    tail, _ = hist_compare(rand, 1 << P, W * 32)
    del rand
    out.append({
        "name": "planes_hist", "route": "cuda",
        "source": "raxtax_tpu_torch/csrc/planes_hist.cu",
        "replaces": "raxtax_tpu/ops/planes.py:74",
        "library_ms": None, **h, "tail_heavy": tail,
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
        "regroup_ms": f["regroup_ms"],
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
    probs32 = batch_probs32(planes, hist, ks, s_max)  # [B, 32, S, 128] f32
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

    # DB build + the classify passes (the mesh's too) + kernels phase
    # (plain versions included) + oracle: keep what is left of the budget
    # for all of them
    n_refs = 200_000
    for cand in (1_000_000, 500_000):
        est = 3.0 * per_ref_s * cand + 370.0 + 2.5e-4 * cand
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
    dd_lines = (outs, tsvs)
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
    del clf
    torch.cuda.empty_cache()
    p1m_mesh = phase_path_1m_mesh(db, queries, *dd_lines)
    return kernels, p1m, p1m_dd, p1m_stream, p1m_gathered, p1m_xla, p1m_mesh


#: the kernels each backend of the sharded pipeline runs on its stripe (the
#: dense counts of ``xla`` run none; its scan is K6 only on aligned widths)
MESH_PATH = {
    "pallas": ("fold_planes_gathered", "planes_hist", "planes_probs", "dd_cumsum"),
    "stream": ("fold_planes_stream", "planes_hist", "planes_probs", "dd_cumsum"),
    "xla": (),
}


def phase_path_1m_mesh(db, queries, dd_outs, dd_tsvs) -> dict:
    """The sharded pipeline on a mesh ``1,1``, a world of one rank with
    NCCL, at the large size: ``--mesh 1,1`` as the CLI hands it to
    ``make_classifier``, for ``pallas``, ``stream`` and ``xla``, one pass of
    every query each after a warm-up batch. Each is byte-equal to the
    oracle on the checked queries and to the single-device double-f32
    run's lines on the queries that run classified; each planes backend
    launched its fold, K3, K4 and K6 on every batch."""
    import copy

    import torch.distributed as dist

    from raxtax_tpu_torch.db.database import ensure_kmer_layout
    from raxtax_tpu_torch.engine.classify import make_classifier
    from raxtax_tpu_torch.parallel import multihost

    t0 = time.time()
    # the mesh shards contiguous reference columns: the packed layout (a
    # second matrix on the host; the flat one stays the other phases')
    packed = ensure_kmer_layout(copy.copy(db), "packed")
    line = {"phase": "path_1m_mesh", "mesh": "1,1", "refs": db.num_tips,
            "queries": len(queries), "packed_layout_s": round(time.time() - t0, 2)}
    for backend in ("pallas", "stream", "xla"):
        a = args_for(backend=backend)
        a.mesh, a.global_mesh = "1,1", False
        t0 = time.time()
        clf = make_classifier(packed, a, n_queries_hint=len(queries))
        torch.cuda.synchronize()
        upload_s = time.time() - t0
        pipe = clf.pipeline
        if pipe is None or pipe.backend != backend:
            raise AssertionError(f"path_1m_mesh {backend}: no sharded pipeline")
        line["world"] = {"size": dist.get_world_size(),
                         "backend": pipe.mesh.backend}
        if pipe.mesh.backend != "nccl":
            raise AssertionError(f"path_1m_mesh: {pipe.mesh.backend}, not NCCL")
        torch.cuda.reset_peak_memory_stats()
        outs, tsvs, dt, counts, phase_ms = timed_pass(
            packed, queries, a, clf, f"path_1m_mesh {backend}")
        n_batches = -(-len(queries) // clf.batch_size)
        for k in MESH_PATH[backend]:
            if counts[k] < n_batches:
                raise AssertionError(
                    f"path_1m_mesh {backend} launched {k} {counts[k]} times")
        if backend == "xla":
            check_dense_launches("path_1m_mesh xla", counts, n_batches,
                                 scan=pipe.n_local % 128 == 0)
        checked = check_oracle(packed, queries, outs, tsvs, 5)
        differ = [l for l in dd_outs
                  if outs[l] != dd_outs[l] or tsvs[l] != dd_tsvs[l]]
        if differ:
            raise AssertionError(
                f"path_1m_mesh {backend}: {len(differ)} queries differ from "
                f"the double-f32 run, first {differ[0]}")
        line[backend] = {
            "batch": clf.batch_size, "upload_s": round(upload_s, 2),
            "pass_s": round(dt, 3), "queries_per_s": round(len(queries) / dt, 2),
            "phase_ms_per_batch": phase_ms, "oracle_checked": checked,
            "equal_to_dd_run": len(dd_outs), "host_replays": clf.host_replays,
            "n_local": pipe.n_local, "n_padded": pipe.n_padded,
            "scan": "dd_cumsum" if pipe.n_local % 128 == 0 else "pairwise tree",
            "peak_gpu_bytes": int(torch.cuda.max_memory_allocated()),
            "launches": {k: v for k, v in counts.items() if v},
        }
        del clf, pipe
        torch.cuda.empty_cache()
        note(f"path_1m_mesh {backend}: {dt:.2f}s")
    multihost.shutdown()
    del packed
    return line

# -- the scripts path: probes, fuzz, sweep -----------------------------------

#: adversarial pairs drawn for K11 (about 16.7M survive the overflow cut)
PROBE_PAIRS = 17_000_000
PROBE_ITERS = 5_000_000  # the TPU probe's step count
PROBE_CHECK_ITERS = 256  # steps at which the chains meet their plain version
#: K11's whole-space word pairs (K12's ragged shapes: phase_probe_f64)
WORD_PAIRS = 1 << 20


def phase_probe_ops():
    """K13's seven chains through ``tools/probe_ops.py``, the SM clock
    sampled while they run; then, outside the counted run, every chain at
    the edges of its unrolled loop on the probe's state and on whole-space
    words, its SASS, and the software add's latency (K12's floor):
    ``(the phase's line, K13 entry, the SASS counts, the add's latency)``."""
    from raxtax_tpu_torch.ops.opchain import CHAINS
    from raxtax_tpu_torch.tools import probe_ops as po
    from raxtax_tpu_torch.tools.kernel_batch import (
        dependent_op_ns,
        f64_add_latency,
        op_chain_bounds,
    )

    dev = torch.device("cuda")
    reset_counts()
    with po.SmClock() as clock:
        lines = [po.chain_line(c, dev, PROBE_ITERS, PROBE_CHECK_ITERS)
                 for c in CHAINS]
    counts = read_counts()
    bad = [l["chain"] for l in lines if not l["bits_equal_plain"]]
    if bad:
        raise AssertionError(f"probe_ops: chains differ from the plain version: {bad}")
    if counts["probe_op_chain"] < len(CHAINS):
        raise AssertionError(f"probe_ops: launches {counts['probe_op_chain']}")
    edges = po.edge_mismatches(dev)
    if edges:
        raise AssertionError(f"probe_ops: differ at the unroll edges: {edges}")
    sass = po.chain_sass(po.library_sass("probe_ops"))
    if set(sass) != set(CHAINS):
        raise AssertionError(f"probe_ops: SASS loops of {sorted(sass)}")
    lat = f64_add_latency(dev)
    ns = {l["chain"]: l["ns_per_iter"] for l in lines}
    ms = sum(l["ms"] for l in lines)
    b = op_chain_bounds(sass, 8 * 128, PROBE_ITERS,
                        dependent_op_ns(ns["u32_add_x1"], sass))
    k13 = {
        "name": "probe_op_chain", "route": "cuda",
        "source": "raxtax_tpu_torch/csrc/probe_ops.cu",
        "replaces": "scripts/probe_mosaic_perf.py:55",
        "max_abs_err": 0.0,
        # the seven chains, one launch each at PROBE_ITERS steps
        "ms": ms,
        # the plain version at PROBE_CHECK_ITERS steps (a torch loop)
        "plain_ms": sum(l["plain_ms_host_clock"] for l in lines),
        "plain_iters": PROBE_CHECK_ITERS,
        **b, "bound_share": b["bound_ms"] / ms,
        "chain_floor_share": b["chain_floor_ms"] / ms,
        "library_ms": None, "iters": PROBE_ITERS, "ns_per_iter": ns,
        "sm_clock_mhz": clock.mhz,
        "dependent_op_cycles": (b["dependent_op_ns"] * clock.mhz * 1e-3
                                if clock.mhz else None),
        "sass": sass, "edge_iters_checked": list(po.EDGE_ITERS), **lat,
    }
    line = {"phase": "probe_ops", "chains": lines, "launches": counts,
            "sm_clock_samples_mhz": clock.samples}
    return line, k13, sass, lat


def phase_probe_f64(sass: dict, lat: dict):
    """K11 and K12 through ``tools/probe_f64.py`` at its shapes, every check
    bit for bit, then (outside the counted run) both on whole-space words,
    K12 at ragged tip counts: ``(the phase's line, [K11 entry, K12
    entry])``. ``sass`` and ``lat`` come from :func:`phase_probe_ops`."""
    from raxtax_tpu_torch.ops.exactf64 import SCAN_TILE
    from raxtax_tpu_torch.tools import probe_f64 as pf
    from raxtax_tpu_torch.tools import probe_ops as po
    from raxtax_tpu_torch.tools.kernel_batch import probe_ew_bounds, probe_scan_bounds

    dev = torch.device("cuda")
    reset_counts()
    lines = pf.run(dev, PROBE_PAIRS, pf.SCRIPT_TIPS, BATCH,
                   plain_pairs=PROBE_PAIRS, plain_tips=512)
    counts = read_counts()
    shapes = [(2, 1), (2, SCAN_TILE - 1), (2, SCAN_TILE + 1),
              (1, 4 * SCAN_TILE + 3)]
    lines.append(pf.check_words(dev, WORD_PAIRS, shapes, seed=8))
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
    ipp = po.ew_instructions_per_pair(po.library_sass("probe_f64"))
    b11 = probe_ew_bounds(n, ipp)
    k11 = {
        "name": "probe_f64_ew", "route": "cuda",
        "source": "raxtax_tpu_torch/csrc/probe_f64.cu",
        "replaces": "scripts/probe_mosaic_f64.py:62",
        "max_abs_err": 0.0, "ms": ew["ms"], "plain_ms": ew["plain_ms_host_clock"],
        **b11, "bound_share": b11["bound_ms"] / ew["ms"],
        "instructions_per_pair": ipp,
        # no single torch call computes c = a + b and d = c - b
        "library_ms": None,
        "torch_add_ms": ew["hardware_add_ms"],
        "torch_add_sub_ms": ew["hardware_add_sub_ms"],
        "pairs": n, "bits_equal_hardware_f64": True,
        "whole_space_pairs": WORD_PAIRS,
        "ms_8x128": next(l for l in lines if l["probe"] == "ew_8x128")["ms"],
    }
    big = scans[-1]
    B, N = big["B"], big["N"]
    b12 = probe_scan_bounds(B, N, sass["f64_add_full"]["instructions_per_step"],
                            lat["f64_add_latency_ns"])
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
        **b12, "bound_share": b12["bound_ms"] / big["ms"],
        "chain_floor_share": b12["chain_floor_ms"] / big["ms"],
        "library_ms": None,
        "cumsum_yardstick_ms": yard_ms,  # other rounding: not the function
        "shape": {"G": B // 128, "N": N, "lanes": 128},
        "chain_adds": N, "ns_per_chain_step": big["ns_per_chain_step"],
        "k5_ms_same_values": big["k5_ms"],
        "ms_by_tips": {l["N"]: l["ms"] for l in scans},
        "k5_ms_by_tips": {l["N"]: l["k5_ms"] for l in scans},
        "bits_equal_k5": True,
        "whole_space_shapes": shapes,
    }
    line = {"phase": "probe_f64", "checks": lines, "launches": counts}
    return line, [k11, k12]


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


#: records of the mesh ranks' synthetic FASTA, and its queries (the first
#: records again)
MESH_RECORDS, MESH_QUERIES = 65_536, 512


def phase_mesh_ranks_65k() -> dict:
    """The CLI as a user runs it on several ranks of one machine, through
    ``tools/mesh_ranks.py``: the database cache once (``--only-db``), the
    single-process run, then two child ranks started by
    ``parallel/launch.py`` that share the card over gloo for
    ``--global-mesh --mesh 1,2``, ``--global-mesh --mesh 2,1`` and two
    independent ranks. Every merged ``raxtax.out``/``.tsv`` is byte-equal
    to the single run's, no ``.shard*`` file is left, and rank 0's log gives
    its peak device memory and the gloo host-copy count. Then
    ``tools/speedup.py --devices 1 2`` (a sweep on a shared card: no scaling
    claim)."""
    from raxtax_tpu_torch.tools import mesh_ranks, speedup
    from raxtax_tpu_torch.tools.make_synth_fasta import write_synth_fasta
    from raxtax_tpu_torch.tools.sweep_common import read_fasta_records

    torch.cuda.empty_cache()  # the ranks are children with their own contexts
    line = {"phase": "mesh_ranks_65k", **mesh_ranks.run(
        MESH_RECORDS, MESH_QUERIES, 2, ["1,2", "2,1"], BATCH, "cuda", log=note)}
    for name, run in line["runs"].items():
        if name.startswith("global") and not run["gloo_host_copies_rank0"]:
            raise AssertionError(f"mesh_ranks_65k {name}: no gloo host copies")
    with tempfile.TemporaryDirectory() as tmp:
        refs = os.path.join(tmp, "refs.fasta")
        write_synth_fasta(MESH_RECORDS, refs)
        rows = speedup.sweep(read_fasta_records(refs), [1, 2], 20_000,
                             MESH_QUERIES, 0, "pallas", "cuda", log=note)
    if any(row["returncode"] for row in rows):
        raise AssertionError(f"mesh_ranks_65k speedup: {rows}")
    line["speedup"] = {"rows": rows, "note": speedup.shared_note([1, 2], "cuda")}
    return line


#: ranks of the mesh dry run: the ``n_devices`` of MULTICHIP_r05.json
DRYRUN_RANKS = 8


def phase_dryrun() -> dict:
    """The graft entry points (``tools/dryrun.py``, the port's
    ``__graft_entry__.py``): ``entry()`` on the card eager and under
    ``torch.compile``, both bit-equal to the same step on the CPU (f32
    unpack against the card's f16: both exact for counts up to 2,048);
    ``dryrun_multichip(8)``, eight ranks sharing the card over gloo on a
    mesh ``2,4``, every backend's lines byte-equal to one device's, rank 0
    having launched K9, K3, K4 and K6 under ``pallas`` and K10, K3, K4 and
    K6 under ``stream``; then ``dryrun_multiprocess(2)``. The eight ranks
    must end inside the budget: fewer are never tried."""
    from raxtax_tpu_torch.tools import dryrun

    seconds = {}
    t0 = time.time()
    fn, args = dryrun.entry()
    eager = fn(*args)
    torch.cuda.synchronize()
    seconds["entry_eager"] = time.time() - t0
    t0 = time.time()
    compiled = torch.compile(fn)(*args)
    torch.cuda.synchronize()
    seconds["entry_compiled"] = time.time() - t0
    cpu_fn, cpu_args = dryrun.entry("cpu")
    on_cpu = cpu_fn(*cpu_args)
    for name, e, c, h in zip(("hist", "vals", "idx"), eager, compiled, on_cpu):
        if not dryrun.same_bits(e, c):
            raise AssertionError(f"dryrun entry: compiled {name} differs")
        if not dryrun.same_bits(e, h):
            raise AssertionError(f"dryrun entry: {name} differs from the CPU")
    del fn, args, eager, compiled
    torch.cuda.empty_cache()  # the ranks are children with their own contexts
    if remaining() <= 0:
        raise AssertionError(f"dryrun: no budget left for {DRYRUN_RANKS} ranks")
    t0 = time.time()
    mc = dryrun.dryrun_multichip(DRYRUN_RANKS, timeout=remaining(), log=note)
    seconds["multichip"] = time.time() - t0
    if mc["world_backend"] != "gloo":
        raise AssertionError(f"dryrun_multichip: {mc['world_backend']}")
    for backend in ("pallas", "stream"):
        missing = [k for k in MESH_PATH[backend]
                   if not mc["launches"][backend].get(k)]
        if missing:
            raise AssertionError(
                f"dryrun_multichip {backend}: rank 0 did not launch {missing}")
    t0 = time.time()
    mp = dryrun.dryrun_multiprocess(2, log=note)
    seconds["multiprocess"] = time.time() - t0
    return {
        "phase": "dryrun", "seconds": seconds,
        "entry": {"shapes": [list(o.shape) for o in on_cpu],
                  "bit_equal": ["eager", "compiled", "cpu"]},
        "multichip": {
            "ranks": mc["ranks"], "lines": mc["lines"],
            "launches_rank0": mc["launches"],
            "peak_device_bytes_rank0": mc["peak_device_bytes"],
            "world_backend": mc["world_backend"],
            "equal_to_single_device": True,
        },
        "multiprocess": {k: mp[k] for k in ("processes", "lines",
                                            "equal_to_single")},
    }


#: records of the trace phase's synthetic FASTA, and its queries (the first
#: records again: every query has an exact match)
TRACE_RECORDS, TRACE_QUERIES = 20_000, 512
#: seconds the bench leaves to the runtime / memory sweep after it
SWEEP_RESERVE_S = 180.0


def _cli_cmd(*args) -> list[str]:
    return [sys.executable, "-m", "raxtax_tpu_torch.cli", *map(str, args)]


def phase_trace() -> dict:
    """The CLI with ``--trace DIR`` on a synthetic FASTA, in a child process
    as a user runs it: exit 0, every query in ``raxtax.out``, and a profiler
    trace in DIR that names K1's kernel of ``csrc/``."""
    from raxtax_tpu_torch.tools.make_synth_fasta import write_synth_fasta
    from raxtax_tpu_torch.utils.trace import csrc_kernels_in, trace_files

    with tempfile.TemporaryDirectory() as tmp:
        refs, qf = Path(tmp) / "refs.fasta", Path(tmp) / "queries.fasta"
        write_synth_fasta(TRACE_RECORDS, str(refs))
        qf.write_text("".join(refs.read_text().splitlines(True)[: 2 * TRACE_QUERIES]))
        out, tr = Path(tmp) / "out", Path(tmp) / "trace"
        t0 = time.time()
        r = subprocess.run(
            _cli_cmd("-d", refs, "-i", qf, "-o", out, "--batch-size", BATCH,
                     "--trace", tr),
            capture_output=True, text=True, timeout=600,
            cwd=str(Path(__file__).resolve().parent),
        )
        dt = time.time() - t0
        if r.returncode != 0:
            raise AssertionError(f"trace: exit {r.returncode}\n{r.stderr[-4000:]}")
        labels = {l.split("\t", 1)[0] for l in (out / "raxtax.out").read_text().splitlines()}
        files = trace_files(tr)
        found = csrc_kernels_in(tr)
        if len(labels) != TRACE_QUERIES or not files:
            raise AssertionError(f"trace: {len(labels)} queries, files {files}")
        if "fold_planes_kernel" not in found:
            raise AssertionError(f"trace: no K1 kernel among {found}")
        return {"phase": "trace", "records": TRACE_RECORDS,
                "queries": TRACE_QUERIES, "seconds": round(dt, 2),
                "trace_files": [f.name for f in files],
                "trace_bytes": sum(f.stat().st_size for f in files),
                "csrc_kernels": found}


def phase_bench() -> list[dict]:
    """``python -m raxtax_tpu_torch.tools.bench`` in a child process, under
    what is left of the budget less the sweep's reserve, with its database
    cache in a temporary directory: its JSON lines. The 65,536-reference
    line must be there with every pass; the 1M line comes when the budget
    allows."""
    from raxtax_tpu_torch.tools import bench

    budget = remaining() - SWEEP_RESERVE_S
    torch.cuda.empty_cache()  # the bench runs in a child with its own context
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, RAXTAX_BENCH_BUDGET=str(int(budget)),
                   RAXTAX_BENCH_CACHE_DIR=tmp)
        for name in ("RAXTAX_BENCH_REFS", "RAXTAX_BENCH_QUERIES",
                     "RAXTAX_BENCH_BATCH", "RAXTAX_BENCH_BACKEND",
                     "RAXTAX_BENCH_REPS", "RAXTAX_BENCH_ORACLE_QUERIES"):
            env.pop(name, None)
        t0 = time.time()
        r = subprocess.run(
            [sys.executable, "-m", "raxtax_tpu_torch.tools.bench"],
            capture_output=True, text=True, env=env, timeout=budget + 120,
            cwd=str(Path(__file__).resolve().parent),
        )
        dt = time.time() - t0
    sys.stderr.write(r.stderr[-6000:])
    lines = [json.loads(l) for l in r.stdout.splitlines() if l.startswith("{")]
    by_refs = {l["metric"]: l for l in lines}
    small = by_refs.get("classify_throughput_65536ref_db")
    reps = bench.config({}).reps
    if r.returncode != 0 or small is None or len(small["pass_s"]) != reps:
        raise AssertionError(
            f"bench: exit {r.returncode}, lines {lines}\n{r.stderr[-3000:]}")
    for l in lines:
        if l["unit"] != "queries/s/gpu" or not l["value"] > 0:
            raise AssertionError(f"bench: {l}")
    note(f"bench: {len(lines)} lines in {dt:.1f}s (budget {budget:.0f}s)")
    return lines


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
    ops_line, k13, sass, add_latency = phase_probe_ops()
    say(ops_line)
    probe_line, probe_kernels = phase_probe_f64(sass, add_latency)
    say(probe_line)
    note("probes done")
    db, queries, build_s = build_world(65536)
    note(f"65k world built in {build_s:.1f}s")
    p65 = phase_path_65k(db, queries, build_s)
    per_ref_s = p65.pop("build_s_per_ref")
    say(p65)
    import copy

    from raxtax_tpu_torch.db.database import ensure_kmer_layout

    packed = ensure_kmer_layout(copy.copy(db), "packed")
    p65_dd, k7_on_path = phase_path_65k_dd(db, packed, queries)
    say(p65_dd)
    short = queries[: 2 * BATCH]
    say(phase_path_65k_split2_off(db, short))
    say(phase_path_65k_split_sig(db, packed, short))
    del packed
    say(phase_path_65k_descent_device(db, short))
    say(phase_path_65k_fold(db, queries, "stream"))
    say(phase_path_65k_fold(db, queries, "gathered"))
    say(phase_path_65k_xla(db, queries))
    del db
    say(phase_trace())
    kernels, p1m, p1m_dd, p1m_stream, p1m_gathered, p1m_xla, p1m_mesh = (
        phase_path_large(per_ref_s))
    per_ref_s_large = p1m["db_build_s"] / p1m["refs"]
    say(p1m)
    say(p1m_stream)
    say(p1m_gathered)
    say(p1m_dd)
    say(p1m_xla)
    say(p1m_mesh)
    say(phase_fuzz())
    note("fuzz done; the CLI in two ranks")
    say(phase_mesh_ranks_65k())
    note("mesh ranks done; the graft entry points")
    say(phase_dryrun())
    note("dry runs done; the bench")
    bench_lines = phase_bench()
    for line in bench_lines:
        say(line)
    say({"phase": "bench", "lines": len(bench_lines),
         "metrics": [l["metric"] for l in bench_lines]})
    note("bench done; the runtime / memory sweep")
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
    # K2 and K3 at 65,536 references (K2's path runs there), beside their
    # numbers at the large size
    for name, at_65k in (("fold_planes_sparse", p65_dd["fold_same_batch"]),
                         ("planes_hist", p65_dd["planes_hist_same_batch"])):
        next(k for k in kernels if k["name"] == name)["at_65k"] = at_65k
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
