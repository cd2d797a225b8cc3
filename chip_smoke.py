#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``raxtax_tpu_torch``).

Run ``python3 chip_smoke.py`` from the repository root on a machine with one
NVIDIA Hopper GPU, the CUDA toolkit (``nvcc``) and PyTorch built for CUDA.
It needs no arguments, no network and no JAX. It

1. builds the four CUDA kernels from ``raxtax_tpu_torch/csrc`` (``env``),
2. drives the classify path end to end on a 65,536-reference synthetic
   database through ``run_queries`` and checks the output files against the
   host oracle, for every flag combination (``path_65k``),
3. builds the 1,000,000-reference database (or the largest of 1M / 500k /
   200k that fits the time budget), runs each kernel at that size against
   its plain PyTorch version, bit for bit, and times both (``kernels``),
4. drives the classify path at that size, checks it against the oracle and
   reports throughput, phase times and peak memory (``path_1m``).

Each phase prints one JSON line; the ``kernels`` line carries, per kernel,
its launches on the main path, its time, its plain version's time and its
bound on this card. Any failed phase raises, so the exit code is non-zero
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


def args_for(skip: bool = False, raw: bool = False):
    """The parsed command line of ``raxtax-torch --tsv --batch-size 256
    --debug-checks`` (output prefix and database path are set per run)."""
    return SimpleNamespace(
        backend="auto", device="cuda", batch_size=BATCH, debug_checks=True,
        tsv=True, skip_exact_matches=skip, raw_confidence=raw, redo=True,
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
    from raxtax_tpu_torch.ops.intersect_fold import fold_planes
    from raxtax_tpu_torch.ops.planes import planes_histogram, planes_probs

    return {
        "fold_planes": fold_planes, "planes_hist": planes_histogram,
        "planes_probs": planes_probs, "exact_cumsum": exact_cumsum,
    }


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


def phase_path_65k() -> dict:
    from raxtax_tpu_torch.engine.classify import make_classifier

    db, queries, build_s = build_world(65536)
    note(f"65k world built in {build_s:.1f}s")
    reset_counts()
    outs, tsvs, dt = run_path(db, queries, args_for())
    counts = read_counts()
    if set(outs) != {l for l, _ in queries}:
        raise AssertionError("path_65k: not every query has output lines")
    checked = check_oracle(db, queries, outs, tsvs, 16)
    if min(counts.values()) <= 0:
        raise AssertionError(f"path_65k: a kernel was never launched: {counts}")
    # every flag combination on one batch; half of the compared queries are
    # exact copies of references, so the exact-match policy is exercised
    combos = []
    for skip in (False, True):
        for raw in (False, True):
            batch = list(queries[:BATCH])
            for j in range(4):
                tip = (j * 7919) % db.num_tips
                batch[j] = (f"x{j}", np.array(db.sequence(tip)))
            a = args_for(skip=skip, raw=raw)
            clf = make_classifier(db, a, n_queries_hint=len(batch))
            res = clf.classify_batch(batch)
            o = {r.label: r.out_string() for r in res}
            t = {r.label: r.tsv_string() for r in res}
            check_oracle(db, batch, o, t, 8, skip=skip, raw=raw)
            combos.append({"skip_exact": skip, "raw_conf": raw, "checked": 8})
            del clf
    torch.cuda.empty_cache()
    return {
        "phase": "path_65k", "refs": 65536, "queries": len(queries),
        "batch": BATCH, "db_build_s": round(build_s, 2),
        "pass_s": round(dt, 3), "queries_per_s": round(len(queries) / dt, 2),
        "oracle_checked": checked, "flag_combos": combos, "launches": counts,
        "build_s_per_ref": build_s / 65536,
    }


def phase_kernels(db, queries, state) -> list[dict]:
    """Each kernel at the large database's shapes, B = 256, against its
    plain version on the same inputs (tolerance 0: integers and f64 bit
    patterns), with times and bounds."""
    from raxtax_tpu_torch import native
    from raxtax_tpu_torch.ops import exactscan, intersect_fold, planes as pl
    from raxtax_tpu_torch.prob.model import KTableCache, normalized_size_probs

    dev = state.device
    chunk = queries[:BATCH]
    seqs = [s for _, s in chunk]
    flat_k, off_k = native.distinct_kmers_flat(seqs)
    ks = np.diff(off_k[: BATCH + 1]).astype(np.int32)
    k_pad = -(-int(ks.max()) // 128) * 128
    s_max = -(-(int(ks.max()) + 1) // 128) * 128
    kmer_idx = np.full((BATCH, k_pad), intersect_fold.PAD_ROW, np.int32)
    mask = np.arange(k_pad)[None, :] < ks[:, None]
    kmer_idx[mask] = flat_k[: off_k[BATCH]]
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
    hist_h = hist.cpu().numpy()
    cache = KTableCache()
    table64 = np.zeros((BATCH, s_max), np.float64)
    for b in range(BATCH):
        ps, _ = normalized_size_probs(hist_h[b], int(ks[b]), cache)
        table64[b, : ps.shape[0]] = ps
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
    return out


def phase_path_large(per_ref_s: float):
    from raxtax_tpu_torch.engine.classify import make_classifier

    # DB build + kernels phase (plain versions included) + classify pass +
    # oracle: keep what is left of the budget for all of them
    n_refs = 200_000
    for cand in (1_000_000, 500_000):
        est = 3.0 * per_ref_s * cand + 150.0 + 1.5e-4 * cand
        if est < remaining():
            n_refs = cand
            break
    note(f"large phase: {n_refs} references ({remaining():.0f}s of budget left)")
    db, queries, build_s = build_world(n_refs)
    note(f"{n_refs} world built in {build_s:.1f}s")
    torch.cuda.reset_peak_memory_stats()
    a = args_for()
    t0 = time.time()
    clf = make_classifier(db, a, n_queries_hint=len(queries))
    torch.cuda.synchronize()
    upload_s = time.time() - t0
    kernels = phase_kernels(db, queries, clf.state)
    torch.cuda.empty_cache()
    note("kernels compared; driving the path")
    clf.classify_batch(queries[:BATCH])  # warm-up batch: allocator, tables
    torch.cuda.synchronize()
    for k in clf.phase_seconds:
        clf.phase_seconds[k] = 0.0
    reset_counts()
    outs, tsvs, dt = run_path(db, queries, a, classifier=clf)
    torch.cuda.synchronize()
    counts = read_counts()
    if set(outs) != {l for l, _ in queries}:
        raise AssertionError("path_1m: not every query has output lines")
    for k in kernels:
        k["launches"] = counts[k["name"]]
        if k["launches"] <= 0:
            raise AssertionError(f"path_1m never launched {k['name']}")
    n_batches = -(-len(queries) // clf.batch_size)
    checked = check_oracle(db, queries, outs, tsvs, 5)
    line = {
        "phase": "path_1m", "refs": n_refs, "queries": len(queries),
        "batch": clf.batch_size, "db_build_s": round(build_s, 2),
        "upload_s": round(upload_s, 2), "pass_s": round(dt, 3),
        "queries_per_s": round(len(queries) / dt, 2),
        "phase_ms_per_batch": {
            k: round(v * 1e3 / n_batches, 2)
            for k, v in clf.phase_seconds.items()
        },
        "oracle_checked": checked,
        "peak_gpu_bytes": int(torch.cuda.max_memory_allocated()),
        "launches": counts,
    }
    return kernels, line


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    env = phase_env()
    say(env)
    p65 = phase_path_65k()
    per_ref_s = p65.pop("build_s_per_ref")
    say(p65)
    kernels, p1m = phase_path_large(per_ref_s)
    say(p1m)
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
