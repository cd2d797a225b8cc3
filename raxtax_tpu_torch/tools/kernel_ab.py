"""Designs of K1, K2, K3, K5, K10, K6/K7 and of the probes K11-K13 against
each other, in turns, in one process.

    python -m raxtax_tpu_torch.tools.kernel_ab --other DIR [--other DIR2 ...]
        [--refs 1000000] [--rounds 2] [--cases fold_sparse,planes_hist,...]
        [--groups 1,2]
    python -m raxtax_tpu_torch.tools.kernel_ab --other DIR \
        --cases probe_f64,probe_f64_ew,probe_ops

``DIR`` holds other sources of ``fold_planes.cu``, ``fold_sparse.cu``,
``planes_hist.cu``, ``exact_cumsum.cu``, ``fold_stream.cu`` and
``dd_cumsum.cu`` (with the ``*.cuh`` headers they include), for example the
csrc directory of an earlier commit unpacked with ``git archive``. They
must export the package's C entry points with the package's argument lists
(``rx_dd_cumsum_scratch_words`` too): a design whose entry differs is given
a wrapper in its own copy. Each design is built by ``ops/_build.build_all``
into a directory of its own under the package's build directory, with the
package's ``nvcc`` flags, and bound with the argument types of the
package's wrappers. The inputs are those of ``chip_smoke.py``'s ``kernels``
phase (``tools/kernel_batch.py``): the synthetic world at ``--refs``
references with the sparse fold's block-padded matrix, one batch of 256
queries, K1's planes, K2's ``build_pairs`` lists with the pair budget
lifted (regrouped by ``group_pairs_by_block``; the line says whether the
engine's budget holds them), K10's pair lists of ``build_pairs``, and, from
K3 and the host model, K4's tip probabilities in f64 (K5) and f32 (K6 tip
order, K7 bit-major). K10 and K3 also run on a second batch whose queries
all come from one family (``kernel_batch.family_queries``: most rows shared
within a group), K10 at every group size of ``--groups``; K3 also on its two
extremes at the same shape, random planes (nearly every tip counts 16 or
more) and planes that spell one count at every tip. Every design's output
must be bit-equal to the package's (K2's and K10's to K1's planes of the
batch); then each case is timed by CUDA events (mean of ``REPS`` launches
after a warm-up) with the designs in the order package, others, others
reversed, package, ``--rounds`` times.
Prints one JSON line with every turn's time, the median and
``bound_share`` per design, each library's registers and spills from
``-Xptxas -v``, every case's bounds, K2's regroup time and K5's chain floor
(``kernel_batch.dadd_latency``). Needs a GPU. Another kernel joins by
entries in ``KERNELS`` and ``CASES`` and its launch in ``main``'s ``run``.

The probe cases (``PROBE_CASES``) run on their own, without the world, in
:func:`run_probes`: K12 (``probe_f64``) at 256 queries over 65,536 and
1,048,576 tips, K11 (``probe_f64_ew``) on the adversarial pairs of
``tools/probe_f64.py``, K13 (``probe_ops``) each chain at 5,000,000 steps.
Before timing, every design is held against the plain versions on
whole-space words (K12 at ragged tip counts, K13 at the step counts around
its unrolled loop) and against the package's design at the timed shapes.
Each design's floors come from its own library: K12's from its
``f64_add_full`` chain's latency, K13's from the dependent instructions a
step of its SASS (``tools/probe_ops.chain_sass``; an older design without
``CHAIN_UNROLL`` walks one step a trip) times one dependent integer
operation's latency, which the package's unrolled ``u32_add_x1`` chain
reads for every design.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import sys
from pathlib import Path
from types import SimpleNamespace

#: the kernel sources: stem -> C entry (argument types from the wrapper's
#: module, so a design is called exactly as the package calls its own)
KERNELS = {"fold_planes": "rx_fold_planes",
           "fold_sparse": "rx_fold_planes_sparse",
           "planes_hist": "rx_planes_hist", "exact_cumsum": "rx_exact_cumsum",
           "fold_stream": "rx_fold_stream", "dd_cumsum": "rx_dd_cumsum",
           "probe_f64": "rx_probe_f64_scan", "probe_ops": "rx_probe_op_chain"}
#: the timed cases: name -> source stem (K7 is the bit-major form of K6, K11
#: shares K12's source)
CASES = {"fold_planes": "fold_planes", "fold_sparse": "fold_sparse",
         "planes_hist": "planes_hist", "exact_cumsum": "exact_cumsum",
         "fold_stream": "fold_stream", "dd_cumsum": "dd_cumsum",
         "dd_cumsum_bitmajor": "dd_cumsum", "probe_f64": "probe_f64",
         "probe_f64_ew": "probe_f64", "probe_ops": "probe_ops"}
#: the cases that run without the world, by :func:`run_probes`
PROBE_CASES = ("probe_f64", "probe_f64_ew", "probe_ops")
PROBE_TIPS = (65_536, 1_048_576)  # K12's tips (tools/probe_f64.SCRIPT_TIPS)
PROBE_PAIRS = 17_000_000  # K11's adversarial pairs, as chip_smoke.py draws
PROBE_ITERS = 5_000_000  # K13's steps, the TPU probe's count
BATCH = 256  # queries, as in chip_smoke.py's kernels phase
REPS = 5  # launches per timed turn


def package_argtypes(stem: str) -> list:
    from ..ops import (
        exactf64,
        exactscan,
        intersect_fold,
        intersect_stream,
        opchain,
        planes,
    )

    return {"fold_planes": intersect_fold._ARGTYPES,
            "fold_sparse": intersect_fold._SPARSE_ARGTYPES,
            "planes_hist": planes._HIST_ARGTYPES,
            "exact_cumsum": exactscan._ARGTYPES,
            "fold_stream": intersect_stream._STREAM_ARGTYPES,
            "dd_cumsum": planes._DD_ARGTYPES,
            "probe_f64": exactf64._SCAN_ARGTYPES,
            "probe_ops": opchain._ARGTYPES}[stem]


def build(csrc: Path, out: Path) -> tuple[dict, dict]:
    """Every source of ``KERNELS`` under ``csrc``, built into ``out``: the
    entry points by stem (and K6/K7's scratch size as
    ``dd_cumsum_scratch``, K11 as ``probe_f64_ew``), and nvcc's ``-Xptxas
    -v`` reading by stem."""
    from ..ops import _build, exactf64, planes

    _build.build_all(tuple(KERNELS), csrc, out)
    fns, usage = {}, {}
    for stem, entry in KERNELS.items():
        lib = ctypes.CDLL(str(_build._lib_path(stem, csrc, out)))
        fn = getattr(lib, entry)
        fn.restype, fn.argtypes = ctypes.c_int, package_argtypes(stem)
        fns[stem] = fn
        if stem == "dd_cumsum":
            f = lib.rx_dd_cumsum_scratch_words
            f.restype, f.argtypes = ctypes.c_longlong, planes._DD_SCRATCH_ARGTYPES
            fns["dd_cumsum_scratch"] = f
        if stem == "probe_f64":
            f = lib.rx_probe_f64_ew
            f.restype, f.argtypes = ctypes.c_int, exactf64._EW_ARGTYPES
            fns["probe_f64_ew"] = f
        log = out / f"{stem}.nvcc.log"
        usage[stem] = ptxas_usage(log.read_text()) if log.is_file() else []
    return fns, usage


def ptxas_usage(log: str) -> list[dict]:
    """Registers, spill bytes and shared memory per kernel entry from
    nvcc's ``-Xptxas -v`` output (the sm_90a lines)."""
    rows, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)' for 'sm_90a'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            rows.append({"kernel": name, "spill_store_bytes": int(m.group(1)),
                         "spill_load_bytes": int(m.group(2))})
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name and rows and rows[-1]["kernel"] == name:
            rows[-1]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            rows[-1]["static_smem_bytes"] = int(s.group(1)) if s else 0
    return rows


def mean_ms(fn, reps: int) -> float:
    import torch

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


def turns_of(keys, labels, rounds: int, fn) -> dict:
    """CUDA-event times of ``fn(label, *key)`` for every key, the designs
    in the order package, others, others reversed, package, ``rounds``
    times: ``{key: {label: [ms, ...]}}``."""
    order = labels + labels[1:][::-1] + labels[:1]
    turns = {key: {l: [] for l in labels} for key in keys}
    for _ in range(rounds):
        for key in keys:
            for label in order:
                turns[key][label].append(fn(label, *key))
    return turns


def design_unroll(csrc: Path) -> int:
    """K13's steps a trip of the main loop in the design under ``csrc``
    (``CHAIN_UNROLL``; 1 for a design without it)."""
    m = re.search(r"CHAIN_UNROLL\s*=\s*(\d+)", (csrc / "probe_ops.cu").read_text())
    return int(m.group(1)) if m else 1


def run_probes(cases, designs: dict, fns: dict, rounds: int) -> dict:
    """The probe cases of every design, in turns (see the module's note):
    one JSON-ready dict with each case's turns, medians, bounds and floors
    per design, and each design's SASS counts and add latency."""
    import numpy as np
    import torch

    from ..ops import _build
    from ..ops import exactf64 as xf
    from ..ops.opchain import CHAINS, probe_op_chain_plain, probe_state
    from . import probe_f64 as pf
    from . import probe_ops as po
    from .kernel_batch import (
        dependent_op_ns,
        op_chain_bounds,
        probe_ew_bounds,
        probe_scan_bounds,
    )
    from .profile_path import gpu_line

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    labels = list(designs)

    def ok(code: int, what: str):
        if code != 0:
            raise RuntimeError(f"{what}: CUDA error {code}")

    def scan(label, ph, pl):
        oh, ol = torch.empty_like(ph), torch.empty_like(pl)
        ok(fns[label, "probe_f64"](ph.data_ptr(), pl.data_ptr(), oh.data_ptr(),
                                   ol.data_ptr(), ph.shape[0], ph.shape[1],
                                   stream), f"{label} probe_f64")
        return oh, ol

    def ew(label, halves):
        outs = [torch.empty_like(halves[0]) for _ in range(4)]
        ok(fns[label, "probe_f64_ew"](*(t.data_ptr() for t in halves),
                                      *(o.data_ptr() for o in outs),
                                      halves[0].numel(), stream),
           f"{label} probe_f64_ew")
        return tuple(outs)

    def chain(label, name, x, y, iters):
        out = torch.empty_like(x)
        ok(fns[label, "probe_ops"](CHAINS.index(name), x.data_ptr(),
                                   y.data_ptr(), out.data_ptr(), x.numel(),
                                   iters, stream), f"{label} probe_ops")
        return out

    def same(x, y) -> bool:
        return all(bool(torch.equal(u, v)) for u, v in zip(x, y))

    # every design against the plain versions on whole-space words
    words = pf.whole_space_halves((1 << 16,), dev, 3)
    want_ew = xf.probe_f64_ew_plain(*words)
    wx, wy = po.whole_space_state(dev, 4)
    shapes = ((2, 1), (2, xf.SCAN_TILE - 1), (2, xf.SCAN_TILE + 1),
              (1, 3 * xf.SCAN_TILE + 5))
    for label in labels:
        if "probe_f64_ew" in cases and not same(ew(label, words), want_ew):
            raise AssertionError(f"{label}: K11 differs on whole-space words")
        for G, N in shapes if "probe_f64" in cases else ():
            ph, pl, _, _ = pf.whole_space_halves((G, N, 128), dev, N)
            if not same(scan(label, ph, pl), xf.probe_f64_scan_plain(ph, pl)):
                raise AssertionError(f"{label}: K12 differs at {G} x {N}")
        for name in CHAINS if "probe_ops" in cases else ():
            for n in po.EDGE_ITERS:
                if not torch.equal(chain(label, name, wx, wy, n),
                                   probe_op_chain_plain(name, wx, wy, n)):
                    raise AssertionError(f"{label}: {name} differs at {n} steps")

    # the timed inputs, and every design against the package's on them
    keys, run = [], {}
    if "probe_f64" in cases:
        for N in PROBE_TIPS:
            ph, pl = xf.to_lane_groups(pf.scan_inputs(BATCH, N, dev, seed=N))
            keys.append(("probe_f64", N))
            run["probe_f64", N] = lambda l, ph=ph, pl=pl: scan(l, ph, pl)
    if "probe_f64_ew" in cases:
        a, b = pf.adversarial_pairs(np.random.default_rng(0), PROBE_PAIRS)
        halves = [torch.from_numpy(x.view(np.int32)).to(dev)
                  for x in (*xf.split64(a), *xf.split64(b))]
        n_pairs = int(a.size)
        keys.append(("probe_f64_ew",))
        run["probe_f64_ew",] = lambda l: ew(l, halves)
    x, y = probe_state(dev)
    if "probe_ops" in cases:
        for name in CHAINS:
            keys.append(("probe_ops", name))
            run["probe_ops", name] = (
                lambda l, name=name: chain(l, name, x, y, PROBE_ITERS))
    for key in keys:
        want = run[key]("tree")
        for label in labels[1:]:
            got = run[key](label)
            if not same(got if isinstance(got, tuple) else (got,),
                         want if isinstance(want, tuple) else (want,)):
                raise AssertionError(f"{label}: {key} differs from the package's")
    torch.cuda.synchronize()

    # REPS launches a turn; K13's chains one (each is 0.05-0.6 s)
    turns = turns_of(keys, labels, rounds, lambda l, *key: mean_ms(
        lambda: run[key](l), 1 if key[0] == "probe_ops" else REPS))

    # each design's floors: its SASS, its add's latency
    sass, lat, ipp = {}, {}, {}
    for i, label in enumerate(labels):
        out = _build.BUILD_DIR / "ab" / str(i)
        sass[label] = po.chain_sass(
            po.library_sass("probe_ops", designs[label], out),
            design_unroll(designs[label]))
        ipp[label] = po.ew_instructions_per_pair(
            po.library_sass("probe_f64", designs[label], out))
        short, long_ = (statistics.median(
            mean_ms(lambda: chain(label, "f64_add_full", x, y, n), 1)
            for _ in range(3)) for n in (1 << 20, 4 << 20))
        lat[label] = (long_ - short) * 1e6 / (3 << 20)

    line = {"gpu": gpu_line(), "batch": BATCH, "rounds": rounds,
            "order": labels + labels[1:][::-1] + labels[:1],
            "bits_equal": True, "whole_space_scan_shapes": shapes,
            "f64_add_latency_ns": lat, "sass": sass,
            "k11_instructions_per_pair": ipp}
    med = {key: {l: statistics.median(v) for l, v in t.items()}
           for key, t in turns.items()}
    if "probe_f64" in cases:
        line["probe_f64"] = {}
        for N in PROBE_TIPS:
            b = {l: probe_scan_bounds(BATCH, N,
                                      sass[l]["f64_add_full"]["instructions_per_step"],
                                      lat[l]) for l in labels}
            m = med["probe_f64", N]
            line["probe_f64"][N] = {
                "turns_ms": turns["probe_f64", N], "median_ms": m,
                "bounds": b,
                "bound_share": {l: b[l]["bound_ms"] / m[l] for l in labels},
                "chain_floor_share": {l: b[l]["chain_floor_ms"] / m[l]
                                      for l in labels},
                "ns_per_chain_step": {l: m[l] * 1e6 / N for l in labels}}
    if "probe_f64_ew" in cases:
        m = med["probe_f64_ew",]
        b = {l: probe_ew_bounds(n_pairs, ipp[l]) for l in labels}
        line["probe_f64_ew"] = {
            "pairs": n_pairs, "turns_ms": turns["probe_f64_ew",],
            "median_ms": m, "bounds": b,
            "bound_share": {l: b[l]["bound_ms"] / m[l] for l in labels}}
    if "probe_ops" in cases:
        per = {c: {l: med["probe_ops", c][l] for l in labels} for c in CHAINS}
        total = {l: sum(per[c][l] for c in CHAINS) for l in labels}
        # one dependent operation's latency, from the package's unrolled
        # u32_add_x1 chain (an older design's one-step trips time the trip)
        op_ns = dependent_op_ns(per["u32_add_x1"]["tree"] * 1e6 / PROBE_ITERS,
                                sass["tree"])
        b = {l: op_chain_bounds(sass[l], x.numel(), PROBE_ITERS, op_ns)
             for l in labels}
        line["probe_ops"] = {
            "iters": PROBE_ITERS,
            "turns_ms": {c: turns["probe_ops", c] for c in CHAINS},
            "median_ms": per, "total_ms": total,
            "ns_per_iter": {c: {l: per[c][l] * 1e6 / PROBE_ITERS
                                for l in labels} for c in CHAINS},
            "bounds": b,
            "bound_share": {l: b[l]["bound_ms"] / total[l] for l in labels},
            "chain_floor_share": {l: b[l]["chain_floor_ms"] / total[l]
                                  for l in labels}}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", required=True,
                    help="a directory with other sources of the kernels")
    ap.add_argument("--refs", type=int, default=1_000_000)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--cases",
                    default=",".join(c for c in CASES if c not in PROBE_CASES),
                    help="comma-separated cases to time (default: all but "
                    "the probes, which run on their own)")
    ap.add_argument("--groups", default="1,2",
                    help="K10's group sizes, each timed on both batches")
    a = ap.parse_args(argv)
    cases = [c for c in a.cases.split(",") if c]
    if not set(cases) <= set(CASES):
        ap.error(f"--cases: one of {', '.join(CASES)}")
    probes = [c for c in cases if c in PROBE_CASES]
    if probes and len(probes) != len(cases):
        ap.error("--cases: the probe cases run on their own")
    groups = [int(g) for g in a.groups.split(",") if g]

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device available", file=sys.stderr)
        return 1
    from ..engine.device import (
        SPARSE_BUDGET_MIN,
        SPARSE_CROSSOVER_DIV,
        DeviceClassifier,
    )
    from ..ops import _build, intersect_fold as fo, intersect_stream as st
    from ..ops import planes as pl
    from ..ops.exactscan import exact_cumsum
    from .kernel_batch import (
        batch_inputs,
        batch_probs32,
        dadd_latency,
        dd_cumsum_bounds,
        exact_cumsum_bounds,
        family_queries,
        fold_planes_bounds,
        fold_sparse_bounds,
        fold_stream_bounds,
        group_row_loads,
        planes_hist_bounds,
        tail_tips,
    )
    from .profile_path import gpu_line
    from .profile_stages import host_tables
    from .synth import build_world

    dev = torch.device("cuda")
    B = BATCH
    designs = {"tree": _build.CSRC, **{str(d): Path(d) for d in a.other}}
    fns, usage = {}, {}
    for i, (label, csrc) in enumerate(designs.items()):
        built, use = build(csrc, _build.BUILD_DIR / "ab" / str(i))
        for stem, fn in built.items():
            fns[label, stem] = fn
        for stem in KERNELS:
            usage[f"{label}:{stem}"] = use[stem]
    if probes:
        line = run_probes(probes, designs, fns, a.rounds)
        line["ptxas"] = {k: v for k, v in usage.items()
                         if k.split(":")[-1] in {CASES[c] for c in probes}}
        print(json.dumps(line), flush=True)
        return 0

    db, queries, _ = build_world(a.refs, B)
    # the sparse fold's block-padded matrix; every fold reads it (at 65,536
    # and 1M references it is the dense fold's matrix too)
    clf = DeviceClassifier.create(db, batch_size=B, device=dev, fold="sparse")
    km3 = clf.state.kmer_major3
    S, W = int(km3.shape[1]), int(km3.shape[1] * km3.shape[2])

    def batch_of(qs) -> SimpleNamespace:
        idx, ks, k_pad, s_max, flat, off = batch_inputs(qs, B)
        d_idx = torch.from_numpy(idx).to(dev)
        planes = fo.fold_planes(d_idx, torch.from_numpy(ks).to(dev), km3,
                                max_count=k_pad)
        return SimpleNamespace(idx=idx, ks=ks, k_pad=k_pad, s_max=s_max,
                               flat=flat, off=off, d_idx=d_idx, planes=planes,
                               n_tips=db.num_tips)

    # the world's batch (one query per family) and, for K10 and K3, one
    # family's
    batches = {"world": batch_of(queries)}
    if {"fold_stream", "planes_hist"} & set(cases):
        batches["family"] = batch_of(family_queries(B))
    wb = batches["world"]
    d_ks = torch.from_numpy(wb.ks).to(dev)
    planes = wb.planes
    P = int(planes.shape[1])
    if "planes_hist" in cases:
        # K3's two extremes at the world batch's shape, without pad tips:
        # random planes (nearly every tip 16 or more, the counts spread;
        # s_max = 2^P keeps them all) and planes that spell one count, 300,
        # at every tip (every tip in the tail, all on one bucket)
        gen = torch.Generator(device=dev).manual_seed(7)
        rand = torch.randint(-(2**31), 2**31, tuple(planes.shape),
                             dtype=torch.int32, device=dev, generator=gen)
        one = torch.zeros_like(planes)
        one[:, [q for q in range(P) if (300 >> q) & 1]] = -1
        batches["random"] = SimpleNamespace(planes=rand, s_max=1 << P,
                                            n_tips=W * 32, k_pad=None)
        batches["one_count"] = SimpleNamespace(planes=one, s_max=wb.s_max,
                                               n_tips=W * 32, k_pad=None)
    hist = pl.planes_histogram(planes, wb.s_max, db.num_tips)
    tab = torch.from_numpy(host_tables(hist, wb.ks, wb.s_max)).to(dev)
    p = pl.planes_probs(planes, tab).reshape(B, -1).contiguous()
    N = int(p.shape[1])
    cum = exact_cumsum(p) if "exact_cumsum" in cases else None
    del tab
    probs32 = batch_probs32(planes, hist, wb.ks, wb.s_max)  # [B, 32, S, 128]
    flat32 = probs32.reshape(B, -1)  # tip order of the flat layout
    want = {}
    if "dd_cumsum" in cases:
        want["dd_cumsum"] = tuple(t[:, 1:] for t in pl.dd_cumsum(flat32))
    if "dd_cumsum_bitmajor" in cases:
        want["dd_cumsum_bitmajor"] = tuple(
            t[:, 1:] for t in pl.dd_cumsum_bitmajor(probs32))
    sparse = None
    if "fold_sparse" in cases:
        # the budget lifted, as chip_smoke.py's fold_compare lifts it
        pk, pb, max_pairs, totals = fo.build_pairs(
            wb.idx, clf.state.blk_ptr, clf.state.blk_ids, budget=1 << 40)
        d_pk, d_pb = torch.from_numpy(pk).to(dev), torch.from_numpy(pb).to(dev)
        d_tot = torch.from_numpy(totals.astype(np.int32)).to(dev)

        def regroup():
            return fo.group_pairs_by_block(d_pk, d_pb, d_tot,
                                           S // fo.BLOCK_SUB)

        kb, blk_off = regroup()
        budget = max(SPARSE_BUDGET_MIN, wb.k_pad * S // SPARSE_CROSSOVER_DIV)
        sparse = SimpleNamespace(
            kb=kb, blk_off=blk_off, p_pad=int(pk.shape[1]),
            bounds=fold_sparse_bounds(pk, pb, totals, W, P),
            info={"pairs_per_query_max": max_pairs, "engine_budget": budget,
                  "within_engine_budget": max_pairs <= budget,
                  "regroup_ms": mean_ms(regroup, REPS)})
    pair_cache = {}

    def pairs_for(batch: str, group: int):
        if (batch, group) not in pair_cache:
            q, r, lo, hi = st.build_pairs(batches[batch].d_idx, group)
            pair_cache[batch, group] = (((q % group) << st.ROW_BITS) | r, lo, hi)
        return pair_cache[batch, group]

    stream = torch.cuda.current_stream().cuda_stream

    def run_stream(label: str, batch: str, group: int):
        packed, lo, hi = pairs_for(batch, group)
        ref = batches[batch].planes
        out = torch.empty_like(ref)
        code = fns[label, "fold_stream"](
            packed.data_ptr(), lo.data_ptr(), hi.data_ptr(), km3.data_ptr(),
            out.data_ptr(), B, int(ref.shape[1]), W, group, stream)
        return code, out

    def run_hist(label: str, batch: str):
        bt = batches[batch]
        out = torch.zeros((B, bt.s_max), dtype=torch.int32, device=dev)
        code = fns[label, "planes_hist"](
            bt.planes.data_ptr(), out.data_ptr(), B, int(bt.planes.shape[1]),
            W, bt.s_max, bt.n_tips, stream)
        return code, out

    def run_dd(label: str, x, rows: int, bitmajor: bool):
        pad, words = pl.DD_OUT_PAD, fns[label, "dd_cumsum_scratch"]
        scratch = torch.empty(words(B, N, rows, 0), dtype=torch.int32,
                              device=dev)
        scratch[: words(B, N, rows, 1)].zero_()
        hi = torch.empty((B, N + pad), dtype=torch.float32, device=dev)
        lo = torch.empty_like(hi)
        code = fns[label, "dd_cumsum"](
            x.data_ptr(), hi.data_ptr(), lo.data_ptr(), B, N, rows,
            int(bitmajor), N + pad, pad, scratch.data_ptr(), stream)
        return code, (hi[:, pad:], lo[:, pad:])

    def run(label: str, case: str, batch: str = "world",
            group: int = st.stream_group_size(B, P)):
        if case == "fold_planes":
            out = torch.empty_like(planes)
            code = fns[label, case](wb.d_idx.data_ptr(), d_ks.data_ptr(),
                                    km3.data_ptr(), out.data_ptr(), B,
                                    wb.k_pad, W, P - 4, stream)
        elif case == "fold_sparse":
            out = torch.empty_like(planes)
            code = fns[label, case](sparse.kb.data_ptr(),
                                    sparse.blk_off.data_ptr(), km3.data_ptr(),
                                    out.data_ptr(), B, sparse.p_pad, W, P,
                                    stream)
        elif case == "planes_hist":
            code, out = run_hist(label, batch)
        elif case == "exact_cumsum":
            out = torch.empty_like(cum)
            code = fns[label, case](p.data_ptr(), out.data_ptr(), B, N, stream)
        elif case == "fold_stream":
            code, out = run_stream(label, batch, group)
        elif case == "dd_cumsum":
            code, out = run_dd(label, flat32, min(N // 128, pl.DD_TILE_ROWS),
                               False)
        else:
            code, out = run_dd(label, probs32,
                               min(N // 128, pl.DD_TILE_ROWS_BITMAJOR), True)
        if code != 0:
            raise RuntimeError(f"{label} {case}: CUDA error {code}")
        return out

    def same(x, y) -> bool:
        if isinstance(x, tuple):
            return all(same(u, v) for u, v in zip(x, y))
        if x.dtype.is_floating_point:
            it = torch.int64 if x.dtype == torch.float64 else torch.int32
            x, y = x.view(it), y.view(it)
        return bool(torch.equal(x, y))

    # every timed key: (case,), (case, batch) or ("fold_stream", batch, group)
    keys = []
    for case in cases:
        if case == "fold_stream":
            keys += [(case, b, g) for b in ("world", "family") for g in groups]
        elif case == "planes_hist":
            keys += [(case, b) for b in batches]
        else:
            keys.append((case,))

    def reference(key):
        case, batch = key[0], key[1] if len(key) > 1 else "world"
        if case in ("fold_planes", "fold_sparse", "fold_stream"):
            return batches[batch].planes  # K1's planes of the batch
        if case == "planes_hist":
            bt = batches[batch]
            return pl.planes_histogram(bt.planes, bt.s_max, bt.n_tips)
        return cum if case == "exact_cumsum" else want[case]

    for label in designs:
        for key in keys:
            if not same(run(label, *key), reference(key)):
                raise AssertionError(
                    f"{label}: {key} differs from the package's")
    del clf

    labels = list(designs)
    order = labels + labels[1:][::-1] + labels[:1]
    turns = turns_of(keys, labels, a.rounds,
                     lambda label, *key: mean_ms(lambda: run(label, *key), REPS))

    group = st.stream_group_size(B, P)

    def bounds_of(key) -> dict:
        case = key[0]
        bt = batches[key[1] if len(key) > 1 else "world"]
        if case == "fold_planes":
            return fold_planes_bounds(bt.idx, bt.ks, bt.flat, bt.off, W, P)
        if case == "fold_sparse":
            return {**sparse.bounds, **sparse.info}
        if case == "planes_hist":
            return planes_hist_bounds(B, int(bt.planes.shape[1]), W, bt.s_max,
                                      tail_tips(bt.planes))
        if case == "exact_cumsum":
            return exact_cumsum_bounds(B, N)
        if case in ("dd_cumsum", "dd_cumsum_bitmajor"):
            return dd_cumsum_bounds(B, N)
        g = key[2]
        return {
            **fold_stream_bounds(bt.idx, bt.ks, bt.flat, bt.off, W,
                                 int(bt.planes.shape[1]), B * bt.k_pad,
                                 -(-B // g)),
            "row_loads": group_row_loads(bt.idx, bt.ks, g),
        }

    shapes = {
        "fold_planes": {"B": B, "k_pad": wb.k_pad, "W": W, "P": P, "S": S},
        "fold_sparse": {"B": B, "W": W, "P": P,
                        "blocks": S // fo.BLOCK_SUB,
                        "p_pad": sparse.p_pad if sparse else None},
        "planes_hist": {"B": B, "W": W},
        "exact_cumsum": {"B": B, "N": N},
        "dd_cumsum": {"B": B, "N": N, "tile_rows": pl.DD_TILE_ROWS},
        "dd_cumsum_bitmajor": {"B": B, "N": N,
                               "tile_rows": pl.DD_TILE_ROWS_BITMAJOR},
        "fold_stream": {"B": B, "W": W, "slice_bytes": 512,
                        "engine_group": group},
    }
    line = {"gpu": gpu_line(), "refs": a.refs, "batch": B, "order": order,
            "reps": REPS, "rounds": a.rounds, "bits_equal": True}

    def summary(key) -> dict:
        med = {l: statistics.median(v) for l, v in turns[key].items()}
        b = bounds_of(key)
        return {**b, "turns_ms": turns[key], "median_ms": med,
                "bound_share": {l: b["bound_ms"] / m for l, m in med.items()}}

    for case in cases:
        mine = [k for k in keys if k[0] == case]
        if len(mine[0]) == 1:
            line[case] = {"shape": shapes[case], **summary(mine[0])}
            continue
        # one entry per batch (and K10's group); the engine's group on the
        # world's batch is K10's headline
        entries = {}
        for key in mine:
            bt = batches[key[1]]
            name = key[1] if len(key) == 2 else f"{key[1]}, groups of {key[2]}"
            entries[name] = {"k_pad": bt.k_pad, "s_max": bt.s_max,
                             "num_tips": bt.n_tips,
                             "P": int(bt.planes.shape[1]), **summary(key)}
        line[case] = {"shape": shapes[case], **entries}
    if "exact_cumsum" in cases:
        lat = dadd_latency(dev)
        med = line["exact_cumsum"]["median_ms"]
        line["exact_cumsum"].update(
            **lat, chain_floor_ms=N * lat["dadd_latency_ns"] * 1e-6,
            ns_per_chain_step={l: m * 1e6 / N for l, m in med.items()})
    line["ptxas"] = usage
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
