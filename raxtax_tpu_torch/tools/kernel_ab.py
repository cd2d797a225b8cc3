"""Two designs of K1 and K5 against each other, in turns, in one process.

    python -m raxtax_tpu_torch.tools.kernel_ab --other DIR [--other DIR2 ...]
        [--refs 1000000] [--rounds 2]

``DIR`` holds other sources of ``fold_planes.cu`` and ``exact_cumsum.cu``
(with the ``*.cuh`` headers they include), for example the csrc directory of
an earlier commit unpacked with ``git archive``. Each design is built by
``ops/_build.build_all`` into a directory of its own under the package's
build directory, with the package's ``nvcc`` flags, and bound by the same C
entry points and argument types as the package's kernels. The inputs are
those of ``chip_smoke.py``'s ``kernels`` phase (``tools/kernel_batch.py``):
the synthetic world at ``--refs`` references, one batch of 256 queries, K1's
planes and, from K3, the host model and K4 in f64, K5's tip probabilities.
Every design's output must be bit-equal to the package's; then each kernel is
timed by CUDA events (mean of ``REPS`` launches after a warm-up) with the
designs in the order package, others, others reversed, package,
``--rounds`` times. Prints one JSON line with every turn's time, the median
per design, each library's registers and spills from ``-Xptxas -v``, both
kernels' bounds and K5's chain floor (``kernel_batch.dadd_latency``). Needs
a GPU. Another kernel joins by an entry in ``KERNELS`` and its launch in
``main``'s ``run``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import sys
from pathlib import Path

#: the kernels: source stem -> C entry (argument types from the wrapper's
#: module, so a design is called exactly as the package calls its own)
KERNELS = {"fold_planes": "rx_fold_planes", "exact_cumsum": "rx_exact_cumsum"}
BATCH = 256  # queries, as in chip_smoke.py's kernels phase
REPS = 5  # launches per timed turn


def build(csrc: Path, out: Path) -> tuple[dict, dict]:
    """Every source of ``KERNELS`` under ``csrc``, built into ``out``: the
    entry points by stem, and nvcc's ``-Xptxas -v`` reading by stem."""
    from ..ops import _build, exactscan, intersect_fold

    argtypes = {"fold_planes": intersect_fold._ARGTYPES,
                "exact_cumsum": exactscan._ARGTYPES}
    _build.build_all(tuple(KERNELS), csrc, out)
    fns, usage = {}, {}
    for stem, entry in KERNELS.items():
        fn = getattr(ctypes.CDLL(str(_build._lib_path(stem, csrc, out))), entry)
        fn.restype, fn.argtypes = ctypes.c_int, argtypes[stem]
        fns[stem] = fn
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", required=True,
                    help="a directory with other sources of the two kernels")
    ap.add_argument("--refs", type=int, default=1_000_000)
    ap.add_argument("--rounds", type=int, default=2)
    a = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device available", file=sys.stderr)
        return 1
    from ..engine.device import DeviceClassifier
    from ..ops import _build
    from ..ops.exactscan import exact_cumsum
    from ..ops.intersect_fold import fold_planes
    from ..ops.planes import planes_histogram, planes_probs
    from .kernel_batch import (
        batch_inputs,
        dadd_latency,
        exact_cumsum_bounds,
        fold_planes_bounds,
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
        for stem in KERNELS:
            fns[label, stem] = built[stem]
            usage[f"{label}:{stem}"] = use[stem]

    db, queries, _ = build_world(a.refs, B)
    clf = DeviceClassifier.create(db, batch_size=B, device=dev)
    km3 = clf.state.kmer_major3
    kmer_idx, ks, k_pad, s_max, flat_k, off_k = batch_inputs(queries, B)
    d_idx = torch.from_numpy(kmer_idx).to(dev)
    d_ks = torch.from_numpy(ks).to(dev)
    planes = fold_planes(d_idx, d_ks, km3, max_count=k_pad)
    P = int(planes.shape[1])
    S, W = int(km3.shape[1]), int(km3.shape[1] * km3.shape[2])
    hist = planes_histogram(planes, s_max, db.num_tips)
    tab = torch.from_numpy(host_tables(hist, ks, s_max)).to(dev)
    p = planes_probs(planes, tab).reshape(B, -1).contiguous()
    N = int(p.shape[1])
    cum = exact_cumsum(p)
    stream = torch.cuda.current_stream().cuda_stream

    def run(label: str, stem: str):
        if stem == "fold_planes":
            out = torch.empty_like(planes)
            code = fns[label, stem](d_idx.data_ptr(), d_ks.data_ptr(),
                                    km3.data_ptr(), out.data_ptr(), B, k_pad,
                                    W, P - 4, stream)
        else:
            out = torch.empty_like(cum)
            code = fns[label, stem](p.data_ptr(), out.data_ptr(), B, N, stream)
        if code != 0:
            raise RuntimeError(f"{label} {stem}: CUDA error {code}")
        return out

    def same(x, y) -> bool:
        if x.dtype == torch.float64:
            x, y = x.view(torch.int64), y.view(torch.int64)
        return bool(torch.equal(x, y))

    for label in designs:
        if not same(run(label, "fold_planes"), planes):
            raise AssertionError(f"{label}: fold_planes differs from the package's")
        if not same(run(label, "exact_cumsum"), cum):
            raise AssertionError(f"{label}: exact_cumsum differs from the package's")
    del clf

    labels = list(designs)
    order = labels + labels[1:][::-1] + labels[:1]
    turns = {stem: {l: [] for l in labels} for stem in KERNELS}
    for _ in range(a.rounds):
        for stem in KERNELS:
            for label in order:
                turns[stem][label].append(
                    mean_ms(lambda: run(label, stem), REPS))
    lat = dadd_latency(dev)
    print(json.dumps({
        "gpu": gpu_line(), "refs": a.refs, "batch": B, "order": order,
        "reps": REPS, "rounds": a.rounds, "bits_equal": True,
        "fold_planes": {
            "shape": {"B": B, "k_pad": k_pad, "W": W, "P": P, "S": S},
            **fold_planes_bounds(kmer_idx, ks, flat_k, off_k, W, P),
            "turns_ms": turns["fold_planes"],
            "median_ms": {l: statistics.median(v)
                          for l, v in turns["fold_planes"].items()},
        },
        "exact_cumsum": {
            "shape": {"B": B, "N": N},
            **exact_cumsum_bounds(B, N),
            **lat, "chain_floor_ms": N * lat["dadd_latency_ns"] * 1e-6,
            "turns_ms": turns["exact_cumsum"],
            "median_ms": {l: statistics.median(v)
                          for l, v in turns["exact_cumsum"].items()},
            "ns_per_chain_step": {l: statistics.median(v) * 1e6 / N
                                  for l, v in turns["exact_cumsum"].items()},
        },
        "ptxas": usage,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
