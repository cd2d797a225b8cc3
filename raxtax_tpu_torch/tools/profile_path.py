"""Where a batch's time goes on the GPU: a ``torch.profiler`` trace of the
classify loop on a synthetic world.

    python -m raxtax_tpu_torch.tools.profile_path --refs 1000000 --batches 6
    python -m raxtax_tpu_torch.tools.profile_path --significance dd --fold sparse
    python -m raxtax_tpu_torch.tools.profile_path --fold stream
    python -m raxtax_tpu_torch.tools.profile_path --counts dense --refs 65536

Prints one JSON object: wall seconds of the profiled window, the device's
summed kernel milliseconds in it, host seconds per engine phase, and the
kernels by device time. Needs a GPU; there is no CPU mode.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import deque
from types import SimpleNamespace


def drive(clf, queries, B: int) -> list:
    """The three-deep submit / prepare / finalize loop over ``queries`` in
    batches of ``B``, as ``run_queries`` runs it; returns the results in
    query order."""
    done: list = []
    prepared: deque = deque()
    for lo in range(0, len(queries), B):
        st = clf.submit_batch(queries[lo : lo + B])
        if len(prepared) >= 2:
            done += clf.finalize_batch(prepared.popleft())
        prepared.append(clf.prepare_batch(st))
    while prepared:
        done += clf.finalize_batch(prepared.popleft())
    return done


def gpu_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def warm_classifier(db, queries, B: int, significance: str, fold: str,
                    bm_scan: bool = False, counts: str = "planes"):
    """A classifier of ``db`` in the given mode on the GPU, after one
    warm-up batch (kernels built, allocator warm, sticky flips taken), with
    its phase clocks at zero. ``counts="dense"`` is the ``xla`` backend and
    needs a database with the ref-major matrix."""
    import torch

    from ..engine.classify import make_classifier

    args = SimpleNamespace(
        backend="xla" if counts == "dense" else "auto", device="cuda",
        batch_size=B, debug_checks=False,
        tsv=True, skip_exact_matches=False, raw_confidence=False,
        significance=significance, fold=fold, bm_scan=bm_scan,
    )
    clf = make_classifier(db, args, n_queries_hint=len(queries))
    clf.classify_batch(queries[:B])
    torch.cuda.synchronize()
    for k in clf.phase_seconds:
        clf.phase_seconds[k] = 0.0
    return clf


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--refs", type=int, default=1_000_000)
    ap.add_argument("--batches", type=int, default=6)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--significance", choices=["exact", "dd", "auto"],
                    default="exact", help="the engine's significance mode")
    ap.add_argument("--fold", default="dense",
                    choices=["dense", "sparse", "gathered", "stream"])
    ap.add_argument("--counts", choices=["planes", "dense"], default="planes",
                    help="dense: the count matrix of the xla backend "
                    "(double-f32 significance, no fold)")
    ap.add_argument("--bm-scan", action="store_true",
                    help="dd mode: the bit-major scan (packed layout)")
    ap.add_argument("--trace", default="", help="also write a chrome trace here")
    a = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_path: no CUDA device available", file=sys.stderr)
        return 1
    from .synth import build_world

    gpu = gpu_line()
    B = a.batch_size
    db, queries, build_s = build_world(
        a.refs, B * (a.batches + 1), with_ref_major=a.counts == "dense"
    )
    if a.bm_scan:
        from ..db.database import ensure_kmer_layout

        db = ensure_kmer_layout(db, "packed")
    clf = warm_classifier(
        db, queries, B, a.significance, a.fold, a.bm_scan, a.counts
    )

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        done = len(drive(clf, queries[B:], B))
        torch.cuda.synchronize()
        wall_s = time.time() - t0
    if a.trace:
        prof.export_chrome_trace(a.trace)

    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        # device-side events only: the host-side operator that launched a
        # kernel reports the same device time again
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((ev.key, float(dev_us) / 1e3, int(ev.count)))
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    out = {
        "gpu": gpu, "refs": a.refs, "batch": B, "batches": a.batches,
        "significance": a.significance, "fold": a.fold, "bm_scan": a.bm_scan,
        "counts": a.counts,
        "fold_still_sparse": bool(clf._sparse), "host_replays": clf.host_replays,
        "queries": done, "db_build_s": round(build_s, 2),
        "wall_s": wall_s, "queries_per_s": done / wall_s,
        "device_busy_ms": busy_ms if rows else "not measured",
        "host_phase_s": dict(clf.phase_seconds),
        "device_ms_by_kernel": [
            {"name": n[:100], "ms": round(ms, 3), "calls": c}
            for n, ms, c in rows
        ],
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
