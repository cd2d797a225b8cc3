"""Fine-grained timing of the prepare / finalize sub-steps at bench scale.

``diag_engine.py`` times whole phases; this breaks ``prepare_batch`` and
``finalize_batch`` into their parts, each followed by a device
synchronisation, so an optimisation target is a measured line, not a guess.
The steps are the JAX package's ``scripts/probe_prepare.py`` A-K under the
names of the port's counterparts:

    A.submit_dispatch       submit_batch (host k-mers, fold + histogram queued)
    B.fold+hist_device      torch.cuda.synchronize(): the fold and K3 on the device
    C.compress_dispatch     compress_planes (dd path, before the full-width flip)
    D.compress_device       synchronize: K8 + nonzero
    E.hist_pull             the histogram from its pinned host buffer
    F.prob_model_host       DeviceClassifier._host_model (the f64 tables)
    G.significant_dispatch  DeviceClassifier._dispatch_significance
    H.significance_device   synchronize: K4, the scan, the masks
    J.significant_pull      SignificantSet(.DD).pull: compaction + copy out
    K.finalize_all          finalize_batch on a normally prepared batch, split
                            into its phase clocks (pull, descend, eval)

``I.pack_dispatch`` has no counterpart: the port compacts with ``nonzero``
and pulls directly (``pack_significant`` was replaced, not ported), so I is
listed as absent; C and D are absent on the exact path, which has no wire.

    RAXTAX_BENCH_REFS=1000000 python -m raxtax_tpu_torch.tools.probe_prepare
    RAXTAX_EXACT=0 RAXTAX_BENCH_REFS=1000000 python -m raxtax_tpu_torch.tools.probe_prepare
    RAXTAX_BENCH_REFS=300 RAXTAX_BENCH_BATCH=4 python -m raxtax_tpu_torch.tools.probe_prepare --device cpu

The world is ``tools/bench.py``'s (and its database cache), the batch size
``RAXTAX_BENCH_BATCH`` (0: the engine's), the repetitions
``RAXTAX_PROFILE_REPS`` (4), as in the JAX script; the engine's mode comes
from the CLI's environment names. Prints the table on stderr and one
JSON line on stdout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from . import bench

ABSENT = {
    "I.pack_dispatch": "replaced by direct pulls: the port compacts with "
    "torch.nonzero and copies the significant set out in J (no "
    "pack_significant)",
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    a = ap.parse_args(argv)
    reps = int(os.environ.get("RAXTAX_PROFILE_REPS", 4))
    import torch

    from ..ops.compress import compress_planes
    from ..utils.device import resolve_device

    dev = resolve_device(a.device)
    cfg = bench.config()
    n_refs = cfg.configs[-1]
    fam, rng = bench.synth_fam()
    db, _, saver = bench.get_database(cfg, n_refs, fam, rng)
    queries = bench.synth_queries(fam, cfg.n_queries)
    clf = bench.make_bench_classifier(
        db, cfg.backend, cfg.batch, a.device, len(queries)
    )
    B = clf.batch_size
    bench.log(f"refs={db.num_tips} batch={B} significance={clf.significance}"
              f" fold={clf.fold} counts={clf.counts}")
    bench.warm_up(clf, queries, 2)
    bench.join_saver(saver)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    acc: dict[str, list[float]] = {}

    def t(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        acc.setdefault(name, []).append(time.perf_counter() - t0)
        return out

    n_chunks = max(1, len(queries) // B)
    absent = dict(ABSENT)
    for r in range(reps):
        chunk = queries[(r % n_chunks) * B : (r % n_chunks) * B + B]
        state = t("A.submit_dispatch", clf.submit_batch, chunk)
        t("B.fold+hist_device", sync)
        exact_mode = clf._exact_mode
        wire = None
        if not exact_mode and clf.counts == "planes" and not clf._mux_dense:
            wire = t("C.compress_dispatch", compress_planes, state.planes,
                     budget=clf._over_budget, layout=clf.state.layout)
            t("D.compress_device", sync)
        else:
            absent["C.compress_dispatch"] = absent["D.compress_device"] = (
                "no wire on this path"
            )
        hist = t("E.hist_pull", lambda: state.hist_host.numpy().copy())
        table64, *_ = t("F.prob_model_host", clf._host_model, hist,
                        state.ks, state.n_real, state.s_max)
        sig, _, _ = t("G.significant_dispatch", clf._dispatch_significance,
                      state.planes, table64, exact_mode, wire)
        t("H.significance_device", sync)
        t("J.significant_pull", sig.pull)
        del state, sig, wire
        # -- finalize on a fresh, normally prepared batch --
        prepared = clf.prepare_batch(clf.submit_batch(chunk))
        sync()
        before = dict(clf.phase_seconds)
        t("K.finalize_all", clf.finalize_batch, prepared)
        for k in ("finalize_pull", "finalize_descend", "finalize_eval"):
            acc.setdefault(f"K.{k}", []).append(
                clf.phase_seconds[k] - before[k])
    steps = {}
    for k in sorted(acc):
        v = sorted(acc[k])
        steps[k] = {"median_ms": v[len(v) // 2] * 1e3, "min_ms": v[0] * 1e3,
                    "max_ms": v[-1] * 1e3, "n": len(v)}
        bench.log(f"{k:24s} median {steps[k]['median_ms']:7.1f} ms  "
                  f"(min {steps[k]['min_ms']:.1f} max {steps[k]['max_ms']:.1f})")
    for k, why in sorted(absent.items()):
        if k not in steps:
            bench.log(f"{k:24s} absent: {why}")
    print(json.dumps({
        "tool": "probe_prepare", "refs": db.num_tips, "batch": B,
        "device": str(dev), "significance": clf.significance,
        "exact_mode": clf._exact_mode, "fold": clf.fold, "counts": clf.counts,
        "steps": steps,
        "absent": {k: v for k, v in absent.items() if k not in steps},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
