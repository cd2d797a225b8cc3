"""Per-op device time of the double-f32 significance stage and of the wire
compression at bench scale, the port of the JAX package's
``scripts/probe_sig.py``.

Each op of ``significant_nodes_planes``' unit/wide path (the engine's
default dd path) and of ``compress_planes`` runs on its own between two CUDA
events, on one real batch of the bench world, so the stage's time decomposes
into measured lines:

    c0.compress_full          compress_planes: K8 + the nonzero overflow lists
    c1.high_counts_kernel     K8 (planes_high_counts)
    c2.overflow_lists         the nonzero compaction of the counts above 15
    s1.probs_mux4             K4 with the low-bit lookup (scatter variant)
    s1b.probs_mux4_zero_high  K4 zeroing the overflow tips (sideband variant)
    s2.over_scatter           the overflow tips' table values scattered
    s2b.sideband_scan         the double-f32 prefix of the overflow list
    s3.dd_cumsum              K6 (tip_prob_cumsum_dd)
    s4.compact_unit_wide      _compact_unit_wide: the threshold masks
    s4b.wide_conf_sideband    the wide nodes' confidences with the sideband
    s5.unit_wide_pull         the masks' nonzero compaction and copy out

The JAX script's ``threshold_set_tiled`` / ``top_k`` lines have no
counterpart (the port compacts with ``nonzero``: s5).

    RAXTAX_BENCH_REFS=1000000 python -m raxtax_tpu_torch.tools.probe_sig
    RAXTAX_BENCH_REFS=300 RAXTAX_BENCH_BATCH=4 python -m raxtax_tpu_torch.tools.probe_sig --device cpu

On the CPU the host clock stands in for the events. The world is
``tools/bench.py``'s, the batch size ``RAXTAX_BENCH_BATCH`` (0: the
engine's), the repetitions ``RAXTAX_PROFILE_REPS`` (4; one more warms the
ops), as in the JAX script; the fold comes from the CLI's environment
names, the significance is the double-f32 one with the unit/wide split.
Prints the table on stderr and one JSON line on stdout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from . import bench


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    a = ap.parse_args(argv)
    reps = int(os.environ.get("RAXTAX_PROFILE_REPS", 4))
    import torch

    from ..cli import engine_mode_from_env
    from ..engine.classify import make_classifier
    from ..ops import compress as cp, nodeconf as nc, planes as pl
    from ..utils.device import resolve_device

    dev = resolve_device(a.device)
    cfg = bench.config()
    n_refs = cfg.configs[-1]
    fam, rng = bench.synth_fam()
    db, _, saver = bench.get_database(cfg, n_refs, fam, rng)
    queries = bench.synth_queries(fam, cfg.n_queries)
    mode = {**engine_mode_from_env(), "significance": "dd", "split2": True}
    args = argparse.Namespace(
        backend="pallas", device=a.device, batch_size=cfg.batch,
        debug_checks=False, tsv=True, skip_exact_matches=False,
        raw_confidence=False, **mode,
    )
    clf = make_classifier(db, args, n_queries_hint=len(queries))
    st = clf.state
    B = clf.batch_size
    split2 = st.split2
    bench.log(f"refs={db.num_tips} batch={B} layout={st.layout} "
              f"sideband={st.sideband} over_budget={clf._over_budget} "
              f"n_wide={int(split2[0].shape[0])}")
    bench.warm_up(clf, queries, 1)
    bench.join_saver(saver)

    acc: dict[str, list[float]] = {}

    def t(name, fn, *args, **kw):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            ms = (time.perf_counter() - t0) * 1e3
        acc.setdefault(name, []).append(ms)
        return out

    budget, layout = clf._over_budget, st.layout
    for r in range(reps + 1):
        chunk = queries[(r % 2) * B : (r % 2) * B + B]
        state = clf.submit_batch(chunk)
        if state.ready is not None:
            state.ready.synchronize()
        table64, *_ = clf._host_model(
            state.hist_host.numpy(), state.ks, state.n_real, state.s_max
        )
        table = clf._to_device(table64.astype("float32"))
        planes = state.planes
        # -- the wire --
        wire = t("c0.compress_full", cp.compress_planes, planes,
                 budget=budget, layout=layout)
        high_bm = t("c1.high_counts_kernel", pl.planes_high_counts, planes)
        high = (high_bm.reshape(B, -1) if layout == "flat"
                else pl.probs_to_tip_order(high_bm))
        t("c2.overflow_lists", cp._overflow_lists, high, budget)
        del high_bm, high
        over_idx, over_val = wire[1], wire[2]
        fixv = nc._over_fixval(table, over_idx, over_val)
        # -- the significance stage, both overflow strategies --
        probs = nc._tip_order_probs(
            t("s1.probs_mux4", pl.planes_probs, planes, table, mux_bits=4),
            layout)
        probs = t("s2.over_scatter", nc._scatter_fix, probs, over_idx, fixv)
        probs_zh = nc._tip_order_probs(
            t("s1b.probs_mux4_zero_high", pl.planes_probs, planes, table,
              mux_bits=4, zero_high=True), layout)
        sb = t("s2b.sideband_scan", nc._sideband_of, over_idx, fixv)
        if st.sideband:  # the strategy the engine takes on this database
            probs = probs_zh
        else:
            sb = fixv = None
        del probs_zh
        cum_hi, cum_lo = t("s3.dd_cumsum", nc.tip_prob_cumsum_dd, probs)
        if sb is not None:
            t("s4b.wide_conf_sideband", nc._wide_conf_dd, cum_hi, cum_lo,
              split2[0], split2[1], sb)
        sig = t("s4.compact_unit_wide", nc._compact_unit_wide, cum_hi, cum_lo,
                probs, sb, fixv, *split2, db.num_tips)
        t("s5.unit_wide_pull", sig.pull)
        del state, planes, wire, probs, cum_hi, cum_lo, sig, sb, fixv
    steps = {}
    for k in sorted(acc):
        v = sorted(acc[k][1:]) or acc[k]  # the first rep warms the ops
        steps[k] = {"median_ms": v[len(v) // 2], "min_ms": v[0],
                    "max_ms": v[-1], "n": len(v)}
        bench.log(f"{k:28s} median {steps[k]['median_ms']:8.3f} ms  "
                  f"(min {v[0]:.3f} max {v[-1]:.3f} n={len(v)})")
    print(json.dumps({
        "tool": "probe_sig", "refs": db.num_tips, "batch": B,
        "device": str(dev), "layout": layout, "sideband": st.sideband,
        "over_budget": budget, "n_wide": int(split2[0].shape[0]),
        "clock": "cuda events" if dev.type == "cuda" else "host",
        "steps": steps,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
