"""Device time of each stage of the planes pipeline, one at a time, on the
engine's own inputs.

    python -m raxtax_tpu_torch.tools.profile_stages [--refs 1000000] [--batch-size 256]
    RAXTAX_PROFILE_REPS=9 python -m raxtax_tpu_torch.tools.profile_stages --refs 65536

The counterpart of the JAX package's ``scripts/profile_stages.py``. A
synthetic world (``tools/synth.build_world``) feeds an engine in the JAX
package's default mode (double-f32 significance, block-sparse fold); two real
batches warm it, then each stage runs alone on one batch of its queries, with
the engine's own padding (``k_pad``, ``s_max``), tables from the host model
and overflow budget:

- fold: dense (K1), and block-sparse (K2) when the pair budget admits the
  batch (the pair statistics are printed either way);
- histogram (K3); compress (K8 + the overflow lists);
- probabilities at ``mux_bits`` 4, 5, 6 and the full plane count (K4);
- the double-f32 scan over tip order (K6, or the pairwise tree);
- the fused significance: plain eval-node compaction, the unit/wide split
  (split2), and the bit-major scan (K7) on a packed copy of the database;
- the exact significance (K4 in f64 + K5), the port's default.

Each time is the median over ``RAXTAX_PROFILE_REPS`` (default 5) runs of
CUDA events around the stage, after one warm-up run. Prints one JSON line.
Runs on the GPU unless ``--device cpu``, where no device time exists and
every stage reads "not measured".
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import statistics
import sys

import numpy as np
import torch

REPS = int(os.environ.get("RAXTAX_PROFILE_REPS", 5))


def stage_ms(fn, dev: torch.device, reps: int = REPS):
    """Median CUDA-event milliseconds of ``fn()`` over ``reps`` runs after a
    warm-up run; "not measured" off the GPU (the stage still runs once)."""
    out = fn()
    if dev.type != "cuda":
        return "not measured"
    del out
    torch.cuda.synchronize(dev)
    times = []
    for _ in range(max(reps, 1)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize(dev)
        times.append(start.elapsed_time(end))
        del out
    return statistics.median(times)


def batch_inputs(clf, queries):
    """One batch with the engine's sticky padding: ``(kmer_idx [B, k_pad],
    ks [B], k_pad, s_max)``."""
    from .. import native
    from ..ops.intersect_fold import PAD_ROW
    from ..utils.encoding import sequence_to_kmers

    B = clf.batch_size
    seqs = [s for _, s in queries[:B]]
    res = native.distinct_kmers_flat(seqs)
    if res is None:
        sets = [sequence_to_kmers(s) for s in seqs]
        flat = np.concatenate(sets) if sets else np.zeros(0, np.int32)
        off = np.concatenate(([0], np.cumsum([k.size for k in sets])))
    else:
        flat, off = res
    ks = np.diff(off[: len(seqs) + 1]).astype(np.int32)
    k_pad, s_max = clf._k_pad_hw, clf._s_max_hw
    kmer_idx = np.full((B, k_pad), PAD_ROW, np.int32)
    mask = np.arange(k_pad)[None, :] < ks[:, None]
    kmer_idx[: len(seqs)][mask] = flat[: off[len(seqs)]]
    ks = np.concatenate([ks, np.zeros(B - len(seqs), np.int32)])
    return kmer_idx, ks, k_pad, s_max


def host_tables(hist: torch.Tensor, ks: np.ndarray, s_max: int) -> np.ndarray:
    """The host model's ``[B, s_max]`` f64 tables from the histograms."""
    from ..prob.model import KTableCache, normalized_size_probs

    hist_h = hist.cpu().numpy()
    cache = KTableCache()
    table = np.zeros((hist_h.shape[0], s_max), np.float64)
    for b in range(hist_h.shape[0]):
        ps, _ = normalized_size_probs(hist_h[b], int(ks[b]), cache)
        table[b, : ps.shape[0]] = ps
    return table


def profile(n_refs: int, batch: int, device: str) -> dict:
    from ..db.database import ensure_kmer_layout
    from ..engine.device import (
        SPARSE_BUDGET_MIN,
        SPARSE_CROSSOVER_DIV,
        DeviceClassifier,
    )
    from ..ops.compress import compress_planes
    from ..ops.exactscan import significant_nodes_exact
    from ..ops.intersect_fold import (
        BLOCK_SUB,
        build_pairs,
        fold_planes,
        fold_planes_sparse,
    )
    from ..ops.nodeconf import significant_nodes_planes, tip_prob_cumsum_dd
    from ..ops.planes import planes_histogram, planes_probs, probs_to_tip_order
    from ..utils.device import resolve_device
    from .synth import build_world

    dev = resolve_device(device)
    db, queries, build_s = build_world(n_refs, 2 * batch)
    clf = DeviceClassifier.create(
        db, batch_size=batch, device=dev, significance="dd", fold="sparse"
    )
    clf.classify_batch(queries[:batch])  # two real batches: padding, flips
    clf.classify_batch(queries[batch:])
    st = clf.state
    kmer_idx, ks, k_pad, s_max = batch_inputs(clf, queries)
    d_idx = torch.from_numpy(kmer_idx).to(dev)
    d_ks = torch.from_numpy(ks).to(dev)
    km3 = st.kmer_major3
    ms: dict = {}

    ms["fold (dense, K1)"] = stage_ms(
        lambda: fold_planes(d_idx, d_ks, km3, max_count=k_pad), dev)
    S = int(km3.shape[1])
    budget = max(SPARSE_BUDGET_MIN, k_pad * S // SPARSE_CROSSOVER_DIV)
    blk_ptr = st.blk_ptr
    pairs = (blk_ptr[kmer_idx + 1] - blk_ptr[kmer_idx]).sum(axis=1)
    sparse_stats = {"pairs_per_query_max": int(pairs.max()),
                    "pairs_per_query_mean": float(pairs.mean()),
                    "budget": budget, "blocks": S // BLOCK_SUB}
    res = build_pairs(kmer_idx, st.blk_ptr, st.blk_ids, budget)
    if res is not None:
        pk, pb, _, tot = (torch.from_numpy(np.asarray(x)).to(dev) for x in res)
        tot = tot.to(torch.int32)
        ms["fold (block-sparse, K2)"] = stage_ms(
            lambda: fold_planes_sparse(pk, pb, tot, km3, max_count=k_pad), dev)
    else:
        ms["fold (block-sparse, K2)"] = "over the pair budget: the engine folds dense"

    planes = fold_planes(d_idx, d_ks, km3, max_count=k_pad)
    P = int(planes.shape[1])
    ms["histogram (K3)"] = stage_ms(
        lambda: planes_histogram(planes, s_max, db.num_tips), dev)
    hist = planes_histogram(planes, s_max, db.num_tips)
    table64 = host_tables(hist, ks, s_max)
    tab64 = torch.from_numpy(table64).to(dev)
    tab32 = tab64.float()
    ms["compress (K8 + overflow lists)"] = stage_ms(
        lambda: compress_planes(planes, budget=clf._over_budget, layout=st.layout),
        dev)
    wire = compress_planes(planes, budget=clf._over_budget, layout=st.layout)
    lists_fit = bool((wire[3] <= wire[1].shape[1]).all())
    over_idx, over_val = (wire[1], wire[2]) if lists_fit else (None, None)
    del wire
    for mb in (4, 5, 6, None):
        if mb is not None and mb >= P:
            continue
        ms[f"probs (mux_bits={mb if mb is not None else P}, K4)"] = stage_ms(
            lambda mb=mb: planes_probs(planes, tab32, mux_bits=mb), dev)
    probs = planes_probs(planes, tab32)
    flat = (probs.reshape(batch, -1) if st.layout == "flat"
            else probs_to_tip_order(probs).contiguous())
    del probs
    ms["dd scan (K6 or the pairwise tree)"] = stage_ms(
        lambda: tip_prob_cumsum_dd(flat), dev)
    del flat

    def fused(state, pl_, over, split2, bm_scan):
        return significant_nodes_planes(
            pl_, tab32, state.node_starts, state.node_ends, over_idx=over[0],
            over_val=over[1], bm_scan=bm_scan, layout=state.layout,
            split2=split2, sideband=state.sideband, num_tips=db.num_tips,
        )

    over = (over_idx, over_val)
    ms["significance (plain)"] = stage_ms(
        lambda: fused(st, planes, over, None, False), dev)
    if st.split2 is not None:
        ms["significance (split2)"] = stage_ms(
            lambda: fused(st, planes, over, st.split2, False), dev)
    ms["exact significance (K4 f64 + K5)"] = stage_ms(
        lambda: significant_nodes_exact(
            planes, tab64, st.node_starts, st.node_ends, split2=st.split2,
            layout=st.layout, num_tips=db.num_tips), dev)
    del planes, clf
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the bit-major scan reads the packed layout: a packed copy, its planes
    packed = ensure_kmer_layout(copy.copy(db), "packed")
    pclf = DeviceClassifier.create(
        packed, batch_size=batch, device=dev, significance="dd", bm_scan=True
    )
    p_planes = fold_planes(d_idx, d_ks, pclf.state.kmer_major3, max_count=k_pad)
    p_wire = compress_planes(p_planes, budget=pclf._over_budget, layout="packed")
    p_over = ((p_wire[1], p_wire[2])
              if bool((p_wire[3] <= p_wire[1].shape[1]).all()) else (None, None))
    ms["significance (bm_scan, packed, K7)"] = stage_ms(
        lambda: fused(pclf.state, p_planes, p_over, None, True), dev)

    return {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "refs": n_refs, "batch": batch, "reps": REPS, "db_build_s": build_s,
        "layout": db.kmer_layout, "k_pad": k_pad, "s_max": s_max, "planes": P,
        "overflow_lists_fit": lists_fit, "sparse_pairs": sparse_stats,
        "stage_ms": ms,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--refs", type=int, default=1_000_000)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    a = ap.parse_args(argv)
    print(json.dumps(profile(a.refs, a.batch_size, a.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
