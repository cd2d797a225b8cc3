"""One batch of queries at the kernels' shapes, and the bounds of K1, K2,
K3, K5, K10 and K6/K7 on it, and of the probes K11-K13: shared by
``chip_smoke.py``'s ``kernels`` and probe phases and ``tools/kernel_ab.py``,
so both time the same inputs against the same bounds.

A bound is the least time the card could take for a kernel's work: the
larger of the bytes it must move over the memory rate and the operations it
must do over the peak rate for their type (one H100 SXM, NVIDIA's data
sheet). K5, K12 and K13 have a third limit that neither sees, their chains
of dependent steps: K5's floor is ``N`` times one dependent ``__dadd_rn``
(:func:`dadd_latency`), K12's ``N`` times one dependent software f64 add
(:func:`f64_add_latency`), K13's per chain its dependent instructions a step
times the latency of one dependent integer operation
(:func:`op_chain_bounds`, :func:`dependent_op_ns`). The probes' operations are SASS instructions a
step or an element (``tools/probe_ops.py``), counted in the run.
"""

from __future__ import annotations

import statistics

import numpy as np

PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS = 33.5e12  # int32 issues on half the f32 lanes (67 TFLOP/s / 2)
PEAK_F64_ADDS = 16.75e12  # 33.5 TFLOP/s f64 counts an FMA as two operations
PEAK_F32_ADDS = 33.5e12  # 67 TFLOP/s f32 counts an FMA as two operations


def batch_inputs(queries, batch: int):
    """Host arrays of the first ``batch`` queries, padded as the kernels
    phase pads them: ``(kmer_idx, ks, k_pad, s_max, flat_k, off_k)``."""
    from .. import native
    from ..ops.intersect_fold import PAD_ROW

    seqs = [s for _, s in queries[:batch]]
    flat_k, off_k = native.distinct_kmers_flat(seqs)
    ks = np.diff(off_k[: batch + 1]).astype(np.int32)
    k_pad = -(-int(ks.max()) // 128) * 128
    s_max = -(-(int(ks.max()) + 1) // 128) * 128
    kmer_idx = np.full((batch, k_pad), PAD_ROW, np.int32)
    mask = np.arange(k_pad)[None, :] < ks[:, None]
    kmer_idx[mask] = flat_k[: off_k[batch]]
    return kmer_idx, ks, k_pad, s_max, flat_k, off_k


def family_queries(n: int, family: int = 0):
    """``n`` queries of the synthetic world all drawn from one family's
    consensus (10 mutations each, ``synth.synth_queries``'s draws): a batch
    whose queries share most of their rows, as an amplicon run of one
    species does. The world's own queries come from ``n`` families."""
    from .synth import N_FAMILIES, synth_fam, synth_queries

    fam, _ = synth_fam()
    return synth_queries(np.repeat(fam[family : family + 1], N_FAMILIES, 0), n)


def group_row_loads(kmer_idx, ks, group: int) -> int:
    """Row loads of the stream fold on a batch in groups of ``group``
    queries: the distinct rows of each group, summed over the groups."""
    loads = 0
    for g0 in range(0, ks.shape[0], group):
        rows = [kmer_idx[b, : ks[b]] for b in range(g0, min(g0 + group, ks.shape[0]))]
        loads += int(np.unique(np.concatenate(rows)).size)
    return loads


def batch_probs32(planes, hist, ks, s_max: int):
    """K4's ``[B, 32, S, 128]`` f32 tip probabilities of the batch, from
    its planes and histogram through the host model: what the double-f32
    path hands its scan."""
    import torch

    from ..ops.planes import planes_probs
    from .profile_stages import host_tables

    tab = torch.from_numpy(host_tables(hist, ks, s_max)).to(planes.device)
    return planes_probs(planes, tab.float())


def bound(t_bytes: float, t_ops: float) -> dict:
    """``bound_ms`` and ``bound_by`` from the two times in seconds."""
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def fold_planes_bounds(kmer_idx, ks, flat_k, off_k, W: int, P: int) -> dict:
    """K1 on one batch: the bound with every row the batch names read once
    (``unique_rows``), and ``stream_bound_ms`` with all ``rows_folded``
    (query, k-mer) rows streamed, no reuse between queries."""
    B = ks.shape[0]
    uniq = int(np.unique(flat_k[: off_k[B]]).size)
    rows = int(ks.sum())
    out_bytes = B * P * W * 4
    once = uniq * W * 4 + kmer_idx.nbytes + ks.nbytes + out_bytes
    return {
        **bound(once / PEAK_BYTES_PER_S, rows * W * 6 / PEAK_INT32_OPS),
        "stream_bound_ms": (rows * W * 4 + out_bytes) / PEAK_BYTES_PER_S * 1e3,
        "rows_folded": rows, "unique_rows": uniq,
    }


def fold_sparse_bounds(pair_kmer, pair_blk, totals, W: int, P: int) -> dict:
    """K2 on one batch of ``build_pairs`` lists: every distinct (k-mer,
    block) pair's 4 KB sub-row read once, the planes written and the pair
    lists read; ``stream_bound_ms`` streams every pair's sub-row, no reuse
    between queries. The carry-save adder tree takes about 6 operations a
    word, as in K1."""
    from ..ops.intersect_fold import BLOCK_WORDS

    B, p_pad = pair_kmer.shape
    valid = np.arange(p_pad)[None, :] < totals[:, None]
    pairs = int(totals.sum())
    uniq = int(np.unique(pair_kmer[valid].astype(np.int64) * (W // BLOCK_WORDS)
                         + pair_blk[valid]).size)
    out_bytes = B * P * W * 4
    lists = pair_kmer.nbytes + pair_blk.nbytes + totals.size * 4
    once = uniq * BLOCK_WORDS * 4 + out_bytes + lists
    return {
        **bound(once / PEAK_BYTES_PER_S,
                pairs * BLOCK_WORDS * 6 / PEAK_INT32_OPS),
        "stream_bound_ms": (pairs * BLOCK_WORDS * 4 + out_bytes + lists)
        / PEAK_BYTES_PER_S * 1e3,
        "pairs": pairs, "unique_pairs": uniq,
    }


def tail_tips(planes) -> int:
    """Tips of a ``[B, P, S, 128]`` planes batch whose count is 16 or more
    (a bit set in planes 4..P-1): the ones K3 decodes one by one."""
    import torch

    if planes.shape[1] <= 4:
        return 0
    hi = planes[:, 4].clone()
    for p in range(5, planes.shape[1]):
        hi |= planes[:, p]
    # popcount of each 32-bit pattern, in int64 so no step overflows
    x = hi.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return int((((x * 0x01010101) >> 24) & 0xFF).sum().item())


def planes_hist_bounds(B: int, P: int, W: int, s_max: int,
                       n_tail: int) -> dict:
    """K3 on one batch: the planes read once and the histogram written.
    Beside them the operations of the kernel's design (``csrc/
    planes_hist.cu``): P + 59 a word (the ORs of the high planes, the
    16-minterm tree, 16 popcounts and adds) and 3 P + 1 for each of the
    ``n_tail`` tips of 16 or more, decoded one by one; ``tail_share`` is
    their share of the tips."""
    ops = B * W * (P + 59) + n_tail * (3 * P + 1)
    return {
        **bound((B * P * W * 4 + B * s_max * 4) / PEAK_BYTES_PER_S,
                ops / PEAK_INT32_OPS),
        "ops_ms": ops / PEAK_INT32_OPS * 1e3,
        "tail_tips": n_tail, "tail_share": n_tail / (B * W * 32),
    }


def fold_stream_bounds(kmer_idx, ks, flat_k, off_k, W: int, P: int,
                       n_pairs_listed: int, n_groups: int) -> dict:
    """K10 on one batch: every row the batch names read once, the planes
    written and the pair lists read (``n_pairs_listed`` packed pairs and
    two group bounds per group); ``stream_bound_ms`` streams all
    ``rows_folded`` rows. Adding a row word into a counter takes at least
    one operation, so the operations are one per word and pair."""
    B = ks.shape[0]
    k1 = fold_planes_bounds(kmer_idx, ks, flat_k, off_k, W, P)
    rows = k1["rows_folded"]
    out_bytes = B * P * W * 4
    once = k1["unique_rows"] * W * 4 + out_bytes + n_pairs_listed * 4 \
        + n_groups * 8
    return {
        **bound(once / PEAK_BYTES_PER_S, rows * W / PEAK_INT32_OPS),
        "stream_bound_ms": (rows * W * 4 + out_bytes) / PEAK_BYTES_PER_S * 1e3,
        "rows_folded": rows, "unique_rows": k1["unique_rows"],
    }


def dd_cumsum_bounds(B: int, N: int) -> dict:
    """K6 / K7 at ``[B, N]``: 4 bytes read and 8 written per tip (and the
    zero column); ``reload_bound_ms`` is the two-sweep form that reads every
    tip twice (16 bytes). Each tip takes 9 compensated adds of 8 f32
    operations: 7 lane steps, the row offset and the carry."""
    return {
        **bound((B * N * 12 + B * 8) / PEAK_BYTES_PER_S,
                B * N * 9 * 8 / PEAK_F32_ADDS),
        "reload_bound_ms": (B * N * 16 + B * 8) / PEAK_BYTES_PER_S * 1e3,
    }


def exact_cumsum_bounds(B: int, N: int) -> dict:
    """K5 at ``[B, N]``: one read of the addends, one write of the sums."""
    return bound((B * N * 8 + B * (N + 1) * 8) / PEAK_BYTES_PER_S,
                 B * N / PEAK_F64_ADDS)


#: addends of the latency chain: mixed signs and magnitudes, so the running
#: sum keeps changing and every add rounds
CHAIN_ADDENDS = (0.5, -0.3, 1.0e-3, 7.25, -7.0, 2.0**-30, -1.0e-7, 0.0625)
CHAIN_STEPS = 1 << 22
CHECK_STEPS = 4096


def dadd_latency(device, steps: int = CHAIN_STEPS, reps: int = 3) -> dict:
    """The latency of one dependent ``__dadd_rn`` on ``device``, from
    :func:`~..ops.exactscan.dadd_chain`: the CUDA-event times of chains of
    ``steps`` and ``4 * steps`` adds (median of ``reps`` each), their
    difference over ``3 * steps`` (the launch drops out), and the SM cycles
    per add that the long chain counted. A short chain is first held bit for
    bit against the host loop."""
    import torch

    from ..ops.exactscan import dadd_chain, dadd_chain_plain

    x = torch.tensor(CHAIN_ADDENDS, dtype=torch.float64, device=device)
    got = dadd_chain(x, CHECK_STEPS)
    want = dadd_chain_plain(x, CHECK_STEPS)
    if not bool(torch.equal(got[:1].cpu().view(torch.int64),
                            want[:1].view(torch.int64))):
        raise AssertionError("dadd_chain differs from the host loop")

    def ms(n: int) -> float:
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            dadd_chain(x, n)
            end.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    short, long_ = ms(steps), ms(4 * steps)
    cycles = float(dadd_chain(x, 4 * steps)[1].item())
    return {"dadd_latency_ns": (long_ - short) * 1e6 / (3 * steps),
            "dadd_latency_cycles": cycles / (4 * steps),
            "dadd_chain_steps": 4 * steps}


def f64_add_latency(device, steps: int = 1 << 20, reps: int = 3) -> dict:
    """The latency of one dependent software f64 add (``rx_f64_add_u32``)
    on ``device``: K13's unrolled ``f64_add_full`` chain timed by CUDA events
    at ``steps`` and ``4 * steps`` steps (median of ``reps`` each), their
    difference over ``3 * steps`` (the launch drops out). The chain's bits
    are held against the plain version first, at a few steps."""
    import torch

    from ..ops.opchain import probe_op_chain, probe_op_chain_plain, probe_state

    x, y = probe_state(device)
    if not bool(torch.equal(probe_op_chain("f64_add_full", x, y, 35),
                            probe_op_chain_plain("f64_add_full", x, y, 35))):
        raise AssertionError("f64_add_full differs from the plain version")

    def ms(n: int) -> float:
        times = []
        probe_op_chain("f64_add_full", x, y, n)
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            probe_op_chain("f64_add_full", x, y, n)
            end.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    short, long_ = ms(steps), ms(4 * steps)
    return {"f64_add_latency_ns": (long_ - short) * 1e6 / (3 * steps),
            "f64_add_chain_steps": 4 * steps}


def probe_ew_bounds(pairs: int, instructions_per_pair: float) -> dict:
    """K11 on ``pairs`` pairs: 16 bytes read and 16 written a pair, and the
    SASS instructions of its loop a pair (an add and a subtraction, the
    loads and stores)."""
    return bound(pairs * 32 / PEAK_BYTES_PER_S,
                 pairs * instructions_per_pair / PEAK_INT32_OPS)


def probe_scan_bounds(B: int, N: int, instructions_per_add: float,
                      add_latency_ns: float) -> dict:
    """K12 at ``[B // 128, N, 128]``: 8 bytes read and 8 written a (tip,
    query), the instructions of one add a (tip, query) (K13's
    ``f64_add_full`` step, whose addend is hoisted: fewer than K12's), and
    the chain floor, ``N`` dependent adds at ``add_latency_ns`` each."""
    return {
        **bound(B * N * 16 / PEAK_BYTES_PER_S,
                B * N * instructions_per_add / PEAK_INT32_OPS),
        "chain_floor_ms": N * add_latency_ns * 1e-6,
    }


def dependent_op_ns(ns_per_step_x1: float, sass: dict) -> float:
    """The latency of one dependent integer operation: the unrolled
    ``u32_add_x1`` chain's time a step over its dependent instructions a
    step in ``sass`` (``tools/probe_ops.chain_sass``; ptxas fuses two of its
    steps into one three-input add)."""
    return ns_per_step_x1 / sass["u32_add_x1"]["dependent_per_step"]


def op_chain_bounds(sass: dict, threads: int, iters: int, op_ns: float) -> dict:
    """K13, ``iters`` steps of every chain of ``sass`` (``tools/probe_ops.
    chain_sass``: instructions and dependent instructions a step) on
    ``threads`` elements. The operations are the instructions; the bytes
    12 an element and chain. A chain's floor is its dependent instructions
    a step times ``op_ns``, the latency of one dependent integer operation
    (:func:`dependent_op_ns`); ``chain_floor_ms`` sums the chains."""
    floors = {c: iters * v["dependent_per_step"] * op_ns * 1e-6
              for c, v in sass.items()}
    ops = sum(v["instructions_per_step"] for v in sass.values()) * threads * iters
    return {
        **bound(threads * 12 * len(sass) / PEAK_BYTES_PER_S,
                ops / PEAK_INT32_OPS),
        "dependent_op_ns": op_ns, "chain_floor_ms_by_chain": floors,
        "chain_floor_ms": sum(floors.values()),
    }
