"""One batch of queries at the kernels' shapes, and the bounds of K1 and K5
on it: shared by ``chip_smoke.py``'s ``kernels`` phase and
``tools/kernel_ab.py``, so both time the same inputs against the same
bounds.

A bound is the least time the card could take for a kernel's work: the
larger of the bytes it must move over the memory rate and the operations it
must do over the peak rate for their type (one H100 SXM, NVIDIA's data
sheet). K5 has a third limit that neither sees: its ``B`` chains of ``N``
dependent adds, measured here by :func:`dadd_latency`.
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
