"""The benchmark's arithmetic: device intervals from the profiler, their
union, kernel time by name, the least bytes a kernel needs for its inputs,
and the card's published peaks. Nothing here imports the program.
"""

from __future__ import annotations

import json
import math
import re
from pathlib import Path

import numpy as np

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peaks_for(kind: str) -> dict | None:
    """The published peaks of a device by its name, or None."""
    return json.loads(PEAKS.read_text()).get(kind)


def device_events(prof) -> list:
    """``(name, start_ns, duration_ns)`` of every device activity (kernels,
    copies, sets) a ``torch.profiler.profile`` recorded, read in memory."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        dur = int(e.duration_ns())
        if dur > 0:
            out.append((e.name(), int(e.start_ns()), dur))
    return out


def union_seconds(events: list) -> float:
    """Seconds covered by at least one interval (overlaps counted once)."""
    spans = sorted((s, s + d) for _, s, d in events)
    total = 0
    cur_s = cur_e = None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e9


def kernel_seconds(events: list, names: list) -> float:
    """Summed device seconds of the events whose name holds one of
    ``names`` as a word."""
    pat = re.compile(r"\b(" + "|".join(map(re.escape, names)) + r")\b")
    return sum(d for n, _, d in events if pat.search(n)) / 1e9


def top_ops(events: list, n: int = 10) -> list:
    """``[name, seconds]`` of the ``n`` device operations that took most
    time, summed by name."""
    by: dict = {}
    for name, _, d in events:
        by[name] = by.get(name, 0) + d
    return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def count_bits(k_max: int) -> int:
    """Bits of one intersection count of a query with ``k_max`` 8-mers."""
    return max(1, math.ceil(math.log2(k_max + 1)))


def fold_bytes(batches: list, n_refs: int) -> float:
    """Least bytes of the fold over ``batches`` of ``(queries, distinct
    8-mers of the batch, largest distinct 8-mers of one query)``: each
    distinct postings row read once (one bit per reference) and one count
    per query and reference written."""
    row = math.ceil(n_refs / 8)
    return float(sum(d * row + b * n_refs * count_bits(k) / 8
                     for b, d, k in batches))


def scan_bytes(queries: int, n_refs: int) -> float:
    """Least bytes of the exact prefix sum: one f64 written per query and
    reference."""
    return float(queries) * n_refs * 8


def batch_shapes(kmer_sets: list, batch: int) -> list:
    """``(queries, distinct 8-mers, largest distinct 8-mers of one query)``
    of each consecutive batch of ``batch`` queries, from each query's
    distinct 8-mers."""
    seen = np.zeros(1 << 16, dtype=bool)
    out = []
    for lo in range(0, len(kmer_sets), batch):
        part = kmer_sets[lo : lo + batch]
        seen[:] = False
        for k in part:
            seen[k] = True
        out.append((len(part), int(seen.sum()),
                    max((k.size for k in part), default=0)))
    return out
