"""Share of the HBM roofline the fold reaches: the least bytes the fold
needs for the window's batches (each distinct postings row read once, one
count per query and reference written; from the benchmark's own 8-mers of
the queries) over the card's peak bandwidth, divided by the device time of
the fold kernels named in ``kernel.fold_roofline.json``."""

import json
from pathlib import Path

from portbench import yardstick

NAMES = json.loads(Path(__file__).with_suffix(".json").read_text())["kernels"]


def read(ctx):
    if ctx.peaks is None or not ctx.batch_shapes:
        return None
    t = yardstick.kernel_seconds(ctx.events, NAMES)
    if t <= 0:
        return None
    least = yardstick.fold_bytes(ctx.batch_shapes, ctx.n_refs)
    return 100.0 * least / ctx.peaks["hbm_bytes_per_s"] / t
