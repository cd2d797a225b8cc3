"""Share of the HBM roofline the exact f64 scan reaches: one f64 prefix sum
written per query and reference over the card's peak bandwidth, divided by
the device time of the scan kernels named in ``kernel.scan_roofline.json``."""

import json
from pathlib import Path

from portbench import yardstick

NAMES = json.loads(Path(__file__).with_suffix(".json").read_text())["kernels"]


def read(ctx):
    if ctx.peaks is None or not ctx.queries:
        return None
    t = yardstick.kernel_seconds(ctx.events, NAMES)
    if t <= 0:
        return None
    least = yardstick.scan_bytes(ctx.queries, ctx.n_refs)
    return 100.0 * least / ctx.peaks["hbm_bytes_per_s"] / t
