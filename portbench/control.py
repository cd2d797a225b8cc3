"""The lower-precision control: the reference computed in float32 put in the
program's place, judged by the run's own comparison against the float64
reference, at the cell's own size.

    python3 portbench/control.py --workload coi5p_1m.known --seeds 1 2 3

For each seed: the cell's records and first query file, the queries a run
compares (drawn the same way), and the lines of ``raxtax.out`` and
``raxtax.tsv`` in which the float32 reference differs. Prints one JSON line
per seed. The benchmark's runs do not run it; it shows that the comparison
fails a program that computes below the configuration's f64.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def control(spec, seed: int, device: str) -> dict:
    from portbench import generator, harness
    from portbench.reference import Reference

    t0 = time.perf_counter()
    world = generator.make_world(spec.config, seed)
    qf = generator.Traffic(world, spec.traffic, seed).file(0)
    picks = harness.sample([qf], seed, int(spec.traffic["check_queries"]))
    ref = Reference(world.lineages, world.codes4, world.starts, world.lengths,
                    device=device)
    low = ref.with_dtype(np.float32)
    differ = 0
    failed = 0
    for _, q in picks:
        want = ref.lines(qf.labels[q], qf.sequence(q))
        try:
            got = low.lines(qf.labels[q], qf.sequence(q))
        except ArithmeticError:
            # float32 underflowed every probability: no answer, every line
            # of the query differs
            got, failed = ([], []), failed + 1
        for a, b in zip(got, want):
            differ += harness.lines_differ(a, b)
    return {"workload": spec.name, "seed": seed, "control": "float32",
            "lines_differ": differ, "queries": len(picks),
            "queries_without_answer": failed,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    a = ap.parse_args(argv)
    from portbench import harness

    spec = harness.cell_spec(ROOT, a.workload)
    for seed in a.seeds:
        print(json.dumps(control(spec, seed, "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
