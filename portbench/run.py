"""The benchmark's command: one run of one cell on this machine's GPU.

    python3 portbench/run.py --workload coi5p_1m.known --seed 7 --seconds 30 --trace 0

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` and, last, ``check``:
each number compared with the reference beside its limit, which also end
standard error. Exits non-zero with no result when there is no GPU, when the
program cannot be imported, when the window used up the query files made
for it, or when JAX or the JAX package was loaded. Runs numpy's BLAS and
OpenMP with one thread.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402

# one process with few threads: numpy's BLAS and OpenMP pools run one
# thread, so the host model's matrix-vector products do not wake (and
# spin) a pool as wide as the machine beside the program's own threads
for _name in ("OPENBLAS_NUM_THREADS", "OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_name] = "1"

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    a = ap.parse_args(argv)

    import torch

    from portbench import harness

    spec = harness.cell_spec(ROOT, a.workload)
    chips = int(spec.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {a.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    try:
        result = harness.run(a.workload, a.seed, a.seconds, bool(a.trace),
                             T_START, log=log)
    except harness.BenchError as e:
        log(f"portbench: {e}")
        return 1
    bad = harness.forbidden_modules()
    if bad:
        log("portbench: loaded forbidden modules: " + ", ".join(bad))
        return 1
    for name, v in result["check"].items():
        log(f"check {name} {v['value']} limit {v['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
