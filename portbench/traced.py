"""A traced run of one cell with the program's spans and counters.

    python3 portbench/traced.py --workload coi5p_1m.known --seed 7 --seconds 50
    python3 portbench/traced.py --workload coi5p_1m.known --seed 7 --seconds 50 --recorder-cost odd

The first form is ``run.py --trace 1`` with the program's span recorder
(``raxtax_tpu_torch.utils.trace.RECORDER``) enabled over each profiled
stretch. From the window's spans, the engine's counters over the window and
the device intervals it adds ``breakdown.idle_gaps`` (``portbench/gaps.py``:
the device's idle time by the innermost span open on the thread that runs
the loop), the per-layer metrics whose readers need spans or counters
(``ctx.span_seconds``, ``ctx.counters``), and ``program``: the counters,
every span's milliseconds a batch, and the records the buffer dropped. The
second form is ``run.py --trace 0`` with the recorder enabled for every
other query file (the odd or the even ones of the run, the warm-up's two
first) and no profiler; ``recorder_cost`` gives each file's seconds with the
recorder on and off and the ratio of their medians, so the host's speed,
which moves between processes, moves both alike.

Prints the result as ``run.py`` does, one JSON object on the last line of
standard output.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402

for _name in ("OPENBLAS_NUM_THREADS", "OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_name] = "1"

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
import weakref  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: per-layer metrics read here from the program's spans and counters
READ_HERE = ("engine.submit_ms", "engine.hist_wait_ms",
             "host_model.closed_form_share", "host_model.table_builds_per_kq",
             "descent.sites_per_kq")


class Window:
    """A ``torch.profiler.profile`` that also enables the program's span
    recorder over its stretch and takes the classifier's counters at both
    ends."""

    def __init__(self, prof, classifier, recorder, now_ns):
        self.prof, self.classifier = prof, classifier
        self.recorder, self.now_ns = recorder, now_ns
        self.profiler = None

    def __enter__(self):
        clf = self.classifier()
        self.counters0 = dict(clf.counters)
        self.totals0 = dict(self.recorder.totals)
        self.recorder.drain()
        self.recorder.enable()
        self.prof.__enter__()
        self.profiler = self.prof.profiler
        self.t0 = self.now_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = self.now_ns()
        out = self.prof.__exit__(*exc)
        self.drained = self.recorder.drain()
        self.recorder.disable()
        clf = self.classifier()
        self.counters = {k: v - self.counters0.get(k, 0)
                         for k, v in clf.counters.items()}
        self.span_seconds = {
            k: (v - self.totals0.get(k, 0)) / 1e9
            for k, v in self.recorder.totals.items()
            if v != self.totals0.get(k, 0)}
        return out


def traced(cell: str, seed: int, seconds: float, recorder_cost: str | None,
           t_start: float, root: Path = ROOT, device: str = "cuda",
           log=None) -> dict:
    """One run of ``cell`` as the module note says; returns the result
    line's object. Raises :class:`portbench.harness.BenchError` as a run
    does."""
    from portbench import gaps, harness, yardstick
    from raxtax_tpu_torch.engine import classify
    from raxtax_tpu_torch.utils.trace import RECORDER, now_ns

    made = []
    windows = []
    files = []
    make, profile = classify.make_classifier, harness.profiler
    classify_file = harness.classify_file

    def make_and_keep(*args, **kw):
        clf = make(*args, **kw)
        made.append(weakref.ref(clf))
        return clf

    def profiler(dev):
        windows.append(Window(profile(dev), made[-1], RECORDER, now_ns))
        return windows[-1]

    def classify_alternating(db, clf, args, queries, out_dir):
        on = len(files) % 2 == (recorder_cost == "odd")
        if on:
            RECORDER.enable()
        t = time.perf_counter()
        try:
            classify_file(db, clf, args, queries, out_dir)
        finally:
            files.append((on, len(queries), time.perf_counter() - t))
            RECORDER.drain()
            RECORDER.disable()

    classify.make_classifier, harness.profiler = make_and_keep, profiler
    if recorder_cost:
        harness.classify_file = classify_alternating
    try:
        result = harness.run(cell, seed, seconds, not recorder_cost, t_start,
                             root=root, device=device, log=log)
    finally:
        classify.make_classifier, harness.profiler = make, profile
        harness.classify_file = classify_file
        RECORDER.disable()
    if recorder_cost:
        size = max(n for _, n, _ in files)
        on = sorted(t for o, n, t in files if o and n == size)
        off = sorted(t for o, n, t in files if not o and n == size)
        result["recorder_cost"] = {
            "on_s": on, "off_s": off,
            "median_ratio": on[len(on) // 2] / off[len(off) // 2]
            if on and off else None}
        return result
    w = windows[-1]
    off = w.drained["offset_ns"]
    result["breakdown"]["idle_gaps"] = gaps.idle_gaps(
        yardstick.device_events(w), w.drained["spans"],
        threading.get_native_id(), off, w.t0 + off, w.t1 + off)
    n_batches = sum(1 for s in w.drained["spans"] if s["name"] == "engine.submit")
    ctx = SimpleNamespace(
        n_batches=n_batches, counters=w.counters, span_seconds=w.span_seconds,
        phases={"submit": w.span_seconds.get("engine.submit", 0.0)})
    for name in READ_HERE:
        v = harness.load_reader(root, name)(ctx)
        if v is not None:
            result["metrics"].setdefault(name, {"value": float(v)})
    result["program"] = {
        "counters": w.counters, "batches": n_batches,
        "dropped": w.drained["dropped"], "window_ms": (w.t1 - w.t0) / 1e6,
        "span_ms_per_batch": {k: v * 1e3 / max(n_batches, 1)
                              for k, v in sorted(w.span_seconds.items())},
    }
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--recorder-cost", choices=["odd", "even"], default=None)
    a = ap.parse_args(argv)

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("portbench: needs a CUDA device", file=sys.stderr)
        return 2

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    try:
        result = traced(a.workload, a.seed, a.seconds, a.recorder_cost,
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
