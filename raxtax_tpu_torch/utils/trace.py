"""The program's spans, and profiler traces of the classification phase
(``cli.py --trace DIR``).

Spans: ``with RECORDER.span("engine.prepare", batch=seq):`` times a stretch
of host work on :func:`now_ns`, a monotonic clock. Every span adds its
nanoseconds to ``RECORDER.totals`` by name, always. While the recorder is
enabled it also keeps a record of each span (its id, its parent's id, name,
start and end, thread and batch) in a bounded buffer, counting the spans it
had no room for; :meth:`SpanRecorder.drain` hands the records over with the
conversion of :func:`now_ns` readings to the clock of ``torch.profiler``'s
events (Unix nanoseconds, as ``_KinetoEvent.start_ns()`` and the trace
file's ``baseTimeNanoseconds`` read), sampled when the recorder was
enabled. Nothing is written anywhere unless ``--trace DIR`` asks for it.

Traces: the JAX package wraps its classification phase in
``jax.profiler.trace``; here it is ``torch.profiler.profile`` with the
host's operators and, on the GPU, every kernel the device ran (CUPTI sees
the ``csrc/`` kernels launched through ``ctypes`` as well as torch's own).
The trace lands in ``DIR`` as ``<host>_<pid>.<time>.pt.trace.json`` through
``torch.profiler.tensorboard_trace_handler``, with the program's spans of the
block added to it (category ``program_span``) on the same timeline, and the
classifier's counters over the block under the file's ``programCounters``
key: TensorBoard's profiler plugin and Perfetto read it.
"""

from __future__ import annotations

import itertools
import json
import os
import re
import threading
import time
from contextlib import contextmanager
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"

#: span records kept while the recorder is enabled (about 200 bytes each);
#: spans past it are counted in ``dropped`` and not kept
MAX_RECORDS = 1 << 18


def now_ns() -> int:
    """The recorder's clock: monotonic nanoseconds."""
    return time.perf_counter_ns()


def profiler_offset_ns() -> int:
    """Nanoseconds to add to a :func:`now_ns` reading to put it on the
    profiler's clock (Unix time): of 16 Unix readings, the one whose
    bracketing :func:`now_ns` pair is tightest, against the pair's
    midpoint."""
    best = None
    for _ in range(16):
        a = now_ns()
        unix = time.time_ns()
        b = now_ns()
        if best is None or b - a < best[0]:
            best = (b - a, unix - (a + b) // 2)
    return best[1]


class _Span:
    """One timed stretch; ``seconds`` holds its length once it has ended."""

    __slots__ = ("_rec", "name", "batch", "start_ns", "seconds", "_id",
                 "_parent")

    def __init__(self, rec: "SpanRecorder", name: str, batch):
        self._rec = rec
        self.name = name
        self.batch = batch
        self.seconds = 0.0

    def __enter__(self):
        rec = self._rec
        self._id = 0
        if rec._records is not None:
            stack = rec._stack()
            self._parent = stack[-1] if stack else 0
            self._id = next(rec._ids)
            stack.append(self._id)
        self.start_ns = now_ns()
        return self

    def __exit__(self, *exc):
        end = now_ns()
        ns = end - self.start_ns
        self.seconds = ns / 1e9
        rec = self._rec
        rec.totals[self.name] = rec.totals.get(self.name, 0) + ns
        if self._id:
            rec._stack().pop()
            rec._keep((self._id, self._parent, self.name, self.start_ns, end,
                       threading.get_native_id(), self.batch))
        return False


class SpanRecorder:
    """Span totals by name (always) and span records (while enabled)."""

    def __init__(self, capacity: int = MAX_RECORDS):
        #: nanoseconds by span name since the process started
        self.totals: dict[str, int] = {}
        self.capacity = capacity
        #: spans that ended while the buffer was full, since the last drain
        self.dropped = 0
        self.offset_ns = 0
        self._records: list | None = None
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()

    def span(self, name: str, batch: int | None = None) -> _Span:
        return _Span(self, name, batch)

    @property
    def enabled(self) -> bool:
        return self._records is not None

    def enable(self) -> None:
        """Keep span records from now on, and sample the clock conversion."""
        with self._lock:
            if self._records is None:
                self.offset_ns = profiler_offset_ns()
                self.dropped = 0
                self._records = []

    def disable(self) -> None:
        """Keep no more records; those not drained are discarded."""
        with self._lock:
            self._records = None

    def drain(self) -> dict:
        """The records kept since the last drain, which empties the buffer:
        ``{"spans": [{id, parent, name, start_ns, end_ns, tid, batch}],
        "dropped", "offset_ns"}``. Times are :func:`now_ns` readings; add
        ``offset_ns`` for the profiler's clock. A parent of 0 is none."""
        with self._lock:
            recs = self._records or []
            if self._records is not None:
                self._records = []
            out = {"dropped": self.dropped, "offset_ns": self.offset_ns}
            self.dropped = 0
        keys = ("id", "parent", "name", "start_ns", "end_ns", "tid", "batch")
        out["spans"] = [dict(zip(keys, r)) for r in recs]
        return out

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _keep(self, record: tuple) -> None:
        recs = self._records
        if recs is None:
            return
        if len(recs) < self.capacity:
            recs.append(record)
        else:
            self.dropped += 1


#: the process's one recorder
RECORDER = SpanRecorder()


def span(name: str, batch: int | None = None) -> _Span:
    """A span of :data:`RECORDER`."""
    return RECORDER.span(name, batch)


@contextmanager
def classification_trace(trace_dir, device="cuda"):
    """Profile the enclosed block into ``trace_dir``: host operators always,
    device kernels when ``device`` is a CUDA device, and the program's spans
    of the block, added to the profiler's trace file. The block is handed a
    dict: the counters it puts there are written beside the spans."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    Path(trace_dir).mkdir(parents=True, exist_ok=True)
    before = set(trace_files(trace_dir))
    counters: dict = {}
    RECORDER.enable()
    try:
        with profile(
            activities=activities,
            on_trace_ready=tensorboard_trace_handler(str(trace_dir)),
        ):
            yield counters
        spans = RECORDER.drain()
    finally:
        RECORDER.disable()
    new = [f for f in trace_files(trace_dir) if f not in before]
    if new:
        add_spans_to_trace(max(new, key=lambda f: f.stat().st_mtime), spans,
                           counters)


def add_spans_to_trace(path: Path, drained: dict,
                       counters: dict | None = None) -> None:
    """Add drained spans to a profiler trace file as complete events of
    category ``program_span`` on the spans' threads, in the file's time base
    (microseconds after its ``baseTimeNanoseconds``); ``programCounters``
    holds ``counters`` and the spans dropped (``spans.dropped``)."""
    data = json.loads(Path(path).read_text())
    base = int(data.get("baseTimeNanoseconds", 0))
    shift = drained["offset_ns"] - base
    pid = os.getpid()
    data.setdefault("traceEvents", []).extend(
        {"ph": "X", "cat": "program_span", "name": s["name"], "pid": pid,
         "tid": s["tid"], "ts": (s["start_ns"] + shift) / 1e3,
         "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
         "args": {"id": s["id"], "parent": s["parent"], "batch": s["batch"]}}
        for s in drained["spans"]
    )
    data["programCounters"] = {**(counters or {}),
                               "spans.dropped": drained["dropped"]}
    Path(path).write_text(json.dumps(data))


def trace_files(trace_dir) -> list[Path]:
    return sorted(Path(trace_dir).glob("*.pt.trace.json*"))


def trace_kernel_names(trace_dir) -> set[str]:
    """Names of the device kernels (``cat`` ``kernel``) in every trace file
    under ``trace_dir``."""
    import gzip

    names: set[str] = set()
    for f in trace_files(trace_dir):
        opener = gzip.open if f.suffix == ".gz" else open
        with opener(f, "rt") as fh:
            events = json.load(fh).get("traceEvents", [])
        names.update(
            e["name"] for e in events
            if isinstance(e, dict) and e.get("cat") == "kernel" and "name" in e
        )
    return names


def csrc_kernels(csrc: Path = CSRC) -> set[str]:
    """The ``__global__`` function names of the package's CUDA sources."""
    pat = re.compile(
        r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\("
    )
    return {m for f in csrc.glob("*.cu*") for m in pat.findall(f.read_text())}


def csrc_kernels_in(trace_dir, csrc: Path = CSRC) -> list[str]:
    """The ``csrc/`` kernels a trace names, matched on the function name
    inside the demangled kernel name."""
    wanted = csrc_kernels(csrc)
    return sorted({
        k for name in trace_kernel_names(trace_dir) for k in wanted
        if re.search(rf"\b{k}\b", name)
    })
