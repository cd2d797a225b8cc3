"""The device's idle time by program span (``portbench/gaps.py``), the
readers of the program's spans and counters, and a traced run on the CPU
(``portbench/traced.py``)."""

import json
import time
from types import SimpleNamespace

import pytest

from portbench import gaps, harness
from portbench.tests.tiny import REPO, make_root

MS = 10**6
LOOP, OTHER = 11, 22


def _span(name, a, b, tid=LOOP):
    return {"name": name, "start_ns": a * MS, "end_ns": b * MS, "tid": tid}


def test_idle_time_goes_to_the_innermost_span_of_the_loops_thread():
    # window 0-100 ms; the device busy 10-20 and 15-30 (one busy 10-30),
    # and 60-70
    events = [("k1", 10 * MS, 10 * MS), ("k2", 15 * MS, 15 * MS),
              ("k3", 60 * MS, 10 * MS), ("before", -5 * MS, 6 * MS)]
    assert gaps.idle_intervals(events, 0, 100 * MS) == [
        (1 * MS, 10 * MS), (30 * MS, 60 * MS), (70 * MS, 100 * MS)]
    spans = [
        _span("engine.prepare", 0, 50),
        _span("engine.prepare.model", 5, 40),  # nested: wins inside it
        _span("model.ktable_build", 32, 35),  # nested twice
        _span("engine.finalize", 55, 90),
        _span("writer.join", 0, 100, tid=OTHER),  # another thread: no credit
    ]
    # the spans are on the program's clock, 1 s behind the profiler's
    off = 1000 * MS
    shifted = [dict(s, start_ns=s["start_ns"] - off, end_ns=s["end_ns"] - off)
               for s in spans]
    got = dict(map(tuple, gaps.idle_gaps(events, shifted, LOOP, off, 0, 100 * MS)))
    want = {
        "engine.prepare": (5 - 1) + (50 - 40),
        "engine.prepare.model": (10 - 5) + (32 - 30) + (40 - 35),
        "model.ktable_build": 35 - 32,
        gaps.NO_SPAN: (55 - 50) + (100 - 90),
        "engine.finalize": (60 - 55) + (90 - 70),
    }
    assert got == pytest.approx({k: v / 1e3 for k, v in want.items()})
    assert sum(got.values()) == pytest.approx((100 - 1 - 20 - 10) / 1e3)
    # the ten largest, largest first
    listed = gaps.idle_gaps(events, shifted, LOOP, off, 0, 100 * MS, n=2)
    assert [k for k, _ in listed] == ["engine.finalize", gaps.NO_SPAN]


def test_a_window_no_span_covers_is_all_no_span():
    assert gaps.idle_gaps([], [], LOOP, 0, 0, 3 * MS) == [[gaps.NO_SPAN, 0.003]]
    assert gaps.innermost([(0, 5, "a"), (5, 9, "b"), (5, 7, "c")]) == [
        (0, 5, "a"), (5, 7, "c"), (7, 9, "b")]


def test_the_readers_of_spans_and_counters():
    ctx = SimpleNamespace(
        n_batches=4, phases={"submit": 0.02},
        span_seconds={"engine.prepare.hist_wait": 0.006},
        counters={"queries": 1000, "model.closed_form": 200,
                  "ktable.builds": 3, "descent.sites": 450})
    want = {"engine.submit_ms": 5.0, "engine.hist_wait_ms": 1.5,
            "host_model.closed_form_share": 20.0,
            "host_model.table_builds_per_kq": 3.0,
            "descent.sites_per_kq": 450.0}
    for name, v in want.items():
        assert harness.load_reader(REPO, name)(ctx) == pytest.approx(v)
    # the context of a run without the program's spans and counters (the
    # harness's own): nothing, and no error
    bare = SimpleNamespace(n_batches=4, phases={}, queries=1000)
    for name in want:
        assert harness.load_reader(REPO, name)(bare) is None


def test_a_traced_run_puts_the_idle_window_on_spans(tmp_path):
    from portbench import traced
    from raxtax_tpu_torch.utils.trace import RECORDER

    root = make_root(tmp_path)
    r = traced.traced("tinycoi.known", 2**31 + 7, 0.2, None,
                      time.perf_counter(), root=root, device="cpu",
                      log=lambda m: None)
    assert r["correct"] is True and not RECORDER.enabled
    listed = dict(map(tuple, r["breakdown"]["idle_gaps"]))
    # on the CPU no device interval: the whole window is idle, and the ten
    # names listed hold most of it
    window_s = r["program"]["window_ms"] / 1e3
    assert 0.9 * window_s < sum(listed.values()) <= window_s * (1 + 1e-9)
    assert "engine.prepare.dispatch" in listed and listed[gaps.NO_SPAN] < 0.5 * sum(
        listed.values())
    c = r["program"]["counters"]
    assert c["queries"] == r["attempted"] and r["program"]["batches"] > 0
    for name in traced.READ_HERE:
        assert name in r["metrics"], name
    assert json.dumps(r)
