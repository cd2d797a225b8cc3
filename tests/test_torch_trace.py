"""The program's spans and counters (``utils/trace.py``, the engine's
``phase_seconds`` and ``counters``) on the goldens' world, on the CPU."""

import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from raxtax_tpu_torch.db.database import build_database
from raxtax_tpu_torch.engine.classify import run_queries
from raxtax_tpu_torch.engine.device import DeviceClassifier
from raxtax_tpu_torch.io.fasta import (
    parse_query_fasta_file,
    parse_reference_fasta_file,
)
from raxtax_tpu_torch.io.outputs import OutputWriters, ResultWriter
from raxtax_tpu_torch.utils.encoding import sequence_to_kmers
from raxtax_tpu_torch.utils.trace import (
    RECORDER,
    SpanRecorder,
    classification_trace,
    trace_files,
)

DATA = Path(__file__).resolve().parent / "data"
BATCH = 4
ENGINE = ("engine.submit", "engine.prepare", "engine.finalize")
CHILDREN = {
    "engine.submit": {"engine.submit.kmers", "engine.submit.dispatch"},
    "engine.prepare": {"engine.prepare.hist_wait", "engine.prepare.model",
                       "engine.prepare.dispatch"},
    "engine.finalize": {"engine.finalize.pull", "engine.finalize.descend",
                        "engine.finalize.eval"},
}


@pytest.fixture(scope="module")
def world():
    recs = parse_reference_fasta_file(DATA / "golden_refs.fasta")
    db = build_database(recs.lineages, recs.sequences)
    return db, recs, parse_query_fasta_file(DATA / "golden_queries.fasta")


@pytest.fixture
def recorder():
    """The process's recorder, enabled for the test and left disabled."""
    RECORDER.drain()
    RECORDER.enable()
    try:
        yield RECORDER
    finally:
        RECORDER.disable()


def _classifier(db) -> DeviceClassifier:
    return DeviceClassifier.create(db, batch_size=BATCH, device="cpu")


def _run(db, queries, clf, out: Path):
    out.mkdir()
    writers = OutputWriters(
        primary=open(out / "raxtax.out", "w"), tsv=open(out / "raxtax.tsv", "w"),
        log=open(out / "raxtax.log", "w"), progress=open(out / "raxtax.ckp", "w"),
    )
    writer = ResultWriter(writers)
    try:
        run_queries(db, queries, SimpleNamespace(tsv=True), writer,
                    classifier=clf)
    finally:
        writer.join()
        writers.close()


def test_recorder_keeps_records_only_while_enabled_and_bounds_them():
    rec = SpanRecorder(capacity=3)
    with rec.span("a", 1):
        with rec.span("b", 1):
            pass
    assert rec.drain()["spans"] == [] and set(rec.totals) == {"a", "b"}
    rec.enable()

    def other_thread():
        with rec.span("t"):
            pass

    with rec.span("outer", 7) as outer:
        t = threading.Thread(target=other_thread)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        with rec.span("inner", 7):
            pass
    for _ in range(2):
        with rec.span("extra"):
            pass
    got = rec.drain()
    assert got["dropped"] == 2 and rec.drain()["spans"] == []
    by = {s["name"]: s for s in got["spans"]}
    # the thread's span ran inside "outer" but on its own stack: no parent
    assert by["inner"]["parent"] == by["outer"]["id"] and by["inner"]["batch"] == 7
    assert by["outer"]["parent"] == 0 == by["t"]["parent"]
    assert by["t"]["tid"] != by["outer"]["tid"]
    assert by["inner"]["tid"] == by["outer"]["tid"] == threading.get_native_id()
    assert outer.seconds == (by["outer"]["end_ns"] - by["outer"]["start_ns"]) / 1e9
    assert rec.totals["outer"] == by["outer"]["end_ns"] - by["outer"]["start_ns"]
    rec.disable()
    with rec.span("after"):
        pass
    assert rec.drain()["spans"] == []


def test_engine_spans_nest_and_carry_batch_ids(world, recorder, tmp_path):
    db, _, queries = world
    _run(db, queries, _classifier(db), tmp_path / "out")
    spans = recorder.drain()["spans"]
    by_id = {s["id"]: s for s in spans}
    names = [s["name"] for s in spans]
    assert names.count("writer.join") == 1
    (run,) = [s for s in spans if s["name"] == "query.run"]
    n_batches = -(-len(queries) // BATCH)
    for name in ENGINE:
        mine = [s for s in spans if s["name"] == name]
        assert [s["batch"] for s in mine] == list(range(1, n_batches + 1))
        assert all(by_id[s["parent"]] is run for s in mine)
    for s in spans:
        parent = by_id.get(s["parent"])
        if parent is None:
            continue
        assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] <= parent["end_ns"]
        if parent["name"] in CHILDREN:
            assert s["name"] in CHILDREN[parent["name"]]
            assert s["batch"] == parent["batch"]
    prewarm = [s for s in spans if s["name"] == "query.prewarm"]
    assert len(prewarm) == 1 and by_id[prewarm[0]["parent"]] is run
    builds = [s for s in spans if s["name"] == "model.ktable_build"]
    assert builds and all(
        by_id[s["parent"]]["name"] == "engine.prepare.model" for s in builds)


def test_phase_seconds_equal_the_span_totals(world):
    db, _, queries = world
    clf = _classifier(db)
    before = dict(RECORDER.totals)
    for lo in range(0, len(queries), BATCH):
        clf.classify_batch(queries[lo : lo + BATCH])
    spent = {k: (v - before.get(k, 0)) / 1e9 for k, v in RECORDER.totals.items()}
    for key, name in (("submit", "engine.submit"), ("prepare", "engine.prepare"),
                      ("finalize", "engine.finalize"),
                      ("finalize_pull", "engine.finalize.pull"),
                      ("finalize_descend", "engine.finalize.descend"),
                      ("finalize_eval", "engine.finalize.eval")):
        assert clf.phase_seconds[key] == pytest.approx(spent[name], rel=1e-12)
    assert clf.phase_seconds["finalize"] >= clf.phase_seconds["finalize_eval"] > 0


def test_closed_form_counts_queries_a_reference_holds_whole(world):
    db, recs, queries = world
    clf = _classifier(db)
    for lo in range(0, len(queries), BATCH):
        clf.classify_batch(queries[lo : lo + BATCH])
    ref_sets = [sequence_to_kmers(s) for s in recs.sequences]
    want = 0
    for _, seq in queries:
        q = sequence_to_kmers(seq)
        # the query's intersection-size histogram, from the 8-mer sets
        hist = np.bincount([np.intersect1d(q, r).size for r in ref_sets],
                           minlength=q.size + 1)
        want += int(hist[q.size] > 0)
    assert 0 < want < len(queries)
    assert clf.counters["model.closed_form"] == want
    assert clf.counters["queries"] == len(queries)


def test_ktable_builds_count_the_distinct_new_k(world):
    db, _, queries = world
    clf = _classifier(db)
    ks = {sequence_to_kmers(s).size for _, s in queries}
    for lo in range(0, len(queries), BATCH):
        clf.classify_batch(queries[lo : lo + BATCH])
    assert clf.counters["ktable.builds"] == len(ks - {0})
    clf.classify_batch(queries[:BATCH])
    assert clf.counters["ktable.builds"] == len(ks - {0})
    label, seq = queries[0]
    cut = next(seq[:-n] for n in range(1, 50)
               if sequence_to_kmers(seq[:-n]).size not in ks)
    clf.classify_batch([(label, cut), (label + "_again", cut)])
    assert clf.counters["ktable.builds"] == len(ks - {0}) + 1


def test_descent_sites_count_the_sites_handed_to_the_descents(world, monkeypatch):
    db, _, queries = world
    clf = _classifier(db)
    seen = []
    resolve = DeviceClassifier._resolve_fallbacks

    def spy(self, sites, st, cum_cache):
        seen.extend(sites)
        return resolve(self, sites, st, cum_cache)

    monkeypatch.setattr(DeviceClassifier, "_resolve_fallbacks", spy)
    for lo in range(0, len(queries), BATCH):
        clf.classify_batch(queries[lo : lo + BATCH])
    assert clf.counters["descent.sites"] == len(seen) > 0


def test_trace_puts_the_spans_around_their_host_operators(tmp_path):
    """On the profiler's clock each span encloses the host operators run
    inside it (``classification_trace`` on the CPU; the host operators'
    times are the profiler's own)."""
    import json

    import torch

    from raxtax_tpu_torch.utils.trace import span

    x = torch.arange(4096, dtype=torch.float64)
    with classification_trace(tmp_path / "tr", "cpu"):
        for i in range(50):
            with span("clock.check", i):
                x.cumsum(0).sum()
    (f,) = trace_files(tmp_path / "tr")
    events = json.loads(f.read_text())["traceEvents"]
    tid = threading.get_native_id()
    spans = sorted((e for e in events if e.get("cat") == "program_span"
                    and e["tid"] == tid), key=lambda e: e["ts"])
    ops = sorted((e for e in events if e.get("cat") == "cpu_op"
                  and e.get("tid") == tid and e["name"] == "aten::cumsum"),
                 key=lambda e: e["ts"])
    assert len(spans) == len(ops) == 50
    assert [e["args"]["batch"] for e in spans] == list(range(50))
    slack_us = 5.0
    for sp, op in zip(spans, ops):
        assert sp["ts"] - slack_us <= op["ts"]
        assert op["ts"] + op["dur"] <= sp["ts"] + sp["dur"] + slack_us
    assert not RECORDER.enabled
