"""The plain reference against the program on the CPU, byte for byte, and
the float32 control failing the same comparison."""

import time

import numpy as np
import pytest

from portbench import generator as g
from portbench import harness
from portbench.reference import Reference, k_tables, query_kmers, size_probs
from portbench.tests.tiny import CELLS, COI, SSU, make_root

SEED = 2**31 + 99


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("tiny"))


def run(root, cell, seed=SEED, trace=False):
    return harness.run(cell, seed, 0.05, trace, time.perf_counter(), root=root,
                       device="cpu", log=lambda m: None)


@pytest.mark.parametrize("cell", [c for c, _, _ in CELLS])
def test_harness_run_is_correct_on_the_cpu(root, cell):
    r = run(root, cell)
    assert r["correct"] is True
    assert r["check"]["lines_differ"]["value"] == 0
    assert r["check"]["lines_differ"]["queries"] >= 16
    assert r["check"]["unanswered"]["value"] == 0
    assert list(r)[-1] == "check"


@pytest.mark.parametrize("conf,traffic", [(COI, "known"), (SSU, "fulllength"),
                                          (SSU, "v4")])
def test_reference_equals_the_program_line_for_line(conf, traffic):
    """Every query of a file, against the program's own exact classifier."""
    from raxtax_tpu_torch.db.database import build_database
    from raxtax_tpu_torch.models.oracle import OracleClassifier

    from portbench.tests.tiny import TRAFFIC

    w = g.make_world(conf, 7)
    t = dict(TRAFFIC[traffic], file_queries=40, warmup_queries=8,
             check_queries=16)
    qf = g.Traffic(w, t, 7).file(0)
    db = build_database(w.lineages, w.port_sequences(), with_ref_major=False)
    oracle = OracleClassifier(db)
    ref = Reference(w.lineages, w.codes4, w.starts, w.lengths)
    for label, seq in qf.queries():
        out, tsv = ref.lines(label, seq)
        qr = oracle.classify(label, seq)
        assert "\n".join(out) == qr.out_string()
        assert "\n".join(tsv) == qr.tsv_string()


def test_exact_copies_print_confidence_one():
    w = g.make_world(COI, 3)
    ref = Reference(w.lineages, w.codes4, w.starts, w.lengths)
    out, _ = ref.lines("x", w.record(5))
    conf = out[0].split("\t")[2].split(",")
    assert len(out) == 1 and set(conf) == {"1.00"}


def test_query_kmers_are_distinct_and_skip_ambiguity():
    seq = np.array([1, 2, 4, 8] * 4 + [15] + [1] * 9, dtype=np.uint8)
    k = query_kmers(seq)
    assert k.size == len(set(k.tolist())) and (np.diff(k) > 0).all()
    # 16 unambiguous bases: 9 windows, 4 distinct; the N breaks 8 windows;
    # then nine As: one window
    assert k.size == 5
    assert 0 in k  # AAAAAAAA


def test_size_probs_full_match_path():
    t = k_tables(10, np.float64)
    hist = np.zeros(11, dtype=np.int64)
    hist[[3, 10]] = [5, 1]
    p = size_probs(hist, 10, t, np.float64)
    assert p[10] > p[3] > 0 and abs(hist @ p - 1.0) < 1e-12


@pytest.mark.parametrize("conf,traffic", [(COI, "known"), (SSU, "fulllength")])
def test_float32_control_differs(conf, traffic):
    """The reference in float32 differs from float64 on every seed."""
    from portbench.tests.tiny import TRAFFIC

    for seed in (1, 2, 3):
        w = g.make_world(conf, seed)
        t = dict(TRAFFIC[traffic], file_queries=40, warmup_queries=8,
                 check_queries=16)
        qf = g.Traffic(w, t, seed).file(0)
        ref = Reference(w.lineages, w.codes4, w.starts, w.lengths)
        low = ref.with_dtype(np.float32)
        differ = 0
        for label, seq in qf.queries():
            for a, b in zip(low.lines(label, seq), ref.lines(label, seq)):
                differ += harness.lines_differ(a, b)
        assert differ > 0, seed


def test_float32_control_in_the_programs_place_is_not_correct(root, monkeypatch):
    """The control answers through the program's loop and writer; the run's
    own check refuses it."""
    from raxtax_tpu_torch.engine.device import DeviceClassifier
    from raxtax_tpu_torch.models.oracle import QueryResult

    spec = harness.cell_spec(root, "tinycoi.known")
    w = g.make_world(spec.config, SEED)
    low = Reference(w.lineages, w.codes4, w.starts, w.lengths).with_dtype(np.float32)
    orig = DeviceClassifier.finalize_batch

    def control(self, state):
        results = orig(self, state)
        out = []
        for r in results:
            o, t = low.lines(r.label, r.sequence)
            out.append(QueryResult(label=r.label, results=[], sequence=r.sequence,
                                   out_text="\n".join(o), tsv_text="\n".join(t)))
        return out

    monkeypatch.setattr(DeviceClassifier, "finalize_batch", control)
    r = run(root, "tinycoi.known")
    assert r["correct"] is False and r["check"]["lines_differ"]["value"] > 0
