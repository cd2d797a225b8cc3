"""The second slice as a whole on the CPU: the port's engine in its
double-f32 mode (``significance="dd"``, ``fold="sparse"``, ``device="cpu"``)
against the JAX package's default engine (``RAXTAX_EXACT=0``, ``--backend
pallas``: its Pallas kernels run in interpret mode), against the port's own
host oracle and against the goldens. Output strings compare byte for
byte."""

from collections import deque
from pathlib import Path

import numpy as np
import pytest

from raxtax_tpu.db.database import build_database
from raxtax_tpu.utils.encoding import encode_sequence
from raxtax_tpu_torch.engine import device as tdev
from raxtax_tpu_torch.engine.device import DeviceClassifier
from raxtax_tpu_torch.models.oracle import OracleClassifier
from tests.test_fuzz_parity import make_world
from tests.test_torch_common import port_db

DATA = Path(__file__).resolve().parent / "data"
FLAGS = [(False, False), (True, False), (False, True), (True, True)]


def _classify(dev, queries, bs):
    got = []
    for lo in range(0, len(queries), bs):
        got += dev.classify_batch(queries[lo : lo + bs])
    return got


def _pipelined(dev, queries, bs):
    got, prepared = [], deque()
    for lo in range(0, len(queries), bs):
        a = dev.submit_batch(queries[lo : lo + bs])
        if len(prepared) >= 2:
            got += dev.finalize_batch(prepared.popleft())
        prepared.append(dev.prepare_batch(a))
    while prepared:
        got += dev.finalize_batch(prepared.popleft())
    return got


def _assert_oracle(db, got, queries, skip=False, raw=False):
    orc = OracleClassifier(db, skip_exact_matches=skip, raw_confidence=raw)
    for (label, seq), qr in zip(queries, got):
        want = orc.classify(label, seq)
        assert qr.out_string() == want.out_string(), label
        assert qr.tsv_string() == want.tsv_string(), label


def _family_world(seed=11, n_refs=96):
    """Queries match a whole family of references: counts above 15 on many
    tips, thin probability mass, dense fallback descents and near-ties."""
    rng = np.random.default_rng(seed)

    def rseq(n):
        return "".join("ACGT"[i] for i in rng.integers(0, 4, n))

    def mutate(s, rate):
        return "".join(
            "ACGT"[rng.integers(0, 4)] if rng.random() < rate else c for c in s
        )

    fams = [rseq(240) for _ in range(6)]
    lineages = [f"p:P{i % 2},f:F{i % 6},g:G{i % 24},s:S{i}" for i in range(n_refs)]
    seqs = [mutate(fams[i % 6], 0.08) for i in range(n_refs)]
    jdb = build_database(lineages, [encode_sequence(s) for s in seqs])
    queries = [
        (f"q{i}", encode_sequence(mutate(fams[i % 6], 0.03))) for i in range(16)
    ]
    # queries that match nothing: every tip ties, the root is a fallback
    # site and no device margin proves its descent
    queries += [(f"r{i}", encode_sequence(rseq(150))) for i in range(8)]
    return jdb, queries


def _two_queries(jdb, queries):
    """One query that is an exact copy of a reference and one that is not
    (so the flags change the output), where the world has both."""
    hits = jdb.exact_map.get_batch([s for _, s in queries])
    copy = next((q for q, h in zip(queries, hits) if len(h)), queries[0])
    other = next((q for q, h in zip(queries, hits) if not len(h)), queries[1])
    return [copy, other]


@pytest.mark.parametrize("skip_exact,raw_conf", FLAGS)
def test_dd_engine_equals_jax_default_engine(skip_exact, raw_conf, monkeypatch):
    """The JAX package's default single-device path (``--backend pallas``,
    sparse fold, ``RAXTAX_EXACT=0``: double-f32 with the wire and host
    replays; Pallas kernels interpreted) and the port's dd mode give the
    same bytes, which are the oracle's. One batch of two queries: the JAX
    side costs seconds per query slot in interpret mode."""
    from raxtax_tpu.engine.device import DeviceClassifier as JaxClassifier

    monkeypatch.setenv("RAXTAX_EXACT", "0")
    monkeypatch.delenv("RAXTAX_SPARSE_FOLD", raising=False)
    monkeypatch.delenv("RAXTAX_BM_SCAN", raising=False)
    jdb, queries = make_world(9101)
    queries = _two_queries(jdb, queries)
    jdev = JaxClassifier.create(
        jdb, backend="pallas", batch_size=2,
        skip_exact_matches=skip_exact, raw_confidence=raw_conf,
    )
    assert jdev._sparse and jdev._interpret
    want = jdev.classify_batch(queries)
    assert not jdev._exact_mode and jdev._sparse
    db = port_db(jdb)
    dev = DeviceClassifier.create(
        db, batch_size=2, skip_exact_matches=skip_exact,
        raw_confidence=raw_conf, device="cpu", significance="dd",
        fold="sparse", debug_checks=True,
    )
    got = dev.classify_batch(queries)
    assert dev._sparse and not dev._exact_mode
    for g, w in zip(got, want):
        assert g.out_string() == w.out_string(), g.label
        assert g.tsv_string() == w.tsv_string(), g.label
    _assert_oracle(db, got, queries, skip_exact, raw_conf)


@pytest.mark.parametrize("skip_exact,raw_conf", FLAGS)
def test_dd_engine_equals_oracle_and_goldens(skip_exact, raw_conf):
    """The golden references and queries through the port's dd mode:
    byte-equal to the oracle for all four flag combinations and to the three
    committed golden file pairs."""
    from raxtax_tpu.io.fasta import (
        parse_query_fasta_file,
        parse_reference_fasta_file,
    )

    recs = parse_reference_fasta_file(str(DATA / "golden_refs.fasta"))
    jdb = build_database(recs.lineages, recs.sequences)
    queries = parse_query_fasta_file(str(DATA / "golden_queries.fasta"))
    db = port_db(jdb)
    dev = DeviceClassifier.create(
        db, batch_size=4, skip_exact_matches=skip_exact,
        raw_confidence=raw_conf, device="cpu", significance="dd",
        fold="sparse", debug_checks=True,
    )
    got = _pipelined(dev, queries, 4)
    _assert_oracle(db, got, queries, skip_exact, raw_conf)
    suffix = {(False, False): "", (False, True): "_rawconf",
              (True, False): "_skipexact"}.get((skip_exact, raw_conf))
    if suffix is not None:
        out = "".join(g.out_string() + "\n" for g in got)
        tsv = "".join(g.tsv_string() + "\n" for g in got)
        assert out == (DATA / f"golden_raxtax{suffix}.out").read_text()
        assert tsv == (DATA / f"golden_raxtax{suffix}.tsv").read_text()


@pytest.mark.parametrize("seed", [1044, 1054, 7])
@pytest.mark.parametrize("split2,bm_scan", [(True, False), (False, False), (True, True)])
def test_dd_engine_equals_oracle_on_random_worlds(seed, split2, bm_scan):
    """Small uniform worlds put confidences on half-cent boundaries and
    descents on exact ties: the risk-band and margin replays decide."""
    jdb, queries = make_world(seed)
    db = port_db(jdb)
    dev = DeviceClassifier.create(
        db, batch_size=4, device="cpu", significance="dd", fold="sparse",
        split2=split2, bm_scan=bm_scan, debug_checks=True,
    )
    _assert_oracle(db, _classify(dev, queries, 4), queries)


def _boundary_world():
    """Eight equal references under each genus give each a confidence of
    1/8 = 0.125, on a half-cent boundary."""
    rng = np.random.default_rng(3)
    base = "".join("ACGT"[i] for i in rng.integers(0, 4, 120))
    other = "".join("ACGT"[i] for i in rng.integers(0, 4, 120))
    lineages = [f"p:P,g:G{i // 8},s:S{i}" for i in range(16)]
    jdb = build_database(
        lineages, [encode_sequence(s) for s in [base] * 8 + [other] * 8]
    )
    queries = [
        (f"{name}{i}", encode_sequence(s))
        for i in range(3) for name, s in (("copy", base), ("other", other))
    ]
    return jdb, queries


def test_confidence_inside_the_risk_band_replays_on_the_host():
    """The double-f32 value of 0.125 lands inside the risk band and the
    query's confidences are recomputed from its wire row."""
    jdb, queries = _boundary_world()
    db = port_db(jdb)
    dev = DeviceClassifier.create(
        db, batch_size=2, device="cpu", significance="dd", fold="sparse",
        raw_confidence=True,
    )
    got = dev.classify_batch(queries[:2])
    assert dev.host_replays == 2 and dev._fb_dense and not dev._exact_mode
    _assert_oracle(db, got, queries[:2], raw=True)


@pytest.mark.parametrize("pipelined", [False, True])
def test_overflow_beyond_the_budget_redoes_with_the_full_lookup(pipelined):
    """More tips above 15 than overflow slots: the batch's significance is
    redone with the full-width lookup, the flag sticks, and a batch prepared
    before the flip gets its own redo."""
    jdb, queries = _family_world()
    db = port_db(jdb)
    dev = DeviceClassifier.create(
        db, batch_size=8, device="cpu", significance="dd", fold="sparse"
    )
    dev._over_budget = 2
    run = _pipelined if pipelined else _classify
    got = run(dev, queries, 8)
    assert dev._mux_dense
    _assert_oracle(db, got, queries)


def test_auto_flips_to_exact_and_still_matches():
    """Every query replays on the host: ``auto`` flips to the exact path
    for the rest of the run. The two batches in flight at the flip finish on
    the double-f32 path, the third runs exact; all are byte-equal to the
    oracle. ``dd`` never flips."""
    jdb, queries = _boundary_world()
    db = port_db(jdb)
    dev = DeviceClassifier.create(
        db, batch_size=2, device="cpu", significance="auto", fold="sparse",
        raw_confidence=True,
    )
    assert not dev._exact_mode
    got = _pipelined(dev, queries, 2)
    assert dev._exact_mode and dev.host_replays == 4
    _assert_oracle(db, got, queries, raw=True)
    dd = DeviceClassifier.create(
        db, batch_size=2, device="cpu", significance="dd", fold="sparse",
        raw_confidence=True,
    )
    _classify(dd, queries, 2)
    assert not dd._exact_mode and dd.host_replays == 6


def test_sparse_fold_flips_to_dense_over_the_budget(monkeypatch):
    jdb, queries = make_world(99)
    db = port_db(jdb)
    monkeypatch.setattr(tdev, "SPARSE_BUDGET_MIN", 4)
    dev = DeviceClassifier.create(
        db, batch_size=4, device="cpu", significance="dd", fold="sparse"
    )
    got = _classify(dev, queries, 4)
    assert not dev._sparse
    _assert_oracle(db, got, queries)


def test_device_descent_with_margins_and_no_native_library(monkeypatch):
    """Past the host-work budget the sites descend on the device with
    margins and only the marginal ones replay; without the native library
    the numpy decoders of the wire give the same bytes."""
    from raxtax_tpu_torch import native

    jdb, queries = _family_world(seed=13)
    db = port_db(jdb)
    dev = DeviceClassifier.create(
        db, batch_size=8, device="cpu", significance="dd", fold="sparse",
        skip_exact_matches=True,
    )
    dev.DESCEND_HOST_WORK = 0
    _assert_oracle(db, _classify(dev, queries, 8), queries, skip=True)
    assert dev.host_replays > 0 and not dev._exact_mode
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    slow = DeviceClassifier.create(
        db, batch_size=8, device="cpu", significance="dd", fold="sparse"
    )
    slow.force_signal_replay = True
    _assert_oracle(db, slow.classify_batch(queries[12:20]), queries[12:20])
    assert slow.host_replays > 0


def test_mode_arguments_are_checked():
    jdb, _ = make_world(7)
    db = port_db(jdb)
    with pytest.raises(ValueError):
        DeviceClassifier.create(db, device="cpu", significance="f32")
    with pytest.raises(ValueError):
        DeviceClassifier.create(db, device="cpu", fold="blocked")
    with pytest.raises(ValueError):
        DeviceClassifier.create(db, device="cpu", counts="sparse")
    with pytest.raises(ValueError):
        DeviceClassifier.create(db, device="cpu", descent="host")
    # the planes backends take the single-tip split where split2 is off
    s = DeviceClassifier.create(db, device="cpu", split_sig=True, split2=False,
                                significance="dd")
    assert s.state.split_sig is not None and s.state.split2 is None
    # and upload it only where a compaction reads it
    for kw in ({"significance": "dd"}, {"split2": False}):
        u = DeviceClassifier.create(db, device="cpu", split_sig=True, **kw)
        assert u.state.split_sig is None
    d = DeviceClassifier.create(db, device="cpu")
    assert d.significance == "exact" and not d._sparse and d._exact_mode
    assert d.descent == "exact" and d.state.split_sig is None
