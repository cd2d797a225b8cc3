"""The slice as a whole on the CPU: the port's engine (``device="cpu"``)
against its own host oracle and against the JAX package's exact engine, on
worlds built once by the JAX package's ``build_database``. Output strings
compare byte for byte."""

from collections import deque

import numpy as np
import pytest

from raxtax_tpu.db.database import build_database
from raxtax_tpu.utils.encoding import encode_sequence
from raxtax_tpu_torch.db.database import ensure_kmer_layout
from raxtax_tpu_torch.engine.device import DeviceClassifier, auto_batch_size
from raxtax_tpu_torch.models.oracle import OracleClassifier
from raxtax_tpu_torch.utils.encoding import sequence_to_kmers
from tests.test_fuzz_parity import make_world
from tests.test_torch_common import port_db

COMBOS = [
    (9100, False, False, True),
    (9101, True, False, True),
    (9102, False, True, False),
    (9103, True, True, True),
    (9104, False, False, False),
]


def _classify(dev, queries, bs=4):
    got = []
    for lo in range(0, len(queries), bs):
        got += dev.classify_batch(queries[lo : lo + bs])
    return got


def _assert_same(got, want_of, queries):
    for (label, seq), qr in zip(queries, got):
        want = want_of(label, seq)
        assert qr.out_string() == want.out_string(), label
        assert qr.tsv_string() == want.tsv_string(), label


@pytest.mark.parametrize("seed,skip_exact,raw_conf,split2", COMBOS)
def test_port_engine_equals_oracle(seed, skip_exact, raw_conf, split2):
    jdb, queries = make_world(seed)
    db = port_db(jdb)
    dev = DeviceClassifier.create(
        db, batch_size=4, skip_exact_matches=skip_exact,
        raw_confidence=raw_conf, split2=split2, device="cpu",
        debug_checks=True,
    )
    orc = OracleClassifier(
        db, skip_exact_matches=skip_exact, raw_confidence=raw_conf
    )
    _assert_same(_classify(dev, queries), orc.classify, queries)


@pytest.mark.parametrize("seed,skip_exact,raw_conf,split2", [COMBOS[1], COMBOS[2]])
def test_port_engine_equals_jax_exact_engine(
    seed, skip_exact, raw_conf, split2, monkeypatch
):
    from raxtax_tpu.engine.device import DeviceClassifier as JaxClassifier
    from raxtax_tpu.ops.intersect_pallas import prepare_kmer_major

    monkeypatch.setenv("RAXTAX_EXACT", "1")
    monkeypatch.setenv("RAXTAX_SPARSE_FOLD", "0")
    monkeypatch.setenv("RAXTAX_FUSED_GATHER", "1")
    monkeypatch.setenv("RAXTAX_SPLIT2", "1" if split2 else "0")
    jdb, queries = make_world(seed)
    jdev = JaxClassifier.create(
        jdb, backend="pallas", batch_size=4,
        skip_exact_matches=skip_exact, raw_confidence=raw_conf,
    )
    assert jdev.kmer_major.ndim == 3  # the fused-gather fold (K1)
    want = []
    for lo in range(0, len(queries), 4):
        want += jdev.classify_batch(queries[lo : lo + 4])
    assert jdev._exact_mode
    dev = DeviceClassifier.create(
        port_db(jdb), batch_size=4, skip_exact_matches=skip_exact,
        raw_confidence=raw_conf, split2=split2, device="cpu",
    )
    got = _classify(dev, queries)
    for g, w in zip(got, want):
        assert g.out_string() == w.out_string(), g.label
        assert g.tsv_string() == w.tsv_string(), g.label


def test_pipelined_loop_equals_classify_batch():
    """The three-deep submit / prepare / finalize loop of ``run_queries``
    gives what batch-at-a-time classification gives."""
    jdb, queries = make_world(9200)
    db = port_db(jdb)
    dev = DeviceClassifier.create(db, batch_size=2, device="cpu")
    got = []
    prepared: deque = deque()
    for lo in range(0, len(queries), 2):
        a = dev.submit_batch(queries[lo : lo + 2])
        if len(prepared) >= 2:
            got += dev.finalize_batch(prepared.popleft())
        prepared.append(dev.prepare_batch(a))
    while prepared:
        got += dev.finalize_batch(prepared.popleft())
    ref = _classify(DeviceClassifier.create(db, batch_size=2, device="cpu"),
                    queries, bs=2)
    assert [g.label for g in got] == [l for l, _ in queries]
    for g, r in zip(got, ref):
        assert g.out_string() == r.out_string()
        assert g.tsv_string() == r.tsv_string()
    orc = OracleClassifier(db)
    _assert_same(got, orc.classify, queries)


def test_flat_layout_and_forced_signal_replay_equal_oracle():
    """The flat postings layout (bit-major planes are tip order) and the
    sequential global-signal replay from a decoded count row."""
    jdb, queries = make_world(9101)
    db = ensure_kmer_layout(port_db(jdb), "flat")
    assert db.kmer_layout == "flat"
    dev = DeviceClassifier.create(
        db, batch_size=4, device="cpu", skip_exact_matches=True,
        debug_checks=True,
    )
    dev.force_signal_replay = True
    orc = OracleClassifier(db, skip_exact_matches=True)
    _assert_same(_classify(dev, queries), orc.classify, queries)


def test_no_native_library_python_replay_equals_oracle(monkeypatch):
    """Without the native host library the engine's numpy / Python fallbacks
    (k-mer extraction, site finding, evaluation) give the same bytes."""
    from raxtax_tpu_torch import native

    jdb, queries = make_world(9103)
    db = port_db(jdb)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    dev = DeviceClassifier.create(db, batch_size=4, device="cpu")
    assert dev._evaluator is None
    orc = OracleClassifier(db)
    _assert_same(_classify(dev, queries), orc.classify, queries)


def test_query_with_more_than_1024_distinct_kmers():
    """A long query (> 1,024 distinct 8-mers, so a table wider than 1,024
    entries and 11 counter planes) classifies byte-equal to the oracle."""
    rng = np.random.default_rng(77)
    bases = "ACGT"
    fams = ["".join(bases[i] for i in rng.integers(0, 4, 1500)) for _ in range(3)]
    lineages, seqs = [], []
    for i in range(18):
        s = list(fams[i % 3])
        for _ in range(int(rng.integers(0, 40))):
            s[rng.integers(0, len(s))] = bases[rng.integers(0, 4)]
        seqs.append("".join(s))
        lineages.append(f"p:P{i % 2},f:F{i % 3},s:S{i}")
    jdb = build_database(lineages, [encode_sequence(s) for s in seqs])
    db = port_db(jdb)
    q = list(fams[1])
    for _ in range(25):
        q[rng.integers(0, len(q))] = bases[rng.integers(0, 4)]
    queries = [
        ("long", encode_sequence("".join(q))),
        ("member", encode_sequence(seqs[4])),
        ("short", encode_sequence(fams[2][:60])),
    ]
    assert sequence_to_kmers(queries[0][1]).size > 1024
    dev = DeviceClassifier.create(db, batch_size=4, device="cpu", debug_checks=True)
    got = dev.classify_batch(queries)
    assert dev._s_max_hw > 1024
    orc = OracleClassifier(db)
    _assert_same(got, orc.classify, queries)


def test_batch_size_and_chunk_checks():
    jdb, queries = make_world(9100)
    db = port_db(jdb)
    dev = DeviceClassifier.create(db, device="cpu", n_queries_hint=len(queries))
    assert dev.batch_size == auto_batch_size(dev.state, 0, len(queries)) == 32
    small = DeviceClassifier.create(db, device="cpu", batch_size=2)
    with pytest.raises(ValueError):
        small.submit_batch(queries[:3])
    assert small.classify_batch([]) == []
