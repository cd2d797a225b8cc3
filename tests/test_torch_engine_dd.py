"""The second slice as a whole on the CPU: the port's engine in its
double-f32 mode (``significance="dd"``, ``fold="sparse"``, ``device="cpu"``)
against the JAX package's default engine (``RAXTAX_EXACT=0``, ``--backend
pallas``: its Pallas kernels run in interpret mode), against the port's own
host oracle and against the goldens. Output strings compare byte for
byte. The random worlds are in ``test_torch_engine_dd_worlds.py``, the
replays and flips in ``test_torch_engine_dd_replays.py``: no file of the
port's slow parity tests holds more than ten tests (ROADMAP, tier-1's
clock)."""

from collections import deque
from pathlib import Path

import numpy as np
import pytest

from raxtax_tpu.db.database import build_database
from raxtax_tpu.utils.encoding import encode_sequence
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
