"""The third slice as a whole on the CPU: the port's engine with dense counts
(``counts="dense"``) against the JAX package's ``backend="xla"`` engine, the
host oracle and the goldens, its replay paths, and the planes the stream and
gathered folds hand on. Output strings compare byte for byte. (More of the
slice: ``test_torch_engine_dense.py`` for random worlds,
``test_torch_engine_folds.py`` and ``test_torch_engine_fold_modes.py`` for the
engine on the stream and gathered folds.)"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from raxtax_tpu.db.database import build_database
from raxtax_tpu_torch.engine.device import DeviceClassifier
from tests.test_fuzz_parity import make_world
from tests.test_torch_common import port_db
from tests.test_torch_engine_dd import (
    FLAGS,
    _assert_oracle,
    _boundary_world,
    _classify,
    _family_world,
    _pipelined,
)

DATA = Path(__file__).resolve().parent / "data"
GOLDEN_SUFFIX = {(False, False): "", (False, True): "_rawconf",
                 (True, False): "_skipexact"}


def _golden_world():
    from raxtax_tpu.io.fasta import (
        parse_query_fasta_file,
        parse_reference_fasta_file,
    )

    recs = parse_reference_fasta_file(str(DATA / "golden_refs.fasta"))
    jdb = build_database(recs.lineages, recs.sequences)
    return jdb, parse_query_fasta_file(str(DATA / "golden_queries.fasta"))


def _assert_goldens(got, skip_exact, raw_conf):
    suffix = GOLDEN_SUFFIX.get((skip_exact, raw_conf))
    if suffix is not None:
        out = "".join(g.out_string() + "\n" for g in got)
        tsv = "".join(g.tsv_string() + "\n" for g in got)
        assert out == (DATA / f"golden_raxtax{suffix}.out").read_text()
        assert tsv == (DATA / f"golden_raxtax{suffix}.tsv").read_text()


@pytest.mark.parametrize("skip_exact,raw_conf", FLAGS)
def test_dense_engine_equals_jax_xla_engine(skip_exact, raw_conf):
    """The JAX package's ``xla`` backend and the port's dense-count engine
    give the same bytes on a fuzz world and on the goldens, for every flag
    combination; both are the oracle's."""
    from raxtax_tpu.engine.device import DeviceClassifier as JaxClassifier

    for jdb, queries in (make_world(9101), _golden_world()):
        jdev = JaxClassifier.create(
            jdb, backend="xla", batch_size=4,
            skip_exact_matches=skip_exact, raw_confidence=raw_conf,
        )
        want = []
        for lo in range(0, len(queries), 4):
            want += jdev.classify_batch(queries[lo : lo + 4])
        db = port_db(jdb)
        dev = DeviceClassifier.create(
            db, batch_size=4, skip_exact_matches=skip_exact,
            raw_confidence=raw_conf, device="cpu", counts="dense",
            debug_checks=True,
        )
        assert not dev._exact_mode and dev.state.kmer_major3 is None
        got = _pipelined(dev, queries, 4)
        for g, w in zip(got, want):
            assert g.out_string() == w.out_string(), g.label
            assert g.tsv_string() == w.tsv_string(), g.label
        _assert_oracle(db, got, queries, skip_exact, raw_conf)
    _assert_goldens(got, skip_exact, raw_conf)


@pytest.mark.parametrize("native_lib", [True, False])
def test_dense_engine_replays_from_the_nibble_wire(native_lib, monkeypatch):
    """Every query of the boundary world replays on the host: the first batch
    gathers u16 rows, the next ones are prepared with the nibble wire
    (decoded by the native library, or by numpy without it). ``auto`` never
    flips a dense-count engine to the exact path."""
    from raxtax_tpu_torch import native
    from raxtax_tpu_torch.ops import compress

    if not native_lib:
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", True)
    calls = []
    orig = compress.compress_counts
    monkeypatch.setattr(
        "raxtax_tpu_torch.engine.device.compress_counts",
        lambda c: calls.append(1) or orig(c),
    )
    jdb, queries = _boundary_world()
    db = port_db(jdb)
    dev = DeviceClassifier.create(
        db, batch_size=2, device="cpu", counts="dense", significance="auto",
        raw_confidence=True,
    )
    dev.force_signal_replay = True
    got = _classify(dev, queries, 2)
    assert dev.host_replays == 6 and dev._fb_dense and not dev._exact_mode
    assert len(calls) == 2  # batches two and three
    _assert_oracle(db, got, queries, raw=True)


def test_dense_engine_overflowing_wire_falls_back_to_count_rows(monkeypatch):
    """A nibble wire whose overflow list is too short for a query is not
    used for it: its rows come from the count matrix."""
    from raxtax_tpu_torch.ops import compress

    orig = compress.compress_counts
    monkeypatch.setattr(
        "raxtax_tpu_torch.engine.device.compress_counts",
        lambda c: orig(c, budget=1),
    )
    jdb, queries = _family_world(seed=13)
    db = port_db(jdb)
    dev = DeviceClassifier.create(db, batch_size=8, device="cpu", counts="dense")
    dev._fb_dense = True  # start on the wire
    _assert_oracle(db, _classify(dev, queries, 8), queries)
    assert dev.host_replays > 0


def test_dense_engine_sizes_its_batch_and_skips_the_postings_matrix():
    """The dense-count engine uploads the ref-major matrix, not the postings
    matrix, takes no unit/wide split, and sizes its batch from the hint like
    the planes engine."""
    jdb, queries = make_world(7)
    db = port_db(jdb)
    dev = DeviceClassifier.create(
        db, device="cpu", counts="dense", n_queries_hint=len(queries),
        significance="exact", bm_scan=True,
    )
    st = dev.state
    assert st.kmer_major3 is None and st.blk_ptr is None and st.split2 is None
    assert tuple(st.ref_bits.shape) == (db.num_tips, 2048)
    assert dev.batch_size == 32 and dev._flat_w == 0
    assert not dev._exact_mode and not dev.bm_scan and not dev._sparse
    _assert_oracle(db, _classify(dev, queries, 32), queries)


def test_dense_engine_needs_the_ref_major_matrix():
    jdb, _ = make_world(7)
    db = dataclasses.replace(port_db(jdb), ref_major=None)
    with pytest.raises(RuntimeError, match="ref-major"):
        DeviceClassifier.create(db, device="cpu", counts="dense")
    assert DeviceClassifier.create(db, device="cpu").counts == "planes"


def test_fold_backends_make_the_planes_of_the_dense_fold():
    """The planes a batch hands to the histogram are the same tensor, bit
    for bit, whichever fold made them (the sparse fold's are wider: its
    matrix is padded to whole blocks)."""
    jdb, queries = make_world(31)
    db = port_db(jdb)
    seen = {}
    for fold in ("dense", "stream", "gathered", "sparse"):
        dev = DeviceClassifier.create(db, batch_size=8, device="cpu", fold=fold)
        seen[fold] = dev.submit_batch(queries[:8]).planes.numpy()
    S = seen["dense"].shape[2]
    assert seen["dense"].any()
    for fold in ("stream", "gathered"):
        assert np.array_equal(seen[fold], seen["dense"]), fold
    assert np.array_equal(seen["sparse"][:, :, :S], seen["dense"])
    assert not seen["sparse"][:, :, S:].any()
