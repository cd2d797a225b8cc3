"""The port's double-f32 mode on the CPU where it leaves its fast path: host
replays inside the risk band, the full-width redo past the overflow budget,
``auto``'s flip to the exact path, the sparse fold's flip to dense and the
device descent with margins, each byte-equal to the host oracle. Split from
``test_torch_engine_dd.py`` so that no file of the port's slow parity tests
holds more than ten tests (ROADMAP, tier-1's clock)."""

import pytest

from raxtax_tpu_torch.engine import device as tdev
from raxtax_tpu_torch.engine.device import DeviceClassifier
from tests.test_fuzz_parity import make_world
from tests.test_torch_common import port_db
from tests.test_torch_engine_dd import (
    _assert_oracle,
    _boundary_world,
    _classify,
    _family_world,
    _pipelined,
)


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

