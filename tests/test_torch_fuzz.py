"""The port's byte-parity fuzz on the CPU: its worlds equal the JAX package's
test worlds, its schedule meets every flag combination, and a short run
agrees with the oracle."""

import itertools

import numpy as np
import pytest

from raxtax_tpu.models.oracle import OracleClassifier as JaxOracle
from raxtax_tpu_torch.convert import database_fields
from raxtax_tpu_torch.tools import fuzz_hardware as fz
from raxtax_tpu_torch.tools.fuzzworld import make_world
from tests import test_fuzz_parity
from tests import test_torch_common  # noqa: F401  (one torch thread per worker)


@pytest.mark.parametrize("seed", [1044, 2000, 12345])
def test_world_equals_the_jax_test_world(seed):
    db, queries = make_world(seed)
    jdb, jqueries = test_fuzz_parity.make_world(seed)
    got, want = database_fields(db), database_fields(jdb)
    assert got.keys() == want.keys()
    for k in got:
        if isinstance(got[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k
    assert [l for l, _ in queries] == [l for l, _ in jqueries]
    for (_, s), (_, js) in zip(queries, jqueries, strict=True):
        np.testing.assert_array_equal(s, js)


def test_fuzz_runs_clean_on_the_cpu(capsys):
    assert fz.main(["--device", "cpu", "--trials", "4"]) == 0
    out = capsys.readouterr().out
    assert "fuzz total: 4 trials, 24 query checks, 0 mismatches" in out
    assert out.startswith("not drawn")


def test_fuzz_reports_a_mismatch(monkeypatch, capsys):
    """The checker itself: an oracle that disagrees makes the tool fail."""
    from raxtax_tpu_torch.models import oracle

    real = oracle.OracleClassifier.classify

    def off_by_one(self, label, seq):
        r = real(self, label, seq)
        r.out_text = (r.out_text or r.out_string()) + "x"
        return r

    monkeypatch.setattr(oracle.OracleClassifier, "classify", off_by_one)
    assert fz.main(["--device", "cpu", "--trials", "1"]) == 1
    assert "MISMATCH" in capsys.readouterr().out


def test_default_schedule_meets_every_flag_combination():
    """Every backend, significance mode and loop shape meets every
    (skip_exact, raw_confidence) pair in the default 50 trials (the JAX
    script paired split2 with skip_exact=True only); refused combinations
    are never drawn."""
    cfgs = [fz.trial_config(t) for t in range(50)]
    both = [False, True]

    def pairs(key, sel=lambda c: True):
        return {(c[key], c["skip_exact"], c["raw_conf"]) for c in cfgs if sel(c)}

    assert pairs("backend") == set(itertools.product(fz.BACKENDS, both, both))
    assert pairs("significance") == set(
        itertools.product(fz.SIGNIFICANCE, both, both))
    assert pairs("pipelined") == set(itertools.product(both, both, both))
    assert pairs("significance", lambda c: c["backend"] != "xla") == pairs("significance")
    assert all(c["layout"] == "packed" for c in cfgs if c["bm_scan"])
    assert all(c["backend"] == "xla" for c in cfgs if c["split_sig"])
    assert {c["fold"] for c in cfgs if c["backend"] == "pallas"} == set(fz.FOLDS)
    assert any(c["bm_scan"] for c in cfgs) and any(c["split_sig"] for c in cfgs)


def test_engine_equals_the_jax_oracle_on_one_world():
    """The port's engine on the CPU, in two of the fuzz's configurations
    (planes with ``auto`` significance; the dense-count backend), against the
    JAX package's own oracle on the same world."""
    from raxtax_tpu_torch.engine.classify import make_classifier

    seed = 1054
    db, queries = make_world(seed)
    jdb, _ = test_fuzz_parity.make_world(seed)
    for cfg in (fz.trial_config(0), fz.trial_config(7)):
        clf = make_classifier(db, fz.cli_args(cfg, "cpu"))
        got = fz.classify(clf, queries, pipelined=True)
        orc = JaxOracle(jdb, skip_exact_matches=cfg["skip_exact"],
                        raw_confidence=cfg["raw_conf"])
        for (label, seq), qr in zip(queries, got, strict=True):
            want = orc.classify(label, seq)
            assert qr.out_string() == want.out_string(), label
            assert qr.tsv_string() == want.tsv_string(), label
