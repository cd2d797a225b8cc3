"""The port's engine on the stream fold (K10) and the gathered fold (K9)
against its own dense fold (whose downstream is held against the JAX package
elsewhere), the host oracle and the goldens, for every flag combination.
Output strings compare byte for byte."""

import pytest

from raxtax_tpu_torch.engine.device import DeviceClassifier
from tests.test_torch_common import port_db
from tests.test_torch_engine_backends import _assert_goldens, _golden_world
from tests.test_torch_engine_dd import FLAGS, _assert_oracle, _pipelined


@pytest.mark.parametrize("fold", ["stream", "gathered"])
@pytest.mark.parametrize("skip_exact,raw_conf", FLAGS)
def test_fold_backends_equal_the_dense_fold_and_goldens(fold, skip_exact, raw_conf):
    """``fold="stream"`` and ``fold="gathered"`` only swap the fold: the
    exact-f64 engine gives the bytes of the dense fold, the oracle and the
    goldens."""
    jdb, queries = _golden_world()
    db = port_db(jdb)
    kw = dict(batch_size=4, skip_exact_matches=skip_exact,
              raw_confidence=raw_conf, device="cpu", debug_checks=True)
    ref = _pipelined(DeviceClassifier.create(db, fold="dense", **kw), queries, 4)
    dev = DeviceClassifier.create(db, fold=fold, **kw)
    assert dev.fold == fold and not dev._sparse and dev._exact_mode
    got = _pipelined(dev, queries, 4)
    for g, w in zip(got, ref):
        assert g.out_string() == w.out_string() and g.tsv_string() == w.tsv_string()
    _assert_oracle(db, got, queries, skip_exact, raw_conf)
    _assert_goldens(got, skip_exact, raw_conf)
