"""Both significance modes of the port's engine on top of the stream and the
gathered fold, in both postings layouts, against the host oracle. Output
strings compare byte for byte."""

import pytest

from raxtax_tpu_torch.engine.device import DeviceClassifier
from tests.test_torch_common import port_db
from tests.test_torch_engine_dd import _assert_oracle, _family_world, _pipelined


@pytest.mark.parametrize("fold", ["stream", "gathered"])
@pytest.mark.parametrize("significance,layout", [("dd", "packed"), ("dd", "flat"),
                                                 ("exact", "flat")])
def test_fold_backends_under_both_significance_modes(fold, significance, layout):
    """Both significance modes run unchanged on top of the swapped fold, in
    both postings layouts: the family world has counts above 15, fallback
    descents and near-ties."""
    from raxtax_tpu_torch.db.database import ensure_kmer_layout

    jdb, queries = _family_world()
    db = ensure_kmer_layout(port_db(jdb), layout)
    assert db.kmer_layout == layout
    dev = DeviceClassifier.create(
        db, batch_size=8, device="cpu", significance=significance, fold=fold,
        debug_checks=True,
    )
    _assert_oracle(db, _pipelined(dev, queries, 8), queries)
