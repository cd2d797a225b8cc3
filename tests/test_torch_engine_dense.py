"""The port's dense-count engine (``counts="dense"``, the ``xla`` backend) on
small uniform worlds against the host oracle, with and without the single-tip
split. Output strings compare byte for byte."""

import pytest

from raxtax_tpu_torch.engine.device import DeviceClassifier
from tests.test_fuzz_parity import make_world
from tests.test_torch_common import port_db
from tests.test_torch_engine_dd import _assert_oracle, _classify


@pytest.mark.parametrize("split_sig", [False, True])
@pytest.mark.parametrize("seed", [1044, 1054, 7])
def test_dense_engine_equals_oracle_on_random_worlds(seed, split_sig):
    """Small uniform worlds put confidences on half-cent boundaries and
    descents on exact ties: the replays read gathered count rows first and
    the nibble wire once they are dense."""
    jdb, queries = make_world(seed)
    db = port_db(jdb)
    dev = DeviceClassifier.create(
        db, batch_size=4, device="cpu", counts="dense", split_sig=split_sig,
        debug_checks=True,
    )
    assert (dev.state.split_sig is not None) == split_sig
    _assert_oracle(db, _classify(dev, queries, 4), queries)
