"""The port's double-f32 mode (``significance="dd"``, ``fold="sparse"``)
against its host oracle on small uniform worlds, with and without split2 and
the bit-major scan. Output strings compare byte for byte. Split from
``test_torch_engine_dd.py`` so that no file of the port's slow parity tests
holds more than ten tests (ROADMAP, tier-1's clock)."""

import pytest

from raxtax_tpu_torch.engine.device import DeviceClassifier
from tests.test_fuzz_parity import make_world
from tests.test_torch_common import port_db
from tests.test_torch_engine_dd import _assert_oracle, _classify


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
