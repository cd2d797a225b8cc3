"""The port's engine (``device="cpu"``) against the JAX package's exact
engine (``RAXTAX_EXACT=1``, ``--backend pallas``, the fused-gather fold; its
Pallas kernels run in interpret mode) on worlds built once by the JAX
package's ``build_database``. Output strings compare byte for byte."""

import pytest

from raxtax_tpu_torch.engine.device import DeviceClassifier
from tests.test_fuzz_parity import make_world
from tests.test_torch_common import port_db
from tests.test_torch_engine import COMBOS, _classify


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
