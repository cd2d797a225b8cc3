"""The engine's last single-device options against the JAX engine under the
same environment names, on the golden references and one batch of two
golden queries (the JAX side runs its Pallas kernels in interpret mode, at
seconds per batch; ``RAXTAX_SPARSE_FOLD=0`` keeps it on its fused fold):

- ``RAXTAX_SPLIT2=0`` (no unit/wide split) in the packed and flat layouts,
- ``RAXTAX_SPLIT2=0 RAXTAX_SPLIT_SIG=1`` (the single-tip split) on the
  tip-order scan and on the bit-major scan,
- ``--descent device`` (the device's f32 descent, no host replay).

Each compares the significant sets after host rounding (as the host sees
them, taken at its site search) and the output lines; the split runs are
also byte-equal to the goldens, the device descents end at the same nodes.
Then the CLI: the environment mapping, ``--descent device`` and ``--trace``
on the CPU, and ``--mesh 1,1``."""

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from raxtax_tpu.db.database import build_database
from raxtax_tpu.io.fasta import parse_query_fasta_file, parse_reference_fasta_file
from tests.test_torch_common import port_db

DATA = Path(__file__).resolve().parent / "data"
#: two golden queries whose batch has fallback sites (three descents), which
#: the exact double-f32 descent replays on the host
QUERY_SLICE = slice(8, 10)
ENV_NAMES = ("RAXTAX_EXACT", "RAXTAX_SPARSE_FOLD", "RAXTAX_FUSED_GATHER",
             "RAXTAX_BM_SCAN", "RAXTAX_SPLIT2", "RAXTAX_SPLIT_SIG")


def _golden_blocks(name):
    blocks: dict[str, list[str]] = {}
    for line in (DATA / name).read_text().splitlines():
        blocks.setdefault(line.split("\t", 1)[0], []).append(line)
    return {k: "\n".join(v) for k, v in blocks.items()}


def _rounded_sets(nodes, conf, off):
    """Per query ``{node: conf rounded half away from zero to 2 decimals}``
    of the nodes that stay significant, as the host's site search sees
    them."""
    from raxtax_tpu_torch.utils.encoding import round_half_away

    r = round_half_away(np.asarray(conf, np.float64))
    return [
        {int(n): float(v) for n, v in zip(nodes[off[b] : off[b + 1]],
                                          r[off[b] : off[b + 1]]) if v != 0.0}
        for b in range(len(off) - 1)
    ]


def _spy(monkeypatch, native_mod, engine_cls):
    """Record what each engine hands its site search and what its
    fallback resolution returns."""
    seen = {}
    find_sites = native_mod.find_sites
    resolve = engine_cls._resolve_fallbacks

    def sites_spy(nodes, conf, off, *rest):
        seen["sets"] = _rounded_sets(nodes, conf, off)
        return find_sites(nodes, conf, off, *rest)

    def resolve_spy(self, *a, **kw):
        seen["finals"] = resolve(self, *a, **kw)
        return seen["finals"]

    monkeypatch.setattr(native_mod, "find_sites", sites_spy)
    monkeypatch.setattr(engine_cls, "_resolve_fallbacks", resolve_spy)
    return seen


def _run_both(monkeypatch, env: dict, layout: str, descent: str = "exact"):
    """The JAX engine and the port's, each made the way its CLI makes it
    under ``env``, on one batch of two golden queries: ``(results, spied)``
    per package."""
    from raxtax_tpu import native as jnative
    from raxtax_tpu.engine.device import DeviceClassifier as JaxClassifier
    from raxtax_tpu_torch import native as tnative
    from raxtax_tpu_torch.cli import engine_mode_from_env
    from raxtax_tpu_torch.engine.classify import make_classifier
    from raxtax_tpu_torch.engine.device import DeviceClassifier

    for name in ENV_NAMES:
        monkeypatch.delenv(name, raising=False)
    for name, value in {"RAXTAX_EXACT": "0", "RAXTAX_SPARSE_FOLD": "0",
                        **env}.items():
        monkeypatch.setenv(name, value)
    recs = parse_reference_fasta_file(str(DATA / "golden_refs.fasta"))
    jdb = build_database(recs.lineages, recs.sequences, kmer_layout=layout)
    queries = parse_query_fasta_file(str(DATA / "golden_queries.fasta"))[QUERY_SLICE]
    with monkeypatch.context() as m:
        jseen = _spy(m, jnative, JaxClassifier)
        jdev = JaxClassifier.create(
            jdb, backend="pallas", batch_size=2, descent=descent)
        assert jdev._interpret and not jdev._sparse
        want = jdev.classify_batch(queries)
    args = SimpleNamespace(
        backend="pallas", device="cpu", batch_size=2, debug_checks=True,
        tsv=True, skip_exact_matches=False, raw_confidence=False,
        descent=descent, **engine_mode_from_env())
    with monkeypatch.context() as m:
        tseen = _spy(m, tnative, DeviceClassifier)
        dev = make_classifier(port_db(jdb), args)
        got = dev.classify_batch(queries)
    assert not dev._exact_mode and dev.fold == "dense"
    assert dev.state.layout == jdev._layout == layout
    return (want, jseen), (got, tseen), dev


def _assert_same(want, got, goldens: bool):
    (w_res, w_seen), (g_res, g_seen) = want, got
    assert g_seen["sets"] == w_seen["sets"]
    assert sum(len(s) for s in g_seen["sets"]) > 2
    outs, tsvs = _golden_blocks("golden_raxtax.out"), _golden_blocks("golden_raxtax.tsv")
    for w, g in zip(w_res, g_res):
        assert g.out_string() == w.out_string(), g.label
        assert g.tsv_string() == w.tsv_string(), g.label
        if goldens:
            assert g.out_string() == outs[g.label], g.label
            assert g.tsv_string() == tsvs[g.label], g.label


@pytest.mark.parametrize("layout", ["packed", "flat"])
def test_split2_off_equals_the_jax_engine(monkeypatch, layout):
    want, got, dev = _run_both(monkeypatch, {"RAXTAX_SPLIT2": "0"}, layout)
    assert dev.state.split2 is None and dev.state.split_sig is None
    _assert_same(want, got, goldens=True)


@pytest.mark.parametrize(
    "layout,bm_scan", [("flat", ""), ("packed", "1")], ids=["tip-order", "bm-scan"]
)
def test_split_sig_equals_the_jax_engine(monkeypatch, layout, bm_scan):
    from raxtax_tpu_torch.ops import nodeconf

    calls = []
    split = nodeconf._compact_split
    monkeypatch.setattr(nodeconf, "_compact_split",
                        lambda *a: calls.append(1) or split(*a))
    want, got, dev = _run_both(
        monkeypatch,
        {"RAXTAX_SPLIT2": "0", "RAXTAX_SPLIT_SIG": "1", "RAXTAX_BM_SCAN": bm_scan},
        layout,
    )
    assert dev.state.split_sig is not None and dev.bm_scan == bool(bm_scan)
    assert calls  # the batch was compacted by the single-tip split
    _assert_same(want, got, goldens=True)


def test_device_descent_equals_the_jax_engine(monkeypatch):
    """Exact ties may resolve otherwise than in the reference, so the
    device descent is held to the JAX engine's device descent, not to the
    goldens: the same final nodes and the same output lines, and nothing
    replayed on the host (the exact descent replays this batch)."""
    want, got, dev = _run_both(monkeypatch, {}, "flat", descent="device")
    assert got[1]["finals"] == want[1]["finals"] and len(got[1]["finals"]) >= 2
    assert dev.host_replays == 0 and dev.descent == "device"
    _assert_same(want, got, goldens=False)


def test_engine_mode_reads_split2_like_the_jax_engine():
    from raxtax_tpu_torch.cli import engine_mode_from_env

    assert engine_mode_from_env({})["split2"] is True  # unset: on
    assert engine_mode_from_env({"RAXTAX_SPLIT2": "1"})["split2"] is True
    assert engine_mode_from_env({"RAXTAX_SPLIT2": "0"})["split2"] is False
    assert engine_mode_from_env({"RAXTAX_SPLIT2": ""})["split2"] is False
    both = engine_mode_from_env({"RAXTAX_SPLIT2": "0", "RAXTAX_SPLIT_SIG": "1"})
    assert both["split2"] is False and both["split_sig"] is True


def _cli(out, *extra):
    from raxtax_tpu_torch.cli import main

    return main(["-d", str(DATA / "golden_refs.fasta"), "-i",
                 str(DATA / "golden_queries.fasta"), "-o", str(out),
                 "--device", "cpu", "--batch-size", "4", "--tsv", *extra])


def test_cli_descent_device_and_trace_run(tmp_path, monkeypatch):
    """``--descent device`` on the double-f32 path and ``--trace DIR`` on the
    default path exit 0 and write their outputs; the trace is a profiler
    JSON file in DIR that holds the program's spans and counters."""
    from raxtax_tpu_torch.utils.trace import trace_files

    for name in ENV_NAMES:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("RAXTAX_EXACT", "0")
    out = tmp_path / "device"
    assert _cli(out, "--descent", "device") == 0
    lines = (out / "raxtax.out").read_text().splitlines()
    assert len({l.split("\t", 1)[0] for l in lines}) == 12
    monkeypatch.delenv("RAXTAX_EXACT")
    out = tmp_path / "trace"
    assert _cli(out, "--trace", str(tmp_path / "tr")) == 0
    assert (out / "raxtax.out").read_bytes() == (DATA / "golden_raxtax.out").read_bytes()
    files = trace_files(tmp_path / "tr")
    assert len(files) == 1 and b"traceEvents" in files[0].read_bytes()[:4096]
    # the program's spans of the classification phase ride in the same
    # file: three batches of four
    spans = [e for e in json.loads(files[0].read_text())["traceEvents"]
             if e.get("cat") == "program_span"]
    names = {e["name"] for e in spans}
    assert {"query.run", "query.prewarm", "engine.prepare.model"} <= names
    assert sorted(e["args"]["batch"] for e in spans
                  if e["name"] == "engine.finalize") == [1, 2, 3]
    # and the classifier's counters over the phase, twelve queries
    counters = json.loads(files[0].read_text())["programCounters"]
    assert counters["queries"] == 12 and counters["spans.dropped"] == 0
    assert {"model.closed_form", "ktable.builds", "descent.sites"} <= set(counters)


def test_mesh_1_1_cli_run_is_byte_equal_to_the_goldens(tmp_path):
    """``--mesh 1,1 --device cpu``: a world of one rank and the sharded
    pipeline, byte-equal to the goldens."""
    out = tmp_path / "out"
    assert _cli(out, "--mesh", "1,1") == 0
    for ext in ("out", "tsv"):
        assert (out / f"raxtax.{ext}").read_bytes() == (
            DATA / f"golden_raxtax.{ext}").read_bytes()
    assert "mesh {'data': 1, 'model': 1}" in (out / "raxtax.log").read_text()
