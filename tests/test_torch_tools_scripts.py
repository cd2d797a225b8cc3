"""CPU smokes of the port's profiling scripts on a tiny bench world
(``RAXTAX_BENCH_REFS=300``; ``--device cpu`` where a script drives the
engine): ``probe_prepare`` (the sub-steps A-K, I listed as absent),
``probe_sig`` (per-op times of the significance stage), ``native_baseline``
(the reference's hot loop through the native binding; its postings CSR
checked against the bit matrix in both layouts) and ``plot_runtime_memory``
(a PNG from a three-row CSV of ``tools/runtime_memory.py``'s columns)."""

import json

import numpy as np
import pytest


def _tiny(monkeypatch, tmp_path, backend="auto"):
    for name in ("RAXTAX_EXACT", "RAXTAX_SPARSE_FOLD", "RAXTAX_BM_SCAN",
                 "RAXTAX_FUSED_GATHER", "RAXTAX_SPLIT2", "RAXTAX_SPLIT_SIG",
                 "RAXTAX_BENCH_BATCH", "RAXTAX_BENCH_BUDGET"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("RAXTAX_BENCH_REFS", "300")
    monkeypatch.setenv("RAXTAX_BENCH_QUERIES", "16")
    monkeypatch.setenv("RAXTAX_BENCH_BACKEND", backend)
    monkeypatch.setenv("RAXTAX_BENCH_CACHE_DIR", str(tmp_path))


def _json_line(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("exact", ["", "0"], ids=["exact", "dd"])
def test_probe_prepare_times_every_step(tmp_path, monkeypatch, capsys, exact):
    from raxtax_tpu_torch.tools import probe_prepare

    _tiny(monkeypatch, tmp_path)
    monkeypatch.setenv("RAXTAX_EXACT", exact)
    monkeypatch.setenv("RAXTAX_BENCH_BATCH", "4")
    monkeypatch.setenv("RAXTAX_PROFILE_REPS", "2")
    assert probe_prepare.main(["--device", "cpu"]) == 0
    line = _json_line(capsys)
    steps = set(line["steps"])
    common = {"A.submit_dispatch", "B.fold+hist_device", "E.hist_pull",
              "F.prob_model_host", "G.significant_dispatch",
              "H.significance_device", "J.significant_pull", "K.finalize_all",
              "K.finalize_pull", "K.finalize_descend", "K.finalize_eval"}
    wire = {"C.compress_dispatch", "D.compress_device"}
    assert steps == (common | wire if exact == "0" else common)
    assert "I.pack_dispatch" in line["absent"]
    assert all(v["n"] == 2 for v in line["steps"].values())


def test_probe_sig_times_every_op(tmp_path, monkeypatch, capsys):
    from raxtax_tpu_torch.tools import probe_sig

    _tiny(monkeypatch, tmp_path)
    monkeypatch.setenv("RAXTAX_BENCH_BATCH", "4")
    monkeypatch.setenv("RAXTAX_PROFILE_REPS", "2")
    assert probe_sig.main(["--device", "cpu"]) == 0
    line = _json_line(capsys)
    assert line["sideband"] and line["clock"] == "host"
    assert set(line["steps"]) == {
        "c0.compress_full", "c1.high_counts_kernel", "c2.overflow_lists",
        "s1.probs_mux4", "s1b.probs_mux4_zero_high", "s2.over_scatter",
        "s2b.sideband_scan", "s3.dd_cumsum", "s4.compact_unit_wide",
        "s4b.wide_conf_sideband", "s5.unit_wide_pull",
    }


def test_native_baseline_csr_and_hot_loop(tmp_path, monkeypatch, capsys):
    """The postings CSR lists, per k-mer, the tips whose bit is set, in
    both layouts; the hot loop runs through the native binding (packed
    database: the xla backend's cache)."""
    from raxtax_tpu_torch import native
    from raxtax_tpu_torch.db.database import build_database
    from raxtax_tpu_torch.tools import native_baseline, synth

    fam, rng = synth.synth_fam()
    lineages, seqs = synth.synth_records(200, fam, rng)
    for layout in ("packed", "flat"):
        db = build_database(lineages, seqs, kmer_layout=layout)
        postings, offsets = native_baseline.build_csr(db)
        for k in (0, 123, 4097, 65535):
            row = db.kmer_major[k]
            if layout == "flat":
                W = row.shape[0]
                tips = [t for t in range(200) if row[t % W] >> (t // W) & 1]
            else:
                tips = [t for t in range(200) if row[t // 32] >> (t % 32) & 1]
            assert postings[offsets[k] : offsets[k + 1]].tolist() == tips
    if native.get_lib() is None:
        pytest.skip("the native host library did not build here")
    _tiny(monkeypatch, tmp_path, backend="xla")
    monkeypatch.setenv("RAXTAX_BASELINE_QUERIES", "3")
    assert native_baseline.main() == 0
    line = _json_line(capsys)
    assert line["n_timed"] == 3 and line["hot_loop_qps_1core"] > 0
    assert line["postings_entries"] > 0


def test_plot_runtime_memory_writes_a_png(tmp_path, capsys):
    from raxtax_tpu_torch.tools import plot_runtime_memory
    from raxtax_tpu_torch.tools.runtime_memory import COLUMNS, write_csv

    rows = [dict.fromkeys(COLUMNS, 0) | {
        "tool": "raxtax-torch", "size": n, "rep": 0, "runtime_s": 10.0 + i,
        "peak_rss_mb": 5000.0 + 1000 * i, "returncode": 0}
        for i, n in enumerate((50_000, 100_000, 200_000))]
    csv = tmp_path / "rm.csv"
    write_csv(rows, str(csv))
    assert plot_runtime_memory.main([str(csv)]) == 0
    png = tmp_path / "rm.png"
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert str(png) in capsys.readouterr().out
