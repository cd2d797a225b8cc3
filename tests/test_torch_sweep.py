"""The port's sweep and profiling tools on the CPU at tiny sizes: the
synthetic FASTA is byte-equal to the JAX package's, the runtime / memory
sweep writes its row, and the stage profile and the engine diagnosis print
their line."""

import csv
import json
import subprocess
import sys
from pathlib import Path

from raxtax_tpu_torch.tools import (
    diag_engine,
    make_synth_fasta,
    profile_stages,
    runtime_memory,
    sweep_common,
)
from tests import test_torch_common  # noqa: F401  (one torch thread per worker)

ROOT = Path(__file__).resolve().parent.parent


def test_synth_fasta_equals_the_jax_script(tmp_path):
    want = tmp_path / "script.fasta"
    subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "make_synth_fasta.py"), "64",
         str(want), "--seed", "42"],
        check=True, capture_output=True, cwd=str(ROOT),
    )
    got = tmp_path / "port.fasta"
    assert make_synth_fasta.main(["64", str(got), "--seed", "42"]) == 0
    assert got.read_bytes() == want.read_bytes()


def test_runtime_memory_writes_a_row(tmp_path, capsys):
    fasta = tmp_path / "synth.fasta"
    make_synth_fasta.write_synth_fasta(400, str(fasta), seed=7)
    out = tmp_path / "rm.csv"
    assert runtime_memory.main([
        str(fasta), "--sizes", "300", "--reps", "1", "--device", "cpu",
        "--out", str(out),
    ]) == 0
    rows = list(csv.DictReader(out.open()))
    assert [r["tool"] for r in rows] == ["raxtax-torch"]
    row = rows[0]
    assert list(row) == list(runtime_memory.COLUMNS)
    assert row["returncode"] == "0" and float(row["peak_rss_mb"]) > 0
    assert int(row["queries"]) == 30 and float(row["classify_s"]) > 0


def test_memory_poll_sees_a_child_and_the_phase_lines(tmp_path):
    """The poll finds a child's resident set without psutil; the phase
    lines of a run's log parse into seconds."""
    code = "b = bytearray(200 * 2**20); import time; time.sleep(0.5)"
    runtime, peak_mb, rc = sweep_common.run_with_memory_poll(
        [sys.executable, "-c", code], poll_hz=50)
    assert rc == 0 and runtime > 0.4 and peak_mb > 200
    log = tmp_path / "raxtax.log"
    log.write_text("[INFO ] Parsing References took 12.500 ms\n"
                   "[INFO ] raxtax took 2500.000 ms\n")
    assert runtime_memory.log_phases(log) == {
        "Parsing References": 0.0125, "raxtax": 2.5}


def test_profile_stages_and_diag_engine_print_their_line(capsys):
    assert profile_stages.main(["--device", "cpu", "--refs", "1024",
                                "--batch-size", "8"]) == 0
    stages = json.loads(capsys.readouterr().out)
    assert stages["device"] == "cpu"
    assert set(stages["stage_ms"].values()) == {"not measured"}
    assert "significance (bm_scan, packed, K7)" in stages["stage_ms"]
    assert diag_engine.main(["--device", "cpu", "--refs", "1024",
                             "--queries", "32", "--batch-size", "8"]) == 0
    diag = json.loads(capsys.readouterr().out)
    assert len(diag["pipelined_passes"]) == 2
    assert diag["pipelined_passes"][0]["queries"] == 32
    assert set(diag["modes_before"]) == set(diag["modes_after"])
    assert "_top_k" in diag["not_in_port"]
