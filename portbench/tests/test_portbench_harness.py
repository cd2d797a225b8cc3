"""The harness on the CPU: its arithmetic, its data-driven lookup, the
contract of ``BENCHMARK.json``, and where and how much a run writes."""

import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from portbench import harness, yardstick
from portbench.tests.tiny import REPO, make_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_fold_bytes_on_hand_checked_shapes():
    # 16 references: a postings row is 2 bytes; counts of k_max 7 take 3
    # bits; k_max 8 takes 4
    assert yardstick.count_bits(7) == 3 and yardstick.count_bits(8) == 4
    assert yardstick.fold_bytes([(2, 10, 7)], 16) == 10 * 2 + 2 * 16 * 3 / 8
    assert yardstick.fold_bytes([(2, 10, 7), (1, 3, 8)], 16) == (
        32.0 + 3 * 2 + 1 * 16 * 4 / 8)
    # 1M references, B = 256, 651 8-mers a query (10 bits a count)
    assert yardstick.fold_bytes([(256, 50000, 651)], 10**6) == (
        50000 * 125000 + 256 * 10**6 * 10 / 8)
    assert yardstick.scan_bytes(256, 10**6) == 256 * 10**6 * 8


def test_batch_shapes_follow_the_loops_batches():
    sets = [np.array([1, 2, 3]), np.array([3, 4]), np.array([9]),
            np.array([1, 2, 3, 4, 5])]
    assert yardstick.batch_shapes(sets, 2) == [(2, 4, 3), (2, 6, 5)]
    assert yardstick.batch_shapes(sets, 3) == [(3, 5, 3), (1, 5, 5)]


def test_busy_time_is_the_union_of_intervals():
    ns = 10**9
    ev = [("a", 0, 2 * ns), ("b", 1 * ns, 2 * ns),  # overlap: 0-3
          ("c", 5 * ns, 1 * ns),  # gap 3-5, then 5-6
          ("d", 5 * ns, ns // 2), ("e", 10 * ns, ns)]  # inside; 10-11
    assert yardstick.union_seconds(ev) == 5.0
    assert yardstick.union_seconds([]) == 0.0
    ctx = type("C", (), {"events": ev, "busy_s": 5.0, "window_s": 20.0})
    read = harness.load_reader(REPO, "device.idle_share")
    assert read(ctx) == 75.0


def test_kernel_time_matches_names_as_words():
    ev = [("void (anonymous namespace)::fold_planes_kernel<6>(int const*)", 0, 3),
          ("fold_planes_kernel_old", 0, 100), ("exact_cumsum_kernel(double*)", 0, 5)]
    assert yardstick.kernel_seconds(ev, ["fold_planes_kernel"]) == 3e-9
    names = json.loads((REPO / "portbench/metrics/kernel.fold_roofline.json").read_text())
    assert "fold_planes_kernel" in names["kernels"]


def test_roofline_readers_give_nothing_without_their_kernels():
    ctx = type("C", (), {"events": [("other", 0, 5)], "peaks": {"hbm_bytes_per_s": 1.0},
                         "batch_shapes": [(1, 1, 1)], "n_refs": 8, "queries": 1})
    for m in ("kernel.fold_roofline", "kernel.scan_roofline"):
        assert harness.load_reader(REPO, m)(ctx) is None


def test_peaks_of_the_card():
    assert yardstick.peaks_for("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] == 3.35e12
    assert yardstick.peaks_for("cpu") is None


def test_benchmark_json_keeps_the_contract():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"] and 1 <= bench["run_seconds"] <= 51
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (REPO / c["file"]).is_file()
        conf = json.loads((REPO / c["file"]).read_text())
        assert set(c["reduced"]) == set(conf["reduced_from_source"])
        assert all(NAME.match(k) for k in c["reduced"])
    cells = {w["name"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (REPO / "portbench/traffic" / f"{w['traffic']}.json").is_file()
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert (REPO / "portbench/metrics" / f"{m['name']}.py").is_file()
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for x in bench[group]:
            assert NAME.match(x["name"]), x["name"]
            assert x["name"] not in names
            names.add(x["name"])
            if "unit" in x:
                assert UNIT.match(x["unit"]), x["unit"]
                assert x["better"] in ("lower", "higher")
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for p in (REPO / "portbench").rglob("*"):
        if "__pycache__" not in p.parts:
            assert re.match(r"^[A-Za-z0-9_/.-]+$", str(p.relative_to(REPO))), p
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_a_cell_added_as_files_only_is_found_and_run(tmp_path):
    root = make_root(tmp_path)
    conf = json.loads((root / "portbench/configs/tinycoi.json").read_text())
    conf.update(name="tinycoi2", records=250, alignment_length=100,
                record_length=[100, 100])
    (root / "portbench/configs/tinycoi2.json").write_text(json.dumps(conf))
    (root / "portbench/traffic/novel.json").write_text(json.dumps(
        {"anchor": "g", "divergence": [0.05, 0.0075], "record_copy_share": 0.0,
         "span": "full", "file_queries": 16, "warmup_queries": 8,
         "check_queries": 8}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tinycoi2", "source": "test", "reduced": [],
                             "why": "test", "file": "portbench/configs/tinycoi2.json"})
    bench["workloads"].append({"name": "tinycoi2.novel", "config": "tinycoi2",
                               "traffic": "novel", "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = harness.run("tinycoi2.novel", 5, 0.05, False, time.perf_counter(),
                    root=root, device="cpu", log=lambda m: None)
    assert r["correct"] is True and r["attempted"] >= 16
    assert set(r["metrics"]) == {"throughput", "peak_device_mem",
                                 "peak_host_rss", "setup_s"}
    # a new metric is a file and an entry
    (root / "portbench/metrics/engine.submit_ms.py").write_text(
        "def read(ctx):\n    return ctx.phases['submit'] * 1e3 / ctx.n_batches\n")
    bench["per_layer"].append({"name": "engine.submit_ms", "unit": "ms/batch",
                               "better": "lower", "source": "program_counter",
                               "layer": "engine phase A", "moves": "throughput"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = harness.run("tinycoi2.novel", 5, 0.05, True, time.perf_counter(),
                    root=root, device="cpu", log=lambda m: None)
    assert r["correct"] is True and "engine.submit_ms" in r["metrics"]
    # the metrics whose workloads list leaves the new cell out stay out
    assert "engine.prepare_ms" not in r["metrics"]
    assert r["device"]["window_s"] > 0 and "busy_s" in r["device"]


def files_under(d: Path) -> dict:
    return {p: p.stat().st_size for p in d.rglob("*") if p.is_file()}


def test_a_run_writes_only_its_dirs_and_keeps_no_trace(tmp_path):
    """Two runs (plain and traced) in a child process whose HOME,
    XDG_CACHE_HOME and TMPDIR are empty directories: afterwards the working
    directory and the home and cache directories are empty, the temporary
    directory holds nothing, and the checkout gained nothing but byte code."""
    root = make_root(tmp_path / "root")
    dirs = {k: tmp_path / k for k in ("home", "cache", "tmp", "cwd")}
    for d in dirs.values():
        d.mkdir()
    before = {p for p in REPO.rglob("*") if "__pycache__" not in p.parts
              and "build" not in p.parts and ".git" not in p.parts}
    env = dict(os.environ, HOME=str(dirs["home"]), XDG_CACHE_HOME=str(dirs["cache"]),
               TMPDIR=str(dirs["tmp"]), PYTHONPATH=str(REPO))
    code = (
        "import sys, time, json\n"
        "from pathlib import Path\n"
        "from portbench import harness\n"
        "written = []\n"
        "def hook(ev, args):\n"
        "    if ev == 'open' and isinstance(args[0], str) and args[1] and "
        "any(c in args[1] for c in 'wax+'):\n"
        "        written.append(args[0])\n"
        "sys.addaudithook(hook)\n"
        f"root = Path({str(root)!r})\n"
        "for trace in (False, True):\n"
        "    r = harness.run('tinyssu.fulllength', 3, 0.05, trace, time.perf_counter(),"
        " root=root, device='cpu', log=lambda m: None)\n"
        "    assert r['correct'], r\n"
        "print(json.dumps(written))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=dirs["cwd"], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    written = json.loads(out.stdout.strip().splitlines()[-1])
    assert written, "the run wrote its outputs"
    for path in written:
        if path == os.devnull:
            continue
        assert Path(path).resolve().is_relative_to(dirs["tmp"].resolve()) or (
            Path(path).resolve().is_relative_to(REPO / "raxtax_tpu_torch" / "build")
        ), path
        assert ".pt.trace" not in path and not path.endswith(".json")
    for k in ("home", "cache", "tmp", "cwd"):
        assert files_under(dirs[k]) == {}, k
    after = {p for p in REPO.rglob("*") if "__pycache__" not in p.parts
             and "build" not in p.parts and ".git" not in p.parts}
    assert after == before


def test_query_files_are_made_from_the_warm_up_rate():
    assert harness.files_for(100.0, 10, 50) == int(harness.MARGIN * 20) + 1
    assert harness.files_for(1e-9, 10, 50) == 2  # always one past the window


def test_a_program_that_outpaces_the_files_made_is_refused(tmp_path, monkeypatch):
    """The window uses up the query files made before it: the run raises
    rather than make a file inside the window, and gives no result."""
    root = make_root(tmp_path)
    made = []
    monkeypatch.setattr(harness, "files_for",
                        lambda rate, seconds, fq: made.append(rate) or 2)
    with pytest.raises(harness.BenchError, match="used all 2 query files"):
        harness.run("tinycoi.known", 4, 30.0, False, time.perf_counter(),
                    root=root, device="cpu", log=lambda m: None)
    assert made and made[0] > 0


def test_a_run_that_would_write_too_much_is_refused(tmp_path, monkeypatch):
    root = make_root(tmp_path)
    monkeypatch.setattr(harness, "WRITE_BUDGET", 1000)
    with pytest.raises(harness.BenchError, match="may write"):
        harness.run("tinyssu.v4", 4, 0.05, False, time.perf_counter(),
                    root=root, device="cpu", log=lambda m: None)


def test_the_window_reads_no_query_made_inside_it(tmp_path, monkeypatch):
    """Every query file is written before the window's clock starts."""
    from portbench import generator

    root = make_root(tmp_path)
    calls = []
    orig_file = generator.Traffic.file
    orig_counter = time.perf_counter
    monkeypatch.setattr(generator.Traffic, "file",
                        lambda self, f: calls.append(orig_counter()) or orig_file(self, f))
    starts = []
    orig_classify = harness.classify_file

    def classify(db, clf, args, queries, out_dir):
        if out_dir.name.startswith("file"):
            starts.append(orig_counter())
        return orig_classify(db, clf, args, queries, out_dir)

    monkeypatch.setattr(harness, "classify_file", classify)
    r = harness.run("tinycoi.known", 4, 0.05, False, time.perf_counter(),
                    root=root, device="cpu", log=lambda m: None)
    assert r["correct"] is True and calls and starts
    assert max(calls) < min(starts)


def test_command_refuses_without_a_gpu(tmp_path):
    """No CUDA device here: exit 2 and no result on stdout."""
    out = subprocess.run(
        [sys.executable, str(REPO / "portbench/run.py"), "--workload",
         "coi5p_1m.known", "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 2 and out.stdout == ""


def test_command_fails_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and portbench/ gives no result."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, runpy, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "torch.cuda.device_count = lambda: 1\n"
            "sys.argv = ['run.py', '--workload', 'coi5p_1m.known', '--seed', '3',"
            " '--seconds', '1', '--trace', '0']\n"
            "runpy.run_path('portbench/run.py', run_name='__main__')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "raxtax_tpu_torch" in out.stderr
