"""The port's bench (``raxtax_tpu_torch/tools/bench.py``) and
``tools/bench_scale.py`` on the CPU: the same synthetic world as the JAX
package's ``bench.py`` (imported here only, for its numpy generators), the
environment names and defaults, one JSON line per finished configuration on
a tiny world, and the global deadline."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
KEYS = {"metric", "value", "unit", "vs_baseline", "median", "pass_s",
        "warmup_s", "batch"}


def test_synthetic_world_equals_the_root_bench():
    sys.path.insert(0, str(ROOT))
    import bench as jbench

    from raxtax_tpu_torch.tools import synth

    fam_j, rng_j = jbench.synth_fam()
    fam_t, rng_t = synth.synth_fam()
    np.testing.assert_array_equal(fam_t, fam_j)
    lin_j, seq_j = jbench.synth_records(3000, fam_j, rng_j)
    lin_t, seq_t = synth.synth_records(3000, fam_t, rng_t)
    assert lin_t == lin_j
    np.testing.assert_array_equal(seq_t, seq_j)
    q_j, q_t = jbench.synth_queries(fam_j, 300), synth.synth_queries(fam_t, 300)
    assert [l for l, _ in q_t] == [l for l, _ in q_j]
    np.testing.assert_array_equal(np.stack([s for _, s in q_t]),
                                  np.stack([s for _, s in q_j]))


def test_config_reads_the_jax_bench_names_and_defaults(tmp_path):
    from raxtax_tpu_torch.tools.bench import config

    c = config({})
    assert (c.configs, c.n_queries, c.batch, c.backend, c.reps, c.budget,
            c.oracle_queries) == ([65536, 1_000_000], 2048, 0, "auto", 3, 1320.0,
                                  None)
    c = config({"RAXTAX_BENCH_REFS": "4096", "RAXTAX_BENCH_QUERIES": "64",
                "RAXTAX_BENCH_BATCH": "1024", "RAXTAX_BENCH_BACKEND": "stream",
                "RAXTAX_BENCH_REPS": "0", "RAXTAX_BENCH_BUDGET": "99",
                "RAXTAX_BENCH_ORACLE_QUERIES": "2",
                "RAXTAX_BENCH_CACHE_DIR": str(tmp_path)})
    assert (c.configs, c.n_queries, c.batch, c.backend, c.reps, c.budget,
            c.oracle_queries, c.cache_dir) == ([4096], 64, 1024, "stream", 1,
                                               99.0, 2, tmp_path)


def _tiny(monkeypatch, tmp_path, **extra):
    env = {"RAXTAX_BENCH_REFS": "300", "RAXTAX_BENCH_QUERIES": "8",
           "RAXTAX_BENCH_BATCH": "4", "RAXTAX_BENCH_REPS": "2",
           "RAXTAX_BENCH_ORACLE_QUERIES": "2",
           "RAXTAX_BENCH_CACHE_DIR": str(tmp_path), **extra}
    for name in ("RAXTAX_EXACT", "RAXTAX_SPARSE_FOLD", "RAXTAX_BM_SCAN",
                 "RAXTAX_FUSED_GATHER", "RAXTAX_SPLIT2", "RAXTAX_SPLIT_SIG",
                 "RAXTAX_BENCH_BUDGET", "RAXTAX_BENCH_BACKEND"):
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("exact", ["", "0"], ids=["exact", "dd"])
def test_bench_prints_one_json_line_per_configuration(
    tmp_path, monkeypatch, capsys, exact
):
    """A tiny world on the CPU: exactly one line on stdout with the JAX
    bench's keys (unit per GPU), REPS passes, the explicit batch, and the
    engine mode taken from the environment; the database cache is written
    for the next run."""
    from raxtax_tpu_torch.tools import bench

    _tiny(monkeypatch, tmp_path, RAXTAX_EXACT=exact)
    assert bench.main(["--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == KEYS
    assert line["metric"] == "classify_throughput_300ref_db"
    assert line["unit"] == "queries/s/gpu" and line["batch"] == 4
    assert len(line["pass_s"]) == 2 and line["value"] >= line["median"] > 0
    assert line["vs_baseline"] > 0
    assert f"significance={'dd' if exact == '0' else 'exact'}" in err
    # the cache write ended before the timed passes began
    assert bench.cache_path(bench.config(), 300).is_file()
    assert err.index("waited") < err.index("pass 1/")


def test_deadline_skips_a_configuration_that_cannot_fit(monkeypatch, capsys):
    """The first configuration always runs; a later one runs only when its
    estimate (build at the measured rate + the run) fits what is left."""
    from raxtax_tpu_torch.tools import bench

    monkeypatch.delenv("RAXTAX_BENCH_REFS", raising=False)
    monkeypatch.setenv("RAXTAX_BENCH_BUDGET", "120")
    ran = []
    monkeypatch.setattr(bench, "run_config",
                        lambda cfg, n, device: ran.append(n) or 1e-4)
    assert bench.main(["--device", "cpu"]) == 0
    assert ran == [65536]
    assert "skipping 1000000-ref config" in capsys.readouterr().err
    monkeypatch.setenv("RAXTAX_BENCH_BUDGET", "100000")
    ran.clear()
    assert bench.main(["--device", "cpu"]) == 0
    assert ran == [65536, 1_000_000]


def test_bench_scale_parses_and_runs_a_tiny_world(capsys, monkeypatch):
    from raxtax_tpu_torch.tools import bench_scale

    with pytest.raises(SystemExit) as e:
        bench_scale.main(["--help"])
    assert e.value.code == 0
    help_text = capsys.readouterr().out
    for flag in ("--refs", "--queries", "--backend", "--batch-size",
                 "--seq-len", "--families", "--device"):
        assert flag in help_text
    monkeypatch.setenv("RAXTAX_BENCH_REPS", "1")
    assert bench_scale.main(["--refs", "500", "--queries", "8", "--batch-size",
                             "4", "--families", "32", "--seq-len", "200",
                             "--device", "cpu"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("500-ref DB: 8 queries in ") and "q/s/gpu" in last
