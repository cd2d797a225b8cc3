"""The port's command line on the CPU (``--device cpu``): the committed
golden fixture byte for byte (every ``--backend``), resume after an
interrupted run, and the usage errors of the mesh and multi-process
flags."""

from pathlib import Path

import pytest

from raxtax_tpu_torch.cli import main

DATA = Path(__file__).parent / "data"
REFS = DATA / "golden_refs.fasta"
QUERIES = DATA / "golden_queries.fasta"


def run_cli(out, *extra):
    return main(
        ["-d", str(REFS), "-i", str(QUERIES), "-o", str(out), "--device", "cpu",
         "--batch-size", "4"] + list(extra)
    )


@pytest.mark.parametrize(
    "suffix,flags",
    [
        ("", []),
        ("_rawconf", ["--raw-confidence"]),
        ("_skipexact", ["--skip-exact-matches"]),
    ],
)
def test_golden_bytes(tmp_path, suffix, flags):
    out = tmp_path / "out"
    assert run_cli(out, "--tsv", *flags) == 0
    assert (out / "raxtax.out").read_bytes() == (
        DATA / f"golden_raxtax{suffix}.out"
    ).read_bytes()
    assert (out / "raxtax.tsv").read_bytes() == (
        DATA / f"golden_raxtax{suffix}.tsv"
    ).read_bytes()
    assert "raxtax-torch" in (out / "raxtax.log").read_text()
    assert len(list(out.glob("*.bin.rxdb"))) == 1


def test_tsv_off_gives_the_same_out_bytes(tmp_path):
    out = tmp_path / "out"
    assert run_cli(out, "--debug-checks") == 0
    assert (out / "raxtax.out").read_bytes() == (
        DATA / "golden_raxtax.out"
    ).read_bytes()
    assert not (out / "raxtax.tsv").exists()


def test_resume_after_interrupted_run(tmp_path, monkeypatch):
    out = tmp_path / "out"
    assert run_cli(out, "--tsv") == 0
    first = (out / "raxtax.out").read_text()
    labels = (out / "raxtax.ckp").read_text().strip().split("\n")
    assert len(labels) == 12
    # simulate an interrupted run: the last three queries were not committed
    lost = set(labels[-3:])
    (out / "raxtax.ckp").write_text("\n".join(labels[:-3]) + "\n")

    from raxtax_tpu_torch.engine.device import DeviceClassifier

    seen = []
    orig = DeviceClassifier.submit_batch

    def spy(self, chunk):
        seen.extend(l for l, _ in chunk)
        return orig(self, chunk)

    monkeypatch.setattr(DeviceClassifier, "submit_batch", spy)
    assert run_cli(out, "--tsv") == 0  # reads the binary DB it wrote
    assert set(seen) == lost
    assert sorted((out / "raxtax.out").read_text().strip().split("\n")) == sorted(
        first.strip().split("\n")
    )
    assert set((out / "raxtax.ckp").read_text().strip().split("\n")) == set(labels)
    assert "Restarting from checkpoint" in (out / "raxtax.log").read_text()


def test_existing_output_requires_redo_and_clean_removes_artifacts(tmp_path):
    out = tmp_path / "out"
    assert run_cli(out) == 0
    (out / "raxtax.json").unlink()
    assert run_cli(out) == 73  # CANTCREAT
    assert run_cli(out, "--redo", "--clean") == 0
    assert not (out / "raxtax.json").exists()
    assert not (out / "raxtax.ckp").exists()
    assert not list(out.glob("*.bin.rxdb"))
    assert (out / "raxtax.out").read_bytes() == (
        DATA / "golden_raxtax.out"
    ).read_bytes()


def test_only_db_then_skip_db_and_oracle_backend(tmp_path):
    out = tmp_path / "out"
    assert main(["-d", str(REFS), "-o", str(out), "--only-db"]) == 0
    assert len(list(out.glob("*.bin.rxdb"))) == 1
    out2 = tmp_path / "out2"
    assert main(
        ["-d", str(REFS), "-i", str(QUERIES), "-o", str(out2), "--skip-db",
         "--backend", "oracle"]
    ) == 0
    assert not list(out2.glob("*.bin.rxdb"))
    assert (out2 / "raxtax.out").read_bytes() == (
        DATA / "golden_raxtax.out"
    ).read_bytes()


@pytest.mark.parametrize(
    "flags,name",
    [
        # the JAX command line's usage error: a process count or id without
        # a coordinator (exit 2)
        (["--num-processes", "2"], "--num-processes/--process-id require"),
        (["--process-id", "0"], "--num-processes/--process-id require"),
        # meshes that do not fit the world, refused before any rank starts
        (["--mesh", "3,3"], "mesh 3x3 > 1 available ranks"),
        (["--mesh", "2x2"], "is not '<data>,<model>'"),
        (["--coordinator", "127.0.0.1:1", "--num-processes", "2",
          "--process-id", "0", "--global-mesh", "--mesh", "1,1"],
         "--global-mesh spans the world of 2 ranks"),
    ],
)
def test_mesh_flags_usage_errors_exit_2(tmp_path, capsys, flags, name):
    """What the mesh and multi-process flags refuse exits 2 with its
    message, before anything is written."""
    out = tmp_path / "out"
    with pytest.raises(SystemExit) as e:
        run_cli(out, *flags)
    assert e.value.code == 2
    assert name in capsys.readouterr().err
    assert not out.exists()  # nothing ran, nothing was written


def test_default_device_is_the_gpu(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("needs a machine without a GPU")
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["-d", str(REFS), "-i", str(QUERIES), "-o", str(out)])
    assert not out.exists()


def test_version_and_usage_errors(tmp_path, capsys):
    from raxtax_tpu_torch import __version__

    with pytest.raises(SystemExit) as e:
        main(["--version"])
    assert e.value.code == 0
    assert __version__ in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        main(["-d", str(REFS), "-o", str(tmp_path / "o"), "--only-db", "--skip-db"])
    assert e.value.code == 2
    assert main(["-d", str(REFS), "-o", str(tmp_path / "o"), "--device", "cpu"]) != 0


@pytest.mark.parametrize(
    "env,want",
    [
        ({}, ("exact", "dense", False)),
        ({"RAXTAX_EXACT": "1", "RAXTAX_SPARSE_FOLD": "0"}, ("exact", "dense", False)),
        ({"RAXTAX_EXACT": "0", "RAXTAX_SPARSE_FOLD": "1"}, ("dd", "sparse", False)),
        ({"RAXTAX_EXACT": "auto", "RAXTAX_BM_SCAN": "1"}, ("auto", "dense", True)),
        ({"RAXTAX_FUSED_GATHER": "0"}, ("exact", "gathered", False)),
        ({"RAXTAX_FUSED_GATHER": "0", "RAXTAX_SPARSE_FOLD": "0"},
         ("exact", "gathered", False)),
        ({"RAXTAX_FUSED_GATHER": "0", "RAXTAX_SPARSE_FOLD": "1"},
         ("exact", "sparse", False)),
        ({"RAXTAX_FUSED_GATHER": "1"}, ("exact", "dense", False)),
    ],
)
def test_engine_mode_from_the_jax_environment_names(env, want):
    from raxtax_tpu_torch.cli import engine_mode_from_env

    got = engine_mode_from_env(env)
    assert (got["significance"], got["fold"], got["bm_scan"]) == want
    assert got["split_sig"] is False
    assert engine_mode_from_env({"RAXTAX_SPLIT_SIG": "1"})["split_sig"] is True
    with pytest.raises(ValueError):
        engine_mode_from_env({"RAXTAX_EXACT": "yes"})


@pytest.mark.parametrize("bm_scan", ["", "1"])
def test_golden_bytes_in_dd_mode_through_the_environment(tmp_path, monkeypatch, bm_scan):
    """``RAXTAX_EXACT=0 RAXTAX_SPARSE_FOLD=1`` select the double-f32 path
    with the sparse fold from the command line: same golden bytes."""
    monkeypatch.setenv("RAXTAX_EXACT", "0")
    monkeypatch.setenv("RAXTAX_SPARSE_FOLD", "1")
    monkeypatch.setenv("RAXTAX_BM_SCAN", bm_scan)
    out = tmp_path / "out"
    assert run_cli(out, "--tsv", "--debug-checks") == 0
    assert (out / "raxtax.out").read_bytes() == (DATA / "golden_raxtax.out").read_bytes()
    assert (out / "raxtax.tsv").read_bytes() == (DATA / "golden_raxtax.tsv").read_bytes()


@pytest.mark.parametrize(
    "backend,env",
    [
        ("xla", {}),
        ("xla", {"RAXTAX_SPLIT_SIG": "1"}),
        ("pallas", {}),
        ("pallas", {"RAXTAX_FUSED_GATHER": "0", "RAXTAX_EXACT": "0"}),
        ("stream", {}),
        ("stream", {"RAXTAX_EXACT": "0"}),
    ],
)
def test_golden_bytes_for_every_backend(tmp_path, monkeypatch, backend, env):
    """``--backend xla|pallas|stream`` run on the port's engine and give the
    golden bytes; the launch counters stay untouched on the CPU."""
    from raxtax_tpu_torch.ops.intersect_fold import fold_planes_gathered
    from raxtax_tpu_torch.ops.intersect_stream import fold_planes_stream

    for name in ("RAXTAX_EXACT", "RAXTAX_SPARSE_FOLD", "RAXTAX_FUSED_GATHER",
                 "RAXTAX_BM_SCAN", "RAXTAX_SPLIT_SIG"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    out = tmp_path / "out"
    assert run_cli(out, "--tsv", "--debug-checks", "--backend", backend) == 0
    assert (out / "raxtax.out").read_bytes() == (DATA / "golden_raxtax.out").read_bytes()
    assert (out / "raxtax.tsv").read_bytes() == (DATA / "golden_raxtax.tsv").read_bytes()
    assert fold_planes_gathered.launches == 0 and fold_planes_stream.launches == 0
    log = (out / "raxtax.log").read_text()
    assert ("Skipped the ref-major" in log) == (backend != "xla")


def test_xla_backend_needs_the_ref_major_matrix(tmp_path):
    """A binary database written without the ref-major matrix cannot feed
    the dense-count backend: the run fails with the engine's message and
    writes no result."""
    first = tmp_path / "first"
    assert run_cli(first, "--backend", "stream") == 0
    rxdb = next(first.glob("*.bin.rxdb"))
    out = tmp_path / "out"
    rc = main(["-d", str(rxdb), "-i", str(QUERIES), "-o", str(out),
               "--device", "cpu", "--backend", "xla"])
    assert rc == 75  # TEMPFAIL
    assert "ref-major" in (out / "raxtax.log").read_text()
