"""The port's command line on the CPU (``--device cpu``): the committed
golden fixture byte for byte, resume after an interrupted run, and the flags
whose code paths are not ported yet."""

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
        (["--mesh", "2,4"], "--mesh"),
        (["--coordinator", "localhost:1234"], "--coordinator"),
        (["--num-processes", "2"], "--num-processes"),
        (["--process-id", "0"], "--process-id"),
        (["--global-mesh"], "--global-mesh"),
        (["--backend", "xla"], "--backend xla"),
        (["--backend", "stream"], "--backend stream"),
        (["--descent", "device"], "--descent device"),
        (["--trace", "tracedir"], "--trace"),
    ],
)
def test_unported_flags_exit_with_their_message(tmp_path, capsys, flags, name):
    out = tmp_path / "out"
    rc = run_cli(out, *flags)
    assert rc == 69
    err = capsys.readouterr().err
    assert name in err and "not yet ported" in err
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
