"""Multi-process runs of the port on the CPU: ``parallel/multihost.py``
against the JAX package's ``raxtax_tpu/parallel/multihost.py``, and the
command line in two gloo ranks started by ``parallel/launch.py``, byte-equal
to a single process (the goldens), with no ``.shard*`` file left."""

import json
import os
import sys
from pathlib import Path

import pytest

import raxtax_tpu.parallel.multihost as jax_mh
from raxtax_tpu_torch.parallel import launch as port_launch
from raxtax_tpu_torch.parallel import multihost as port_mh

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
REFS = DATA / "golden_refs.fasta"
QUERIES = DATA / "golden_queries.fasta"
ENV = ("RAXTAX_EXACT", "RAXTAX_SPARSE_FOLD", "RAXTAX_BM_SCAN",
       "RAXTAX_FUSED_GATHER", "RAXTAX_SPLIT_SIG", "RAXTAX_SPLIT2",
       "RAXTAX_SHARD_HBM_BUDGET", "JAX_COORDINATOR_ADDRESS",
       "JAX_NUM_PROCESSES", "JAX_PROCESS_ID", "MASTER_ADDR", "MASTER_PORT",
       "WORLD_SIZE", "RANK", "LOCAL_RANK")


def _env(**extra) -> dict:
    # one torch thread a rank: the suite runs beside other test workers
    env = {k: v for k, v in os.environ.items() if k not in ENV}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", **extra)
    return env


def _ranks(n, out, *flags, env=None):
    """``raxtax_tpu_torch.cli`` on the golden world in ``n`` ranks."""
    codes, logs = port_launch.launch(
        n, ["-m", "raxtax_tpu_torch.cli", "-d", str(REFS), "-i", str(QUERIES),
            "-o", str(out), "--tsv", "--device", "cpu", "--batch-size", "4",
            *flags],
        env=env or _env(), timeout=300, cwd=str(ROOT),
    )
    assert codes == [0] * n, "\n".join(logs)[-4000:]


def _assert_golden(out: Path):
    for ext in ("out", "tsv"):
        assert (out / f"raxtax.{ext}").read_bytes() == (
            DATA / f"golden_raxtax.{ext}").read_bytes(), ext
    assert not list(out.glob("*.shard*"))


def test_query_slices_and_shard_names_equal_jax():
    for n in [0, 1, 7, 100, 1001]:
        for pc in [1, 2, 3, 8]:
            for i in range(pc):
                assert port_mh.host_query_slice(n, i, pc) == \
                    jax_mh.host_query_slice(n, i, pc)
    for i, pc in [(0, 1), (3, 8), (3, 16), (0, 2), (11, 12)]:
        assert port_mh.shard_suffix(i, pc) == jax_mh.shard_suffix(i, pc)


def test_consolidate_equals_jax(tmp_path):
    """The scenarios of ``tests/test_multihost.py`` (committed shards,
    uncommitted lines, a re-applied shard, an existing merged file, an
    orphan shard, a shard checkpoint adopted) through both functions: the
    same files with the same bytes."""
    ckp = {"checkpoint_file": "x", "progress_file": "y", "db": "z"}
    scenarios = [
        {"raxtax.out.shard0": "a\tx\nb\ty\n", "raxtax.ckp.shard0": "a\nb\n",
         "raxtax.out.shard1": "c\tz\n", "raxtax.ckp.shard1": "c\n",
         "raxtax.out.shard2": "", "raxtax.ckp.shard2": "",
         "raxtax.log.shard1": "log1\n",
         "raxtax.json.shard0": json.dumps(ckp)},
        {"raxtax.out.shard0": "a\tx\nb\tgarbage\n", "raxtax.ckp.shard0": "a\n"},
        {"raxtax.out": "a\tx\na\tx2\nb\ty\n", "raxtax.ckp": "a\nb\n",
         "raxtax.out.shard0": "a\tx\na\tx2\nb\ty\n", "raxtax.ckp.shard0": "a\nb\n"},
        {"raxtax.out": "old\tline\n", "raxtax.out.shard0": "",
         "raxtax.ckp.shard0": "", "raxtax.tsv.shard3": "q\t1\n"},
    ]
    for k, files in enumerate(scenarios):
        for side, fn in (("jax", jax_mh.consolidate_artifacts),
                         ("port", port_mh.consolidate_artifacts)):
            d = tmp_path / f"{k}_{side}"
            d.mkdir()
            for name, text in files.items():
                (d / name).write_text(text)
            fn(d)
            fn(d)  # idempotent
        got = {p.name: p.read_bytes() for p in (tmp_path / f"{k}_port").iterdir()}
        want = {p.name: p.read_bytes() for p in (tmp_path / f"{k}_jax").iterdir()}
        if "raxtax.json" in want:  # it names its own directory
            want["raxtax.json"] = want["raxtax.json"].replace(
                str(tmp_path / f"{k}_jax").encode(),
                str(tmp_path / f"{k}_port").encode())
        assert got == want, k


def test_world_config_reads_flags_then_jax_then_torchrun_names():
    wc = port_mh.world_config
    assert wc(environ={}) is None
    assert port_mh.maybe_initialize(device="cpu") == (0, 1)  # no world here
    got = wc("10.0.0.1:7000", 4, 2, environ={})
    assert (got.host, got.port, got.world_size, got.rank, got.local_rank) == (
        "10.0.0.1", 7000, 4, 2, 2)
    jax_env = {"JAX_COORDINATOR_ADDRESS": "h:1234", "JAX_NUM_PROCESSES": "2",
               "JAX_PROCESS_ID": "1"}
    torchrun = {"MASTER_ADDR": "m", "MASTER_PORT": "29511", "WORLD_SIZE": "8",
                "RANK": "5", "LOCAL_RANK": "1"}
    got = wc(environ=jax_env)
    assert (got.host, got.port, got.world_size, got.rank) == ("h", 1234, 2, 1)
    got = wc(environ=torchrun)
    assert (got.host, got.port, got.world_size, got.rank, got.local_rank) == (
        "m", 29511, 8, 5, 1)
    # the arguments win over the JAX names, which win over torchrun's
    got = wc("a:1", 3, 0, environ={**jax_env, **torchrun})
    assert (got.host, got.world_size, got.rank) == ("a", 3, 0)
    got = wc(environ={**jax_env, **torchrun})
    assert (got.host, got.world_size, got.rank, got.local_rank) == ("h", 2, 1, 1)
    for bad in (("a:1", 2, -1), ("a:1", 0, 0), ("a:1", 2, 2), ("nohost", 2, 0)):
        with pytest.raises(ValueError):
            wc(*bad, environ={})


def test_a_failed_rank_stops_the_others():
    codes, logs = port_launch.launch(
        2, ["-c", "import os, sys, time\n"
                  "if os.environ['RANK'] == '1': sys.exit(3)\n"
                  "time.sleep(60)"], timeout=30)
    assert codes[1] == 3 and codes[0] != 0


def test_two_independent_ranks_equal_one_process(tmp_path):
    """Each rank classifies its half of the queries into shard files; rank
    0 folds them: the goldens' bytes, no shard left."""
    _ranks(2, tmp_path / "out")
    _assert_golden(tmp_path / "out")


def test_two_ranks_on_a_global_mesh_equal_one_process(tmp_path):
    """``--global-mesh --mesh 1,2``: the database model-sharded over both
    ranks, the same batches fed by both, rank 0 the only writer."""
    _ranks(2, tmp_path / "out", "--global-mesh", "--mesh", "1,2")
    _assert_golden(tmp_path / "out")


def test_over_budget_database_and_a_resume_from_two_ranks_to_one(tmp_path):
    """``tests/test_multiprocess.py:141-204`` for the port: a database
    larger than one rank's budget refuses to start on a mesh of one, runs
    model-sharded over two ranks, and a run cut after 8 of its 12 queries
    resumes in one process to the same lines."""
    from raxtax_tpu_torch import cli
    from raxtax_tpu_torch.db.database import build_database
    from raxtax_tpu_torch.io.fasta import parse_reference_fasta_file
    from raxtax_tpu_torch.parallel.mesh import ShardedPipeline, make_mesh

    recs = parse_reference_fasta_file(str(REFS))
    db = build_database(recs.lineages, recs.sequences)
    budget = str(db.ref_major.nbytes // 2 + 4096)  # half fits, all does not
    os.environ["RAXTAX_SHARD_HBM_BUDGET"] = budget
    try:
        with pytest.raises(RuntimeError, match="exceeds the per-device"):
            ShardedPipeline.create(db, make_mesh("1,1", device="cpu"), "xla")
    finally:
        del os.environ["RAXTAX_SHARD_HBM_BUDGET"]
        port_mh.shutdown()

    out = tmp_path / "out"
    _ranks(2, out, "--global-mesh", "--mesh", "1,2", "--backend", "xla",
           env=_env(RAXTAX_SHARD_HBM_BUDGET=budget))
    expected = (out / "raxtax.out").read_text()
    assert expected == (DATA / "golden_raxtax.out").read_text()
    ckp = (out / "raxtax.ckp").read_text().splitlines()
    assert len(ckp) == 12
    (out / "raxtax.ckp").write_text("\n".join(ckp[:8]) + "\n")
    assert cli.main(["-d", str(REFS), "-i", str(QUERIES), "-o", str(out),
                     "--tsv", "--device", "cpu", "--backend", "xla"]) == 0
    resumed = (out / "raxtax.out").read_text()
    assert sorted(resumed.splitlines()) == sorted(expected.splitlines())
    assert len((out / "raxtax.ckp").read_text().splitlines()) == 12
    assert not list(out.glob("*.shard*"))


@pytest.mark.parametrize("flags", [
    ["--mesh", "1,1"],
    ["--mesh", "1,1", "--backend", "stream"],
    ["--coordinator", "127.0.0.1:1", "--num-processes", "2",
     "--process-id", "0"],
])
def test_cache_layout_under_a_mesh_or_processes_is_the_jax_cli_choice(
        tmp_path, monkeypatch, flags):
    """With ``--mesh`` or several processes the JAX command line builds the
    packed layout, which the shards slice; so does the port (the layout
    test's spy on each package's database loader; both command lines are
    told they are rank 0 of 2 where the flags name two processes)."""
    import jax
    from types import SimpleNamespace

    import raxtax_tpu.cli as jax_cli
    import raxtax_tpu.db.database as jax_database
    import raxtax_tpu.utils.jaxcfg as jaxcfg
    from jax.experimental import multihost_utils
    from raxtax_tpu_torch import cli
    from raxtax_tpu_torch.db import database
    from tests.test_torch_cli_layout import _asked

    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(jaxcfg, "setup_jax", lambda *a, **k: None)
    tpu = SimpleNamespace(platform="tpu")
    monkeypatch.setattr(jax, "devices", lambda *a, **k: [tpu])
    monkeypatch.setattr(jax, "local_devices", lambda *a, **k: [tpu])
    procs = 2 if "--coordinator" in flags else 1
    monkeypatch.setattr(jax_mh, "maybe_initialize", lambda *a, **k: (0, procs))
    monkeypatch.setattr(port_mh, "maybe_initialize", lambda *a, **k: (0, procs))
    monkeypatch.setattr(multihost_utils, "sync_global_devices", lambda *a: None)
    monkeypatch.setattr(port_mh, "barrier", lambda *a: None)
    backend = ["--backend", "pallas"] if "--backend" not in flags else []
    argv = ["-d", str(REFS), "-i", str(QUERIES)] + backend + flags
    want = _asked(monkeypatch, jax_database, jax_cli.main,
                  argv + ["-o", str(tmp_path / "jax")])
    got = _asked(monkeypatch, database, cli.main,
                 argv + ["-o", str(tmp_path / "port"), "--device", "cpu"])
    assert got == want == {"with_ref_major": False, "kmer_layout": "packed"}
    assert cli.cache_layout("pallas", False, False, "exact", mesh="",
                            processes=1)[2] == "auto"


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
