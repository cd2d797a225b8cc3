"""The database cache the two command lines build: the port's layout and
ref-major choice against the JAX command line's on one device, flag for
flag.

Both ``cli.main`` run on the same FASTA with each package's
``load_or_parse_database`` replaced by a spy that records what it was asked
for and stops the run. The JAX command line sees one device
(``tests/conftest.py`` makes eight) and, for a classify run's ``auto``
backend, a TPU, where it resolves ``auto`` to ``pallas``; the port's
``auto`` is ``pallas``. The double-f32 bit-major scan (``RAXTAX_BM_SCAN``)
is a rule of the port alone: the JAX command line has no such branch."""

from pathlib import Path
from types import SimpleNamespace

import jax
import pytest

import raxtax_tpu.cli as jax_cli
import raxtax_tpu.db.database as jax_database
import raxtax_tpu.utils.jaxcfg as jaxcfg
from raxtax_tpu_torch import cli
from raxtax_tpu_torch.db import database
from raxtax_tpu_torch.db.database import load_or_parse_database

DATA = Path(__file__).parent / "data"
REFS = DATA / "golden_refs.fasta"
QUERIES = DATA / "golden_queries.fasta"
ENV = ("RAXTAX_EXACT", "RAXTAX_SPARSE_FOLD", "RAXTAX_BM_SCAN",
       "RAXTAX_FUSED_GATHER", "RAXTAX_SPLIT_SIG", "JAX_COORDINATOR_ADDRESS")


class _Stop(Exception):
    pass


def _asked(monkeypatch, module, main, argv) -> dict:
    """The keyword arguments ``main(argv)`` passes to ``module``'s
    ``load_or_parse_database`` (the command lines import it when they
    run)."""
    asked = {}

    def spy(path, **kw):
        asked.update(kw)
        raise _Stop

    monkeypatch.setattr(module, "load_or_parse_database", spy)
    assert main(argv) != 0  # stopped where the database is loaded
    return {k: asked[k] for k in ("with_ref_major", "kmer_layout")}


@pytest.fixture
def one_tpu(monkeypatch):
    """One local device, a TPU, for the JAX command line's choice."""
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(jaxcfg, "setup_jax", lambda *a, **k: None)
    tpu = SimpleNamespace(platform="tpu")
    monkeypatch.setattr(jax, "devices", lambda *a, **k: [tpu])
    monkeypatch.setattr(jax, "local_devices", lambda *a, **k: [tpu])


@pytest.mark.parametrize(
    "flags,ref_major,layout",
    [
        # --only-db: the future consumer's backend is unknown under auto
        (["--only-db"], True, "packed"),
        (["--only-db", "--backend", "pallas"], False, "auto"),
        (["--only-db", "--backend", "stream"], False, "auto"),
        (["--only-db", "--backend", "xla"], True, "packed"),
        # classify runs
        (["--backend", "xla"], True, "packed"),
        ([], False, "auto"),
        (["--backend", "pallas"], False, "auto"),
        (["--backend", "stream"], False, "auto"),
    ],
)
def test_cache_layout_is_the_jax_cli_choice(
        tmp_path, monkeypatch, one_tpu, flags, ref_major, layout):
    argv = ["-d", str(REFS)] + flags
    if "--only-db" not in flags:
        argv += ["-i", str(QUERIES)]
    got_jax = _asked(monkeypatch, jax_database, jax_cli.main,
                     argv + ["-o", str(tmp_path / "jax")])
    got = _asked(monkeypatch, database, cli.main,
                 argv + ["-o", str(tmp_path / "port"), "--device", "cpu"])
    assert got == got_jax == {"with_ref_major": ref_major, "kmer_layout": layout}


def test_bm_scan_layout_is_packed_a_rule_of_the_port(tmp_path, monkeypatch):
    """The double-f32 bit-major scan reads the packed layout only, so the
    port builds ``packed`` for it whatever the planes backend."""
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("RAXTAX_EXACT", "0")
    monkeypatch.setenv("RAXTAX_BM_SCAN", "1")
    got = _asked(monkeypatch, database, cli.main,
                 ["-d", str(REFS), "-i", str(QUERIES), "-o", str(tmp_path / "out"),
                  "--device", "cpu"])
    assert got == {"with_ref_major": False, "kmer_layout": "packed"}
    assert cli.cache_layout("auto", False, True, "exact")[1:] == (False, "auto")


def test_only_db_pallas_cache_has_no_ref_major_matrix(tmp_path, monkeypatch):
    """``--only-db --backend pallas`` writes a cache without the ref-major
    matrix and says so in the log."""
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    out = tmp_path / "out"
    assert cli.main(["-d", str(REFS), "-o", str(out), "--only-db",
                     "--backend", "pallas"]) == 0
    parsed, db = load_or_parse_database(next(out.glob("*.bin.rxdb")))
    assert not parsed
    assert db.ref_major is None
    assert "Skipped the ref-major" in (out / "raxtax.log").read_text()
