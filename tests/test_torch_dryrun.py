"""The graft entry points on the CPU: ``raxtax_tpu_torch/tools/dryrun.py``
against the root ``__graft_entry__.py`` of the JAX package.

``entry()``: the port's step against the JAX step under ``jax.jit`` on the
entry's own world at tolerance 0 on ``hist``, ``vals`` and ``idx`` (every
probability there is 2^-6, so every partial sum is exact whatever the
order of the adds, and the many equal confidences fix the tie order). On a
random table JAX's CPU prefix sum adds in another order than
``torch.cumsum``: a value is the difference of two prefix sums, so its error
scales with them, not with itself. ``vals`` agree within ``TOL`` times the
row's total probability (the largest prefix sum; about 8 f32 epsilons) plus
``TOL`` of themselves; counts and ``hist`` exactly; ``idx`` wherever a value
stands further than that from both neighbours. JAX returns
``idx`` as int32, the port int64: the values are compared.

The mesh dry run (``dryrun_multichip(4)``: four gloo ranks, mesh ``2,2``)
starts once for the module, in the background, while the JAX side runs; its
lines per backend must equal the JAX package's host oracle, and inside it
the port's single-device run. ``dryrun_multiprocess(2)`` holds its
``raxtax.out`` byte-equal to one process and here to the oracle too.
"""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from raxtax_tpu.io.fasta import parse_query_fasta_str, parse_reference_fasta_str
from raxtax_tpu.db.database import build_database
from raxtax_tpu.models.oracle import OracleClassifier
from raxtax_tpu.ops.intersect_xla import intersection_counts_xla as jax_counts
from raxtax_tpu.parallel.mesh import make_mesh as jax_make_mesh
from raxtax_tpu_torch.convert import database_fields
from raxtax_tpu_torch.ops.intersect_xla import intersection_counts_xla
from raxtax_tpu_torch.tools import dryrun
from tests.test_torch_common import to_i32

TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread_children():
    """The ranks and processes the dry runs start inherit this process's
    environment: one OpenMP thread each, as in ``test_torch_multihost.py``,
    not one a core: alone on 8 cores, the four-rank test burned 108
    core-seconds with one thread a core and 32 with one."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


@pytest.fixture(scope="module")
def mesh_run():
    """``dryrun_multichip(4, device="cpu")``, started at once in the
    background; the value is a function that waits for it and returns its
    result and what it logged."""
    result, logged = {}, []

    def run():
        try:
            result["value"] = dryrun.dryrun_multichip(
                4, device="cpu", log=logged.append)
        except AssertionError as e:
            result["error"] = e

    th = threading.Thread(target=run)
    th.start()

    def wait():
        th.join()
        if "error" in result:
            raise result["error"]
        return result["value"], logged

    yield wait
    th.join()


@pytest.fixture(scope="module")
def jax_entry():
    fn, args = graft.entry()
    return fn, args, [np.asarray(x) for x in jax.jit(fn)(*args)]


def test_tiny_world_equals_jax(mesh_run):  # starts the ranks early
    jdb, pdb = graft._tiny_world(), dryrun.tiny_world()
    want, got = database_fields(jdb), database_fields(pdb)
    assert want.keys() == got.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert want[k].dtype == got[k].dtype, k
            assert np.array_equal(want[k], got[k]), k
        else:
            assert want[k] == got[k], k
    assert np.array_equal(jdb.taxonomy.eval_ids, pdb.taxonomy.eval_ids)


def test_entry_equals_jax_at_tolerance_zero(jax_entry):
    _, _, (jh, jv, ji) = jax_entry
    fn, args = dryrun.entry("cpu")
    assert all(a.device.type == "cpu" for a in args)
    hist, vals, idx = fn(*args)
    assert jh.dtype == np.int32 and hist.dtype == torch.int32
    assert np.array_equal(hist.numpy(), jh)
    assert vals.dtype == torch.float32
    assert np.array_equal(vals.numpy().view(np.int32), jv.view(np.int32))
    assert ji.dtype == np.int32 and idx.dtype == torch.int64
    assert np.array_equal(idx.numpy(), ji)  # ties included
    # the world of the step: 77 eval nodes, every returned value significant
    assert ji.shape == (8, 64) and (jv > 0).all()


def test_entry_on_a_random_table(jax_entry):
    jfn, jargs, _ = jax_entry
    table = (np.random.default_rng(11).random((8, dryrun.S_MAX)) * 0.02
             ).astype(np.float32)
    jh, jv, ji = (np.asarray(x) for x in jax.jit(jfn)(
        jargs[0], jargs[1], jnp.asarray(table)))
    fn, args = dryrun.entry("cpu")
    hist, vals, idx = (x.numpy() for x in fn(args[0], args[1],
                                              torch.from_numpy(table)))
    qb, rb = np.array(jargs[0]), np.array(jargs[1])
    counts = np.asarray(jax_counts(jargs[0], jargs[1]))
    assert np.array_equal(
        intersection_counts_xla(to_i32(qb), to_i32(rb)).numpy(), counts)
    assert np.array_equal(hist, jh)
    assert (jv > 0).sum() > 100  # most of the values are significant
    total = np.take_along_axis(table, counts.astype(np.int64), 1).sum(1)
    tol = TOL * (total[:, None] + np.abs(jv))
    assert (np.abs(vals - jv) <= tol).all()
    gap = np.abs(np.diff(jv, axis=1))
    apart = np.ones_like(jv, dtype=bool)
    apart[:, 1:] &= gap > tol[:, 1:]
    apart[:, :-1] &= gap > tol[:, :-1]
    assert apart.sum() > 64  # the rest are ties (nodes over the same tips)
    assert np.array_equal(idx[apart], ji[apart])


@pytest.mark.parametrize("k", [64, 77])
def test_stable_top_k_matches_lax_top_k_on_ties(k):
    rng = np.random.default_rng(5)
    x = rng.integers(-1, 4, size=(8, 77)).astype(np.float32) / 64
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    vals, idx = dryrun.top_k_stable(torch.from_numpy(x), k)
    assert np.array_equal(vals.numpy(), np.asarray(jv))
    assert np.array_equal(idx.numpy(), np.asarray(ji))


def test_dryrun_multichip_four_ranks_equal_the_oracle(mesh_run):
    res, logged = mesh_run()
    shape = dict(jax_make_mesh("2,2").shape)
    want = [f"dryrun_multichip OK: backend={b} mesh={shape}, 4 queries "
            "classified" for b in ("xla", "pallas", "stream")]
    assert logged == want and res["lines"] == want
    assert res["ranks"] == 4 and res["world_backend"] == "gloo"
    db = graft._tiny_world()
    orc = OracleClassifier(db)
    lines = [orc.classify(f"q{i}", db.sequence(i)).out_string()
             for i in range(4)]
    for b in dryrun.BACKENDS:
        assert res["mesh"][b] == lines, b
        assert res["single"][b] == lines, b
        # the plain versions ran: a wrapper counts kernel launches only
        assert res["launches"][b] == {}, b


def test_dryrun_multiprocess_equals_the_oracle():
    logged = []
    res = dryrun.dryrun_multiprocess(2, device="cpu", log=logged.append)
    assert logged == [
        "dryrun_multiprocess OK: 2 processes, one global mesh, database "
        "model-sharded across processes"]
    recs = parse_reference_fasta_str(dryrun.MULTIPROCESS_FASTA)
    orc = OracleClassifier(build_database(recs.lineages, recs.sequences))
    want = "".join(orc.classify(l, s).out_string() + "\n" for l, s in
                   parse_query_fasta_str(dryrun.MULTIPROCESS_FASTA))
    assert res["out"] == want and res["lines"] >= 8


def test_main_runs_the_three_in_turn(monkeypatch, capsys):
    """``main --device cpu``: the step eager and compiled (here captured by
    dynamo and run without code generation, which takes a minute on a CPU),
    one rank for the mesh dry run, two processes for the other."""
    calls = []
    compile_ = torch.compile
    monkeypatch.setattr(torch, "compile",
                        lambda f: compile_(f, backend="eager"))
    monkeypatch.setattr(dryrun, "dryrun_multichip",
                        lambda n, d: calls.append(("multichip", n, d)))
    monkeypatch.setattr(dryrun, "dryrun_multiprocess",
                        lambda n, d: calls.append(("multiprocess", n, d)))
    assert dryrun.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out == (
        "entry OK: [(8, 256), (8, 64), (8, 64)]\n")
    assert calls == [("multichip", 1, "cpu"), ("multiprocess", 2, "cpu")]


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
