"""The mesh slice on the CPU: ``raxtax_tpu_torch/parallel/mesh.py`` against
the JAX package's ``raxtax_tpu/parallel/mesh.py``.

One world of four gloo ranks starts once for the module, in the background,
from a rank program written to ``tmp_path`` that imports only
``raxtax_tpu_torch``; it is started by ``parallel/launch.py``. The ranks
make the meshes ``1,2`` and ``2,1`` (two independent meshes each: ranks 0-1
and 2-3) and ``2,2`` (all four), run every stage on the seeded world of
``tests/test_parallel.py`` (carried to them by ``convert.database_fields``)
and ``numpy.savez`` what they computed. Meanwhile this process runs the JAX
pipeline on the conftest's eight virtual CPU devices.

Tolerance 0 at ``1,2`` and ``2,1`` (two addends per sum, so the order does
not matter): planes or dense counts per stripe, histograms, the significant
sets of the plain, single-tip split and unit/wide split compactions (sorted
by index), descent finals and margins, and gathered count rows; JAX's
``xla`` backend at both shapes, its ``pallas`` backend in interpret mode at
``1,2``. At ``2,2`` the outputs equal the port's oracle and the JAX mesh
engine."""

import os
import pickle
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

import jax

from raxtax_tpu.db.bitmatrix import pack_query_kmers
from raxtax_tpu.db.database import build_database
from raxtax_tpu.parallel import mesh as jax_mesh
from raxtax_tpu.utils.encoding import encode_sequence, sequence_to_kmers
from raxtax_tpu_torch.convert import database_fields, shard_fields
from raxtax_tpu_torch.parallel import mesh as port_mesh
from raxtax_tpu_torch.parallel.launch import launch

ROOT = Path(__file__).resolve().parent.parent
BASES = "ACGT"
B = 4  #: queries per stage batch
#: the stage batch's queries are the first 60 bases of the world's: 53
#: k-mers at most, so k_pad 64 and s_max 128 (the JAX kernels' interpret
#: mode costs grow with both)
QUERY_BASES, K_PAD, S_MAX = 60, 64, 128
#: the port's (split2, split_sig) per compaction, and the JAX package's
#: environment names for the same
COMPACTIONS = {
    "plain": ((False, False), {"RAXTAX_SPLIT2": "0", "RAXTAX_SPLIT_SIG": "0"}),
    "split": ((False, True), {"RAXTAX_SPLIT2": "0", "RAXTAX_SPLIT_SIG": "1"}),
    "split2": ((True, False), {"RAXTAX_SPLIT2": "1", "RAXTAX_SPLIT_SIG": "0"}),
}
FLAGS = ((False, False), (True, False), (False, True))  # plain, skip, raw

RANK_PROGRAM = r'''
import pickle, sys
import numpy as np
import torch
torch.set_num_threads(1)
from raxtax_tpu_torch.convert import database_from_numpy
from raxtax_tpu_torch.engine.device import DeviceClassifier
from raxtax_tpu_torch.parallel.mesh import ShardedPipeline, make_mesh
from raxtax_tpu_torch.parallel.multihost import maybe_initialize, shutdown

inp = pickle.load(open(sys.argv[1], "rb"))
rank, world = maybe_initialize(device="cpu")
db = database_from_numpy(inp["fields"])
out = {}
for spec in ("1,2", "2,1"):
    mesh = make_mesh(spec, device="cpu")
    for backend in ("xla", "pallas", "stream"):
        for comp, (split2, split_sig) in inp["compactions"].items():
            pipe = ShardedPipeline.create(db, mesh, backend, split2=split2,
                                          split_sig=split_sig)
            counts, hist = pipe.counts_and_hist(
                inp["kmer_idx"], inp["ids"], inp["s_max"], inp["query_bits"])
            sig, cum0 = pipe.significant(counts, torch.from_numpy(inp["table"]))
            key = f"{spec}_{backend}_{comp}_"
            for name, v in zip(("off", "idx", "hi", "lo"), sig.pull()):
                out[key + name] = v
        out[key + "counts"] = counts.numpy()
        out[key + "hist"] = hist.numpy()
        f, m = pipe.descend(cum0, inp["b_arr"], inp["start_arr"])
        out[key + "finals"], out[key + "margins"] = f, m
        out[key + "rows"] = pipe.gather_rows(counts, inp["fb"])
mesh = make_mesh("2,2", device="cpu")
for counts, fold in (("dense", "dense"), ("planes", "gathered"), ("planes", "stream")):
    for skip, raw in inp["flags"]:
        dev = DeviceClassifier.create(
            db, device="cpu", batch_size=4, counts=counts, fold=fold,
            skip_exact_matches=skip, raw_confidence=raw, mesh=mesh)
        got = []
        for lo in range(0, len(inp["queries"]), 4):
            got += dev.classify_batch(inp["queries"][lo : lo + 4])
        out[f"e2e_{fold}_{int(skip)}{int(raw)}"] = np.array(
            [g.out_string() for g in got])
np.savez(f"{sys.argv[2]}/rank{rank}.npz", **out)
shutdown()
'''


def _random_seq(rng, length):
    return "".join(BASES[i] for i in rng.integers(0, 4, size=length))


@pytest.fixture(scope="module")
def world():
    """The seeded world of ``tests/test_parallel.py`` and one batch of
    stage inputs: short queries, a random f32 table and tips to zero (any
    table and tips serve parity; the tips lie on both shards of the ``xla``
    stripes), descent sites at every inner node."""
    rng = np.random.default_rng(7)
    lineages, seqs = [], []
    for p in range(2):
        for f in range(5):
            for s in range(3):
                lineages.append(f"p:P{p},f:F{p}{f},s:S{p}{f}{s}")
                seqs.append(_random_seq(rng, 210))
    db = build_database(lineages, [encode_sequence(s) for s in seqs])
    queries = []
    for i in range(6):
        queries.append((f"q{i}", encode_sequence(seqs[i * 5 % len(seqs)])))
    for i in range(4):
        queries.append((f"r{i}", encode_sequence(_random_seq(rng, 200))))
    kmers = [sequence_to_kmers(s[:QUERY_BASES]) for _, s in queries[3 : 3 + B]]
    kmer_idx = np.full((B, K_PAD), 0x10000, np.int32)
    for i, k in enumerate(kmers):
        kmer_idx[i, : k.size] = k
    ids = np.array([[15, -1], [-1, -1], [3, 20], [29, 0]], np.int32)
    tax = db.taxonomy
    inner = np.flatnonzero(tax.node_type == 0)  # NODE_INNER
    b_arr = np.repeat(np.arange(B, dtype=np.int32), inner.size)
    return {
        "db": db, "queries": queries, "kmer_idx": kmer_idx, "ids": ids,
        "query_bits": pack_query_kmers(kmers),
        "table": (np.random.default_rng(3).random((B, S_MAX)) * 0.01).astype(
            np.float32),
        "b_arr": b_arr, "start_arr": np.tile(inner.astype(np.int32), B),
        "fb": [0, 3],
    }


@pytest.fixture(scope="module")
def ranks(world, tmp_path_factory):
    """The four-rank world, started at once in the background; the value
    is a function that waits for it and returns each rank's arrays."""
    tmp = tmp_path_factory.mktemp("mesh_ranks")
    inp = {k: world[k] for k in ("kmer_idx", "ids", "query_bits", "table",
                                 "b_arr", "start_arr", "fb", "queries")}
    inp.update(
        fields=database_fields(world["db"]), s_max=S_MAX, flags=FLAGS,
        compactions={k: v[0] for k, v in COMPACTIONS.items()},
    )
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    (tmp / "rank.py").write_text(RANK_PROGRAM)
    result = {}

    def run():
        result["codes"], result["logs"] = launch(
            4, [str(tmp / "rank.py"), str(tmp / "inputs.pkl"), str(tmp)],
            env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1"),
            timeout=600, cwd=str(ROOT),
        )

    th = threading.Thread(target=run)
    th.start()

    def wait():
        th.join()
        assert result["codes"] == [0, 0, 0, 0], "\n".join(result["logs"])[-6000:]
        return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)]

    yield wait
    th.join()


def _jax_entries(idx, hi, lo, n_sig):
    """{(row, idx): (hi bits, lo bits)} of a JAX compaction: ``[B, k]``
    slots, the first ``n_sig`` of a row hold its entries."""
    assert (n_sig <= idx.shape[1]).all()  # nothing cut by the width
    return {
        (r, int(idx[r, j])): (hi[r, j].view(np.int32), lo[r, j].view(np.int32))
        for r in range(idx.shape[0]) for j in range(n_sig[r])
    }


def _port_entries(off, idx, hi, lo):
    """The same of the port's flat lists: query r owns ``[off[r],
    off[r+1])``."""
    return {
        (r, int(idx[j])): (hi[j].view(np.int32), lo[j].view(np.int32))
        for r in range(off.shape[0] - 1) for j in range(off[r], off[r + 1])
    }


def _jax_stages(world, spec, backend, comp, monkeypatch):
    for k, v in COMPACTIONS[comp][1].items():
        monkeypatch.setenv(k, v)
    mesh = jax_mesh.make_mesh(spec)
    pipe = jax_mesh.ShardedPipeline.create(world["db"], mesh, backend=backend)
    counts, hist = pipe.counts_and_hist(
        world["query_bits"], world["ids"], S_MAX, kmer_idx=world["kmer_idx"])
    J = world["db"].taxonomy.eval_ids.shape[0]
    vals, vals_lo, idx, n_sig, cum0 = pipe.significant(counts, world["table"], J)
    finals, margins = pipe.descend(cum0, world["b_arr"], world["start_arr"])
    return {
        "counts": np.asarray(counts), "hist": np.asarray(hist),
        "sig": _jax_entries(np.asarray(idx), np.asarray(vals),
                            np.asarray(vals_lo), np.asarray(n_sig)),
        "finals": finals, "margins": margins,
        "rows": pipe.gather_rows(counts, world["fb"]),
    }


def _check_stages(got, jx, spec, backend, comp, full_stages: bool):
    d, m = (int(x) for x in spec.split(","))
    key = f"{spec}_{backend}_{comp}_"
    assert _port_entries(*(got[0][key + k] for k in ("off", "idx", "hi", "lo"))) \
        == jx["sig"], (spec, backend, comp)
    if not full_stages:
        return
    for r in range(2):  # the first mesh's ranks; ranks 2-3 form the second
        c = got[r][key + "counts"]
        di, mi = divmod(r, m)
        b_l = B // d
        block = jx["counts"][di * b_l : (di + 1) * b_l]
        if backend == "xla":
            block = block[:, mi * c.shape[1] : (mi + 1) * c.shape[1]]
        else:
            block = block[:, :, mi * c.shape[2] : (mi + 1) * c.shape[2]]
            c = c.view(np.uint32)
        assert np.array_equal(c, block), (spec, backend, r)
        assert np.array_equal(got[r][key + "hist"], jx["hist"])
        assert np.array_equal(got[r][key + "finals"], jx["finals"])
        assert np.array_equal(got[r][key + "margins"].view(np.int32),
                              jx["margins"].view(np.int32))
        assert np.array_equal(got[r][key + "rows"], jx["rows"])
    for r in (2, 3):  # the second independent mesh computed the same
        assert np.array_equal(got[r][key + "hist"], got[r - 2][key + "hist"])


def test_make_mesh_rules_and_rank_order(ranks):  # starts the ranks early
    """``(d, m)`` and the row-major rank order of JAX's ``make_mesh`` over
    the eight virtual devices; the same refusals (a mesh larger than the
    world); an empty spec is ``1 x world``; the plan of a run."""
    devices = jax.devices()
    assert len(devices) == 8
    for spec in ("1,8", "2,4", "4,2", "8,1", "1,1", "2,2", ""):
        jm = jax_mesh.make_mesh(spec, devices=devices)
        d, m = port_mesh.mesh_shape(spec, 8)
        assert (d, m) == (jm.shape["data"], jm.shape["model"])
        ids = np.vectorize(lambda x: x.id)(jm.devices)
        assert np.array_equal(port_mesh.mesh_grid(d, m, d * m)[0], ids)
    with pytest.raises(ValueError):
        jax_mesh.make_mesh("3,3", devices=devices)
    for bad in ("3,3", "x", "2", "0,2"):
        with pytest.raises(ValueError):
            port_mesh.mesh_shape(bad, 8)
    grid = port_mesh.mesh_grid(1, 2, 4)  # two independent meshes
    assert grid.tolist() == [[[0, 1]], [[2, 3]]]
    with pytest.raises(ValueError):
        port_mesh.mesh_grid(1, 2, 3)
    assert port_mesh.mesh_plan("", 1) is None
    assert port_mesh.mesh_plan("", 4) is None  # every rank on its own
    assert port_mesh.mesh_plan("", 4, global_mesh=True) == (1, 4)
    assert port_mesh.mesh_plan("2,2", 4, global_mesh=True) == (2, 2)
    assert port_mesh.mesh_plan("1,1", 2) == (1, 1)
    assert port_mesh.mesh_plan("1,1", 1, global_mesh=True) == (1, 1)
    with pytest.raises(ValueError, match="spans the world"):
        port_mesh.mesh_plan("1,1", 2, global_mesh=True)


def test_pad_to_multiple():
    rng = np.random.default_rng(0)
    for shape, mult, axis in (((10, 3), 8, 0), ((10, 3), 5, 0), ((4, 7), 4, 1)):
        x = rng.integers(0, 9, size=shape)
        want = jax_mesh.pad_to_multiple(x, mult, axis=axis)
        got = port_mesh.pad_to_multiple(x, mult, axis=axis)
        assert got.shape == want.shape and np.array_equal(got, want)
    mm = np.ones((8, 2)).view(np.memmap)  # a cache-loaded database's arrays
    assert type(port_mesh.pad_to_multiple(mm, 4)) is np.ndarray


def test_rank_stripes_equal_jax_shards(world):
    """``convert.shard_fields`` cuts what JAX's ``addressable_shards`` hold
    (the stream matrix at its block-padded width; JAX also pads its rows to
    ``ROW_BLOCK`` with zero rows, which the port does not make)."""
    db = world["db"]
    fields = database_fields(db)
    for spec in ("1,2", "2,2"):
        jm = jax_mesh.make_mesh(spec)
        d, m = port_mesh.mesh_shape(spec, 8)
        for backend in ("pallas", "stream", "xla"):
            pipe = jax_mesh.ShardedPipeline.create(db, jm, backend=backend)
            arr = pipe.ref_bits if backend == "xla" else pipe.kmer_bits
            for shard in arr.addressable_shards:
                rank = int(np.flatnonzero(jm.devices.reshape(-1) == shard.device)[0])
                part = shard_fields(fields, (d, m), rank, backend)
                want = np.asarray(shard.data)
                if backend == "stream":
                    assert not want[part["matrix"].shape[0]:].any()
                    want = want[: part["matrix"].shape[0]]
                assert np.array_equal(part["matrix"], want), (spec, backend, rank)
                assert part["n_padded"] == pipe.n_padded


@pytest.mark.parametrize("spec", ["1,2", "2,1"])
def test_xla_stages_equal_jax_at_tolerance_zero(world, ranks, spec, monkeypatch):
    got = ranks()
    for comp in COMPACTIONS:
        jx = _jax_stages(world, spec, "xla", comp, monkeypatch)
        _check_stages(got, jx, spec, "xla", comp, full_stages=comp == "split2")


def test_pallas_stages_equal_jax_interpret(world, ranks, monkeypatch):
    """The planes backends at ``1,2``: the port's K9 fold, K3, K4 and K6 on
    each stripe against JAX's ``pallas`` mesh in interpret mode, unit/wide
    split; the stream fold's stripes (wider, block-padded) hold the same
    planes wherever both have columns, and zeros beyond."""
    got = ranks()
    jx = _jax_stages(world, "1,2", "pallas", "split2", monkeypatch)
    _check_stages(got, jx, "1,2", "pallas", "split2", full_stages=True)
    stream = np.concatenate(
        [got[r]["1,2_stream_split2_counts"].view(np.uint32) for r in (0, 1)],
        axis=2,
    )
    S = jx["counts"].shape[2]
    assert np.array_equal(stream[:, :, :S], jx["counts"])
    assert not stream[:, :, S:].any()


def test_four_ranks_end_to_end_equal_oracle_and_jax_mesh(world, ranks):
    """``2,2``: every backend of the port's mesh engine gives the oracle's
    lines, and the JAX engine on ``make_mesh("2,2")`` the same, for the
    plain, skip-exact and raw runs."""
    from raxtax_tpu.engine.device import DeviceClassifier as JaxClassifier
    from raxtax_tpu_torch.models.oracle import OracleClassifier
    from tests.test_torch_common import port_db

    got = ranks()[0]
    db, queries = world["db"], world["queries"]
    for skip, raw in FLAGS:
        orc = OracleClassifier(port_db(db), skip_exact_matches=skip,
                               raw_confidence=raw)
        want = [orc.classify(l, s).out_string() for l, s in queries]
        jdev = JaxClassifier.create(
            db, backend="xla", batch_size=4, mesh=jax_mesh.make_mesh("2,2"),
            skip_exact_matches=skip, raw_confidence=raw)
        jgot = []
        for lo in range(0, len(queries), 4):
            jgot += jdev.classify_batch(queries[lo : lo + 4])
        assert [g.out_string() for g in jgot] == want
        for fold in ("dense", "gathered", "stream"):
            assert got[f"e2e_{fold}_{int(skip)}{int(raw)}"].tolist() == want, fold


def test_mesh_1_1_in_process_equals_the_single_device_dd_engine(world):
    """``--mesh 1,1`` on one process: a world of one rank (gloo on the CPU)
    and the sharded pipeline, byte-equal to the single-device double-f32
    engine on each backend."""
    from raxtax_tpu_torch.engine.device import DeviceClassifier
    from raxtax_tpu_torch.parallel.multihost import shutdown
    from tests.test_torch_common import port_db

    db = port_db(world["db"])
    queries = world["queries"]
    try:
        mesh = port_mesh.make_mesh("1,1", device="cpu")
        assert mesh.shape == {"data": 1, "model": 1} and mesh.backend == "gloo"
        for counts, fold in (("dense", "dense"), ("planes", "gathered"),
                             ("planes", "stream")):
            outs = []
            for m in (mesh, None):
                dev = DeviceClassifier.create(
                    db, device="cpu", batch_size=4, counts=counts, fold=fold,
                    significance="dd", mesh=m)
                assert (dev.pipeline is not None) == (m is not None)
                res = []
                for lo in range(0, len(queries), 4):
                    res += dev.classify_batch(queries[lo : lo + 4])
                outs.append([(r.out_string(), r.tsv_string()) for r in res])
            assert outs[0] == outs[1], fold
    finally:
        shutdown()


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
