"""The graft entry points, on the port: the counterpart of the root
``__graft_entry__.py`` of the JAX package.

    python -m raxtax_tpu_torch.tools.dryrun [--devices N] [--device cpu]

- :func:`entry` returns the classifier's scoring step (dense intersection
  counts -> histogram -> per-size probability gather -> node confidences ->
  top-64 significance) and its example arguments on a tiny world, for a
  single-device check. The step can be handed to ``torch.compile`` (the
  counterpart of ``jax.jit``).
- :func:`dryrun_multichip` classifies one batch on an ``n``-rank
  ('data', 'model') mesh under each backend. The port's unit of a mesh is a
  rank (``parallel/launch.py``): the ranks are ``n`` local processes, which
  share one GPU over gloo where there are fewer GPUs than ranks.
- :func:`dryrun_multiprocess` runs ``n`` processes of the command line on
  one global mesh (``--global-mesh``) over a coordinator.

Each prints the JAX package's line letter for letter and holds its outputs
byte-equal to a single-device (single-process) run of the port on the same
inputs. ``main`` runs the three in turn; any failure exits non-zero. Every
entry point runs on the GPU unless ``device="cpu"`` (``--device cpu``) is
passed, and raises without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import resolve_device

REPO = Path(__file__).resolve().parents[2]
#: the step's histogram width and the significant entries it keeps
S_MAX, TOP_K = 256, 64
BACKENDS = ("xla", "pallas", "stream")


def tiny_world(num_refs: int = 64, seed: int = 0):
    """The JAX package's ``_tiny_world``: the same draws and lineages, built
    by the port's ``build_database`` (the same database)."""
    from ..db.database import build_database
    from ..utils.encoding import encode_sequence

    rng = np.random.default_rng(seed)
    bases = "ACGT"
    lineages, seqs = [], []
    for i in range(num_refs):
        lineages.append(f"p:P{i % 3},f:F{i % 9},s:S{i}")
        seqs.append("".join(bases[b] for b in rng.integers(0, 4, size=160)))
    return build_database(lineages, [encode_sequence(s) for s in seqs])


def top_k_stable(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the ``k`` largest values,
    descending, the lower index first among equal values (a stable sort;
    ``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def entry(device=None):
    """``(fn, example_args)``: the scoring step and its arguments on the
    tiny world (8 of its own sequences as queries; a table holding
    ``1 / num_tips`` up to each query's k-mer count), on ``device``."""
    from ..db.bitmatrix import pack_query_kmers
    from ..ops.histogram import intersection_histogram
    from ..ops.intersect_xla import intersection_counts_xla
    from ..ops.nodeconf import SIG_THRESHOLD
    from ..utils.encoding import sequence_to_kmers

    dev = resolve_device(device)
    db = tiny_world()
    tax = db.taxonomy
    eval_ids = tax.eval_ids
    batch = 8
    kmer_sets = [sequence_to_kmers(db.sequence(i)) for i in range(batch)]
    table = np.zeros((batch, S_MAX), dtype=np.float32)
    for b, km in enumerate(kmer_sets):
        table[b, : km.size + 1] = 1.0 / db.num_tips

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    node_starts = on_dev(tax.range_start[eval_ids].astype(np.int64))
    node_ends = on_dev(tax.range_end[eval_ids].astype(np.int64))

    def forward(query_bits, ref_bits, table):
        counts = intersection_counts_xla(query_bits, ref_bits)
        hist = intersection_histogram(counts, S_MAX)
        probs = torch.gather(table, 1, counts.long())
        cum0 = F.pad(torch.cumsum(probs, dim=1), (1, 0))
        conf = cum0[:, node_ends] - cum0[:, node_starts]
        vals, idx = top_k_stable(
            torch.where(conf >= SIG_THRESHOLD, conf, -1.0), TOP_K)
        return hist, vals, idx

    # the port's bit matrices are int32 bit patterns
    example_args = (
        on_dev(pack_query_kmers(kmer_sets).view(np.int32)),
        on_dev(db.ref_major.view(np.int32)),
        on_dev(table),
    )
    return forward, example_args


def _prepare_ranks(dev: torch.device) -> None:
    """Build what every rank loads once, here, before the ranks start: the
    native host library and, on the GPU, the kernels."""
    from .. import native

    native.get_lib()
    if dev.type == "cuda":
        from ..ops import _build

        _build.build_all()


def mesh_rank(device: str, out: str) -> None:
    """One rank of :func:`dryrun_multichip` (started by
    ``parallel/launch.py``). Rank 0 writes its results to ``out`` as JSON:
    the OK lines, each backend's output lines and kernel launches on the
    mesh and its lines on a single device, its peak device bytes and the
    world's backend."""
    from ..engine.classify import make_classifier
    from ..ops._build import kernel_wrappers
    from ..parallel import multihost
    from ..parallel.mesh import make_mesh

    rank, world = multihost.maybe_initialize(device=device)
    dev = multihost.rank_device(device)
    data = 2 if world % 2 == 0 and world >= 2 else 1
    mesh = make_mesh(f"{data},{world // data}", device=device)
    db = tiny_world()
    wrappers = kernel_wrappers()
    res = {"world_backend": mesh.backend, "lines": [], "mesh": {},
           "launches": {}, "single": {}}

    def args_for(backend: str):
        return SimpleNamespace(
            backend=backend, batch_size=2 * data, device=device,
            skip_exact_matches=False, raw_confidence=False)

    for backend in BACKENDS:
        for fn in wrappers.values():
            fn.launches = 0
        clf = make_classifier(db, args_for(backend), mesh=mesh)
        queries = [(f"q{i}", db.sequence(i)) for i in range(clf.batch_size)]
        results = clf.classify_batch(queries)
        if len(results) != clf.batch_size:
            raise AssertionError(f"{backend}: {len(results)} results")
        texts = [r.out_string() for r in results]
        if not all(t.strip() for t in texts):
            raise AssertionError(f"{backend}: an empty output line")
        line = (f"dryrun_multichip OK: backend={backend} mesh={mesh.shape},"
                f" {len(results)} queries classified")
        if rank == 0:
            print(line, flush=True)
        res["lines"].append(line)
        res["mesh"][backend] = texts
        res["launches"][backend] = {
            k: int(fn.launches) for k, fn in wrappers.items() if fn.launches}
    res["peak_device_bytes"] = (
        int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda"
        else None)
    multihost.shutdown()
    if rank != 0:
        return
    for backend in BACKENDS:
        # the same queries on one device: no world, no mesh
        clf = make_classifier(db, args_for(backend))
        res["single"][backend] = [
            r.out_string() for r in clf.classify_batch(queries)]
    Path(out).write_text(json.dumps(res))


def dryrun_multichip(n_devices: int, device=None, timeout: float = 600.0,
                     log=print) -> dict:
    """One classification batch on an ``n_devices``-rank mesh
    (``2 x n/2`` when ``n`` is even, else ``1 x n``) under ``xla``,
    ``pallas`` and ``stream``, each rank a process. Logs rank 0's three OK
    lines and returns its results (see :func:`mesh_rank`), with ``ranks``.
    Raises ``AssertionError`` when a rank fails, a run outlasts
    ``timeout`` seconds or the mesh's lines differ from the single
    device's."""
    from ..parallel.launch import launch

    dev = resolve_device(device)
    _prepare_ranks(dev)
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "rank0.json"
        code = ("from raxtax_tpu_torch.tools.dryrun import mesh_rank; "
                f"mesh_rank({dev.type!r}, {str(out)!r})")
        codes, logs = launch(
            n_devices, ["-c", code],
            env=dict(os.environ, PYTHONPATH=str(REPO)),
            timeout=timeout, cwd=str(REPO))
        if codes != [0] * n_devices:
            raise AssertionError(
                f"dryrun_multichip: exit codes {codes}\n" + "\n".join(
                    f"--- rank {r} ---\n{text[-3000:]}"
                    for r, text in enumerate(logs)))
        res = json.loads(out.read_text())
    for backend in BACKENDS:
        if res["mesh"][backend] != res["single"][backend]:
            raise AssertionError(
                f"dryrun_multichip {backend}: the mesh's lines differ from "
                "one device's")
    for line in res["lines"]:
        log(line)
    return {"ranks": n_devices, **res}


#: the multi-process dry run's references (and queries): 8 records of one
#: sequence, in two phyla
MULTIPROCESS_FASTA = "".join(
    f">r{i};tax=p:P{i % 2},f:F{i % 4},s:S{i};\n"
    "ACGTACGTACGTACGTACGTACGTACGTACGT\n"
    for i in range(8)
)


def dryrun_multiprocess(n_processes: int = 2, device=None,
                        timeout: float = 600.0, log=print) -> dict:
    """``n_processes`` processes of the command line joined into one global
    ('data', 'model') mesh ``1 x n`` over a coordinator (the database
    model-sharded across them), beside one process on the same inputs.
    Every exit code must be 0 and the mesh's ``raxtax.out`` (8 lines or
    more) byte-equal to the single process's; on failure each process's log
    tail is printed and ``AssertionError`` raised. Returns the line count
    and the mesh's ``raxtax.out``."""
    from ..parallel.launch import free_port, run_all

    dev = resolve_device(device)
    _prepare_ranks(dev)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    with tempfile.TemporaryDirectory() as td:
        ref = Path(td) / "refs.fasta"
        ref.write_text(MULTIPROCESS_FASTA)
        out, single = Path(td) / "out", Path(td) / "single"
        common = ["-d", str(ref), "-i", str(ref), "--redo", "--backend", "xla",
                  "--batch-size", "4"]
        if dev.type == "cpu":
            common += ["--device", "cpu"]

        def cli(argv):
            return [sys.executable, "-c",
                    "import sys; from raxtax_tpu_torch.cli import main; "
                    f"sys.exit(main({argv!r}))"]

        cmds = [cli(common + [
            "-o", str(out), "--coordinator", f"127.0.0.1:{port}",
            "--num-processes", str(n_processes), "--process-id", str(pid),
            "--global-mesh", "--mesh", f"1,{n_processes}"])
            for pid in range(n_processes)]
        cmds.append(cli(common + ["-o", str(single)]))
        codes, logs = run_all(cmds, [env] * len(cmds), timeout=timeout,
                              cwd=str(REPO))
        names = [f"process {pid}" for pid in range(n_processes)] + ["single"]
        if codes != [0] * len(cmds):
            for name, text in zip(names, logs):
                log(f"--- {name} ---")
                log(text[-2000:])
            raise AssertionError(f"dryrun_multiprocess: exit codes {codes}")
        got = (out / "raxtax.out").read_bytes()
        lines = got.decode().strip().split("\n")
        if len(lines) < 8:
            raise AssertionError(f"dryrun_multiprocess: {len(lines)} lines")
        if got != (single / "raxtax.out").read_bytes():
            raise AssertionError(
                "dryrun_multiprocess: raxtax.out differs from one process's")
    log(f"dryrun_multiprocess OK: {n_processes} processes, one global "
        "mesh, database model-sharded across processes")
    return {"processes": n_processes, "lines": len(lines),
            "equal_to_single": True, "out": got.decode()}


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtypes, shapes and bytes (on the host)."""
    a, b = a.detach().cpu().contiguous(), b.detach().cpu().contiguous()
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.view(torch.uint8), b.view(torch.uint8)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=None,
                    help="ranks of the mesh dry run (default: the GPUs, or "
                         "1 with --device cpu)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    a = ap.parse_args(argv)
    resolve_device(a.device)
    fn, args = entry(a.device)
    eager = fn(*args)
    compiled = torch.compile(fn)(*args)
    if not all(same_bits(x, y) for x, y in zip(eager, compiled)):
        raise AssertionError("entry: the compiled step differs from eager")
    print("entry OK:", [tuple(o.shape) for o in eager], flush=True)
    n = a.devices or (torch.cuda.device_count() if a.device == "cuda" else 1)
    dryrun_multichip(n, a.device)
    dryrun_multiprocess(2, a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
