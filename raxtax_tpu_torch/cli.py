"""Command-line interface.

Flag-compatible with the reference CLI (reference: src/io.rs:112-154,
src/main.rs:14-173), plus ``--backend``, ``--batch-size``, ``--device`` and
the JAX package's mesh and multi-process flags.
Same output artifacts (`raxtax.out`, `raxtax.tsv`, `raxtax.log`,
`raxtax.ckp`, `raxtax.json`), same checkpoint / resume semantics, same
BSD-style exit codes. Runs on the GPU unless ``--device cpu`` is given.

The engine's mode is chosen by the JAX package's own environment names, read
here and nowhere else in the package (:func:`engine_mode_from_env`):
``RAXTAX_EXACT`` (``1`` exact f64, ``0`` double-f32, ``auto`` double-f32 until
host replays become dense), ``RAXTAX_SPARSE_FOLD`` (``1`` block-sparse fold),
``RAXTAX_FUSED_GATHER`` (``0``, with the sparse fold off: gather the rows,
then fold them), ``RAXTAX_BM_SCAN`` (``1`` bit-major scan),
``RAXTAX_SPLIT2`` (``0`` or empty: no unit/wide split on the planes backends;
unset means on, as in the JAX package) and ``RAXTAX_SPLIT_SIG`` (``1``: the
single-tip split, taken by the ``xla`` backend and, where the unit/wide split
does not run, by the planes backends). Unset, they leave the port's defaults:
exact significance, dense fold, unit/wide split.

``--backend`` picks how counts are made: ``auto`` and ``pallas`` fold counter
planes (the fold named by the environment), ``stream`` folds them from
row-sorted pairs, ``xla`` builds a dense count matrix from the ref-major
matrix (double-f32 significance only), ``oracle`` runs on the host.

``--descent device`` accepts the double-f32 paths' on-device descents
without proof; ``--trace DIR`` writes a ``torch.profiler`` trace of the
classification phase into ``DIR`` (TensorBoard / Perfetto JSON).

``--mesh D,M`` shards the database over a mesh of ranks
(``parallel/mesh.py``); ``--coordinator host:port`` with
``--num-processes``/``--process-id`` (or the JAX package's
``JAX_COORDINATOR_ADDRESS``/``JAX_NUM_PROCESSES``/``JAX_PROCESS_ID``, or
``torchrun``'s environment) joins a world of processes, one device each
(``parallel/multihost.py``). Without ``--global-mesh`` each group of ``D*M``
ranks (one rank without ``--mesh``) classifies its own slice of the queries
into ``raxtax.*.shard<g>`` files, folded into the single-file artifacts at
the end; ``--global-mesh`` makes one mesh of the whole world, every rank
feeds the same batches and rank 0 writes. A mesh that does not fit the world
is a usage error (exit 2), found before any rank starts. Only rank 0 writes
the binary database.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

from .utils import errors
from .utils.logging import (
    info_stderr,
    phase_timer,
    report_error,
    setup_logging,
    verbosity_to_level,
)


def build_arg_parser() -> argparse.ArgumentParser:
    from . import __version__

    p = argparse.ArgumentParser(
        prog="raxtax-torch",
        description=(
            "k-mer based non-Bayesian taxonomic classifier on one NVIDIA "
            "GPU (capability-compatible with raxtax)"
        ),
    )
    # clap `#[command(version)]` equivalent (reference: src/io.rs:113)
    p.add_argument(
        "--version", action="version", version=f"%(prog)s {__version__}"
    )
    p.add_argument(
        "-d", "--database-path", required=True, type=Path,
        help="Path to the database fasta or binary (.rxdb) file",
    )
    p.add_argument(
        "-i", "--query-file", type=Path, default=None,
        help="Path to the query file",
    )
    p.add_argument(
        "--skip-exact-matches", action="store_true",
        help="If used for mislabeling analysis, skip exact sequence matches",
    )
    p.add_argument(
        "--tsv", action="store_true",
        help="Output primary result file in tsv format",
    )
    p.add_argument(
        "--only-db", action="store_true",
        help="Create binary database and exit",
    )
    p.add_argument(
        "--skip-db", action="store_true",
        help="Don't create the binary database for the reference sequences",
    )
    p.add_argument(
        "-c", "--clean", action="store_true",
        help="Remove binary database and checkpoint files after a successful run",
    )
    p.add_argument(
        "--raw-confidence", action="store_true",
        help="Don't adjust confidence values for 1 exact match",
    )
    p.add_argument(
        "-t", "--threads", type=int, default=0,
        help="Number of host threads (0 = all available)",
    )
    p.add_argument(
        "-o", "--prefix", type=Path, default=Path("raxtax"),
        help="Output prefix",
    )
    p.add_argument(
        "--redo", action="store_true",
        help="Force override of existing output files",
    )
    p.add_argument(
        "--pin", action="store_true",
        help="Thread pinning (no-op; kept for CLI compatibility)",
    )
    p.add_argument("-v", "--verbose", action="count", default=0)
    p.add_argument("-q", "--quiet", action="count", default=0)
    # --- extensions ---
    p.add_argument(
        "--backend", choices=["auto", "oracle", "xla", "pallas", "stream"],
        default="auto",
        help="Compute backend: auto or pallas (the device engine folding "
        "counter planes with its CUDA kernels), stream (the same with the "
        "stream fold), xla (dense counts from the ref-major matrix by a "
        "matrix product), oracle (host numpy, exact f64; slow)",
    )
    p.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="Where the device engine runs: cuda (default; fails without a "
        "GPU) or cpu (plain PyTorch versions of the kernels; for testing)",
    )
    p.add_argument(
        "--batch-size", type=int, default=0,
        help="Query batch size per device step (0 = auto)",
    )
    p.add_argument(
        "--debug-checks", action="store_true",
        help="Validate device-stage invariants every batch (histogram "
        "mass, k-mer bounds, confidence ranges); mirrors the reference's "
        "debug asserts. Off by default: zero overhead",
    )
    p.add_argument(
        "--descent", choices=["exact", "device"], default="exact",
        help="Fallback-descent mode of the double-f32 paths: exact (proved "
        "on the device or replayed on the host in f64, bit-faithful to the "
        "reference) or device (the device's f32 descent as it ends; exact "
        "ties can resolve differently)",
    )
    p.add_argument(
        "--trace", type=Path, default=None, metavar="DIR",
        help="Write a torch.profiler trace of the classification phase to "
        "DIR (view with TensorBoard / Perfetto)",
    )
    p.add_argument(
        "--mesh", type=str, default="",
        help="Mesh of ranks as 'data,model' sizes, e.g. '2,4' (one device "
        "per rank; default: no mesh, or all ranks on the model axis with "
        "--global-mesh)",
    )
    # --- multi-process (torch.distributed) ---
    p.add_argument(
        "--coordinator", type=str, default="",
        help="Address host:port where the ranks meet (multi-process runs; "
        "also honors JAX_COORDINATOR_ADDRESS and torchrun's MASTER_ADDR)",
    )
    p.add_argument("--num-processes", type=int, default=0)
    p.add_argument("--process-id", type=int, default=-1)
    p.add_argument(
        "--global-mesh", action="store_true",
        help="Span one ('data','model') mesh across every rank instead of "
        "independent per-group meshes: the database is model-sharded "
        "across processes (for databases larger than one device); every "
        "rank feeds identical batches, rank 0 writes the output",
    )
    return p


def engine_mode_from_env(environ=None) -> dict:
    """The engine's mode arguments from the JAX package's environment names,
    with the port's defaults where a name is unset or empty."""
    env = os.environ if environ is None else environ
    exact = env.get("RAXTAX_EXACT", "")
    if exact not in ("", "0", "1", "auto"):
        raise ValueError(f"RAXTAX_EXACT must be 0, 1 or auto, not {exact!r}")
    if env.get("RAXTAX_SPARSE_FOLD", "") not in ("", "0"):
        fold = "sparse"
    elif env.get("RAXTAX_FUSED_GATHER", "") == "0":
        # the JAX package's row gather followed by the fold of gathered rows
        # (there also what an unset name means; here unset keeps K1)
        fold = "gathered"
    else:
        fold = "dense"
    return {
        "significance": {"": "exact", "1": "exact", "0": "dd", "auto": "auto"}[exact],
        "fold": fold,
        "bm_scan": env.get("RAXTAX_BM_SCAN", "") not in ("", "0"),
        # the JAX engine's own reading: unset is on, empty or 0 is off
        "split2": env.get("RAXTAX_SPLIT2", "1") not in ("", "0"),
        "split_sig": env.get("RAXTAX_SPLIT_SIG", "") not in ("", "0"),
    }


def cache_layout(backend: str, only_db: bool, bm_scan: bool,
                 significance: str, mesh: str = "",
                 processes: int = 1) -> tuple[str, bool, str]:
    """``(backend, with_ref_major, kmer_layout)`` of the database a run
    builds from FASTA: the JAX CLI's choice (``raxtax_tpu/cli.py:232-254``),
    so both packages write the same cache for the same flags. A classify
    run's ``auto`` is ``pallas``, as the JAX CLI resolves it on its
    accelerator; ``--only-db`` keeps ``auto``, whose
    future consumer is unknown. Only ``auto`` and ``xla`` keep the
    ``[N, 2048]`` ref-major matrix. The planes backends (``pallas``,
    ``stream``) fold the flat postings layout at scale (``auto``: packed for
    tiny databases) when they run on one device: with ``--mesh`` or several
    processes, whose shards slice contiguous reference columns, the layout
    is ``packed`` (one device per process here, where the JAX CLI also asks
    for one local device). Every other run builds ``packed``, and so does
    the double-f32 bit-major scan, which reads only that layout."""
    if backend == "auto" and not only_db:
        backend = "pallas"
    with_ref_major = backend in ("auto", "xla")
    if bm_scan and significance != "exact":
        layout = "packed"
    elif backend in ("pallas", "stream") and not mesh and processes == 1:
        layout = "auto"
    else:
        layout = "packed"
    return backend, with_ref_major, layout


def main(argv: list[str] | None = None) -> int:
    parser = build_arg_parser()
    args = parser.parse_args(argv)
    if args.only_db and args.skip_db:
        # clap `conflicts_with` usage error, exit code 2 (src/io.rs:128-129)
        parser.error("--only-db cannot be used with --skip-db")
    if (args.num_processes or args.process_id >= 0) and not (
        args.coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    ):
        # without a coordinator both processes would run as 0-of-1 and
        # clobber each other's unsharded output files
        parser.error(
            "--num-processes/--process-id require --coordinator "
            "(or JAX_COORDINATOR_ADDRESS)"
        )
    from .parallel.mesh import mesh_plan
    from .parallel.multihost import world_config

    try:
        vars(args).update(engine_mode_from_env())
        # the world and its meshes, checked before any rank starts
        world = world_config(args.coordinator, args.num_processes, args.process_id)
        plan = mesh_plan(
            args.mesh, world.world_size if world else 1, args.global_mesh
        )
    except ValueError as e:
        parser.error(str(e))
    if args.backend != "oracle" and not args.only_db:
        # raises without a GPU unless --device cpu was asked for, before any
        # output file exists
        from .utils.device import resolve_device

        resolve_device(args.device)
    if args.query_file is None and not args.only_db:
        print(
            "error: the following arguments are required: -i/--query-file "
            "(unless --only-db)",
            file=sys.stderr,
        )
        return errors.CANTCREAT

    from .parallel import multihost

    try:
        return _run(args, plan)
    finally:
        multihost.shutdown()


def _run(args, plan) -> int:
    """The run after the checks: join the world, then the reference's
    stages, each rank on its group's share."""
    from .io.buildinfo import write_build_info
    from .io.outputs import OutputError, ResultWriter, get_output
    from .parallel.multihost import (
        barrier,
        consolidate_artifacts,
        host_query_slice,
        maybe_initialize,
        shard_suffix,
    )

    on_device = args.backend != "oracle" and not args.only_db
    rank, world = maybe_initialize(
        args.coordinator, args.num_processes, args.process_id,
        device=args.device if on_device else "cpu",
    )
    # a group of k ranks is one JAX process: its own query slice and shard
    # files without --global-mesh; the one group of the world with it
    k = plan[0] * plan[1] if plan else 1
    group, n_groups = rank // k, world // k
    global_mesh = args.global_mesh and world > 1
    args._read_only_output = rank % k > 0
    args._shard_suffix = shard_suffix(group, n_groups)

    # Resuming across a different process count: fold any stale shard
    # artifacts into the merged single-file set before opening this run's
    # writers, so completed work is never redone or clobbered. Rank 0
    # consolidates; the others wait at the (unconditional) barrier.
    prefix = Path(args.prefix)
    if world > 1:
        if rank == 0 and not args.redo and prefix.is_dir():
            consolidate_artifacts(prefix)
        barrier("raxtax-consolidate")
    elif not args.redo and prefix.is_dir():
        consolidate_artifacts(prefix)

    try:
        writers, checkpoint = get_output(args)
    except (OutputError, OSError) as e:
        print(f"\x1b[31m[ERROR]\x1b[0m {e}", file=sys.stderr)
        return errors.CANTCREAT
    write_build_info(writers.log)
    level = verbosity_to_level(args.verbose, args.quiet)
    setup_logging(writers.log, level)
    if args.pin:
        info_stderr(
            "--pin has no effect: device placement replaces host thread "
            "pinning",
            level,
        )

    from .db.database import load_or_parse_database, save_database
    from .io.checkpoint import FileFingerprint

    with phase_timer("Total Runtime"):
        # Parse reference database (binary fast path via the checkpointed
        # path, src/main.rs:61)
        db_path = Path(checkpoint.db_fingerprint.path)
        backend, want_ref_major, want_layout = cache_layout(
            args.backend, args.only_db, args.bm_scan, args.significance,
            mesh=args.mesh, processes=world,
        )
        try:
            with phase_timer("Parsing References"):
                parsed_from_fasta, db = load_or_parse_database(
                    db_path, threads=args.threads,
                    with_ref_major=want_ref_major,
                    kmer_layout=want_layout,
                )
        except Exception as e:
            report_error(f"Failed to parse {db_path}", e)
            return errors.NOINPUT
        if parsed_from_fasta and not want_ref_major:
            writers.log.write(
                "[INFO ] Skipped the ref-major bit matrix (backend "
                f"{backend} never reads it)\n"
            )
        checkpoint.db_variant = (
            "full" if db.ref_major is not None else "km-only"
        )

        # rank 0 alone writes the binary database: every rank parsed the
        # same FASTA, and concurrent writers of one file would race
        if parsed_from_fasta and not args.skip_db and rank == 0:
            bin_path = (Path(args.prefix) / db_path.name).with_suffix(".bin.rxdb")
            if bin_path.is_file() and not args.redo:
                report_error(
                    "Could not create database! Rerun with --skip-db to skip "
                    "this step.",
                    f"Output database file {bin_path} already exists! Delete "
                    "it or run with --redo to force overriding existing files!",
                )
                return errors.CANTCREAT
            try:
                # stderr info mirror (reference: src/tree.rs:148-150)
                info_stderr("Writing database to file...", level)
                save_database(db, bin_path)
                writers.log.write(
                    f"[INFO ] Created binary database at {bin_path}\n"
                )
                checkpoint.db_fingerprint = FileFingerprint.of(bin_path)
                checkpoint.save()
            except OSError as e:
                report_error("Failed to write database", e)
                return errors.IOERR
        else:
            try:
                checkpoint.save()
            except OSError as e:
                report_error("Failed to write checkpoint! Continuing without...", e)

        if args.only_db:
            return errors.OK

        from .io.fasta import parse_query_fasta_file

        try:
            with phase_timer("Parsing Queries"):
                # several ranks: slice by GLOBAL query index first, then
                # drop the processed queries — filtering first would move
                # queries between groups on a partial resume
                queries = parse_query_fasta_file(
                    args.query_file,
                    None if world > 1 else checkpoint.processed_queries,
                )
        except Exception as e:
            report_error(f"Failed to parse {args.query_file}", e)
            return errors.NOINPUT
        if world > 1:
            done = checkpoint.processed_queries
            if k > 1:
                # a mesh's ranks run one batch loop: all take the processed
                # baseline of its writer (the group's first rank)
                done = _group_baseline(done if rank % k == 0 else None, k, rank)
            if not global_mesh:
                lo, hi = host_query_slice(len(queries), group, n_groups)
                queries = queries[lo:hi]
            queries = [(l, s) for l, s in queries if l not in done]

        from .engine.classify import run_queries

        writer = ResultWriter(writers)
        try:
            if args.trace is not None:
                from .engine.classify import make_classifier
                from .utils.trace import classification_trace

                with classification_trace(args.trace, args.device) as counters:
                    clf = make_classifier(db, args, n_queries_hint=len(queries))
                    run_queries(db, queries, args, writer, classifier=clf)
                    counters.update(getattr(clf, "counters", {}))
            else:
                run_queries(db, queries, args, writer)
        except Exception as e:
            writer.join()
            report_error(
                "Error while classifying queries!\n"
                "Rerun raxtax-torch to continue from the last checkpoint.", e
            )
            return errors.TEMPFAIL
        if world > 1 or plan is not None:
            writers.log.write(_rank_report(rank, world, plan, args.device))
        try:
            writer.join()
        except Exception as e:
            report_error(
                "IO-thread could not be joined. Check if results are complete!", e
            )
            return errors.IOERR

        if args.clean:
            with phase_timer("Checkpoint Cleanup"):
                try:
                    info_stderr("Removing checkpoint files...", level)
                    checkpoint.cleanup()
                except OSError as e:
                    report_error(
                        "Removing checkpoint files failed! "
                        "Please delete them manually.", e
                    )
    writers.close()
    if world > 1:
        # every rank has flushed and closed its shards; rank 0 folds them
        # into the reference's single-file artifacts (checkpoint and
        # progress included, so a resume under any rank count is coherent)
        barrier("raxtax-output-shards")
        if rank == 0:
            consolidate_artifacts(prefix)
    return errors.OK


def _rank_report(rank: int, world: int, plan, device: str) -> str:
    """The log line of a multi-rank or mesh run: this rank's peak device
    memory (on a GPU) and, on a mesh, the CUDA tensors its collectives
    copied through host memory (gloo)."""
    import torch

    parts = []
    if device == "cuda":
        parts.append(f"peak device memory {torch.cuda.max_memory_allocated()} bytes")
    if plan is not None:
        from .parallel.mesh import COUNTERS

        parts.append(
            f"mesh collectives copied {COUNTERS['host_copies']} CUDA tensors "
            "through host memory"
        )
    from .parallel.multihost import backend

    return (f"[INFO ] rank {rank} of {world} ({backend() or 'no world'}): "
            f"{'; '.join(parts) or 'done'}\n")


def _group_baseline(done: set | None, k: int, rank: int) -> set:
    """The processed set of this rank's group writer (rank ``k *
    (rank // k)``), gathered from every rank's contribution."""
    import torch.distributed as dist

    from .parallel.multihost import host_group

    sets = [None] * dist.get_world_size()
    dist.all_gather_object(sets, done, group=host_group())
    return sets[k * (rank // k)]


if __name__ == "__main__":
    sys.exit(main())
