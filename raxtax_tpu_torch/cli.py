"""Command-line interface.

Flag-compatible with the reference CLI (reference: src/io.rs:112-154,
src/main.rs:14-173), plus ``--backend``, ``--batch-size`` and ``--device``.
Same output artifacts (`raxtax.out`, `raxtax.tsv`, `raxtax.log`,
`raxtax.ckp`, `raxtax.json`), same checkpoint / resume semantics, same
BSD-style exit codes. Runs on the GPU unless ``--device cpu`` is given.

Flags of the JAX package whose code paths are not ported yet (meshes,
multi-process runs, the xla/stream backends, the on-device f32 descent,
profiler traces) are still parsed, and exit with a "not yet ported" error
rather than silently running a single-device job.
"""

from __future__ import annotations

import argparse
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
        help="Compute backend: auto (the device engine with its CUDA "
        "kernels), oracle (host numpy, exact f64; slow). xla, pallas and "
        "stream name backends of the JAX package that are not ported yet",
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
    # --- parsed, not ported yet (see NOT_PORTED) ---
    p.add_argument("--mesh", type=str, default="", help="not ported yet")
    p.add_argument(
        "--descent", choices=["exact", "device"], default="exact",
        help="exact (default); device is not ported yet",
    )
    p.add_argument(
        "--trace", type=Path, default=None, metavar="DIR",
        help="not ported yet",
    )
    p.add_argument("--coordinator", type=str, default="", help="not ported yet")
    p.add_argument("--num-processes", type=int, default=0, help="not ported yet")
    p.add_argument("--process-id", type=int, default=-1, help="not ported yet")
    p.add_argument("--global-mesh", action="store_true", help="not ported yet")
    return p


def not_ported(args) -> str | None:
    """The first requested option whose code path is not ported yet."""
    checks = [
        (bool(args.mesh), "--mesh"),
        (bool(args.coordinator), "--coordinator"),
        (bool(args.num_processes), "--num-processes"),
        (args.process_id >= 0, "--process-id"),
        (args.global_mesh, "--global-mesh"),
        (args.backend in ("xla", "pallas", "stream"),
         f"--backend {args.backend}"),
        (args.descent == "device", "--descent device"),
        (args.trace is not None, "--trace"),
    ]
    for hit, name in checks:
        if hit:
            return name
    return None


def main(argv: list[str] | None = None) -> int:
    parser = build_arg_parser()
    args = parser.parse_args(argv)
    if args.only_db and args.skip_db:
        # clap `conflicts_with` usage error, exit code 2 (src/io.rs:128-129)
        parser.error("--only-db cannot be used with --skip-db")
    missing = not_ported(args)
    if missing is not None:
        print(
            f"error: {missing} is not yet ported to the PyTorch/CUDA "
            "package; run without it (single device) or use the JAX package",
            file=sys.stderr,
        )
        return errors.UNAVAILABLE
    if args.backend == "auto" and not args.only_db:
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

    from .io.buildinfo import write_build_info
    from .io.outputs import OutputError, ResultWriter, get_output

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
        # No ported path reads the [N, 2048] ref-major matrix, so a FASTA
        # parse never builds it (a binary DB loads whatever it contains).
        # `--only-db` keeps it: the future consumer's backend is unknown.
        backend = args.backend
        want_ref_major = args.only_db
        # flat postings at scale (the bit-major planes are then tip order),
        # packed for tiny databases
        want_layout = "auto"
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

        if parsed_from_fasta and not args.skip_db:
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
                queries = parse_query_fasta_file(
                    args.query_file, checkpoint.processed_queries
                )
        except Exception as e:
            report_error(f"Failed to parse {args.query_file}", e)
            return errors.NOINPUT

        from .engine.classify import run_queries

        writer = ResultWriter(writers)
        try:
            run_queries(db, queries, args, writer)
        except Exception as e:
            writer.join()
            report_error(
                "Error while classifying queries!\n"
                "Rerun raxtax-torch to continue from the last checkpoint.", e
            )
            return errors.TEMPFAIL
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
    return errors.OK


if __name__ == "__main__":
    sys.exit(main())
