"""Database-size sweep: wall time and peak host RSS of whole CLI runs.

    python -m raxtax_tpu_torch.tools.runtime_memory INPUT_FASTA
        [--sizes 50000 100000 200000 500000 1000000] [--reps 3]
        [--out runtime_memory.csv] [--backend auto] [--device cuda]
        [--reuse-db] [--with-sintax] [--with-rust]

The counterpart of the JAX package's ``scripts/runtime_memory.py`` (the
reference harness's protocol): per size, sample that many records from the
FASTA, split them 90/10 into references and queries, and run
``python -m raxtax_tpu_torch.cli -d refs -i queries -o out --redo`` end to end
(database build, classification, output files) while polling its peak RSS,
``--reps`` times. ``classify_s`` is the run's own ``raxtax`` phase, read from
the ``took … ms`` lines of its ``raxtax.log``, and ``qps_steady`` the queries
over it. ``--reuse-db`` samples once per size and points later reps at the
binary database of rep 0 (``db_mode`` says which rows rebuilt it). Writes the
CSV after every row, prints each row, and exits 1 if a run failed.
"""

from __future__ import annotations

import argparse
import csv
import os
import re
import shutil
import sys
import tempfile
from pathlib import Path

from .sweep_common import (
    find_binary,
    raxtax_torch_cmd,
    read_fasta_records,
    run_rust_raxtax,
    run_sintax,
    run_with_memory_poll,
    sample_split,
    write_fasta,
)

COLUMNS = (
    "tool", "size", "rep", "runtime_s", "peak_rss_mb", "returncode",
    "queries", "qps", "classify_s", "qps_steady", "db_mode",
)
_PHASE_RE = re.compile(r"(\w[\w ]*?) took ([0-9.]+) ms")


def log_phases(logf: Path) -> dict:
    """``{phase name: seconds}`` from a run's ``raxtax.log`` (the first line
    of each name)."""
    phases: dict = {}
    if logf.is_file():
        for name, ms in _PHASE_RE.findall(logf.read_text()):
            phases.setdefault(name, float(ms) / 1000.0)
    return phases


def write_csv(rows: list[dict], path: str) -> None:
    """All rows so far, replacing ``path`` atomically."""
    tmp = path + ".tmp"
    with open(tmp, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(COLUMNS), extrasaction="ignore")
        w.writeheader()
        w.writerows(rows)
    os.replace(tmp, path)


def sweep(records, sizes, reps: int, out: str, backend: str, device: str,
          reuse_db: bool = False, with_sintax: bool = False,
          with_rust: bool = False, log=print) -> list[dict]:
    """Run the sweep; returns the rows written to ``out``."""
    rows: list[dict] = []
    keep_dir = Path(tempfile.mkdtemp(prefix="rxsweep_db_")) if reuse_db else None
    try:
        for size in sizes:
            if size > len(records):
                log(f"skip size {size}: only {len(records)} records")
                continue
            cached_db: Path | None = None
            for rep in range(reps):
                seed = 42 if reuse_db else 42 + rep
                refs, queries = sample_split(records, size, seed=seed)
                with tempfile.TemporaryDirectory() as td:
                    ref_f = Path(td) / "refs.fasta"
                    qry_f = Path(td) / "queries.fasta"
                    write_fasta(refs, ref_f)
                    write_fasta(queries, qry_f)
                    cmd = raxtax_torch_cmd(
                        ref_f if cached_db is None else cached_db, qry_f,
                        Path(td) / "out",
                        extra=["--backend", backend, "--device", device],
                    )
                    detail: dict = {}
                    results = [("raxtax-torch", run_with_memory_poll(
                        cmd, phases={}, detail=detail))]
                    phases = log_phases(Path(td) / "out" / "raxtax.log")
                    if with_sintax:
                        r = run_sintax(ref_f, qry_f, td)
                        if r is not None:
                            results.append(("usearch-sintax", r))
                    if with_rust:
                        r = run_rust_raxtax(ref_f, qry_f, Path(td) / "out_rust")
                        if r is not None:
                            results.append(("raxtax-rust", r))
                    if reuse_db and cached_db is None:
                        built = Path(td) / "out" / "refs.bin.rxdb"
                        if built.is_file():
                            cached_db = keep_dir / f"refs_{size}.bin.rxdb"
                            shutil.move(str(built), cached_db)
                for tool, (runtime, peak_mb, rc) in results:
                    ours = tool == "raxtax-torch"
                    mode = "cached" if reuse_db and rep and ours else "cold"
                    # the classification phase alone: no FASTA parse, no
                    # database build, no kernel build (that lands inside the
                    # first batches, so a cold row's classify_s carries it)
                    classify = phases.get("raxtax") if ours else None
                    rows.append({
                        "tool": tool, "size": size, "rep": rep,
                        "runtime_s": round(runtime, 3),
                        "peak_rss_mb": round(peak_mb, 1),
                        "returncode": rc, "queries": len(queries),
                        "qps": round(len(queries) / runtime, 2),
                        "classify_s": round(classify, 3) if classify is not None else "",
                        "qps_steady": round(len(queries) / classify, 2) if classify else "",
                        "db_mode": mode,
                    })
                    if ours:  # printed beside the row, not in the CSV
                        rows[-1].update(detail)
                    log(rows[-1])
                    write_csv(rows, out)
            if cached_db is not None:
                cached_db.unlink(missing_ok=True)  # gigabytes per size
    finally:
        if keep_dir is not None:
            shutil.rmtree(keep_dir, ignore_errors=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("input_fasta")
    ap.add_argument("--sizes", type=int, nargs="+",
                    default=[50_000, 100_000, 200_000, 500_000, 1_000_000])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default="runtime_memory.csv")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "pallas", "stream", "xla", "oracle"])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--reuse-db", action="store_true",
                    help="sample once per size and reuse rep 0's binary "
                    "database for the later reps (a deviation from the "
                    "reference protocol, which rebuilds every rep)")
    ap.add_argument("--with-sintax", action="store_true",
                    help="also run usearch-SINTAX ($USEARCH or $PATH)")
    ap.add_argument("--with-rust", action="store_true",
                    help="also run the reference Rust raxtax ($RAXTAX or $PATH)")
    a = ap.parse_args(argv)
    if a.with_sintax and find_binary("usearch", "USEARCH") is None:
        print("warning: no usearch binary (set $USEARCH); skipping SINTAX")
        a.with_sintax = False
    if a.with_rust and find_binary("raxtax", "RAXTAX") is None:
        print("warning: no raxtax binary (set $RAXTAX); skipping the Rust arm")
        a.with_rust = False
    records = read_fasta_records(a.input_fasta)
    rows = sweep(records, a.sizes, a.reps, a.out, a.backend, a.device,
                 a.reuse_db, a.with_sintax, a.with_rust)
    if not rows:
        print("no rows produced (all sizes skipped); nothing written")
        return 0
    print(f"wrote {a.out}")
    return 1 if any(r["returncode"] for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
