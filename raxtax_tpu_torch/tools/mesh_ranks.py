"""The command line in several local ranks, held against one process.

    python -m raxtax_tpu_torch.tools.mesh_ranks [--records 65536]
        [--queries 512] [--ranks 2] [--meshes 1,2 2,1] [--batch-size 256]
        [--device cuda|cpu] [--out DIR]

Writes the synthetic FASTA of ``tools/make_synth_fasta.py`` (``--records``
records; its first ``--queries`` records are the queries), builds the
database cache once as a user does (``--only-db``), classifies in one
process, then in ``--ranks`` ranks started by ``parallel/launch.py``: on a
global mesh for each ``--meshes`` spec (``--global-mesh --mesh D,M``, with
``D * M`` ranks), and as independent ranks (each its slice of the queries,
folded by rank 0). Every merged ``raxtax.out``/``.tsv`` must be byte-equal
to the single process's and no ``.shard*`` file may be left. Rank 0's log
gives its peak device memory and, on a mesh, how many CUDA tensors its
collectives copied through host memory (gloo). Prints one JSON line; exit
code 1 when a run fails or differs.

The ranks take ``cuda:(rank % device_count)``: on a machine with one GPU they
share it over gloo, with one GPU per rank they run NCCL.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def _cli(*args) -> list[str]:
    return ["-m", "raxtax_tpu_torch.cli", *map(str, args)]


def _log_numbers(log: str) -> dict:
    """Rank 0's backend, peak device memory and gloo host copies from its
    log."""
    m = re.search(r"\] rank 0 of \d+ \(([a-z ]+)\)", log)
    out = {"backend": m.group(1) if m else None}
    m = re.search(r"peak device memory (\d+) bytes", log)
    out["peak_device_bytes_rank0"] = int(m.group(1)) if m else None
    m = re.search(r"copied (\d+) CUDA tensors", log)
    out["gloo_host_copies_rank0"] = int(m.group(1)) if m else None
    return out


def run(records: int, queries: int, ranks: int, meshes: list[str],
        batch: int = 256, device: str = "cuda", out_dir: str | None = None,
        log=print) -> dict:
    """The runs; returns the JSON line's dict. Raises ``AssertionError``
    when a run fails or differs from the single process."""
    from ..parallel.launch import launch
    from ..parallel.mesh import mesh_shape
    from .make_synth_fasta import write_synth_fasta

    line = {"records": records, "queries": queries, "ranks": ranks, "runs": {}}
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        tmp = Path(tmp)
        refs, qf = tmp / "refs.fasta", tmp / "queries.fasta"
        write_synth_fasta(records, str(refs))
        with open(refs) as f:
            head = [next(f) for _ in range(2 * queries)]
        qf.write_text("".join(head))
        t0 = time.time()
        r = subprocess.run(
            [sys.executable, *_cli("-d", refs, "-o", tmp / "db", "--only-db",
                                   "--device", device)],
            capture_output=True, text=True, cwd=str(REPO))
        if r.returncode != 0:
            raise AssertionError(f"--only-db: {r.stderr[-3000:]}")
        line["db_build_s"] = round(time.time() - t0, 2)
        common = ("-d", tmp / "db" / "refs.bin.rxdb", "-i", qf, "--tsv",
                  "--batch-size", batch, "--device", device)
        t0 = time.time()
        r = subprocess.run([sys.executable, *_cli(*common, "-o", tmp / "single")],
                           capture_output=True, text=True, cwd=str(REPO))
        if r.returncode != 0:
            raise AssertionError(f"single process: {r.stderr[-3000:]}")
        line["runs"]["single"] = {"seconds": round(time.time() - t0, 2)}
        want = {e: (tmp / "single" / f"raxtax.{e}").read_bytes()
                for e in ("out", "tsv")}
        runs = [
            (f"global_{s.replace(',', 'x')}", ("--global-mesh", "--mesh", s),
             math.prod(mesh_shape(s, 1 << 20)))
            for s in meshes
        ] + [("independent", (), ranks)]
        for name, flags, n in runs:
            out = tmp / name
            t0 = time.time()
            codes, logs = launch(n, _cli(*common, "-o", out, *flags),
                                 cwd=str(REPO), timeout=1800)
            dt = time.time() - t0
            if codes != [0] * n:
                raise AssertionError(
                    f"{name}: exit codes {codes}\n"
                    + "\n".join(text[-3000:] for text in logs))
            for e in ("out", "tsv"):
                if (out / f"raxtax.{e}").read_bytes() != want[e]:
                    raise AssertionError(f"{name}: raxtax.{e} differs")
            shards = sorted(p.name for p in out.glob("*.shard*"))
            if shards:
                raise AssertionError(f"{name}: left {shards}")
            numbers = _log_numbers((out / "raxtax.log").read_text())
            if flags and numbers["gloo_host_copies_rank0"] is None:
                raise AssertionError(f"{name}: rank 0 logged no mesh line")
            line["runs"][name] = {"ranks": n, "seconds": round(dt, 2),
                                  "equal_to_single": True, **numbers}
            log(f"mesh_ranks {name}: {n} ranks, {dt:.1f}s")
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--records", type=int, default=65_536)
    ap.add_argument("--queries", type=int, default=512)
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--meshes", nargs="*", default=["1,2", "2,1"])
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--out", default=None,
                    help="where the temporary files go (default: TMPDIR)")
    a = ap.parse_args(argv)
    from ..utils.device import resolve_device

    resolve_device(a.device)
    try:
        line = run(a.records, a.queries, a.ranks, a.meshes, a.batch_size,
                   a.device, a.out, log=lambda m: print(m, file=sys.stderr))
    except AssertionError as e:
        print(f"mesh_ranks: {e}", file=sys.stderr)
        return 1
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
