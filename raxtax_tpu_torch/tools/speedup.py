"""Scaling sweeps over mesh sizes: strong and weak scaling.

    python -m raxtax_tpu_torch.tools.speedup INPUT_FASTA [--devices 1 2 4 8]
        [--db-size 20000] [--queries 2000 | --queries-per-device 2000]
        [--out speedup.csv] [--backend xla] [--device cuda|cpu]

The counterpart of the JAX package's ``scripts/speedup.py``: where that
script makes ``n`` virtual devices in one process
(``--xla_force_host_platform_device_count``), this one starts ``n`` ranks
(``parallel/launch.py``) of one ``--global-mesh --mesh 1,n`` command line
run, one device each: rank ``r`` takes ``cuda:(r % device_count)``. On a
machine with fewer GPUs than ranks, ranks share a GPU (over gloo), so the
rows time the mesh's collectives and duplicated host work, not a scaling:
the script says so in its output.

- strong scaling: a fixed query count over every mesh size;
- weak scaling (``--queries-per-device``): the queries grow with the ranks.

Same CSV columns as the JAX script (``devices, queries, runtime_s,
peak_rss_mb, speedup, efficiency, returncode``); the runtime is the whole
launch, start-up of every rank included, and the peak RSS the polled sum
over the launcher and its ranks.
"""

from __future__ import annotations

import argparse
import csv
import sys
import tempfile
from pathlib import Path

from .sweep_common import (
    raxtax_torch_cmd,
    read_fasta_records,
    run_with_memory_poll,
    sample_split,
    write_fasta,
)


def shared_note(devices: list[int], device: str) -> str | None:
    """Why the rows are no scaling claim on this machine, or None."""
    if device != "cuda":
        return "ranks run on the CPU: the rows are no GPU scaling"
    import torch

    n_gpu = torch.cuda.device_count()
    if max(devices) > n_gpu:
        return (
            f"{n_gpu} GPU(s) for up to {max(devices)} ranks: ranks share a "
            "GPU over gloo, so the rows are no scaling claim"
        )
    return None


def sweep(records, devices: list[int], db_size: int, queries: int,
          queries_per_device: int, backend: str, device: str,
          log=print) -> list[dict]:
    """One launch per mesh size; the JAX script's speedup and efficiency
    against the smallest size."""
    refs, qpool = sample_split(records, db_size, query_fraction=0.5, seed=42)
    rows = []
    base_runtime = None
    for nd in devices:
        nq = queries_per_device * nd if queries_per_device else queries
        picked = (qpool * (nq // len(qpool) + 1))[:nq]
        with tempfile.TemporaryDirectory() as td:
            ref_f = Path(td) / "refs.fasta"
            qry_f = Path(td) / "queries.fasta"
            write_fasta(refs, ref_f)
            write_fasta(
                [(f"{h}#{i}", s) for i, (h, s) in enumerate(picked)], qry_f
            )
            cli = raxtax_torch_cmd(
                ref_f, qry_f, Path(td) / "out",
                extra=["--backend", backend, "--device", device,
                       "--global-mesh", "--mesh", f"1,{nd}"],
            )
            cmd = [sys.executable, "-m", "raxtax_tpu_torch.parallel.launch",
                   "-n", str(nd), "--", *cli[1:]]
            runtime, peak_mb, rc = run_with_memory_poll(cmd)
        if nd == devices[0]:
            base_runtime = runtime  # smallest-mesh reference point
        base_nd = devices[0]
        if queries_per_device:
            # weak scaling: work grows with devices, so ideal is CONSTANT
            # runtime — efficiency = t(base)/t(nd), speedup = efficiency x
            # relative devices
            efficiency = base_runtime / runtime if runtime else 0.0
            speedup = efficiency * (nd / base_nd)
        else:
            # strong scaling: fixed work, ideal runtime ∝ 1/devices
            speedup = base_runtime / runtime if runtime else 0.0
            efficiency = speedup * base_nd / nd
        rows.append({
            "devices": nd, "queries": nq, "runtime_s": round(runtime, 3),
            "peak_rss_mb": round(peak_mb, 1), "speedup": round(speedup, 3),
            "efficiency": round(efficiency, 3), "returncode": rc,
        })
        log(rows[-1])
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("input_fasta")
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--db-size", type=int, default=20_000)
    ap.add_argument("--queries", type=int, default=2_000)
    ap.add_argument("--queries-per-device", type=int, default=0)
    ap.add_argument("--out", default="speedup.csv")
    ap.add_argument("--backend", default="xla")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    a = ap.parse_args(argv)
    from ..utils.device import resolve_device

    resolve_device(a.device)
    note = shared_note(a.devices, a.device)
    if note:
        print(f"note: {note}")
    rows = sweep(read_fasta_records(a.input_fasta), a.devices, a.db_size,
                 a.queries, a.queries_per_device, a.backend, a.device)
    with open(a.out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {a.out}")
    return 0 if all(r["returncode"] == 0 for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
