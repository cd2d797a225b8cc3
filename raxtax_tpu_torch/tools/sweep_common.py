"""Helpers of the runtime / memory sweep (``tools/runtime_memory.py``).

Sample a references / queries split from a FASTA, run a classifier command
while polling its peak host RSS, and time it; the optional comparison arms
(usearch-SINTAX, the reference Rust raxtax) run when their binaries exist.
The counterpart of the JAX package's ``scripts/common.py`` without
``psutil``: the peak is polled from ``/proc``, as the high-water mark
``VmHWM`` of the child and of every descendant, so a spike between two polls
still counts.
"""

from __future__ import annotations

import os
import random
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def read_fasta_records(path: str | Path) -> list[tuple[str, str]]:
    """(header, sequence) pairs of a plain or gzipped FASTA."""
    from ..io.fasta import iter_fasta_records

    return list(iter_fasta_records(path))


def write_fasta(records: list[tuple[str, str]], path: str | Path) -> None:
    with open(path, "w") as f:
        for header, seq in records:
            f.write(f">{header}\n{seq}\n")


def sample_split(
    records: list[tuple[str, str]],
    n: int,
    query_fraction: float = 0.1,
    seed: int = 42,
) -> tuple[list[tuple[str, str]], list[tuple[str, str]]]:
    """Sample ``n`` records and split them 90/10 into references and
    queries (the reference harness's protocol)."""
    rng = random.Random(seed)
    picked = rng.sample(records, min(n, len(records)))
    n_queries = int(len(picked) * query_fraction)
    return picked[n_queries:], picked[:n_queries]


def _children() -> dict[int, list[int]]:
    """Parent pid -> child pids, from ``/proc/<pid>/stat``."""
    kids: dict[int, list[int]] = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        # the command name may hold spaces: the fields start after its ')'
        ppid = int(stat.rsplit(")", 1)[1].split()[1])
        kids.setdefault(ppid, []).append(int(entry))
    return kids


def _status_bytes(pid: int, key: str) -> int:
    """One ``kB`` field of ``/proc/<pid>/status`` in bytes (0 when gone)."""
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith(key + ":"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def tree_bytes(pid: int, key: str = "VmRSS") -> int:
    """The sum of one ``/proc`` memory field over ``pid`` and all its
    descendants now: ``VmRSS`` (resident) or ``VmHWM`` (resident high-water
    mark of each process so far)."""
    kids = _children()
    total, todo = 0, [pid]
    while todo:
        p = todo.pop()
        total += _status_bytes(p, key)
        todo.extend(kids.get(p, ()))
    return total


def run_with_memory_poll(
    cmd: list[str], poll_hz: float = 10.0, phases: dict | None = None,
    detail: dict | None = None,
) -> tuple[float, float, int]:
    """Run ``cmd``; returns ``(runtime_s, peak_rss_mb, returncode)``.

    The peak is the largest sum of ``VmHWM`` over the child's process tree
    seen at ``poll_hz``: each process's own high-water mark, so a spike
    between two polls counts (only the growth in the child's last interval
    before it exits can be missed). The kernel's ``ru_maxrss`` for the child
    (from ``os.wait4``, the per-child form of ``RUSAGE_CHILDREN``) is no
    floor: Linux carries the high-water mark of the address space replaced by
    ``exec`` into it, and with ``fork`` or ``vfork`` that is this process's
    own. ``detail``, when given, receives ``hwm_peak_mb``, ``rss_peak_mb``
    (the largest polled sum of ``VmRSS``) and that ``child_maxrss_mb``. The
    repository goes on ``PYTHONPATH``. When ``phases`` is given, the child's
    stderr is held back and replayed after the run, so its writes do not
    disturb the poll loop (the phase lines themselves are in the run's
    ``raxtax.log``)."""
    import tempfile

    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + (
        ":" + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""
    )
    errf = tempfile.TemporaryFile() if phases is not None else None
    t0 = time.time()
    proc = subprocess.Popen(cmd, env=env, stderr=errf)
    hwm = rss = 0
    while True:
        pid, status, usage = os.wait4(proc.pid, os.WNOHANG)
        if pid == proc.pid:  # reaped here, so Popen must not wait again
            proc.returncode = os.waitstatus_to_exitcode(status)
            break
        hwm = max(hwm, tree_bytes(proc.pid, "VmHWM"))
        rss = max(rss, tree_bytes(proc.pid, "VmRSS"))
        time.sleep(1.0 / poll_hz)
    runtime = time.time() - t0
    if detail is not None:
        detail["hwm_peak_mb"] = hwm / 1e6
        detail["rss_peak_mb"] = rss / 1e6
        detail["child_maxrss_mb"] = usage.ru_maxrss * 1024 / 1e6
    if errf is not None:
        errf.seek(0)
        sys.stderr.write(errf.read().decode(errors="replace"))
        errf.close()
    return runtime, max(hwm, rss) / 1e6, proc.returncode


def raxtax_torch_cmd(
    db: str | Path,
    queries: str | Path,
    out_prefix: str | Path,
    extra: list[str] | None = None,
) -> list[str]:
    """``python -m raxtax_tpu_torch.cli -d DB -i QUERIES -o OUT --redo``."""
    return [
        sys.executable, "-m", "raxtax_tpu_torch.cli",
        "-d", str(db), "-i", str(queries), "-o", str(out_prefix),
        "--redo",
    ] + (extra or [])


def find_binary(name: str, env_var: str) -> str | None:
    """A comparison binary: ``$ENV_VAR`` first, then ``$PATH``."""
    return os.environ.get(env_var) or shutil.which(name)


def run_sintax(
    db_fasta: str | Path,
    queries: str | Path,
    out_dir: str | Path,
    threads: int = 0,
    usearch: str | None = None,
) -> tuple[float, float, int] | None:
    """The usearch-SINTAX arm: build the ``.udb``, classify with
    ``--sintax``; combined runtime and the larger peak. None when there is
    no usearch binary (``$USEARCH`` or ``$PATH``)."""
    usearch = usearch or find_binary("usearch", "USEARCH")
    if usearch is None:
        return None
    threads = threads or (os.cpu_count() or 1)
    db_path = Path(out_dir) / (Path(db_fasta).stem + ".udb")
    out_path = Path(out_dir) / "sintax.out"
    t1, m1, rc1 = run_with_memory_poll(
        [usearch, "--makeudb_usearch", str(db_fasta), "--output", str(db_path)]
    )
    if rc1 != 0:
        return t1, m1, rc1
    t2, m2, rc2 = run_with_memory_poll(
        [usearch, "--sintax", str(queries), "--db", str(db_path),
         "--tabbedout", str(out_path), "--threads", str(threads)]
    )
    db_path.unlink(missing_ok=True)
    return t1 + t2, max(m1, m2), rc2


def run_rust_raxtax(
    db_fasta: str | Path,
    queries: str | Path,
    out_dir: str | Path,
    threads: int = 0,
    binary: str | None = None,
) -> tuple[float, float, int] | None:
    """The reference Rust raxtax arm, when a binary exists (``$RAXTAX`` or
    ``$PATH``); None otherwise."""
    binary = binary or find_binary("raxtax", "RAXTAX")
    if binary is None:
        return None
    threads = threads or (os.cpu_count() or 1)
    return run_with_memory_poll(
        [binary, "-d", str(db_fasta), "-i", str(queries),
         "-o", str(out_dir), "-t", str(threads), "--redo"]
    )
