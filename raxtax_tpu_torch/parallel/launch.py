"""Start ``n`` local ranks as child processes.

    python -m raxtax_tpu_torch.parallel.launch -n 2 -- -m raxtax_tpu_torch.cli ...

The counterpart of ``XLA_FLAGS=--xla_force_host_platform_device_count`` in
the JAX package's scripts: where JAX makes virtual devices inside one
process, the port's unit of a mesh is a rank, so a multi-rank run on one
machine is ``n`` processes. Each child is ``python <args>`` with
``torchrun``'s environment names set (``MASTER_ADDR=127.0.0.1``, a free
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), which
``parallel/multihost.maybe_initialize`` reads. :func:`launch` returns every
rank's exit code and log; the ranks of a failed start are stopped, never
left behind. :func:`run_all` does the same for commands of their own.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path


def free_port() -> int:
    """A TCP port of 127.0.0.1 that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, n: int, port: int, base=None) -> dict:
    env = dict(os.environ if base is None else base)
    env.update(
        MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(n),
        RANK=str(rank), LOCAL_RANK=str(rank),
    )
    return env


def launch(n: int, args: list[str], env: dict | None = None,
           timeout: float = 600.0,
           cwd: str | None = None) -> tuple[list[int], list[str]]:
    """Run ``python *args`` as ranks ``0..n-1`` of one world and wait for
    all (:func:`run_all`). Returns ``(exit codes, logs)`` in rank order."""
    port = free_port()
    return run_all([[sys.executable, *args]] * n,
                   [rank_env(r, n, port, env) for r in range(n)],
                   timeout=timeout, cwd=cwd)


def run_all(cmds: list[list[str]], envs: list[dict], timeout: float = 600.0,
            cwd: str | None = None) -> tuple[list[int], list[str]]:
    """Start every command (with its environment) at once and wait for all.
    After ``timeout`` seconds, or as soon as one exits with an error, every
    one still running is killed (exit code -9). Returns ``(exit codes,
    logs)`` in order; each log is the process's standard output and
    error."""
    tmp = tempfile.TemporaryDirectory()
    paths = [Path(tmp.name) / f"proc{i}.log" for i in range(len(cmds))]
    procs = []
    try:
        for cmd, env, path in zip(cmds, envs, paths):
            with open(path, "w") as f:
                procs.append(subprocess.Popen(
                    cmd, env=env, stdout=f, stderr=subprocess.STDOUT, cwd=cwd,
                ))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            failed = any(p.poll() not in (None, 0) for p in procs)
            if failed or time.monotonic() > deadline:
                # one down (ranks would wait for it in a collective) or the
                # time is up: stop the rest
                for p in procs:
                    if p.poll() is None:
                        p.kill()
            time.sleep(0.05)
        return [p.wait() for p in procs], [p.read_text() for p in paths]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        tmp.cleanup()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-n", "--nproc", type=int, required=True)
    ap.add_argument("--timeout", type=float, default=3600.0)
    ap.add_argument("args", nargs=argparse.REMAINDER,
                    help="what each rank runs: python ARGS")
    a = ap.parse_args(argv)
    args = a.args[1:] if a.args[:1] == ["--"] else a.args
    codes, logs = launch(a.nproc, args, timeout=a.timeout)
    for r, (c, text) in enumerate(zip(codes, logs)):
        sys.stderr.write(f"--- rank {r}: exit {c}\n{text}")
    return next((c for c in codes if c != 0), 0)


if __name__ == "__main__":
    sys.exit(main())
