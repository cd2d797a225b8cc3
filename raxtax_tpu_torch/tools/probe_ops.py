"""What one u32 operation, and one software f64 add, cost on the card: K13's
register-resident chains timed per step.

    python -m raxtax_tpu_torch.tools.probe_ops
    python -m raxtax_tpu_torch.tools.probe_ops --device cpu --iters 64 --check-iters 16
    python -m raxtax_tpu_torch.tools.probe_ops --sass probe_ops.sass

The counterpart of the JAX package's ``scripts/probe_mosaic_perf.py``: each
of the seven chains (``ops/opchain.CHAINS``) runs ``--iters`` steps
(5,000,000, the script's count) on the ``[8, 128]`` state, one launch each,
timed by CUDA events; the bits are first held against the plain version at
``--check-iters`` steps. Prints one JSON line per chain (nanoseconds per
step; "not measured" on the CPU) and exits 1 if any bits differ. ``--sass``
writes ``cuobjdump -sass`` of the built library, to see that every chain's
operations stay inside its loop. Runs on the GPU unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

from ..ops.opchain import CHAINS, probe_op_chain, probe_op_chain_plain, probe_state
from ..utils.device import resolve_device
from .probe_f64 import device_ms

SCRIPT_ITERS = 5_000_000


def chain_line(name: str, dev: torch.device, iters: int, check_iters: int) -> dict:
    """One chain: bits against the plain version at ``check_iters`` steps,
    then the time of one launch of ``iters`` steps."""
    x, y = probe_state(dev)
    got = probe_op_chain(name, x, y, check_iters)
    t0 = time.perf_counter()
    want = probe_op_chain_plain(name, x, y, check_iters)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    plain_s = time.perf_counter() - t0
    line = {
        "chain": name, "device": str(dev), "check_iters": check_iters,
        "bits_equal_plain": torch.equal(got, want), "iters": iters,
    }
    if dev.type != "cuda":
        probe_op_chain(name, x, y, iters)
        line["ns_per_iter"] = "not measured"
        return line
    # one warm-up launch at full length (clocks up), then one timed launch
    ms = device_ms(lambda: probe_op_chain(name, x, y, iters), dev, reps=1)
    line.update({
        "ms": ms, "ns_per_iter": ms * 1e6 / iters,
        "plain_ms_host_clock": plain_s * 1e3,
    })
    return line


def dump_sass(path: str) -> None:
    """``cuobjdump -sass`` of the built K13 library, into ``path``."""
    from ..ops import _build

    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    lib = _build._lib_path("probe_ops")
    _build.build_all()
    out = subprocess.run([tool, "-sass", str(lib)], check=True,
                         capture_output=True, text=True).stdout
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--iters", type=int, default=SCRIPT_ITERS)
    ap.add_argument("--check-iters", type=int, default=256,
                    help="steps at which the bits meet the plain version")
    ap.add_argument("--sass", default="", help="write cuobjdump -sass here")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    ok = True
    for name in CHAINS:
        line = chain_line(name, dev, a.iters, a.check_iters)
        print(json.dumps(line), flush=True)
        ok = ok and line["bits_equal_plain"]
    if a.sass:
        dump_sass(a.sass)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
