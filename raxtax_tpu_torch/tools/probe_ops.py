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
writes ``cuobjdump -sass`` of the built library and prints, per chain, the
instructions and the dependent instructions a step of its unrolled loop
(:func:`chain_sass`), the numbers K13's floors are made of. Runs on the GPU
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time
from collections import defaultdict

import torch

from ..ops.opchain import (
    CHAINS,
    UNROLL,
    probe_op_chain,
    probe_op_chain_plain,
    probe_state,
)
from ..utils.device import resolve_device
from .probe_f64 import device_ms, whole_space_halves

SCRIPT_ITERS = 5_000_000
#: step counts at the edges of the kernel's unrolled loop
EDGE_ITERS = (0, 1, UNROLL - 1, UNROLL, UNROLL + 1, 2 * UNROLL + 3)


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


def whole_space_state(dev, seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """``[8, 128]`` int32 inputs drawn from the whole u32 space (every
    exponent, the sign bit included), from a numpy seed."""
    a, b, _, _ = whole_space_halves((8, 128), dev, seed)
    return a, b


def edge_mismatches(dev, iters=EDGE_ITERS, seed: int = 0) -> list:
    """Every chain at every step count of ``iters``, on the probe's state and
    on whole-space words, against the plain version: the (chain, steps,
    inputs) that differ."""
    bad = []
    for label, (x, y) in (("probe_state", probe_state(dev)),
                          ("whole_space", whole_space_state(dev, seed))):
        for name in CHAINS:
            for n in iters:
                if not torch.equal(probe_op_chain(name, x, y, n),
                                   probe_op_chain_plain(name, x, y, n)):
                    bad.append((name, n, label))
    return bad


# -- SASS ----------------------------------------------------------------------

_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_INSTR = re.compile(r"/\*([0-9a-fA-F]{4,})\*/\s+([^;]*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_REG = re.compile(r"(?<![\w.])(U?[RP])(\d+)(\.64)?")


def library_sass(stem: str, csrc=None, out=None) -> str:
    """``cuobjdump -sass`` of the built library of ``<csrc>/<stem>.cu``
    under ``out`` (by default the package's sources and build directory)."""
    from ..ops import _build

    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    _build.build_all((stem,), csrc, out)
    lib = _build._lib_path(stem, csrc, out)
    return subprocess.run([tool, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout


def sass_functions(text: str) -> dict[str, list]:
    """Each function's listing: ``name -> [("label", name) | (address,
    instruction)]``, in order."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        if cur is None:
            continue
        m = _LABEL.match(line)
        if m:
            cur.append(("label", m.group(1)))
            continue
        m = _INSTR.search(line)
        if m:
            cur.append((int(m.group(1), 16), m.group(2).strip()))
    return funcs


def loop_body(listing: list) -> list[str]:
    """The instructions of the function's largest loop: from a branch
    target up to the backward branch to it (inclusive)."""
    where, instrs = {}, []
    for kind, item in listing:
        if kind == "label":
            where[item] = len(instrs)
        else:
            where[f"0x{kind:x}"] = len(instrs)
            instrs.append(item)
    best = []
    for i, ins in enumerate(instrs):
        m = re.search(r"\bBRA\b.*?(\.L_x_\d+|0x[0-9a-fA-F]+)", ins)
        if not m:
            continue
        tgt = m.group(1)
        j = where.get(tgt.lower() if tgt.startswith("0x") else tgt)
        if j is not None and j <= i and i + 1 - j > len(best):
            best = instrs[j : i + 1]
    return best


def _regs(operand: str) -> list[str]:
    out = []
    for kind, num, pair in _REG.findall(operand):
        out.append(f"{kind}{num}")
        if pair:  # a 64-bit operand names the low register of its pair
            out.append(f"{kind}{int(num) + 1}")
    return out


def _dests_srcs(ins: str) -> tuple[list, list, str]:
    srcs = []
    m = re.match(r"@!?(U?P\w+)\s+(.*)", ins)
    guarded = m is not None
    if guarded:
        srcs.append(m.group(1))
        ins = m.group(2)
    parts = ins.split(None, 1)
    op, ops = parts[0], ([o.strip() for o in parts[1].split(",")]
                         if len(parts) > 1 else [])
    dests = []
    if ops and "[" not in ops[0] and not op.startswith(("ST", "RED", "BRA",
                                                        "EXIT", "BAR")):
        dests = _regs(ops[0])
        k = 1
        while k < len(ops) and re.fullmatch(r"U?P(\d+|T)", ops[k]):
            dests += _regs(ops[k])
            k += 1
        ops = ops[k:]
    for o in ops:
        srcs += _regs(o)
    if guarded:  # a predicated write keeps the old value when it is off
        srcs += dests
    return dests, srcs, op


def dependent_per_trip(body: list[str]) -> int:
    """The longest chain of dependent instructions that one trip of the loop
    adds to the values it carries: the body walked twice, every instruction
    one unit after the latest of its sources, the second trip's growth."""
    depth = defaultdict(int)
    ends = []
    for _ in range(2):
        for ins in body:
            dests, srcs, _ = _dests_srcs(ins)
            d = 1 + max((depth[r] for r in srcs), default=0)
            for r in dests:
                depth[r] = d
        ends.append(max(depth.values(), default=0))
    return ends[1] - ends[0]


def chain_sass(text: str, unroll: int = UNROLL) -> dict:
    """Per chain of ``op_chain_kernel``: the instructions of its unrolled
    main loop a step (loop overhead included) and the dependent
    instructions a step (:func:`dependent_per_trip` over ``unroll``)."""
    out = {}
    for name, listing in sass_functions(text).items():
        m = re.search(r"op_chain_kernelILi(\d+)E", name)
        if not m:
            continue
        body = loop_body(listing)
        out[CHAINS[int(m.group(1))]] = {
            "loop_instructions": len(body),
            "instructions_per_step": len(body) / unroll,
            "dependent_per_step": dependent_per_trip(body) / unroll,
        }
    return out


def ew_instructions_per_pair(text: str) -> float:
    """K11's SASS instructions an element: its grid-stride loop's
    instructions over the elements a trip (four stores an element)."""
    for name, listing in sass_functions(text).items():
        if "probe_f64_ew_kernel" in name:
            body = loop_body(listing)
            stores = sum(_dests_srcs(i)[2].startswith("STG") for i in body)
            return len(body) / (stores / 4)
    raise KeyError("probe_f64_ew_kernel")


class SmClock:
    """``nvidia-smi``'s SM clock sampled every 50 ms while the block runs;
    ``mhz`` is the median of the samples (None when none came)."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits", "-lms", "50"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self.mhz = None
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate()
        samples = [int(s) for s in out.split() if s.isdigit()]
        self.samples = samples
        self.mhz = statistics.median(samples) if samples else None
        return False


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
        text = library_sass("probe_ops")
        os.makedirs(os.path.dirname(os.path.abspath(a.sass)), exist_ok=True)
        with open(a.sass, "w") as f:
            f.write(text)
        print(json.dumps({"sass": a.sass, "chains": chain_sass(text)}),
              flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
