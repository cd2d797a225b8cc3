"""The software-f64 probes on the card: K11 and K12 against their plain
versions, against hardware ``float64`` and against K5.

    python -m raxtax_tpu_torch.tools.probe_f64
    python -m raxtax_tpu_torch.tools.probe_f64 --device cpu --pairs 4096 --tips 512

The counterpart of the JAX package's ``scripts/probe_mosaic_f64.py``, at its
shapes: the ``8 x 128`` elementwise add and subtract, and the sequential scan
at ``B = 256`` queries over 65,536 and 1,048,576 tips. On top of that K11 runs
on ``--pairs`` adversarial pairs (equal and 1-ulp-apart values, Sterbenz
zones, zeros, exponent gaps, powers of two), and every result is held bit for
bit against

- the plain version (torch integer ops), on the first ``--plain-pairs``
  pairs and at ``--plain-tips`` tips;
- hardware ``float64``: ``a + b`` and ``(a + b) - b``, on every pair;
- K5 (``ops/exactscan.exact_cumsum``, hardware f64 in tip order) on the same
  probabilities.

Prints one JSON line per check, with CUDA-event milliseconds on the card
("not measured" on the CPU) and the first mismatch where there is one; the
exit code is 1 if anything differs. Runs on the GPU unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..ops import exactf64 as xf
from ..ops.exactscan import exact_cumsum
from ..utils.device import resolve_device

SCRIPT_TIPS = (65_536, 1_048_576)
SCRIPT_BATCH = 256  # queries of the scan: two lane groups of 128


def adversarial_pairs(rng, n: int):
    """Non-negative normal-or-zero f64 pairs that stress alignment, sticky
    bits, cancellation and rounding (the JAX package's test generator)."""
    with np.errstate(over="ignore"):
        e1 = rng.integers(-300, 300, n)
        e2 = e1 + rng.integers(-60, 60, n)  # mostly alignable gaps
        a = rng.random(n) * np.power(10.0, e1)
        b = rng.random(n) * np.power(10.0, e2)
    k = n // 8
    b[:k] = a[:k]  # exact equality
    b[k : 2 * k] = np.nextafter(a[k : 2 * k], np.inf)  # 1 ulp apart
    b[2 * k : 3 * k] = a[2 * k : 3 * k] * 0.5  # Sterbenz zone
    a[3 * k : 4 * k] = 0.0
    b[4 * k : 5 * k] = 0.0
    b[5 * k : 6 * k] = a[5 * k : 6 * k] * 2.220446049250313e-16  # ~ ulp(a)
    a[6 * k : 7 * k] = np.power(2.0, rng.integers(-200, 200, k).astype(np.float64))
    bad = ~np.isfinite(a) | ~np.isfinite(b)
    a[bad] = 1.0
    b[bad] = 1.0
    tiny = 2.2250738585072014e-308  # no subnormal inputs
    a[(a != 0) & (a < tiny)] = tiny
    b[(b != 0) & (b < tiny)] = tiny
    with np.errstate(over="ignore"):
        keep = np.isfinite(a + b)  # no overflow to inf
    return a[keep], b[keep]


def device_ms(fn, dev: torch.device, reps: int = 3):
    """Mean CUDA-event milliseconds of ``fn()`` after a warm-up run; on the
    CPU no device time exists: "not measured"."""
    if dev.type != "cuda":
        return "not measured"
    fn()
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / reps


def first_mismatch(got: torch.Tensor, want: torch.Tensor, *inputs):
    """None when the bit patterns agree, else the first differing index with
    the inputs and both values (as f64 bit patterns in hex and as floats)."""
    g = got.reshape(-1).view(torch.int64)
    w = want.reshape(-1).view(torch.int64)
    diff = torch.nonzero(g != w)
    if diff.numel() == 0:
        return None
    i = int(diff[0, 0])

    def show(t):
        v = t.reshape(-1)[i]
        return {"bits": f"{int(v.view(torch.int64)) & (2**64 - 1):016x}",
                "value": float(v)}

    return {"index": i, "count": int(diff.shape[0]),
            "inputs": [show(x) for x in inputs],
            "got": show(got), "want": show(want)}


def _pairs_to_f64(hi, lo):
    return torch.stack([lo, hi], dim=-1).view(torch.float64).reshape(hi.shape)


def check_ew(a: np.ndarray, b: np.ndarray, dev: torch.device, name: str,
             plain_pairs: int) -> dict:
    """K11 on the pairs ``(a, b)``: against its plain version on the first
    ``plain_pairs`` and against hardware f64 on all."""
    ah, al = xf.split64(a)
    bh, bl = xf.split64(b)
    halves = [torch.from_numpy(x.view(np.int32)).to(dev) for x in (ah, al, bh, bl)]
    ch, cl, dh, dl = xf.probe_f64_ew(*halves)
    c = _pairs_to_f64(ch, cl)
    d = _pairs_to_f64(dh, dl)
    ta = torch.from_numpy(a).to(dev)
    tb = torch.from_numpy(b).to(dev)
    hw_c = ta + tb
    hw_d = hw_c - tb
    mism = first_mismatch(c, hw_c, ta, tb) or first_mismatch(d, hw_d, ta, tb)
    n_plain = min(plain_pairs, a.size)
    sl = [x[:n_plain] for x in halves]
    t0 = time.perf_counter()
    plain = xf.probe_f64_ew_plain(*sl)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    plain_s = time.perf_counter() - t0
    plain_eq = all(
        torch.equal(p, k[:n_plain]) for p, k in zip(plain, (ch, cl, dh, dl))
    )
    return {
        "probe": name, "device": str(dev), "pairs": int(a.size),
        "bits_equal_hardware_f64": mism is None,
        "plain_pairs": n_plain, "bits_equal_plain": plain_eq,
        "ms": device_ms(lambda: xf.probe_f64_ew(*halves), dev),
        "hardware_add_ms": device_ms(lambda: ta + tb, dev),
        "plain_ms_host_clock": plain_s * 1e3 if dev.type == "cuda" else "not measured",
        "first_mismatch": mism,
    }


def scan_inputs(B: int, N: int, dev: torch.device, seed: int) -> torch.Tensor:
    """``[B, N]`` probability-scale f64 values, 30 % of them zero, made on
    the device from a seed (the probe's distribution)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    p = torch.rand((B, N), dtype=torch.float64, device=dev, generator=g) * 1e-6
    zero = torch.rand((B, N), dtype=torch.float64, device=dev, generator=g) < 0.3
    return p.masked_fill_(zero, 0.0)


def check_scan(B: int, N: int, dev: torch.device, seed: int,
               plain_tips: int) -> dict:
    """K12 at ``[B // 128, N, 128]`` against K5 on the same values, bit for
    bit, and against its plain version on the first ``plain_tips`` tips."""
    p = scan_inputs(B, N, dev, seed)
    ph, pl = xf.to_lane_groups(p)
    oh, ol = xf.probe_f64_scan(ph, pl)
    got = xf.from_lane_groups(oh, ol)
    cum = exact_cumsum(p)
    mism = first_mismatch(got, cum[:, 1:].contiguous(), p)
    line = {
        "probe": "scan", "device": str(dev), "B": B, "N": N,
        "bits_equal_k5": mism is None, "first_mismatch": mism,
    }
    del got, cum
    if plain_tips:
        n = min(plain_tips, N)
        sh, sl = ph[:, :n].contiguous(), pl[:, :n].contiguous()
        k_h, k_l = xf.probe_f64_scan(sh, sl)
        t0 = time.perf_counter()
        p_h, p_l = xf.probe_f64_scan_plain(sh, sl)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        line["plain_tips"] = n
        line["bits_equal_plain"] = torch.equal(k_h, p_h) and torch.equal(k_l, p_l)
        line["plain_ms_host_clock"] = (
            (time.perf_counter() - t0) * 1e3 if dev.type == "cuda" else "not measured")
    line["ms"] = device_ms(lambda: xf.probe_f64_scan(ph, pl), dev)
    line["k5_ms"] = device_ms(lambda: exact_cumsum(p), dev)
    if not isinstance(line["ms"], str):
        line["ns_per_chain_step"] = line["ms"] * 1e6 / N
        line["k5_ns_per_chain_step"] = line["k5_ms"] * 1e6 / N
        line["software_over_hardware"] = line["ms"] / line["k5_ms"]
    return line


def run(dev: torch.device, pairs: int, tips, batch: int, plain_pairs: int,
        plain_tips: int, seed: int = 0) -> list[dict]:
    """Every check of the probe; returns one dict per JSON line."""
    rng = np.random.default_rng(seed)
    n = 8 * 128  # the elementwise probe's [8, 128] block
    a = rng.random(n) * 10.0 ** rng.integers(-30, 2, n)
    b = rng.random(n) * 10.0 ** rng.integers(-30, 2, n)
    lines = [check_ew(a, b, dev, "ew_8x128", plain_pairs)]
    a, b = adversarial_pairs(rng, pairs)
    lines.append(check_ew(a, b, dev, "ew_adversarial", plain_pairs))
    del a, b
    for N in tips:
        lines.append(check_scan(batch, N, dev, seed + N, plain_tips))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return lines


def passed(line: dict) -> bool:
    return all(v for k, v in line.items() if k.startswith("bits_equal"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--pairs", type=int, default=1 << 24,
                    help="adversarial pairs for K11 (before the overflow cut)")
    ap.add_argument("--plain-pairs", type=int, default=1 << 20,
                    help="pairs held against K11's plain version")
    ap.add_argument("--tips", type=int, nargs="+", default=list(SCRIPT_TIPS))
    ap.add_argument("--plain-tips", type=int, default=512,
                    help="tips held against K12's plain version")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    ok = True
    for line in run(dev, a.pairs, a.tips, SCRIPT_BATCH, a.plain_pairs,
                    a.plain_tips):
        print(json.dumps(line), flush=True)
        ok = ok and passed(line)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
