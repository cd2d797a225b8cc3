"""Profiler traces of the classification phase (``cli.py --trace DIR``).

The JAX package wraps its classification phase in ``jax.profiler.trace``;
here it is ``torch.profiler.profile`` with the host's operators and, on the
GPU, every kernel the device ran (CUPTI sees the ``csrc/`` kernels launched
through ``ctypes`` as well as torch's own). The trace lands in ``DIR`` as
``<host>_<pid>.<time>.pt.trace.json`` through
``torch.profiler.tensorboard_trace_handler``: TensorBoard's profiler plugin
and Perfetto read it.
"""

from __future__ import annotations

import json
import re
from contextlib import contextmanager
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"


@contextmanager
def classification_trace(trace_dir, device="cuda"):
    """Profile the enclosed block into ``trace_dir``: host operators always,
    device kernels when ``device`` is a CUDA device."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    Path(trace_dir).mkdir(parents=True, exist_ok=True)
    with profile(
        activities=activities,
        on_trace_ready=tensorboard_trace_handler(str(trace_dir)),
    ):
        yield


def trace_files(trace_dir) -> list[Path]:
    return sorted(Path(trace_dir).glob("*.pt.trace.json*"))


def trace_kernel_names(trace_dir) -> set[str]:
    """Names of the device kernels (``cat`` ``kernel``) in every trace file
    under ``trace_dir``."""
    import gzip

    names: set[str] = set()
    for f in trace_files(trace_dir):
        opener = gzip.open if f.suffix == ".gz" else open
        with opener(f, "rt") as fh:
            events = json.load(fh).get("traceEvents", [])
        names.update(
            e["name"] for e in events
            if isinstance(e, dict) and e.get("cat") == "kernel" and "name" in e
        )
    return names


def csrc_kernels(csrc: Path = CSRC) -> set[str]:
    """The ``__global__`` function names of the package's CUDA sources."""
    pat = re.compile(
        r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\("
    )
    return {m for f in csrc.glob("*.cu*") for m in pat.findall(f.read_text())}


def csrc_kernels_in(trace_dir, csrc: Path = CSRC) -> list[str]:
    """The ``csrc/`` kernels a trace names, matched on the function name
    inside the demangled kernel name."""
    wanted = csrc_kernels(csrc)
    return sorted({
        k for name in trace_kernel_names(trace_dir) for k in wanted
        if re.search(rf"\b{k}\b", name)
    })
