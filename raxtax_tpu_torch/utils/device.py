"""Device resolution for the port's entry points.

Every entry point runs on the GPU unless the caller asks for the CPU by
name: there is no silent CPU fallback. The kernels' wrappers (``ops/``)
follow the same rule per tensor — a CUDA tensor launches the kernel or
raises, a CPU tensor takes the plain PyTorch version.
"""

from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """``None``/"cuda" -> the current CUDA device (raises without one);
    "cpu" -> the CPU, only because it was asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; this package runs on the GPU "
                "unless the CPU is requested explicitly "
                "(device='cpu' / --device cpu)"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
