"""K13: register-resident operation chains (the cost of one u32 operation,
and of one software f64 add, on the card).

:func:`probe_op_chain` — CUDA kernel ``csrc/probe_ops.cu``
(``rx_probe_op_chain``). Replaces ``run``/``kernel`` of
``scripts/probe_mosaic_perf.py:38-51`` (``pallas_call`` at :55): an
``[8, 128]`` u32 state ``(a, a + 1)`` goes through ``iters`` steps of one of
the seven bodies of ``probe_mosaic_perf.py:69-96`` (:data:`CHAINS`) and the
XOR of the two state words comes back. One thread per element, the body a
template parameter and the step count a run-time argument; an empty
``asm volatile`` on the state keeps the compiler from folding a chain into a
closed form (see the source). Bound: the latency of the dependent chain.

:func:`probe_op_chain_plain` runs the same bodies as torch integer ops on
``int64`` words masked to 32 bits (:mod:`.exactf64`); the wrapper takes it
for a CPU tensor and launches the kernel or raises for a CUDA one.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .exactf64 import M32, OPS_PER_ADD, as_i32, f64_add, words

#: the seven chains, in the order of the kernel's template ids
CHAINS = (
    "u32_add_x1", "u32_add_x8", "shift_fixed_x1", "shift_var_x1",
    "shift_var_x4", "cmp_select_x1", "f64_add_full",
)
#: u32 operations per element and step as each body writes them (the masks
#: of the variable shifts included; f64_add as counted in exactf64)
OPS_PER_STEP = {
    "u32_add_x1": 1, "u32_add_x8": 8, "shift_fixed_x1": 2, "shift_var_x1": 3,
    "shift_var_x4": 9, "cmp_select_x1": 4, "f64_add_full": OPS_PER_ADD,
}


def _step(name: str, s0, s1, a, b):
    """One step of a chain's body on u32 words (probe_mosaic_perf.py:69-96)."""
    if name == "u32_add_x1":
        return (s0 + b) & M32, s1
    if name == "u32_add_x8":
        for _ in range(4):
            s0 = (s0 + b) & M32
            s0 = (s0 + a) & M32
        return s0, s1
    if name == "shift_fixed_x1":
        return s0 >> 5, (s1 + a) & M32
    if name == "shift_var_x1":
        return s0 >> (b & 31), (s1 + a) & M32
    if name == "shift_var_x4":
        s0 = s0 >> (b & 31)
        s0 = (s0 << (b & 15)) & M32
        s0 = s0 >> (b & 7)
        s0 = (s0 << (b & 3)) & M32
        return s0, (s1 + a) & M32
    if name == "cmp_select_x1":
        return torch.where(s0 > b, (s0 + a) & M32, s1), (s1 + a) & M32
    if name == "f64_add_full":
        return f64_add(s0, s1, a, b)
    raise ValueError(f"unknown chain {name!r}")


def probe_op_chain_plain(name: str, a: torch.Tensor, b: torch.Tensor,
                         iters: int) -> torch.Tensor:
    """Plain version of K13: ``iters`` steps of chain ``name`` from the state
    ``(a, a + 1)``, then ``s0 ^ s1``, as int32 bit patterns."""
    a, b = words(a), words(b)
    s0, s1 = a, (a + 1) & M32
    for _ in range(iters):
        s0, s1 = _step(name, s0, s1, a, b)
    return as_i32(s0 ^ s1)


def probe_op_chain(name: str, a: torch.Tensor, b: torch.Tensor,
                   iters: int) -> torch.Tensor:
    """K13: chain ``name`` for ``iters`` steps on int32 bit patterns ``a``,
    ``b`` of one shape; returns the XOR of the final state words."""
    if name not in CHAINS:
        raise ValueError(f"unknown chain {name!r}")
    if not 0 <= iters < 2**31:
        raise ValueError("iters must fit a 32-bit int")
    if not a.is_cuda:
        return probe_op_chain_plain(name, a, b, iters)
    _build.require_cuda_tensor(a, torch.int32, "a")
    _build.require_cuda_tensor(b, torch.int32, "b")
    if a.shape != b.shape:
        raise ValueError("probe_op_chain: a and b differ in shape")
    fn = _build.entry(
        "probe_ops", "rx_probe_op_chain",
        [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    )
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        probe_op_chain.launches += 1
        code = fn(CHAINS.index(name), a.data_ptr(), b.data_ptr(),
                  out.data_ptr(), a.numel(), iters, stream)
    _build.check("probe_ops", code, f"probe_op_chain({name})")
    return out


#: kernel launches made by :func:`probe_op_chain`
probe_op_chain.launches = 0


def probe_state(device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """The probe's inputs (probe_mosaic_perf.py:53-54): ``x = arange(1024)``
    and ``y = x % 23`` as ``[8, 128]`` int32."""
    x = torch.arange(8 * 128, dtype=torch.int32, device=device).reshape(8, 128)
    return x, x % 23
