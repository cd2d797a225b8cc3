"""Bit-level tensor primitives shared by the compute paths.

Words are carried as ``int32`` bit patterns (PyTorch has no shifts on
``uint32`` for CPU tensors): shifts are arithmetic, so every extracted bit is
masked.
"""

from __future__ import annotations

import torch

WORD_BITS = 32


def unpack_bits(words: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Unpack 32-bit words into 0/1 values: ``[..., W] -> [..., W * 32]``.

    Bit ``j`` of word ``w`` maps to output position ``w * 32 + j``
    (little-endian bit order, matching the host packers in
    ``db/bitmatrix.py``). The words are read as bytes (little-endian in
    memory: byte ``i`` of a word holds its bits ``8 i .. 8 i + 7``), so the
    shift and the mask run on one-byte values."""
    if words.dtype != torch.int32:
        raise TypeError("unpack_bits expects int32 bit patterns")
    if words.stride(-1) != 1:
        words = words.contiguous()
    shifts = torch.arange(8, dtype=torch.uint8, device=words.device)
    bits = (words.view(torch.uint8)[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], words.shape[-1] * WORD_BITS).to(dtype)


def popcount_u32(x: torch.Tensor) -> torch.Tensor:
    """Population count of every 32-bit word (SWAR), as int32."""
    # the first step works on the logical shift: clear the sign fill
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + ((x >> 4) & 0x0FFFFFFF)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF
