"""Shared helpers of the port's parity tests (tests/test_torch_*.py): one
world built by the JAX package's ``build_database`` feeds both engines."""

import numpy as np
import torch

from raxtax_tpu_torch.convert import database_fields, database_from_numpy

TIPS_PER_WORD = 32


def port_db(jax_db):
    """The port's Database carrying the JAX package's state."""
    return database_from_numpy(database_fields(jax_db))


def to_i32(a: np.ndarray) -> torch.Tensor:
    """uint32 numpy bit patterns -> int32 tensor."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def to_u32(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> uint32 numpy bit patterns."""
    return t.contiguous().numpy().view(np.uint32)


def encode_planes(counts: np.ndarray, n_planes: int) -> np.ndarray:
    """[B, N] int counts -> [B, P, S, 128] uint32 planes, packed layout:
    word (s, lane), bit `bit` holds tip (s*128+lane)*32 + bit."""
    B, N = counts.shape
    assert N % (128 * TIPS_PER_WORD) == 0
    S = N // (128 * TIPS_PER_WORD)
    c = counts.reshape(B, S, 128, TIPS_PER_WORD).astype(np.uint32)
    shifts = np.arange(TIPS_PER_WORD, dtype=np.uint32)
    planes = np.zeros((B, n_planes, S, 128), np.uint32)
    for p in range(n_planes):
        bits = (c >> np.uint32(p)) & np.uint32(1)
        planes[:, p] = (bits << shifts[None, None, None, :]).sum(
            axis=-1, dtype=np.uint32
        )
    return planes
