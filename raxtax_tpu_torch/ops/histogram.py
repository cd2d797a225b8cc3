"""Exact intersection-size histograms of a dense count matrix.

The probability model needs, per query, the histogram of intersection sizes
over all references (src/prob.rs:13-19). The JAX package computes it as a
hi/lo one-hot matrix product because its chip has no fast scatter; by
semantics it is a per-row bincount, which PyTorch has, so the port is by
semantics and the product is not carried over.
"""

from __future__ import annotations

import torch


def intersection_histogram(counts: torch.Tensor, s_max: int) -> torch.Tensor:
    """``[B, N]`` integer-valued counts -> ``[B, s_max]`` int32 histogram.
    Counts at or past ``s_max`` land in no bucket (as a one-hot that matches
    nothing)."""
    B = counts.shape[0]
    c = counts.long()
    ok = (c >= 0) & (c < s_max)
    rows = torch.arange(B, device=counts.device)[:, None]
    # a dropped entry goes to a spare bucket behind the last row
    key = torch.where(ok, c + rows * s_max, B * s_max)
    hist = torch.bincount(key.reshape(-1), minlength=B * s_max + 1)
    return hist[: B * s_max].reshape(B, s_max).to(torch.int32)
