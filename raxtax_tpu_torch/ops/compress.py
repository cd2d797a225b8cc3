"""The planes wire: exact lossless counts for host replays.

The host replays of the double-f32 path (rounding-boundary confidences,
marginal descents) need the per-tip intersection counts of the affected
queries. The counts leave the device as

- ``lo4``: the four tier planes (ones, twos, fours, eights) as they are —
  the low nibble of every count is already bit-sliced there; and
- an exact overflow list per query: ``(tip, count)`` pairs for the counts
  above 15, ascending by tip, in a fixed ``budget`` of slots.

Host reconstruction is exact whenever a query's overflow count fits the
budget; callers decode the full planes for the queries where
``n_over > budget``.

Port of ``compress_planes`` / ``decode_lo4`` / ``decompress_planes_rows`` of
the JAX package's ``ops/compress.py``. The overflow counts come from K8
(:func:`~.planes.planes_high_counts`). The TPU has no compaction primitive
and extracts the list with a tiled top-k that can under-cover (``covered``,
``spread``); here ``torch.nonzero`` over ``high > 0`` compacts it, so the
list always holds ``min(n_over, budget)`` entries and neither notion exists.

The nibble wire of the dense backend (``compress_counts`` /
``decompress_rows``) is the same idea on a ``[B, N]`` count matrix: counts
clamped at 15, eight tips per 32-bit word, plus the same overflow list. The
JAX package cuts that list with ``top_k`` and a re-sort; ``torch.nonzero``
takes their place here too, and unused slots hold the sentinel and 0 where
the JAX arrays hold leftovers that no consumer reads.
"""

from __future__ import annotations

import numpy as np
import torch

from .planes import decode_plane_rows, planes_high_counts, probs_to_tip_order

OVER_BUDGET = 1024  #: default overflow slots per query
OVER_SENTINEL = 2**30  #: tip index of an unused overflow slot


def _overflow_lists(high: torch.Tensor, budget: int):
    """``(over_idx, over_val, n_over)`` from ``[B, N]`` int32 counts that
    are 0 wherever the count is at most 15: per row the positions of the
    non-zero entries in ascending order and their values, in ``budget``
    slots; unused slots carry :data:`OVER_SENTINEL` and 0."""
    B = high.shape[0]
    dev = high.device
    rows, tips = torch.nonzero(high > 0, as_tuple=True)  # row-major order
    n_over = torch.bincount(rows, minlength=B)
    first = torch.cumsum(n_over, 0) - n_over
    pos = torch.arange(rows.numel(), device=dev) - first[rows]
    keep = pos < budget
    rows, tips, pos = rows[keep], tips[keep], pos[keep]
    over_idx = torch.full(
        (B, budget), OVER_SENTINEL, dtype=torch.int32, device=dev
    )
    over_val = torch.zeros((B, budget), dtype=torch.int32, device=dev)
    over_idx[rows, pos] = tips.to(torch.int32)
    over_val[rows, pos] = high[rows, tips]
    return over_idx, over_val, n_over.to(torch.int32)


def compress_planes(
    planes: torch.Tensor,  # [B, P, S, 128] int32
    budget: int = OVER_BUDGET,
    layout: str = "packed",
):
    """``(lo4 int32 [B, 4, S, 128], over_idx int32 [B, budget], over_val
    int32 [B, budget], n_over int32 [B])``.

    Per query ``over_idx`` lists the tips with a count above 15 in ascending
    order, in the layout's tip coordinates, ``over_val`` their counts (at
    most 65,535; carried as int32 because PyTorch has no integer ops on
    uint16, narrowed to u16 where the host decoders take them). Slots past
    ``min(n_over, budget)`` carry :data:`OVER_SENTINEL` and 0, so a
    device-side scatter drops them as out of range. ``n_over`` is the exact
    number of such tips, whether or not they fit the budget."""
    B = planes.shape[0]
    lo4 = planes[:, :4]
    high_bm = planes_high_counts(planes)
    if layout == "flat":
        # the bit-major expansion already enumerates tips in taxonomy order
        high = high_bm.reshape(B, -1)
    else:
        high = probs_to_tip_order(high_bm)
    over_idx, over_val, n_over = _overflow_lists(high, budget)
    return lo4, over_idx, over_val, n_over


def decode_lo4(
    lo4_row: np.ndarray, num_tips: int, layout: str = "packed"
) -> np.ndarray:
    """``[4, S, 128]`` u32 tier planes -> the u16 low nibbles of the counts
    (the overflow list restores the counts above 15)."""
    t = torch.from_numpy(np.ascontiguousarray(lo4_row, np.uint32).view(np.int32))
    row = decode_plane_rows(t[None], [0], layout)
    return row[0, :num_tips].numpy().astype(np.uint16)


def decompress_planes_rows(
    lo4: np.ndarray,  # [B, 4, S, 128] u32
    over_idx: np.ndarray,
    over_val: np.ndarray,
    n_over: np.ndarray,
    rows: list[int],
    num_tips: int,
    budget: int = OVER_BUDGET,
    layout: str = "packed",
) -> tuple[np.ndarray, list[int]]:
    """Reconstruct the selected u16 count rows on the host. Returns
    ``(counts u16 [len(rows), num_tips], over_budget_rows)``; the positions
    in ``rows`` listed in ``over_budget_rows`` overflowed the budget and are
    NOT exact."""
    out = np.zeros((len(rows), num_tips), np.uint16)
    over_budget = []
    for i, b in enumerate(rows):
        out[i] = decode_lo4(lo4[b], num_tips, layout)
        n = int(n_over[b])
        if n > budget:
            over_budget.append(i)
            continue
        out[i, over_idx[b, :n]] = over_val[b, :n]
    return out, over_budget


_NIBBLE_SHIFTS = np.arange(8, dtype=np.uint32) * 4


def compress_counts(counts: torch.Tensor, budget: int = OVER_BUDGET):
    """``counts [B, N]`` f32 (exact integers) -> ``(plane int32 [B,
    ceil(N / 8)], over_idx int32 [B, budget], over_val int32 [B, budget],
    n_over int32 [B])``: the nibble wire. ``plane`` packs the counts clamped
    at 15, eight tips per word (tip ``8 w + j`` in bits ``4 j .. 4 j + 3``);
    the overflow list is that of :func:`compress_planes`, in tip order."""
    B, N = counts.shape
    ci = counts.to(torch.int32)
    lo = torch.clamp(ci, max=15)
    pad = (-N) % 8
    if pad:
        lo = torch.nn.functional.pad(lo, (0, pad))
    shifts = torch.arange(8, dtype=torch.int32, device=counts.device) * 4
    # disjoint nibbles: the sum is their OR (and wraps into the sign bit
    # like the unsigned sum it stands for)
    plane = (lo.reshape(B, -1, 8) << shifts).sum(dim=2, dtype=torch.int32)
    high = torch.where(ci > 15, ci, torch.zeros_like(ci))
    return (plane, *_overflow_lists(high, budget))


def decompress_rows(
    plane: np.ndarray,  # [B, ceil(N / 8)] u32
    over_idx: np.ndarray,
    over_val: np.ndarray,
    n_over: np.ndarray,
    rows: list[int],
    num_tips: int,
    budget: int = OVER_BUDGET,
) -> tuple[np.ndarray, list[int]]:
    """Reconstruct the selected u16 count rows of the nibble wire on the
    host. Returns ``(counts u16 [len(rows), num_tips], over_budget_rows)``;
    the positions in ``rows`` listed in ``over_budget_rows`` overflowed the
    budget and are NOT exact."""
    sel = np.asarray(rows, dtype=np.int64)
    p = np.ascontiguousarray(plane).view(np.uint32)[sel]
    out = (
        (p[:, :, None] >> _NIBBLE_SHIFTS[None, None, :]) & np.uint32(15)
    ).astype(np.uint16)
    out = out.reshape(len(rows), -1)[:, :num_tips]
    over_budget = []
    for i, b in enumerate(sel):
        n = int(n_over[b])
        if n > budget:
            over_budget.append(i)
            continue
        out[i, over_idx[b, :n]] = over_val[b, :n]
    return out, over_budget
