"""K10: the stream fold — counter planes from row-sorted (query, row) pairs.

Third way to build the counter planes of ``ops/intersect_fold.py``: the
batch's (query, k-mer) slots are sorted by postings row, each row is loaded
once per group of queries and applied to every query of the group that holds
that k-mer, and the planes stay on chip until they are complete. Same planes
as K1 / K2 / K9, bit for bit, in plain binary form.

CUDA kernel: ``csrc/fold_stream.cu`` (``rx_fold_stream``). It replaces the
TPU kernel ``_stream_kernel`` of the JAX package
(``ops/intersect_stream.py``: ``_stream_planes``). Bound on the GPU: bytes —
the rows some query of the batch uses, read once, plus the planes written.
The planes do not compose under atomics, so one warp owns a (512-byte
column slice, query group) and keeps each query's planes of its words in
registers, as K1's carry-save adder tiers; the group is the fastest grid
dimension, so the groups walking one slice keep step and a row slice they
share comes from L2 after its first reader. The warp turns its group's
pairs into (row, query mask) runs and stages the rows ahead with
``cp.async``: a row is loaded once per group, and each stage of 16 runs
goes through one adder-tree step per query of the group that holds any of
them.

What is not carried over from the TPU module: its row blocks of 256 with
block pointers, the pair-count buckets, the row padding of the matrix and
the column-tile search under an on-chip memory budget exist for that chip's
memory and compiler. Here padding slots are left out of a group's pair
range instead of being sent to a zero row, and the resident matrix of the
other folds is used as it is.

:func:`build_pairs` is written with torch ops and runs where its input
lies: on the device beside the kernel, on the CPU in the tests.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .intersect_fold import LANE, PAD_ROW

ROW_BITS = 17  #: low bits of a packed pair hold the row id (rows <= 65536)
#: queries per group (the kernel takes 1 or 2). On an H100 at 1,000,000
#: references (``tools/kernel_ab.py``, PERF.md) groups of two fold a batch
#: of one family's queries, which share most rows, 16 % faster than groups
#: of one, and a batch of unrelated queries 9 % slower; groups of four and
#: eight folded the unrelated batch slower still
GROUP_SIZE = 2
MAX_GROUP = 2
MAX_PLANES = 16


def n_planes_for(max_count: int) -> int:
    """Binary planes for counts up to ``max_count`` (the JAX module's rule;
    equal to ``4 + n_high_for(max_count)`` from five planes on)."""
    return max(int(math.ceil(math.log2(max_count + 1))), 1)


def stream_group_size(batch: int, n_planes: int) -> int:
    """Queries whose planes one warp keeps in registers (``n_planes`` is
    the engine's argument; the kernel sizes its registers from it)."""
    return max(1, min(int(batch), GROUP_SIZE))


def build_pairs(kmer_idx: torch.Tensor, group_size: int):
    """The pair lists of a batch: ``(pair_q int32 [B * K_pad], pair_row
    int32 [B * K_pad], group_lo int32 [G], group_hi int32 [G])`` with ``G =
    ceil(B / group_size)``.

    Every (query, slot) of ``kmer_idx`` (``[B, K_pad]`` int32,
    ``PAD_ROW``-padded) is one pair, sorted by (group of the query, row,
    query) with a stable sort. Group ``g`` owns the pairs
    ``[group_lo[g], group_hi[g])``; its padding slots (row ``PAD_ROW``, the
    all-zero row) sort behind them and belong to no range. With one group
    the order is the JAX package's: rows ascending, queries ascending within
    a row. Fixed shapes, no host synchronisation."""
    B, k_pad = kmer_idx.shape
    dev = kmer_idx.device
    n_groups = -(-B // group_size) if B else 0
    rows = kmer_idx.reshape(-1).long()
    queries = torch.arange(B, device=dev).repeat_interleave(k_pad)
    key = ((queries // group_size) << ROW_BITS) | torch.clamp(rows, max=PAD_ROW)
    key, order = torch.sort(key, stable=True)
    starts = torch.arange(n_groups, device=dev) << ROW_BITS
    group_lo = torch.searchsorted(key, starts)
    group_hi = torch.searchsorted(key, starts + PAD_ROW)
    return (
        queries[order].to(torch.int32),
        (key & ((1 << ROW_BITS) - 1)).to(torch.int32),
        group_lo.to(torch.int32),
        group_hi.to(torch.int32),
    )


def fold_planes_stream_plain(
    pair_q: torch.Tensor,
    pair_row: torch.Tensor,
    kmer_major3: torch.Tensor,
    batch: int,
    n_planes: int,
) -> torch.Tensor:
    """Plain PyTorch version of K10: every query's rows in ascending row
    order, one row per query and step added into the query's binary counter
    planes with a ripple carry. Every query owns the same number of pairs
    (its padding slots add the zero row)."""
    _, S, lanes = kmer_major3.shape
    W = S * lanes
    dev = pair_q.device
    km = kmer_major3.reshape(kmer_major3.shape[0], W)
    k_pad = pair_q.numel() // batch if batch else 0
    by_query = torch.argsort(pair_q, stable=True)
    rows = pair_row[by_query].reshape(batch, k_pad).long()
    acc = [
        torch.zeros((batch, W), dtype=torch.int32, device=dev)
        for _ in range(n_planes)
    ]
    real = int((rows < PAD_ROW).sum(dim=1).max().item()) if batch else 0
    for j in range(real):  # padding rows sort last within a query
        carry = km[rows[:, j]]
        for p in range(n_planes):
            plane = acc[p]
            acc[p] = plane ^ carry
            carry = plane & carry
    return torch.stack(acc, dim=1).reshape(batch, n_planes, S, lanes)


_STREAM_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_void_p,
]


def fold_planes_stream(
    pair_q: torch.Tensor,  # [B * K_pad] int32 from build_pairs
    pair_row: torch.Tensor,  # [B * K_pad] int32
    group_lo: torch.Tensor,  # [G] int32
    group_hi: torch.Tensor,  # [G] int32
    kmer_major3: torch.Tensor,  # [65537, S, 128] int32
    batch: int,
    group_size: int,
    n_planes: int,
) -> torch.Tensor:  # [B, n_planes, S, 128] int32 binary counter planes
    """K10: counter planes from the pair lists of :func:`build_pairs` (made
    with the same ``group_size``). ``n_planes`` must hold the largest count.
    The kernel takes groups of up to ``MAX_GROUP`` queries. A CUDA tensor
    runs the kernel (or raises); a CPU tensor takes the plain version."""
    if kmer_major3.ndim != 3 or kmer_major3.shape[2] != LANE:
        raise ValueError("kmer_major3 must be [rows, S, 128]")
    if kmer_major3.shape[0] > (1 << ROW_BITS):
        raise ValueError("fold_planes_stream: more rows than a pair can name")
    if pair_q.shape != pair_row.shape or pair_q.ndim != 1:
        raise ValueError("pair_q and pair_row must be flat and equally long")
    if batch <= 0 or pair_q.numel() % batch:
        raise ValueError("the pair count must be a multiple of the batch")
    n_groups = -(-batch // group_size)
    if group_lo.shape != (n_groups,) or group_hi.shape != (n_groups,):
        raise ValueError("group_lo / group_hi do not match the group size")
    if not 1 <= n_planes <= MAX_PLANES:
        raise ValueError(f"fold_planes_stream: 1 to {MAX_PLANES} planes")
    tensors = (pair_q, pair_row, group_lo, group_hi, kmer_major3)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("fold_planes_stream: tensors on different devices")
    if not pair_q.is_cuda:
        return fold_planes_stream_plain(
            pair_q, pair_row, kmer_major3, batch, n_planes
        )
    for t, name in zip(tensors, ("pair_q", "pair_row", "group_lo",
                                 "group_hi", "kmer_major3")):
        _build.require_cuda_tensor(t, torch.int32, name)
    if not 1 <= group_size <= MAX_GROUP:
        raise ValueError(
            f"fold_planes_stream: groups of 1 to {MAX_GROUP} queries"
        )
    # a pair as the kernel reads it: (query within its group, row)
    packed = ((pair_q % group_size) << ROW_BITS) | pair_row
    fn = _build.entry("fold_stream", "rx_fold_stream", _STREAM_ARGTYPES)
    _, S, lanes = kmer_major3.shape
    out = torch.empty(
        (batch, n_planes, S, lanes), dtype=torch.int32, device=pair_q.device
    )
    with torch.cuda.device(pair_q.device):
        stream = torch.cuda.current_stream().cuda_stream
        fold_planes_stream.launches += 1
        code = fn(
            packed.data_ptr(), group_lo.data_ptr(), group_hi.data_ptr(),
            kmer_major3.data_ptr(), out.data_ptr(), batch, n_planes,
            S * lanes, group_size, stream,
        )
    _build.check("fold_stream", code, "fold_planes_stream")
    return out


#: kernel launches made by :func:`fold_planes_stream`
fold_planes_stream.launches = 0


def intersection_planes_stream(
    kmer_idx: torch.Tensor,  # [B, K_pad] int32, PAD_ROW-padded
    kmer_major3: torch.Tensor,  # [65537, S, 128] int32
    max_count: int | None = None,
) -> torch.Tensor:  # [B, P, S, 128] int32
    """The stream fold of a batch: the pair lists, then K10."""
    B, k_pad = kmer_idx.shape
    n_planes = n_planes_for(max_count if max_count is not None else k_pad)
    group = stream_group_size(B, n_planes)
    pair_q, pair_row, group_lo, group_hi = build_pairs(kmer_idx, group)
    return fold_planes_stream(
        pair_q, pair_row, group_lo, group_hi, kmer_major3, B, group, n_planes
    )
