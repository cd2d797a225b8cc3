"""K1: the postings fold — bit-sliced intersection counters per query.

For every query, the postings bitvector rows ``kmer_major[k]`` of its
distinct k-mers are added up with *vertical counters*: ``planes[b, p, s, l]``
holds bit ``2^p`` of the intersection count of each of the 32 references in
word ``(s, l)``. The planes are the count representation every later stage
reads (``ops/planes.py``); a dense ``[B, num_tips]`` count matrix is never
built.

CUDA kernel: ``csrc/fold_planes.cu`` (``rx_fold_planes``). It replaces the
TPU kernel ``_hs_kernel_fused`` of the JAX package
(``ops/intersect_pallas.py``: ``_hs_planes_fused``). Bound on the GPU:
bytes — ``B * K * W`` postings words are read, about six logic ops each. One
thread keeps all ``P`` planes of four adjacent words in registers and folds
16 rows per step with the Harley-Seal carry-save tree, so every output word
is written once and no accumulator lives in memory.

Planes are carried as ``int32`` bit patterns (PyTorch has no shifts on
``uint32`` for CPU tensors); view them as ``uint32`` only in numpy.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import _build
from .planes import decode_counts_bitmajor, probs_to_tip_order

HS_BLOCK = 16  #: rows folded per carry-save step
LANE = 128  #: words per plane row; the word count pads to a multiple
PAD_ROW = 0x10000  #: index of the all-zero padding row (65536)
TIERS = 4  #: ones/twos/fours/eights tiers (weights 1, 2, 4, 8)
WORD_BITS = 32


def n_high_for(max_count: int) -> int:
    """Binary planes above the four tiers for counts up to ``max_count``."""
    return max(int(math.ceil(math.log2(max_count + 1))) - TIERS, 1)


def prepare_kmer_major(db, device) -> torch.Tensor:
    """Resident copy of the k-mer-major postings matrix,
    ``[65537, S, 128] int32`` (word count padded to a multiple of 128)."""
    km = np.asarray(db.kmer_major)
    pad = (-km.shape[1]) % LANE
    if pad:
        km = np.pad(km, ((0, 0), (0, pad)))
    km = np.ascontiguousarray(km).view(np.int32)
    t = torch.from_numpy(km).to(device)
    return t.reshape(t.shape[0], -1, LANE)


def _csa(a, b, c):
    """Full adder on bit vectors: (sum, carry)."""
    ab = a ^ b
    return ab ^ c, (a & b) | (ab & c)


def fold_planes_plain(
    kmer_idx: torch.Tensor,  # [B, K_pad] int32, PAD_ROW-padded
    kcounts: torch.Tensor,  # [B] int32 real distinct-k-mer counts
    kmer_major3: torch.Tensor,  # [65537, S, 128] int32
    n_high: int,
) -> torch.Tensor:  # [B, 4 + n_high, S, 128] int32
    """Plain PyTorch version of the fold: the same carry-save arithmetic on
    whole ``[B, W]`` bit vectors, 16 gathered rows per step. Slots at or
    past a query's real k-mer count contribute zero rows."""
    B, k_pad = kmer_idx.shape
    _, S, lanes = kmer_major3.shape
    W = S * lanes
    km = kmer_major3.reshape(kmer_major3.shape[0], W)
    dev = kmer_idx.device
    zero = torch.zeros((B, W), dtype=torch.int32, device=dev)
    ones, twos, fours, eights = zero, zero, zero, zero
    high = [zero] * n_high
    idx = kmer_idx.long()
    slot = torch.arange(k_pad, device=dev)[None, :]
    idx = torch.where(slot < kcounts[:, None], idx, PAD_ROW)
    steps = int(-(-int(kcounts.max().item() if B else 0) // HS_BLOCK))
    for step in range(steps):
        x = []
        for i in range(HS_BLOCK):
            k = step * HS_BLOCK + i
            x.append(km[idx[:, k]] if k < k_pad else zero)
        ones, t0 = _csa(ones, x[0], x[1])
        ones, t1 = _csa(ones, x[2], x[3])
        twos, f0 = _csa(twos, t0, t1)
        ones, t0 = _csa(ones, x[4], x[5])
        ones, t1 = _csa(ones, x[6], x[7])
        twos, f1 = _csa(twos, t0, t1)
        fours, e0 = _csa(fours, f0, f1)
        ones, t0 = _csa(ones, x[8], x[9])
        ones, t1 = _csa(ones, x[10], x[11])
        twos, f0 = _csa(twos, t0, t1)
        ones, t0 = _csa(ones, x[12], x[13])
        ones, t1 = _csa(ones, x[14], x[15])
        twos, f1 = _csa(twos, t0, t1)
        fours, e1 = _csa(fours, f0, f1)
        eights, carry = _csa(eights, e0, e1)
        for p in range(n_high):
            plane = high[p]
            high[p] = plane ^ carry
            carry = plane & carry
    planes = torch.stack([ones, twos, fours, eights] + high, dim=1)
    return planes.reshape(B, TIERS + n_high, S, lanes)


_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_void_p,
]


def _launch(kmer_idx, kcounts, kmer_major3, n_high):
    fn = _build.entry("fold_planes", "rx_fold_planes", _ARGTYPES)
    B, k_pad = kmer_idx.shape
    _, S, lanes = kmer_major3.shape
    out = torch.empty(
        (B, TIERS + n_high, S, lanes), dtype=torch.int32,
        device=kmer_idx.device,
    )
    with torch.cuda.device(kmer_idx.device):
        stream = torch.cuda.current_stream().cuda_stream
        fold_planes.launches += 1
        code = fn(
            kmer_idx.data_ptr(), kcounts.data_ptr(), kmer_major3.data_ptr(),
            out.data_ptr(), B, k_pad, S * lanes, n_high, stream,
        )
    _build.check("fold_planes", code, "fold_planes")
    return out


def fold_planes(
    kmer_idx: torch.Tensor,  # [B, K_pad] int32, PAD_ROW-padded
    kcounts: torch.Tensor,  # [B] int32 real distinct-k-mer counts
    kmer_major3: torch.Tensor,  # [65537, S, 128] int32
    max_count: int | None = None,
) -> torch.Tensor:  # [B, P, S, 128] int32 counter planes, plane i = 2^i
    """Counter planes of the intersection counts. ``max_count`` (default
    ``K_pad``) sizes the plane count ``P = 4 + n_high``. A CUDA tensor runs
    the kernel (or raises); a CPU tensor takes the plain version."""
    B, k_pad = kmer_idx.shape
    n_high = n_high_for(max_count if max_count is not None else k_pad)
    if kmer_major3.ndim != 3 or kmer_major3.shape[2] != LANE:
        raise ValueError("kmer_major3 must be [rows, S, 128]")
    if not (kmer_idx.device == kcounts.device == kmer_major3.device):
        raise ValueError("fold_planes: tensors on different devices")
    if not kmer_idx.is_cuda:
        return fold_planes_plain(kmer_idx, kcounts, kmer_major3, n_high)
    _build.require_cuda_tensor(kmer_idx, torch.int32, "kmer_idx")
    _build.require_cuda_tensor(kcounts, torch.int32, "kcounts")
    _build.require_cuda_tensor(kmer_major3, torch.int32, "kmer_major3")
    if n_high > 12:
        raise ValueError("fold_planes: more than 16 planes are not supported")
    return _launch(kmer_idx, kcounts, kmer_major3, n_high)


#: kernel launches made by :func:`fold_planes` (plain runs do not count)
fold_planes.launches = 0


def planes_to_counts(
    planes: torch.Tensor, num_tips: int, layout: str = "packed"
) -> torch.Tensor:
    """``[B, P, S, 128]`` planes -> ``[B, num_tips]`` int32 counts in tip
    order. ``layout`` is the tip -> (word, bit) mapping of the postings
    matrix: packed = (tip // 32, tip % 32), flat = (tip % W, tip // W)."""
    B = planes.shape[0]
    c = decode_counts_bitmajor(planes)  # [B, 32, S, 128]
    if layout == "flat":
        return c.reshape(B, -1)[:, :num_tips]
    return probs_to_tip_order(c)[:, :num_tips]
