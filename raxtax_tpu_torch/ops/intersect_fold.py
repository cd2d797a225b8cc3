"""K1 and K2: the postings fold — bit-sliced intersection counters per query.

For every query, the postings bitvector rows ``kmer_major[k]`` of its
distinct k-mers are added up with *vertical counters*: ``planes[b, p, s, l]``
holds bit ``2^p`` of the intersection count of each of the 32 references in
word ``(s, l)``. The planes are the count representation every later stage
reads (``ops/planes.py``); a dense ``[B, num_tips]`` count matrix is never
built.

CUDA kernel: ``csrc/fold_planes.cu`` (``rx_fold_planes``). It replaces the
TPU kernel ``_hs_kernel_fused`` of the JAX package
(``ops/intersect_pallas.py``: ``_hs_planes_fused``). Bound on the GPU:
bytes — every postings row the batch names read once from device memory,
about six logic ops per word. One thread keeps all ``P`` planes of four
adjacent words in registers and folds 16 rows per step with the Harley-Seal
carry-save tree, so every output word is written once and no accumulator
lives in memory. A CTA owns a 512-byte column slice of one query and the
query varies fastest over the grid, so the queries of a slice run together
and share its rows through L2; each thread stages its rows with ``cp.async``
in a shared-memory ring.

K2, the block-sparse fold (:func:`fold_planes_sparse`), CUDA kernel
``csrc/fold_sparse.cu`` (``rx_fold_planes_sparse``), replaces the TPU kernel
``_sparse_kernel`` (``_sparse_planes`` of the JAX package). It reads only
the (k-mer, 8 x 128-word block) pairs that hold postings — the blockwise
image of an inverted-index walk — and yields the same planes as K1, bit for
bit. Bound: bytes, the batch's distinct pairs ``* 4 KB`` read plus the
planes written. The TPU
kernel holds one query's whole accumulator on chip; here the wrapper groups
each query's pairs by block and one CTA owns one (query, block) with its
planes in registers. The TPU limits around that kernel (the sub-batch split
``fold_max`` and the scalar-prefetch size check) belong to its compiler and
are not carried over.

K9, the gathered-rows fold (:func:`fold_planes_gathered`), CUDA kernel
``csrc/fold_rows.cu`` (``rx_fold_rows``), replaces the TPU kernel
``_hs_kernel`` (``_hs_planes`` of the JAX package): the same Harley-Seal
fold over rows that ``index_select`` gathered beforehand into one contiguous
``[B * K, S, 128]`` tensor (the gather is outside the TPU kernel too, so a
torch op takes its place). Bound: bytes, every gathered word read once plus
the planes written. One thread keeps the planes of a ``uint4`` in registers
and walks the query's contiguous rows with the adder tree it shares with K1;
no ids, no step skip (padding slots hold the zero row). The gathered copy
would be ``B * K`` rows at once, so :func:`intersection_planes_gathered`
chunks the batch under a byte budget as the JAX package does.

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
BLOCK_SUB = 8  #: plane rows (of 128 words) per block of the sparse fold
BLOCK_WORDS = BLOCK_SUB * LANE  #: words per block (1,024)
PAIRS_PER_STEP = 16  #: pair lists pad to a multiple of this


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


def prepare_kmer_major_sparse(db, device):
    """Resident matrix plus the block CSR of the sparse fold: ``(kmer_major3
    [65537, S, 128] int32 with S padded to a multiple of 8, blk_ptr int64
    [65538], blk_ids int32 [nnz])``; ``blk_ids[blk_ptr[k]:blk_ptr[k+1]]``
    lists the blocks of k-mer ``k`` that hold a posting. The dense fold
    works on the same block-padded matrix (its extra words are zero)."""
    km = np.asarray(db.kmer_major)
    pad = (-km.shape[1]) % BLOCK_WORDS
    if pad:
        km = np.pad(km, ((0, 0), (0, pad)))
    n_blocks = km.shape[1] // BLOCK_WORDS
    nz = km.reshape(km.shape[0], n_blocks, -1).any(axis=2)
    nz[PAD_ROW, :] = False  # the all-zero padding row has no blocks
    blk_ptr = np.zeros(km.shape[0] + 1, np.int64)
    np.cumsum(nz.sum(axis=1, dtype=np.int64), out=blk_ptr[1:])
    blk_ids = np.nonzero(nz)[1].astype(np.int32)
    t = torch.from_numpy(np.ascontiguousarray(km).view(np.int32)).to(device)
    return t.reshape(t.shape[0], -1, LANE), blk_ptr, blk_ids


def build_pairs(
    kmer_idx: np.ndarray,  # [B, K_pad] int32, PAD_ROW-padded
    blk_ptr: np.ndarray,
    blk_ids: np.ndarray,
    budget: int,
):
    """``(pair_kmer [B, P_pad], pair_blk [B, P_pad], max_pairs, totals
    [B])`` in k-mer order, or None when some query has more than ``budget``
    pairs (the caller then takes the dense fold). Padding pairs point at the
    all-zero ``PAD_ROW``, block 0. One vectorised pass over the batch: the
    concatenated CSR ranges of every query's k-mers."""
    B, _ = kmer_idx.shape
    starts = blk_ptr[kmer_idx]
    counts = (blk_ptr[kmer_idx + 1] - starts).astype(np.int64)
    totals = counts.sum(axis=1)
    max_pairs = int(totals.max(initial=0))
    if max_pairs > budget:
        return None
    p_pad = max(PAIRS_PER_STEP, -(-max_pairs // PAIRS_PER_STEP) * PAIRS_PER_STEP)
    pair_kmer = np.full((B, p_pad), PAD_ROW, np.int32)
    pair_blk = np.zeros((B, p_pad), np.int32)
    n_all = int(totals.sum())
    if n_all:
        flat_c = counts.reshape(-1)
        src = np.repeat(np.arange(flat_c.size), flat_c)  # (query, slot) of a pair
        first = np.cumsum(flat_c) - flat_c  # first pair of each (query, slot)
        within = np.arange(n_all) - first[src]
        row = src // kmer_idx.shape[1]
        col = np.arange(n_all) - (np.cumsum(totals) - totals)[row]
        pair_blk[row, col] = blk_ids[starts.reshape(-1)[src] + within]
        pair_kmer[row, col] = kmer_idx.reshape(-1)[src]
    return pair_kmer, pair_blk, max_pairs, totals


def _csa(a, b, c):
    """Full adder on bit vectors: (sum, carry)."""
    ab = a ^ b
    return ab ^ c, (a & b) | (ab & c)


def _hs_fold_plain(row_of, B: int, W: int, steps: int, n_high: int, device):
    """The carry-save arithmetic of the dense folds on whole ``[B, W]`` bit
    vectors: ``row_of(k)`` is the ``[B, W]`` row of slot ``k``, folded 16
    slots per step. Returns ``[B, 4 + n_high, W]``."""
    zero = torch.zeros((B, W), dtype=torch.int32, device=device)
    ones, twos, fours, eights = zero, zero, zero, zero
    high = [zero] * n_high
    for step in range(steps):
        x = [row_of(step * HS_BLOCK + i) for i in range(HS_BLOCK)]
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
    return torch.stack([ones, twos, fours, eights] + high, dim=1)


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
    slot = torch.arange(k_pad, device=dev)[None, :]
    idx = torch.where(slot < kcounts[:, None], kmer_idx.long(), PAD_ROW)
    steps = int(-(-int(kcounts.max().item() if B else 0) // HS_BLOCK))
    planes = _hs_fold_plain(
        lambda k: km[idx[:, k]] if k < k_pad else zero,
        B, W, steps, n_high, dev,
    )
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


def fold_planes_gathered_plain(
    rows: torch.Tensor,  # [B * K_pad, S, 128] int32 gathered rows
    batch: int,
    n_high: int,
) -> torch.Tensor:  # [B, 4 + n_high, S, 128] int32
    """Plain PyTorch version of K9: the carry-save tree over the contiguous
    rows of each query, 16 per step, every slot read."""
    total, S, lanes = rows.shape
    k_pad = total // batch if batch else 0
    r = rows.reshape(batch, k_pad, S * lanes)
    planes = _hs_fold_plain(
        lambda k: r[:, k], batch, S * lanes, k_pad // HS_BLOCK, n_high,
        rows.device,
    )
    return planes.reshape(batch, TIERS + n_high, S, lanes)


_ROWS_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
]


def fold_planes_gathered(
    rows: torch.Tensor,  # [B * K_pad, S, 128] int32 gathered rows
    batch: int,
    n_high: int,
) -> torch.Tensor:  # [B, 4 + n_high, S, 128] int32 counter planes
    """K9: counter planes from rows gathered beforehand, ``K_pad`` (a
    multiple of 16) consecutive rows per query, zero rows in padding slots.
    Same planes as :func:`fold_planes` on the id list that gathered them. A
    CUDA tensor runs the kernel (or raises); a CPU tensor takes the plain
    version."""
    if rows.ndim != 3 or rows.shape[2] != LANE:
        raise ValueError("rows must be [B * K_pad, S, 128]")
    if batch <= 0 or rows.shape[0] % batch:
        raise ValueError("the row count must be a multiple of the batch")
    k_pad = rows.shape[0] // batch
    if k_pad % HS_BLOCK:
        raise ValueError("K_pad must be a multiple of 16")
    if not 1 <= n_high <= 12:
        raise ValueError("fold_planes_gathered: n_high must be in [1, 12]")
    if not rows.is_cuda:
        return fold_planes_gathered_plain(rows, batch, n_high)
    _build.require_cuda_tensor(rows, torch.int32, "rows")
    fn = _build.entry("fold_rows", "rx_fold_rows", _ROWS_ARGTYPES)
    _, S, lanes = rows.shape
    out = torch.empty(
        (batch, TIERS + n_high, S, lanes), dtype=torch.int32,
        device=rows.device,
    )
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        fold_planes_gathered.launches += 1
        code = fn(
            rows.data_ptr(), out.data_ptr(), batch, k_pad, S * lanes, n_high,
            stream,
        )
    _build.check("fold_rows", code, "fold_planes_gathered")
    return out


#: kernel launches made by :func:`fold_planes_gathered`
fold_planes_gathered.launches = 0

#: most bytes of gathered rows alive at once (the JAX package's budget)
GATHER_BUDGET_BYTES = 1 << 30


def gather_chunk(batch: int, k_pad: int, row_bytes: int,
                 budget_bytes: int = GATHER_BUDGET_BYTES) -> int:
    """Queries per gather + fold step under the byte budget."""
    return max(1, min(batch, budget_bytes // max(k_pad * row_bytes, 1)))


def intersection_planes_gathered(
    kmer_idx: torch.Tensor,  # [B, K_pad] int32, PAD_ROW-padded
    kmer_major3: torch.Tensor,  # [65537, S, 128] int32
    max_count: int | None = None,
    budget_bytes: int = GATHER_BUDGET_BYTES,
) -> torch.Tensor:  # [B, P, S, 128] int32
    """The gathered fold of a batch: per chunk of queries, one
    ``index_select`` of their rows out of the resident matrix and one K9
    launch; the chunk keeps the gathered copy under ``budget_bytes`` (it
    would be ``B * K_pad`` rows otherwise)."""
    B, k_pad = kmer_idx.shape
    if k_pad % HS_BLOCK:
        raise ValueError("K_pad must be a multiple of 16")
    n_high = n_high_for(max_count if max_count is not None else k_pad)
    _, S, lanes = kmer_major3.shape
    b_sub = gather_chunk(B, k_pad, S * lanes * 4, budget_bytes)
    outs = []
    for lo in range(0, B, b_sub):
        ids = kmer_idx[lo : lo + b_sub].reshape(-1).long()
        rows = kmer_major3.index_select(0, ids)
        outs.append(fold_planes_gathered(rows, ids.numel() // k_pad, n_high))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)


def group_pairs_by_block(
    pair_kmer: torch.Tensor,  # [B, P_pad] int32
    pair_blk: torch.Tensor,  # [B, P_pad] int32
    totals: torch.Tensor,  # [B] int32 real pairs per query
    n_blocks: int,
):
    """Each query's real pairs regrouped by block: ``(kmer_by_blk [B, P_pad]
    int32, blk_off [B, n_blocks + 1] int32)`` with block ``j`` of query
    ``b`` at ``kmer_by_blk[b, blk_off[b, j]:blk_off[b, j + 1]]``. Padding
    pairs sort behind the last block. The count does not depend on the order
    of the adds, so the sort need not be stable."""
    B, p_pad = pair_kmer.shape
    dev = pair_kmer.device
    slot = torch.arange(p_pad, device=dev)[None, :]
    key = torch.where(slot < totals[:, None], pair_blk, n_blocks)
    key, order = torch.sort(key, dim=1)
    kmer_by_blk = torch.gather(pair_kmer, 1, order)
    bounds = torch.arange(n_blocks + 1, dtype=key.dtype, device=dev)
    blk_off = torch.searchsorted(key, bounds[None, :].expand(B, -1).contiguous())
    return kmer_by_blk.contiguous(), blk_off.to(torch.int32).contiguous()


def fold_planes_sparse_plain(
    pair_kmer: torch.Tensor,
    pair_blk: torch.Tensor,
    totals: torch.Tensor,
    kmer_major3: torch.Tensor,
    n_planes: int,
) -> torch.Tensor:
    """Plain PyTorch version of K2: one pair per query and step, its block
    of postings added into the query's binary counter planes at that block
    with a ripple carry. Steps at or past a query's real pair count add the
    zero row."""
    B, p_pad = pair_kmer.shape
    _, S, lanes = kmer_major3.shape
    n_blocks = S // BLOCK_SUB
    dev = pair_kmer.device
    km = kmer_major3.reshape(kmer_major3.shape[0], n_blocks, BLOCK_WORDS)
    acc = torch.zeros(
        (n_planes, B, n_blocks, BLOCK_WORDS), dtype=torch.int32, device=dev
    )
    slot = torch.arange(p_pad, device=dev)[None, :]
    live = slot < totals[:, None]
    kmer = torch.where(live, pair_kmer, 0).long()
    blk = torch.where(live, pair_blk, 0).long()
    q = torch.arange(B, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    for j in range(int(totals.max().item()) if B else 0):
        carry = torch.where(live[:, j, None], km[kmer[:, j], blk[:, j]], zero)
        cur = acc[:, q, blk[:, j]]  # [P, B, 1024]
        new = torch.empty_like(cur)
        for p in range(n_planes):
            new[p] = cur[p] ^ carry
            carry = cur[p] & carry
        acc[:, q, blk[:, j]] = new
    return acc.permute(1, 0, 2, 3).reshape(B, n_planes, S, lanes).contiguous()


_SPARSE_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_void_p,
]


def fold_planes_sparse(
    pair_kmer: torch.Tensor,  # [B, P_pad] int32 from build_pairs
    pair_blk: torch.Tensor,  # [B, P_pad] int32
    totals: torch.Tensor,  # [B] int32 real pairs per query
    kmer_major3: torch.Tensor,  # from prepare_kmer_major_sparse
    max_count: int,
) -> torch.Tensor:  # [B, P, S, 128] int32 binary counter planes
    """Block-sparse variant of :func:`fold_planes`: identical planes, memory
    traffic proportional to the postings' blockwise occupancy instead of
    ``k-mers * num_tips``. A CUDA tensor runs the kernel (or raises); a CPU
    tensor takes the plain version."""
    n_planes = TIERS + n_high_for(max_count)
    if kmer_major3.ndim != 3 or kmer_major3.shape[2] != LANE:
        raise ValueError("kmer_major3 must be [rows, S, 128]")
    if kmer_major3.shape[1] % BLOCK_SUB:
        raise ValueError("the sparse fold needs S padded to a multiple of 8")
    if pair_kmer.shape != pair_blk.shape or pair_kmer.ndim != 2:
        raise ValueError("pair_kmer and pair_blk must both be [B, P_pad]")
    if not (
        pair_kmer.device == pair_blk.device == totals.device
        == kmer_major3.device
    ):
        raise ValueError("fold_planes_sparse: tensors on different devices")
    if not pair_kmer.is_cuda:
        return fold_planes_sparse_plain(
            pair_kmer, pair_blk, totals, kmer_major3, n_planes
        )
    _build.require_cuda_tensor(pair_kmer, torch.int32, "pair_kmer")
    _build.require_cuda_tensor(pair_blk, torch.int32, "pair_blk")
    _build.require_cuda_tensor(totals, torch.int32, "totals")
    _build.require_cuda_tensor(kmer_major3, torch.int32, "kmer_major3")
    if n_planes > 16:
        raise ValueError("fold_planes_sparse: more than 16 planes")
    B, p_pad = pair_kmer.shape
    _, S, lanes = kmer_major3.shape
    kmer_by_blk, blk_off = group_pairs_by_block(
        pair_kmer, pair_blk, totals, S // BLOCK_SUB
    )
    fn = _build.entry("fold_sparse", "rx_fold_planes_sparse", _SPARSE_ARGTYPES)
    out = torch.empty(
        (B, n_planes, S, lanes), dtype=torch.int32, device=pair_kmer.device
    )
    with torch.cuda.device(pair_kmer.device):
        stream = torch.cuda.current_stream().cuda_stream
        fold_planes_sparse.launches += 1
        code = fn(
            kmer_by_blk.data_ptr(), blk_off.data_ptr(),
            kmer_major3.data_ptr(), out.data_ptr(), B, p_pad, S * lanes,
            n_planes, stream,
        )
    _build.check("fold_sparse", code, "fold_planes_sparse")
    return out


#: kernel launches made by :func:`fold_planes_sparse`
fold_planes_sparse.launches = 0


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
