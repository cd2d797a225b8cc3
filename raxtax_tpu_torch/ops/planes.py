"""K3, K4, K6/K7, K8 and the small helpers over counter planes.

``planes[b, p, s, lane]`` (``int32`` bit patterns) holds bit ``2^p`` of the
intersection count of the tip at word ``w = s*128 + lane``, bit position
``bit``: tip ``w*32 + bit`` in the packed postings layout, tip
``bit*W + w`` in the flat one. Everything here reads the planes directly;
the dense count matrix never exists on the main path.

- :func:`planes_histogram` — K3, CUDA kernel ``csrc/planes_hist.cu``
  (``rx_planes_hist``). Replaces the TPU kernel ``_hist_kernel``
  (``ops/planes.py`` of the JAX package: ``planes_histogram``), which ANDs
  the planes once per possible value for want of a scatter. The GPU kernel
  counts the tips below 16 that way over the four low planes only (16
  minterm popcounts into register counters, no atomics) and decodes only
  the tips of 16 or more, into a shared-memory histogram with warp-
  aggregated integer atomics (exact in any order). Bound: bytes, the planes
  are read once.
- :func:`planes_probs` — K4, CUDA kernel ``csrc/planes_probs.cu``
  (``rx_planes_probs``). Replaces the TPU kernel ``_probs_kernel``
  (``planes_probs`` of the JAX package), a select tree run once per u32 half
  of the f64 table; the GPU kernel looks an f32 or f64 table row up from
  shared memory in one launch and writes bit-major. Bound: bytes, the
  ``B*32*W`` output values dominate.

- :func:`planes_high_counts` — K8, CUDA kernel ``csrc/planes_high.cu``
  (``rx_planes_high``). Replaces the TPU kernel of ``planes_high_counts``
  (``ops/planes.py`` of the JAX package): the decoded count where it exceeds
  15, else 0, bit-major. Bound: bytes, 4 bytes written per tip.
- :func:`dd_cumsum` (K6) and :func:`dd_cumsum_bitmajor` (K7), CUDA kernel
  ``csrc/dd_cumsum.cu`` (``rx_dd_cumsum``). Replace the TPU kernels behind
  ``dd_cumsum_pallas`` and ``dd_cumsum_pallas_bitmajor`` (``_dd_scan_kernel``
  of the JAX package): the double-f32 inclusive prefix sum along tips, in
  that kernel's add order, so ``(hi, lo)`` match it bit for bit. K7 reads
  bit-major input and uses 256-row tiles where K6 uses 1,024: their bits
  differ on the same data. Bound: bytes, 12 per tip (4 read, 8 written).
  ``torch.cumsum`` adds in another order and is not their plain version; the
  plain version is the same add tree written with ``F.pad`` shifts.

Each has its plain PyTorch version beside it; a wrapper takes the plain
version only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

WORD_BITS = 32
MAX_PLANES = 24  #: most planes the kernels keep in registers

_HIST_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
]
_PROBS_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]


def decode_counts_bitmajor(planes: torch.Tensor) -> torch.Tensor:
    """``[B, P, S, 128]`` planes -> ``[B, 32, S, 128]`` int32 counts,
    bit-major: entry ``[b, bit, s, l]`` is the count of the tip at word
    ``(s, l)``, bit ``bit``."""
    B, P, S, lanes = planes.shape
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=planes.device)
    shifts = shifts.view(1, WORD_BITS, 1, 1)
    c = torch.zeros(
        (B, WORD_BITS, S, lanes), dtype=torch.int32, device=planes.device
    )
    for p in range(P):
        # arithmetic shift of an int32 bit pattern: mask the sign fill away
        c |= ((planes[:, p, None] >> shifts) & 1) << p
    return c


def _pad_tips(planes: torch.Tensor, num_tips: int) -> int:
    _, _, S, lanes = planes.shape
    pad = S * lanes * WORD_BITS - num_tips
    if pad < 0:
        raise ValueError("planes hold fewer tip slots than num_tips")
    return pad


def planes_histogram_plain(
    planes: torch.Tensor, s_max: int, num_tips: int
) -> torch.Tensor:
    """Plain PyTorch version of K3: decode every count, bincount per query
    (counts at or past ``s_max`` are dropped), take the pad tips out of
    bucket 0."""
    B = planes.shape[0]
    pad = _pad_tips(planes, num_tips)
    c = decode_counts_bitmajor(planes).reshape(B, -1).long()
    ok = c < s_max
    key = torch.where(ok, c, 0) + torch.arange(
        B, device=planes.device
    )[:, None] * s_max
    hist = torch.bincount(
        key.reshape(-1), weights=None, minlength=B * s_max
    ).reshape(B, s_max)
    hist[:, 0] -= (~ok).sum(dim=1)  # dropped entries were parked in bucket 0
    hist[:, 0] -= pad
    return hist.to(torch.int32)


def planes_histogram(
    planes: torch.Tensor,  # [B, P, S, 128] int32 counter planes
    s_max: int,
    num_tips: int,
) -> torch.Tensor:  # [B, s_max] int32
    """Exact intersection-size histogram from counter planes. ``s_max`` must
    exceed the largest count; tip slots in ``[num_tips, S*128*32)`` are
    zero padding and are taken out of bucket 0."""
    if planes.ndim != 4:
        raise ValueError("planes must be [B, P, S, 128]")
    if not planes.is_cuda:
        return planes_histogram_plain(planes, s_max, num_tips)
    _build.require_cuda_tensor(planes, torch.int32, "planes")
    B, P, S, lanes = planes.shape
    if P > MAX_PLANES:
        raise ValueError(f"planes_histogram: at most {MAX_PLANES} planes")
    _pad_tips(planes, num_tips)
    fn = _build.entry("planes_hist", "rx_planes_hist", _HIST_ARGTYPES)
    out = torch.zeros((B, s_max), dtype=torch.int32, device=planes.device)
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream().cuda_stream
        planes_histogram.launches += 1
        code = fn(
            planes.data_ptr(), out.data_ptr(), B, P, S * lanes, s_max,
            num_tips, stream,
        )
    _build.check("planes_hist", code, "planes_histogram")
    return out


#: kernel launches made by :func:`planes_histogram`
planes_histogram.launches = 0


def _resolve_mux(planes: torch.Tensor, mux_bits: int | None) -> int:
    P = planes.shape[1]
    return P if mux_bits is None else max(1, min(int(mux_bits), P))


def planes_probs_plain(
    planes: torch.Tensor,
    table: torch.Tensor,
    mux_bits: int | None = None,
    zero_high: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of K4: decode, mask the count to its low
    ``mux_bits`` bits, gather from the table (zero past its end), zero the
    tips with a high plane bit when ``zero_high``."""
    B, P, S, lanes = planes.shape
    mux = _resolve_mux(planes, mux_bits)
    s_max = table.shape[1]
    c = decode_counts_bitmajor(planes[:, :mux]).reshape(B, -1).long()
    tab = torch.cat(
        [table, torch.zeros((B, 1), dtype=table.dtype, device=table.device)],
        dim=1,
    )
    out = torch.gather(tab, 1, torch.clamp(c, max=s_max))
    out = out.reshape(B, WORD_BITS, S, lanes)
    if zero_high and mux < P:
        high = decode_counts_bitmajor(planes[:, mux:]) != 0
        out = torch.where(high, torch.zeros((), dtype=out.dtype,
                                            device=out.device), out)
    return out


def planes_probs(
    planes: torch.Tensor,  # [B, P, S, 128] int32
    table: torch.Tensor,  # [B, s_max] float32 or float64
    mux_bits: int | None = None,
    zero_high: bool = False,
) -> torch.Tensor:  # [B, 32, S, 128], dtype of the table, bit-major
    """``probs[b, bit, s, lane] = table[b, count of the tip at that word and
    bit]``. With ``mux_bits < P`` only the low ``mux_bits`` count bits are
    read — exact for counts below ``2**mux_bits``; ``zero_high`` then makes
    every larger count decode to 0. Pad tip slots decode to ``table[b, 0]``;
    nothing below ``num_tips`` reads them."""
    if planes.ndim != 4 or table.ndim != 2 or table.shape[0] != planes.shape[0]:
        raise ValueError("planes [B, P, S, 128] and table [B, s_max] expected")
    if table.dtype not in (torch.float32, torch.float64):
        raise TypeError("table must be float32 or float64")
    if planes.device != table.device:
        raise ValueError("planes_probs: tensors on different devices")
    if not planes.is_cuda:
        return planes_probs_plain(planes, table, mux_bits, zero_high)
    _build.require_cuda_tensor(planes, torch.int32, "planes")
    _build.require_cuda_tensor(table, table.dtype, "table")
    B, P, S, lanes = planes.shape
    if P > MAX_PLANES:
        raise ValueError(f"planes_probs: at most {MAX_PLANES} planes")
    mux = _resolve_mux(planes, mux_bits)
    fn = _build.entry("planes_probs", "rx_planes_probs", _PROBS_ARGTYPES)
    out = torch.empty(
        (B, WORD_BITS, S, lanes), dtype=table.dtype, device=planes.device
    )
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream().cuda_stream
        planes_probs.launches += 1
        code = fn(
            planes.data_ptr(), table.data_ptr(), out.data_ptr(), B, P,
            S * lanes, table.shape[1], mux, int(bool(zero_high)),
            table.element_size(), stream,
        )
    _build.check("planes_probs", code, "planes_probs")
    return out


#: kernel launches made by :func:`planes_probs`
planes_probs.launches = 0


def zero_tips_in_planes(
    planes: torch.Tensor, ids: torch.Tensor, layout: str = "packed"
) -> torch.Tensor:
    """Clear the counter bits of the given tips (per query).

    ``ids`` is ``[B, E]`` int tip ids, -1-padded: the dual of the
    reference's ``--skip-exact-matches`` count zeroing (src/raxtax.rs:65-68)
    — a cleared bit in every plane makes the decoded count 0. ``layout``
    selects the tip -> (word, bit) mapping."""
    B, P, S, lanes = planes.shape
    W = S * lanes
    ids = ids.long()
    valid = ids >= 0
    safe = torch.where(valid, ids, 0)
    if layout == "flat":
        word, bit = safe % W, safe // W
    else:
        word, bit = safe // WORD_BITS, safe % WORD_BITS
    one = torch.ones((), dtype=torch.int32, device=planes.device)
    contrib = torch.where(valid, one << bit.to(torch.int32), 0)
    rowid = torch.arange(B, device=planes.device)[:, None].expand_as(ids)
    mask = torch.zeros((B, W), dtype=torch.int32, device=planes.device)
    # tip ids are unique per query, so add == or
    mask.index_put_((rowid, word), contrib.to(torch.int32), accumulate=True)
    return planes & ~mask.reshape(B, 1, S, lanes)


def probs_to_tip_order(bitmajor: torch.Tensor) -> torch.Tensor:
    """``[B, 32, S, 128]`` bit-major values of the PACKED layout ->
    ``[B, S*128*32]`` in tip order (tip = (s*128 + lane)*32 + bit)."""
    B = bitmajor.shape[0]
    return bitmajor.permute(0, 2, 3, 1).reshape(B, -1)


def decode_plane_rows(
    planes: torch.Tensor, rows: list[int], layout: str = "packed"
) -> torch.Tensor:
    """``[len(rows), S*128*32]`` int32 counts in tip order, decoded from the
    planes of the selected queries only."""
    idx = torch.as_tensor(rows, dtype=torch.long, device=planes.device)
    c = decode_counts_bitmajor(planes.index_select(0, idx))
    if layout == "flat":
        return c.reshape(len(rows), -1)
    return probs_to_tip_order(c)


def planes_high_counts_plain(planes: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K8: decode every count, keep those above
    15."""
    c = decode_counts_bitmajor(planes)
    return torch.where(c > 15, c, torch.zeros_like(c))


def planes_high_counts(
    planes: torch.Tensor,  # [B, P, S, 128] int32
) -> torch.Tensor:  # [B, 32, S, 128] int32, bit-major
    """Overflow counts (count where it exceeds 15, else 0), bit-major: the
    low nibble of every count travels as the four tier planes, the rare
    larger counts as an (index, value) list cut from this array
    (``ops/compress.py``)."""
    if planes.ndim != 4:
        raise ValueError("planes must be [B, P, S, 128]")
    if not planes.is_cuda:
        return planes_high_counts_plain(planes)
    _build.require_cuda_tensor(planes, torch.int32, "planes")
    B, P, S, lanes = planes.shape
    if P > MAX_PLANES:
        raise ValueError(f"planes_high_counts: at most {MAX_PLANES} planes")
    fn = _build.entry(
        "planes_high", "rx_planes_high",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_longlong, ctypes.c_void_p],
    )
    out = torch.empty(
        (B, WORD_BITS, S, lanes), dtype=torch.int32, device=planes.device
    )
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream().cuda_stream
        planes_high_counts.launches += 1
        code = fn(planes.data_ptr(), out.data_ptr(), B, P, S * lanes, stream)
    _build.check("planes_high", code, "planes_high_counts")
    return out


#: kernel launches made by :func:`planes_high_counts`
planes_high_counts.launches = 0

LANES = 128  #: tips per scan row
DD_TILE_ROWS = 1024  #: rows per tile of the tip-order scan (K6)
DD_TILE_ROWS_BITMAJOR = 256  #: rows per tile of the bit-major scan (K7)


def dd_add2(a_hi, a_lo, b_hi, b_lo):
    """TwoSum-compensated double-f32 add as the scan uses it: the exact
    error of ``a_hi + b_hi`` joins the two low words, in this order. Adding
    ``(0, 0)`` is an exact identity."""
    s = a_hi + b_hi
    bb = s - a_hi
    err = (a_hi - (s - bb)) + (b_hi - bb)
    return s, err + a_lo + b_lo


def dd_cumsum_plain(x: torch.Tensor, tile_rows: int):
    """Plain PyTorch version of K6 / K7 on tip-order input ``[B, N]``: per
    tile of ``min(N / 128, tile_rows)`` rows, the shift-in-zero log-step
    scan along the 128 lanes, the same over the row totals, the exclusive
    row offset, then the carry from the previous tile."""
    B, N = x.shape
    nr = N // LANES
    rows = min(nr, tile_rows)
    x3 = x.reshape(B, nr, LANES)
    out_hi = torch.empty_like(x3)
    out_lo = torch.empty_like(x3)
    c_hi = torch.zeros((B, 1, 1), dtype=x.dtype, device=x.device)
    c_lo = torch.zeros_like(c_hi)
    for r0 in range(0, nr, rows):
        hi = x3[:, r0 : r0 + rows]
        n_valid = hi.shape[1]
        if n_valid < rows:  # partial last tile: rows past the end are zero
            hi = F.pad(hi, (0, 0, 0, rows - n_valid))
        lo = torch.zeros_like(hi)
        k = 1
        while k < LANES:
            sh_hi = F.pad(hi, (k, 0))[:, :, :LANES]
            sh_lo = F.pad(lo, (k, 0))[:, :, :LANES]
            hi, lo = dd_add2(hi, lo, sh_hi, sh_lo)
            k <<= 1
        rt_hi = hi[:, :, LANES - 1 :]
        rt_lo = lo[:, :, LANES - 1 :]
        k = 1
        while k < rows:
            rt_hi2 = F.pad(rt_hi, (0, 0, k, 0))[:, :rows]
            rt_lo2 = F.pad(rt_lo, (0, 0, k, 0))[:, :rows]
            rt_hi, rt_lo = dd_add2(rt_hi, rt_lo, rt_hi2, rt_lo2)
            k <<= 1
        off_hi = F.pad(rt_hi, (0, 0, 1, 0))[:, :rows]
        off_lo = F.pad(rt_lo, (0, 0, 1, 0))[:, :rows]
        hi, lo = dd_add2(hi, lo, off_hi, off_lo)
        hi, lo = dd_add2(hi, lo, c_hi, c_lo)
        out_hi[:, r0 : r0 + n_valid] = hi[:, :n_valid]
        out_lo[:, r0 : r0 + n_valid] = lo[:, :n_valid]
        c_hi = hi[:, rows - 1 :, LANES - 1 :]
        c_lo = lo[:, rows - 1 :, LANES - 1 :]
    return out_hi.reshape(B, N), out_lo.reshape(B, N)


_DD_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
]
_DD_SCRATCH_ARGTYPES = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
#: columns in front of a scan's output row: prefix 0 sits at column 31 and
#: tip 0's sum at column 32, so every row of sums starts on 128 bytes
DD_OUT_PAD = 32


def dd_scan_scratch(B: int, N: int, tile_rows: int, device) -> torch.Tensor:
    """The kernel's scratch for one scan (ticket, chunk flags, carries and
    the levels of the row-total tree), its head zeroed as the kernel
    requires."""
    fn = _build.entry("dd_cumsum", "rx_dd_cumsum_scratch_words",
                      _DD_SCRATCH_ARGTYPES, restype=ctypes.c_longlong)
    scratch = torch.empty(fn(B, N, tile_rows, 0), dtype=torch.int32,
                          device=device)
    scratch[: fn(B, N, tile_rows, 1)].zero_()
    return scratch


def _dd_scan(x: torch.Tensor, bitmajor: bool, counter):
    """Shared body of K6 / K7: checks, the plain version for a CPU tensor,
    the launch for a CUDA one. The outputs are ``[B, N + 1]`` with a leading
    zero column, as the confidences' range sums read them: on the device,
    views of ``[B, N + DD_OUT_PAD]`` buffers from column ``DD_OUT_PAD - 1``
    (the kernel writes the sums 128-byte aligned, and no padded copy is
    made)."""
    if x.dtype != torch.float32:
        raise TypeError("the double-f32 scan expects float32 input")
    if bitmajor:
        if x.ndim != 4 or x.shape[1] != WORD_BITS or x.shape[3] != LANES:
            raise ValueError("bit-major input must be [B, 32, S, 128]")
        B = x.shape[0]
        N = x.shape[1] * x.shape[2] * x.shape[3]
        tile_rows = DD_TILE_ROWS_BITMAJOR
    else:
        if x.ndim != 2 or x.shape[1] == 0 or x.shape[1] % LANES:
            raise ValueError(
                "tip-order input must be [B, N] with N a positive multiple "
                "of 128"
            )
        B, N = x.shape
        tile_rows = DD_TILE_ROWS
    rows = min(N // LANES, tile_rows)
    if not x.is_cuda:
        flat = probs_to_tip_order(x) if bitmajor else x
        hi, lo = dd_cumsum_plain(flat, tile_rows)
        return F.pad(hi, (1, 0)), F.pad(lo, (1, 0))
    _build.require_cuda_tensor(x, torch.float32, "probs")
    fn = _build.entry("dd_cumsum", "rx_dd_cumsum", _DD_ARGTYPES)
    hi = torch.empty((B, N + DD_OUT_PAD), dtype=torch.float32, device=x.device)
    lo = torch.empty_like(hi)
    hi[:, DD_OUT_PAD - 1] = 0.0
    lo[:, DD_OUT_PAD - 1] = 0.0
    with torch.cuda.device(x.device):
        scratch = dd_scan_scratch(B, N, rows, x.device)
        stream = torch.cuda.current_stream().cuda_stream
        counter.launches += 1
        code = fn(
            x.data_ptr(), hi.data_ptr(), lo.data_ptr(), B, N, rows,
            int(bitmajor), N + DD_OUT_PAD, DD_OUT_PAD, scratch.data_ptr(),
            stream,
        )
    _build.check("dd_cumsum", code, counter.__name__)
    return hi[:, DD_OUT_PAD - 1 :], lo[:, DD_OUT_PAD - 1 :]


def dd_cumsum(probs: torch.Tensor):
    """K6: double-f32 zero-prefixed prefix sum of ``[B, N]`` f32 along tips
    (``N % 128 == 0``). Returns ``(hi, lo)``, each ``[B, N + 1]`` with column
    0 zero and column ``n + 1`` the sum of tips ``0..n``;
    ``float64(hi) + float64(lo)`` tracks the exact prefix sum to about
    ``2**-48``."""
    return _dd_scan(probs, False, dd_cumsum)


#: kernel launches made by :func:`dd_cumsum`
dd_cumsum.launches = 0


def dd_cumsum_bitmajor(probs_bm: torch.Tensor):
    """K7: the same prefix sum in TIP order of the packed layout, fed the
    bit-major ``[B, 32, S, 128]`` probabilities K4 emits, so the global
    permute to tip order is never made. Returns ``(hi, lo)``, each
    ``[B, S*128*32 + 1]`` with the leading zero column."""
    return _dd_scan(probs_bm, True, dd_cumsum_bitmajor)


#: kernel launches made by :func:`dd_cumsum_bitmajor`
dd_cumsum_bitmajor.launches = 0
