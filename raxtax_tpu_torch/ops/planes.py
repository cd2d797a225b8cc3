"""K3, K4 and the small helpers over counter planes.

``planes[b, p, s, lane]`` (``int32`` bit patterns) holds bit ``2^p`` of the
intersection count of the tip at word ``w = s*128 + lane``, bit position
``bit``: tip ``w*32 + bit`` in the packed postings layout, tip
``bit*W + w`` in the flat one. Everything here reads the planes directly;
the dense count matrix never exists on the main path.

- :func:`planes_histogram` — K3, CUDA kernel ``csrc/planes_hist.cu``
  (``rx_planes_hist``). Replaces the TPU kernel ``_hist_kernel``
  (``ops/planes.py`` of the JAX package: ``planes_histogram``), which ANDs
  the planes once per possible value for want of a scatter; the GPU kernel
  decodes each tip and adds into a shared-memory histogram with integer
  atomics (exact in any order). Bound: bytes, the planes are read once.
- :func:`planes_probs` — K4, CUDA kernel ``csrc/planes_probs.cu``
  (``rx_planes_probs``). Replaces the TPU kernel ``_probs_kernel``
  (``planes_probs`` of the JAX package), a select tree run once per u32 half
  of the f64 table; the GPU kernel looks an f32 or f64 table row up from
  shared memory in one launch and writes bit-major. Bound: bytes, the
  ``B*32*W`` output values dominate.

Each has its plain PyTorch version beside it; a wrapper takes the plain
version only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

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
