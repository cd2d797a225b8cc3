"""Software IEEE-754 binary64 on u32 pairs, and the probe kernels K11 / K12.

The counterpart of the JAX package's ``ops/exactf64.py``: the same integer
algorithm, step for step (``_nz``, ``_mux``, ``_shr_pair_sticky``, ``_clz32``,
``_shl_pair``, :func:`f64_add`, :func:`f64_sub`, :func:`f64_to_f32`,
:func:`f64_lt`, :func:`f64_le`), written as torch integer ops. The port's own
classify path does not need it: the GPU adds in hardware f64 (K5). It is the
plain version of the two probe kernels and the means of checking them.

u32 words travel in ``int64`` tensors holding values in ``[0, 2**32)``:
PyTorch has no shifts, adds or compares for ``uint32`` on the CPU, so every
operation that can wrap (``0 - x``, ``+``, ``-``, ``<<``, ``~``, the multiply
in :func:`_clz32`) is masked with ``0xFFFFFFFF`` right after it. The ops take
any integer tensor (``int32`` bit patterns too) and return ``int64`` words.

Contract, as in the JAX module: :func:`f64_add` rounds to nearest even for
non-negative, normal-or-zero operands whose sum does not overflow;
:func:`f64_sub` for ``a >= b >= 0``, both normal or zero.

The probes (CUDA kernels ``csrc/probe_f64.cu`` on ``csrc/exactf64.cuh``):

- :func:`probe_f64_ew` — K11, replaces ``ew_kernel``
  (``scripts/probe_mosaic_f64.py:47``, ``pallas_call`` at :62): per element
  ``c = a + b`` and ``c - b`` as (hi, lo) pairs. One thread per element;
  bound by the integer work (:data:`OPS_PER_ADD` + :data:`OPS_PER_SUB` u32
  operations per pair) rather than by its 32 bytes.
- :func:`probe_f64_scan` — K12, replaces ``make_scan``/``scan_kernel``
  (``probe_mosaic_f64.py:80-113``, :125): the sequential software-f64 prefix
  sum per lane over tips, ``[G, N, 128]`` u32 halves. Each lane of a
  one-warp CTA walks one chain through shared-memory tiles of its own
  column; bound by the latency of N dependent software adds, with only
  ``G * 128`` chains.

Both wrappers launch the kernel for CUDA tensors (``int32`` bit patterns) or
raise; a CPU tensor takes the plain version.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

M32 = 0xFFFFFFFF

#: u32 operations of one :func:`f64_add` / :func:`f64_sub` as the algorithm
#: writes them (a mux is four, a nonzero test three, the pair shift with
#: sticky 72), counted from ``csrc/exactf64.cuh``; the bounds use them
OPS_PER_ADD = 189
OPS_PER_SUB = 285


# -- host conversions ------------------------------------------------------

def split64(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """f64 -> (hi, lo) u32 bit halves."""
    b = np.ascontiguousarray(x, dtype=np.float64).view(np.uint64)
    return (b >> 32).astype(np.uint32), (b & 0xFFFFFFFF).astype(np.uint32)


def join64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """(hi, lo) u32 bit halves -> f64."""
    return (
        (hi.astype(np.uint64) << 32) | lo.astype(np.uint64)
    ).view(np.float64)


def words(x) -> torch.Tensor:
    """u32 words as ``int64`` in ``[0, 2**32)``: from a numpy ``uint32``
    array, or from a tensor of any integer type (``int32`` bit patterns
    included)."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x).astype(np.int64))
    return x.to(torch.int64) & M32


def as_i32(w: torch.Tensor) -> torch.Tensor:
    """``int64`` u32 words -> ``int32`` tensors of the same bit patterns."""
    w = w & M32
    return (w - ((w >> 31) << 32)).to(torch.int32)


# -- the integer algorithm ---------------------------------------------------

def _nz(x):
    """1 iff x != 0, for u32 words: ``(x | -x) >> 31``."""
    return (x | ((0 - x) & M32)) >> 31


def _mux(c, a, b):
    """a if c (0/1) else b, branch-free."""
    m = (0 - c) & M32
    return b ^ ((a ^ b) & m)


def _lt(x, y):
    """u32 compare as a 0/1 word."""
    return (x < y).to(torch.int64)


def _shr_pair_sticky(hi, lo, d):
    """Logical right shift of the pair (hi:lo) by d, with the sticky flag of
    the bits shifted out; any d (d >= 64 shifts everything into sticky)."""
    d1 = _mux(_lt(63, d), 63, d)
    big = (d1 >> 5) & 1
    d32 = d1 & 31
    nonzero_d32 = _nz(d32)
    mask = _mux(nonzero_d32, ((1 << d32) - 1) & M32, 0)
    inv = ((32 - d32) & M32) & 31
    lo_small = _mux(nonzero_d32, (lo >> d32) | ((hi << inv) & M32), lo)
    hi_small = hi >> d32
    st_small = _nz(lo & mask)
    lo_big = hi >> d32
    st_big = _nz(hi & mask) | _nz(lo)
    lo_s = _mux(big, lo_big, lo_small)
    hi_s = _mux(big, 0, hi_small)
    sticky = _mux(big, st_big, st_small)
    huge = _nz(d >> 6)
    lo_s = _mux(huge, 0, lo_s)
    hi_s = _mux(huge, 0, hi_s)
    sticky = _mux(huge, _nz(hi | lo), sticky)
    return hi_s, lo_s, sticky


def f64_add(ah, al, bh, bl):
    """RN(a + b) on (hi, lo) u32 words: ``(ch, cl)``."""
    ah, al, bh, bl = (words(x) for x in (ah, al, bh, bl))
    a_zero = 1 - _nz(ah | al)
    b_zero = 1 - _nz(bh | bl)
    swap = _lt(ah, bh) | ((ah == bh).to(torch.int64) & _lt(al, bl))
    xh = _mux(swap, bh, ah)
    xl = _mux(swap, bl, al)
    yh = _mux(swap, ah, bh)
    yl = _mux(swap, al, bl)
    ex = xh >> 20
    ey = yh >> 20
    d = (ex - ey) & M32
    mask20 = 0xFFFFF
    imp = 0x100000
    x55h = ((((xh & mask20) | imp) << 2) & M32) | (xl >> 30)
    x55l = (xl << 2) & M32
    y55h = ((((yh & mask20) | imp) << 2) & M32) | (yl >> 30)
    y55l = (yl << 2) & M32
    ys_h, ys_l, sticky = _shr_pair_sticky(y55h, y55l, d)
    sl = (x55l + ys_l) & M32
    carry = _lt(sl, x55l)
    sh = (x55h + ys_h + carry) & M32
    ovf = (sh >> 23) & 1
    sticky = sticky | (ovf & sl & 1)
    sl = _mux(ovf, (sl >> 1) | ((sh << 31) & M32), sl)
    sh = _mux(ovf, sh >> 1, sh)
    e_r = (ex + ovf) & M32
    g = (sl >> 1) & 1
    r0 = sl & 1
    lsb = (sl >> 2) & 1
    inc = g & (r0 | sticky | lsb)
    m_l = (sl >> 2) | ((sh << 30) & M32)
    m_h = sh >> 2
    m_l2 = (m_l + inc) & M32
    m_h2 = (m_h + _lt(m_l2, m_l)) & M32
    ovf2 = (m_h2 >> 21) & 1
    m_l3 = _mux(ovf2, (m_l2 >> 1) | ((m_h2 << 31) & M32), m_l2)
    m_h3 = _mux(ovf2, m_h2 >> 1, m_h2)
    e_r2 = (e_r + ovf2) & M32
    ch = ((e_r2 << 20) & M32) | (m_h3 & mask20)
    cl = m_l3
    ch = _mux(a_zero, bh, _mux(b_zero, ah, ch))
    cl = _mux(a_zero, bl, _mux(b_zero, al, cl))
    return ch, cl


def _clz32(x):
    """Count of leading zeros of a u32 word (32 for 0): smear + popcount."""
    x = x | (x >> 1)
    x = x | (x >> 2)
    x = x | (x >> 4)
    x = x | (x >> 8)
    x = x | (x >> 16)
    v = (~x) & M32
    v = (v - ((v >> 1) & 0x55555555)) & M32
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & M32) >> 24


def _shl_pair(hi, lo, k):
    """Logical left shift of the pair (hi:lo) by k in [0, 63]."""
    one_side = (k >> 5) & 1
    k32 = k & 31
    inv = ((32 - k32) & M32) & 31
    hi_small = _mux(_nz(k32), ((hi << k32) & M32) | (lo >> inv), hi)
    lo_small = (lo << k32) & M32
    hi_s = _mux(one_side, (lo << k32) & M32, hi_small)
    lo_s = _mux(one_side, 0, lo_small)
    return hi_s, lo_s


def f64_sub(ah, al, bh, bl):
    """RN(a - b) on (hi, lo) u32 words, ``a >= b >= 0``: ``(ch, cl)``."""
    ah, al, bh, bl = (words(x) for x in (ah, al, bh, bl))
    b_zero = 1 - _nz(bh | bl)
    ex = ah >> 20
    ey = bh >> 20
    d = (ex - ey) & M32
    mask20 = 0xFFFFF
    imp = 0x100000
    x56h = ((((ah & mask20) | imp) << 3) & M32) | (al >> 29)
    x56l = (al << 3) & M32
    y56h = ((((bh & mask20) | imp) << 3) & M32) | (bl >> 29)
    y56l = (bl << 3) & M32
    ys_h, ys_l, sticky = _shr_pair_sticky(y56h, y56l, d)
    ys_l = ys_l | sticky
    borrow = _lt(x56l, ys_l)
    m_l = (x56l - ys_l) & M32
    m_h = (x56h - ys_h - borrow) & M32
    nz_h = _nz(m_h)
    lead = _mux(nz_h, _clz32(m_h), (32 + _clz32(m_l)) & M32)
    k = (lead - 8) & M32
    m_h, m_l = _shl_pair(m_h, m_l, k)
    under = (k >= ex).to(torch.int64)
    e_sig = _mux(under, 0, (ex - k) & M32)
    g = (m_l >> 2) & 1
    r0 = (m_l >> 1) & 1
    s0 = m_l & 1
    lsb = (m_l >> 3) & 1
    inc = g & (r0 | s0 | lsb)
    q_l = (m_l >> 3) | ((m_h << 29) & M32)
    q_h = m_h >> 3
    q_l2 = (q_l + inc) & M32
    q_h2 = (q_h + _lt(q_l2, q_l)) & M32
    ovf2 = (q_h2 >> 21) & 1
    q_l3 = _mux(ovf2, (q_l2 >> 1) | ((q_h2 << 31) & M32), q_l2)
    q_h3 = _mux(ovf2, q_h2 >> 1, q_h2)
    e_r = (e_sig + ovf2) & M32
    denorm = under
    sh_dn = _mux(denorm, (((k - ex) & M32) + 1) & M32, 0)
    dn_h, dn_l, _ = _shr_pair_sticky(q_h3, q_l3, sh_dn)
    ch_n = ((e_r << 20) & M32) | (q_h3 & mask20)
    ch = _mux(denorm, dn_h, ch_n)
    cl = _mux(denorm, dn_l, q_l3)
    zero = (1 - _nz(m_h | m_l)) | (
        (ah == bh).to(torch.int64) & (al == bl).to(torch.int64)
    )
    ch = _mux(zero, 0, _mux(b_zero, ah, ch))
    cl = _mux(zero, 0, _mux(b_zero, al, cl))
    return ch, cl


def f64_to_f32(ah, al) -> torch.Tensor:
    """Truncating f64 -> f32 for non-negative normal-or-zero pairs; below the
    f32 range flushes to 0, above clamps to the largest finite f32."""
    ah, al = words(ah), words(al)
    e64 = ah >> 20
    under = (e64 <= 896).to(torch.int64)
    over = (e64 >= 896 + 255).to(torch.int64)
    e32 = _mux(under, 0, (e64 - 896) & M32)
    m23 = (((ah & 0xFFFFF) << 3) & M32) | (al >> 29)
    e32c = _mux(_lt(254, e32), 254, e32)
    bits = ((e32c << 23) & M32) | m23
    bits = _mux(under, 0, bits)
    bits = _mux(over, 0x7F7FFFFF, bits)
    bits = _mux(1 - _nz(ah | al), 0, bits)
    return as_i32(bits).view(torch.float32)


def f64_lt(ah, al, bh, bl) -> torch.Tensor:
    """a < b for non-negative f64 bit pairs (an integer compare)."""
    ah, al, bh, bl = (words(x) for x in (ah, al, bh, bl))
    return (ah < bh) | ((ah == bh) & (al < bl))


def f64_le(ah, al, bh, bl) -> torch.Tensor:
    """a <= b for non-negative f64 bit pairs."""
    ah, al, bh, bl = (words(x) for x in (ah, al, bh, bl))
    return (ah < bh) | ((ah == bh) & (al <= bl))


# -- K11 ----------------------------------------------------------------------

def probe_f64_ew_plain(ah, al, bh, bl):
    """Plain version of K11: ``(c_hi, c_lo, d_hi, d_lo)`` int32 bit patterns
    of ``c = a + b`` and ``d = c - b``."""
    ch, cl = f64_add(ah, al, bh, bl)
    dh, dl = f64_sub(ch, cl, bh, bl)
    return tuple(as_i32(w) for w in (ch, cl, dh, dl))


def probe_f64_ew(ah, al, bh, bl):
    """K11: software f64 ``a + b`` and ``(a + b) - b`` per element on int32
    bit patterns of equal shape; returns four int32 tensors."""
    if not ah.is_cuda:
        return probe_f64_ew_plain(ah, al, bh, bl)
    for t, name in ((ah, "a_hi"), (al, "a_lo"), (bh, "b_hi"), (bl, "b_lo")):
        _build.require_cuda_tensor(t, torch.int32, name)
        if t.shape != ah.shape:
            raise ValueError("probe_f64_ew: the four halves differ in shape")
    fn = _build.entry(
        "probe_f64", "rx_probe_f64_ew",
        [ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_void_p],
    )
    outs = [torch.empty_like(ah) for _ in range(4)]
    with torch.cuda.device(ah.device):
        stream = torch.cuda.current_stream().cuda_stream
        probe_f64_ew.launches += 1
        code = fn(
            ah.data_ptr(), al.data_ptr(), bh.data_ptr(), bl.data_ptr(),
            *(o.data_ptr() for o in outs), ah.numel(), stream,
        )
    _build.check("probe_f64", code, "probe_f64_ew")
    return tuple(outs)


#: kernel launches made by :func:`probe_f64_ew`
probe_f64_ew.launches = 0


# -- K12 ----------------------------------------------------------------------

def probe_f64_scan_plain(ph, pl):
    """Plain version of K12: the inclusive prefix sum over tips of
    ``[G, N, 128]`` int32 halves, one :func:`f64_add` over all lanes per
    tip, in tip order. Returns ``(hi, lo)`` int32 ``[G, N, 128]``."""
    G, N, L = ph.shape
    wh, wl = words(ph), words(pl)
    out_h = torch.empty((G, N, L), dtype=torch.int32, device=ph.device)
    out_l = torch.empty_like(out_h)
    hi = torch.zeros((G, L), dtype=torch.int64, device=ph.device)
    lo = torch.zeros_like(hi)
    for t in range(N):
        hi, lo = f64_add(hi, lo, wh[:, t], wl[:, t])
        out_h[:, t] = as_i32(hi)
        out_l[:, t] = as_i32(lo)
    return out_h, out_l


def probe_f64_scan(ph, pl):
    """K12: inclusive sequential software-f64 prefix sum per lane over tips,
    ``[G, N, 128]`` int32 (hi, lo) halves -> the same."""
    if ph.ndim != 3 or ph.shape[2] != 128 or pl.shape != ph.shape:
        raise ValueError("probe_f64_scan expects two [G, N, 128] tensors")
    if not ph.is_cuda:
        return probe_f64_scan_plain(ph, pl)
    _build.require_cuda_tensor(ph, torch.int32, "p_hi")
    _build.require_cuda_tensor(pl, torch.int32, "p_lo")
    G, N, _ = ph.shape
    fn = _build.entry(
        "probe_f64", "rx_probe_f64_scan",
        [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong,
                                 ctypes.c_void_p],
    )
    oh = torch.empty_like(ph)
    ol = torch.empty_like(pl)
    with torch.cuda.device(ph.device):
        stream = torch.cuda.current_stream().cuda_stream
        probe_f64_scan.launches += 1
        code = fn(ph.data_ptr(), pl.data_ptr(), oh.data_ptr(), ol.data_ptr(),
                  G, N, stream)
    _build.check("probe_f64", code, "probe_f64_scan")
    return oh, ol


#: kernel launches made by :func:`probe_f64_scan`
probe_f64_scan.launches = 0


def to_lane_groups(p: torch.Tensor):
    """``[B, N]`` float64 (B a multiple of 128) -> the K12 layout: int32
    ``(hi, lo)`` halves ``[B // 128, N, 128]``, query ``g * 128 + lane``."""
    B, N = p.shape
    halves = p.contiguous().view(torch.int32).reshape(B, N, 2)  # (lo, hi)

    def lay(x):
        return x.reshape(B // 128, 128, N).transpose(1, 2).contiguous()

    return lay(halves[..., 1]), lay(halves[..., 0])


def from_lane_groups(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`to_lane_groups`: ``[B, N]`` float64."""
    G, N, L = hi.shape
    halves = torch.stack([as_i32(words(lo)), as_i32(words(hi))], dim=-1)
    return halves.transpose(1, 2).reshape(G * L, N, 2).contiguous().view(
        torch.float64).reshape(G * L, N)
