// Software IEEE-754 binary64 on (hi, lo) u32 halves, for the probe kernels
// (K11, K12, K13). The counterpart, step for step, of the JAX package's
// ops/exactf64.py and of the port's ops/exactf64.py: the same 32-bit
// unsigned operations in the same order, so a kernel built on these
// functions computes the bits the TPU kernels compute, inside and outside
// the contract (the operation-chain probe feeds f64_add arbitrary words).
//
// The card has f64 in hardware; these functions deliberately do not call
// __dadd_rn or __dsub_rn. The one liberty taken: __clz replaces the
// smear-and-popcount count of leading zeros, because it returns the same
// value for every word (32 for 0).
//
// Contract of the arithmetic, as in the JAX module: rx_f64_add_u32 rounds to
// nearest even for non-negative, normal-or-zero operands whose sum does not
// overflow; rx_f64_sub_u32 for a >= b >= 0, both normal or zero.
#pragma once
#include <stdint.h>

#ifdef __CUDACC__
// 1 iff x != 0, in u32 arithmetic
__device__ __forceinline__ unsigned rx_nz(unsigned x) {
    return (x | (0u - x)) >> 31;
}

// a if c (a 0/1 flag) else b, branch-free
__device__ __forceinline__ unsigned rx_mux(unsigned c, unsigned a, unsigned b) {
    const unsigned m = 0u - c;
    return b ^ ((a ^ b) & m);
}

// Logical right shift of the pair (hi:lo) by d, with the sticky flag of the
// bits shifted out; any d (d >= 64 moves everything into sticky).
__device__ __forceinline__ void rx_shr_pair_sticky(unsigned hi, unsigned lo,
                                                   unsigned d, unsigned& hi_s,
                                                   unsigned& lo_s,
                                                   unsigned& sticky) {
    const unsigned d1 = rx_mux(d > 63u ? 1u : 0u, 63u, d);
    const unsigned big = (d1 >> 5) & 1u;
    const unsigned d32 = d1 & 31u;
    const unsigned nonzero_d32 = rx_nz(d32);
    const unsigned mask = rx_mux(nonzero_d32, (1u << d32) - 1u, 0u);
    const unsigned inv = (32u - d32) & 31u;
    const unsigned lo_small = rx_mux(nonzero_d32, (lo >> d32) | (hi << inv), lo);
    const unsigned hi_small = hi >> d32;
    const unsigned st_small = rx_nz(lo & mask);
    const unsigned lo_big = hi >> d32;
    const unsigned st_big = rx_nz(hi & mask) | rx_nz(lo);
    const unsigned l = rx_mux(big, lo_big, lo_small);
    const unsigned h = rx_mux(big, 0u, hi_small);
    const unsigned s = rx_mux(big, st_big, st_small);
    const unsigned huge = rx_nz(d >> 6);
    lo_s = rx_mux(huge, 0u, l);
    hi_s = rx_mux(huge, 0u, h);
    sticky = rx_mux(huge, rx_nz(hi | lo), s);
}

// Logical left shift of the pair (hi:lo) by k in [0, 63].
__device__ __forceinline__ void rx_shl_pair(unsigned hi, unsigned lo,
                                            unsigned k, unsigned& hi_s,
                                            unsigned& lo_s) {
    const unsigned one_side = (k >> 5) & 1u;
    const unsigned k32 = k & 31u;
    const unsigned inv = (32u - k32) & 31u;
    const unsigned hi_small = rx_mux(rx_nz(k32), (hi << k32) | (lo >> inv), hi);
    const unsigned lo_small = lo << k32;
    hi_s = rx_mux(one_side, lo << k32, hi_small);
    lo_s = rx_mux(one_side, 0u, lo_small);
}

// RN(a + b): 53-bit mantissas widened by two guard bits, the smaller
// operand aligned with a sticky bit, one renormalising shift, round to
// nearest even, one more shift if the rounding carried out.
__device__ __forceinline__ void rx_f64_add_u32(unsigned ah, unsigned al,
                                               unsigned bh, unsigned bl,
                                               unsigned& ch, unsigned& cl) {
    const unsigned a_zero = 1u - rx_nz(ah | al);
    const unsigned b_zero = 1u - rx_nz(bh | bl);
    const unsigned swap =
        (unsigned)(bh > ah) | ((unsigned)(bh == ah) & (unsigned)(bl > al));
    const unsigned xh = rx_mux(swap, bh, ah);
    const unsigned xl = rx_mux(swap, bl, al);
    const unsigned yh = rx_mux(swap, ah, bh);
    const unsigned yl = rx_mux(swap, al, bl);
    const unsigned ex = xh >> 20;
    const unsigned ey = yh >> 20;
    const unsigned d = ex - ey;
    const unsigned x55h = (((xh & 0xFFFFFu) | 0x100000u) << 2) | (xl >> 30);
    const unsigned x55l = xl << 2;
    const unsigned y55h = (((yh & 0xFFFFFu) | 0x100000u) << 2) | (yl >> 30);
    const unsigned y55l = yl << 2;
    unsigned ys_h, ys_l, sticky;
    rx_shr_pair_sticky(y55h, y55l, d, ys_h, ys_l, sticky);
    unsigned sl = x55l + ys_l;
    const unsigned carry = (unsigned)(sl < x55l);
    unsigned sh = x55h + ys_h + carry;
    const unsigned ovf = (sh >> 23) & 1u;
    sticky = sticky | (ovf & sl & 1u);
    sl = rx_mux(ovf, (sl >> 1) | (sh << 31), sl);
    sh = rx_mux(ovf, sh >> 1, sh);
    const unsigned e_r = ex + ovf;
    const unsigned g = (sl >> 1) & 1u;
    const unsigned r0 = sl & 1u;
    const unsigned lsb = (sl >> 2) & 1u;
    const unsigned inc = g & (r0 | sticky | lsb);
    const unsigned m_l = (sl >> 2) | (sh << 30);
    const unsigned m_h = sh >> 2;
    const unsigned m_l2 = m_l + inc;
    const unsigned m_h2 = m_h + (unsigned)(m_l2 < m_l);
    const unsigned ovf2 = (m_h2 >> 21) & 1u;
    const unsigned m_l3 = rx_mux(ovf2, (m_l2 >> 1) | (m_h2 << 31), m_l2);
    const unsigned m_h3 = rx_mux(ovf2, m_h2 >> 1, m_h2);
    const unsigned e_r2 = e_r + ovf2;
    const unsigned h = (e_r2 << 20) | (m_h3 & 0xFFFFFu);
    ch = rx_mux(a_zero, bh, rx_mux(b_zero, ah, h));
    cl = rx_mux(a_zero, bl, rx_mux(b_zero, al, m_l3));
}

// RN(a - b) for a >= b >= 0: three extension bits with the sticky bit in
// the lowest, a full-width subtraction, renormalisation by the count of
// leading zeros, round to nearest even, and the exact denormal branch.
__device__ __forceinline__ void rx_f64_sub_u32(unsigned ah, unsigned al,
                                               unsigned bh, unsigned bl,
                                               unsigned& ch, unsigned& cl) {
    const unsigned b_zero = 1u - rx_nz(bh | bl);
    const unsigned ex = ah >> 20;
    const unsigned ey = bh >> 20;
    const unsigned d = ex - ey;
    const unsigned x56h = (((ah & 0xFFFFFu) | 0x100000u) << 3) | (al >> 29);
    const unsigned x56l = al << 3;
    const unsigned y56h = (((bh & 0xFFFFFu) | 0x100000u) << 3) | (bl >> 29);
    const unsigned y56l = bl << 3;
    unsigned ys_h, ys_l, sticky;
    rx_shr_pair_sticky(y56h, y56l, d, ys_h, ys_l, sticky);
    ys_l = ys_l | sticky;
    const unsigned borrow = (unsigned)(x56l < ys_l);
    const unsigned d_l = x56l - ys_l;
    const unsigned d_h = x56h - ys_h - borrow;
    const unsigned lead = rx_mux(rx_nz(d_h), (unsigned)__clz((int)d_h),
                                 32u + (unsigned)__clz((int)d_l));
    const unsigned k = lead - 8u;
    unsigned m_h, m_l;
    rx_shl_pair(d_h, d_l, k, m_h, m_l);
    const unsigned under = (unsigned)(k >= ex);
    const unsigned e_sig = rx_mux(under, 0u, ex - k);
    const unsigned g = (m_l >> 2) & 1u;
    const unsigned r0 = (m_l >> 1) & 1u;
    const unsigned s0 = m_l & 1u;
    const unsigned lsb = (m_l >> 3) & 1u;
    const unsigned inc = g & (r0 | s0 | lsb);
    const unsigned q_l = (m_l >> 3) | (m_h << 29);
    const unsigned q_h = m_h >> 3;
    const unsigned q_l2 = q_l + inc;
    const unsigned q_h2 = q_h + (unsigned)(q_l2 < q_l);
    const unsigned ovf2 = (q_h2 >> 21) & 1u;
    const unsigned q_l3 = rx_mux(ovf2, (q_l2 >> 1) | (q_h2 << 31), q_l2);
    const unsigned q_h3 = rx_mux(ovf2, q_h2 >> 1, q_h2);
    const unsigned e_r = e_sig + ovf2;
    const unsigned sh_dn = rx_mux(under, (k - ex) + 1u, 0u);
    unsigned dn_h, dn_l, dn_st;
    rx_shr_pair_sticky(q_h3, q_l3, sh_dn, dn_h, dn_l, dn_st);
    const unsigned ch_n = (e_r << 20) | (q_h3 & 0xFFFFFu);
    const unsigned h = rx_mux(under, dn_h, ch_n);
    const unsigned l = rx_mux(under, dn_l, q_l3);
    const unsigned zero = (1u - rx_nz(m_h | m_l)) |
                          ((unsigned)(ah == bh) & (unsigned)(al == bl));
    ch = rx_mux(zero, 0u, rx_mux(b_zero, ah, h));
    cl = rx_mux(zero, 0u, rx_mux(b_zero, al, l));
}
#endif  // __CUDACC__
