// Software IEEE-754 binary64 on (hi, lo) u32 halves, for the probe kernels
// (K11, K12, K13). The same functions as the JAX package's ops/exactf64.py
// and the port's ops/exactf64.py, bit for bit on every input word, inside
// and outside the contract (the operation-chain probe feeds f64_add
// arbitrary words, exponent 0 and 2047 and the sign bit included): the
// plain version is the specification, not the order of its operations.
//
// The card has f64 in hardware; these functions deliberately do not call
// __dadd_rn or __dsub_rn and use no double.
//
// rx_f64_add_u32 is written for Hopper's integer pipe. The JAX module's 189
// u32 operations build every 64-bit shift from muxes (ptxas compiles them
// to 110 instructions with a dependent path of 35); here the pair is one
// 64-bit word, and few operations depend on the running sum of a chain
// (K12, K13's f64_add_full):
//   - the swap is one 64-bit compare, and what each operand contributes
//     (the 55-bit mantissa with two guard bits, the exponent differences
//     clamped to 63, the sign-and-exponent field) is computed for both
//     operands before it and selected after it;
//   - the alignment is one 64-bit shift (two funnel shifts); its sticky bit
//     is the shifted word shifted back and compared, so no mask is built;
//   - rounding to nearest even is a round-half-up add folded into the
//     mantissa sum (x + y + 2, or + 4 when the sum carries into bit 55) and
//     one cleared bit on an exact tie; both cases are computed and the carry
//     out of t0 = x + y + 2 selects one (where t0 carries and the sum does
//     not, both cases give the same power of two);
//   - the exponent enters by one 32-bit add on the high word: the mantissa
//     with its implicit bit is added to (exponent - 1) << 52, so a rounding
//     that carries to 2^53 raises the exponent by itself, and the exponent
//     field wraps modulo 4096 as the JAX module's u32 shift wraps it.
// A zero operand returns the other one (both zero: zero), as in the plain
// version: the OR of the two words. On sm_90a the add is 53 instructions a
// step with a dependent path of 14 in K13's unrolled chain
// (tools/probe_ops.py chain_sass).
//
// rx_f64_sub_u32 (K11 alone) keeps the JAX module's u32 steps in their
// order, with __clz for the smear-and-popcount count of leading zeros (the
// same value for every word, 32 for 0).
//
// Contract of the arithmetic, as in the JAX module: rx_f64_add_u32 rounds to
// nearest even for non-negative, normal-or-zero operands whose sum does not
// overflow; rx_f64_sub_u32 for a >= b >= 0, both normal or zero. Outside it
// both return the JAX module's bits, not IEEE's.
//
// Compiled for the card under nvcc; with RX_EXACTF64_HOST defined a host
// compiler builds the same functions (the CPU tests hold them against the
// plain version that way).
#pragma once
#include <stdint.h>

#if defined(__CUDACC__)
#define RX_F64_FN __device__ __forceinline__
#define RX_F64_CLZ(x) ((unsigned)__clz((int)(x)))
#define RX_F64_MIN(x, y) min((x), (y))
#elif defined(RX_EXACTF64_HOST)
#define RX_F64_FN static inline
#define RX_F64_CLZ(x) ((x) ? (unsigned)__builtin_clz(x) : 32u)
#define RX_F64_MIN(x, y) ((x) < (y) ? (x) : (y))
#endif

#ifdef RX_F64_FN
// 1 iff x != 0, in u32 arithmetic
RX_F64_FN unsigned rx_nz(unsigned x) {
    return (x | (0u - x)) >> 31;
}

// a if c (a 0/1 flag) else b, branch-free
RX_F64_FN unsigned rx_mux(unsigned c, unsigned a, unsigned b) {
    const unsigned m = 0u - c;
    return b ^ ((a ^ b) & m);
}

// Logical right shift of the pair (hi:lo) by d, with the sticky flag of the
// bits shifted out; any d (d >= 64 moves everything into sticky).
RX_F64_FN void rx_shr_pair_sticky(unsigned hi, unsigned lo, unsigned d,
                                  unsigned& hi_s, unsigned& lo_s,
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

// Logical left shift of the pair (hi:lo) by k (its low 6 bits, as the JAX
// module's u32 steps read it).
RX_F64_FN void rx_shl_pair(unsigned hi, unsigned lo, unsigned k,
                           unsigned& hi_s, unsigned& lo_s) {
    const unsigned one_side = (k >> 5) & 1u;
    const unsigned k32 = k & 31u;
    const unsigned inv = (32u - k32) & 31u;
    const unsigned hi_small = rx_mux(rx_nz(k32), (hi << k32) | (lo >> inv), hi);
    const unsigned lo_small = lo << k32;
    hi_s = rx_mux(one_side, lo << k32, hi_small);
    lo_s = rx_mux(one_side, 0u, lo_small);
}

// The 53-bit mantissa (implicit bit always set, exponent 0 included)
// shifted up by two guard bits.
RX_F64_FN uint64_t rx_f64_m55(unsigned h, unsigned l) {
    return ((uint64_t)((h & 0xFFFFFu) | 0x100000u) << 34) | ((uint64_t)l << 2);
}

// RN(a + b): the larger word's mantissa plus the smaller one's aligned to
// it, rounded to nearest even; see the note at the top.
RX_F64_FN void rx_f64_add_u32(unsigned ah, unsigned al, unsigned bh,
                              unsigned bl, unsigned& ch, unsigned& cl) {
    const uint64_t a = ((uint64_t)ah << 32) | al;
    const uint64_t b = ((uint64_t)bh << 32) | bl;
    const uint64_t ma = rx_f64_m55(ah, al), mb = rx_f64_m55(bh, bl);
    const unsigned ea = ah >> 20, eb = bh >> 20;
    const unsigned d_ab = RX_F64_MIN(ea - eb, 63u);  // b the smaller
    const unsigned d_ba = RX_F64_MIN(eb - ea, 63u);  // a the smaller
    const bool swap = b > a;
    const uint64_t x = swap ? mb : ma;
    const uint64_t y = swap ? ma : mb;
    const unsigned d = swap ? d_ba : d_ab;
    const unsigned top = (swap ? eb : ea) << 20;
    // y < 2^55, so a shift by 55..63 leaves 0 and every bit sticky
    const uint64_t ys = y >> d;
    const bool sticky = (ys << d) != y;
    const unsigned low = (unsigned)ys;
    // exact ties: the dropped bits are 10 (sum below 2^55) or 100 (above);
    // x's two guard bits are 0, so the sum's low bits are those of x ^ ys
    const uint64_t tie0 = (!sticky && (low & 3u) == 2u) ? 1u : 0u;
    const uint64_t tie1 =
        (!sticky && ((low ^ (unsigned)x) & 7u) == 4u) ? 1u : 0u;
    const uint64_t t0 = x + ys + 2u;
    const uint64_t t1 = x + ys + 4u;
    const uint64_t m0 = (t0 >> 2) & ~tie0;
    const uint64_t m1 = (t1 >> 3) & ~tie1;
    const bool carry = (t0 >> 55) != 0;
    const unsigned h = carry ? top + (unsigned)(m1 >> 32)
                             : top - 0x100000u + (unsigned)(m0 >> 32);
    const unsigned l = carry ? (unsigned)m1 : (unsigned)m0;
    const bool zero = a == 0 || b == 0;
    const uint64_t z = a | b;
    ch = zero ? (unsigned)(z >> 32) : h;
    cl = zero ? (unsigned)z : l;
}

// RN(a - b) for a >= b >= 0: three extension bits with the sticky bit in
// the lowest, a full-width subtraction, renormalisation by the count of
// leading zeros, round to nearest even, and the exact denormal branch.
RX_F64_FN void rx_f64_sub_u32(unsigned ah, unsigned al, unsigned bh,
                              unsigned bl, unsigned& ch, unsigned& cl) {
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
    const unsigned lead =
        rx_mux(rx_nz(d_h), RX_F64_CLZ(d_h), 32u + RX_F64_CLZ(d_l));
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
#endif  // RX_F64_FN
