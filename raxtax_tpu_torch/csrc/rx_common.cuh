// Shared by every kernel source of the port. Each .cu file builds into its
// own shared library with a plain C interface (loaded with ctypes): pointers
// and the stream arrive as void*, every entry point returns
// cudaGetLastError() right after its launch, and nothing synchronises or
// allocates here.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define RX_EXPORT extern "C" __attribute__((visibility("default")))

// Text of a CUDA error code, for the Python wrapper's exception message.
RX_EXPORT const char* rx_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

static inline int rx_div_up(long long a, long long b) {
    return (int)((a + b - 1) / b);
}

#ifdef __CUDACC__
// One 16-byte cp.async from device to shared memory, through L2 only; a
// src_bytes of 0 zero-fills the 16 bytes and reads nothing. The folds (K1,
// K2, K10) stage their rows with it, one commit group per ring stage.
__device__ __forceinline__ void rx_cp_async16(uint4* smem, const uint4* gmem,
                                              int src_bytes) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
                 "l"(gmem), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void rx_cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most N of this thread's commit groups are still in flight.
template <int N>
__device__ __forceinline__ void rx_cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Full adder on bit vectors: s = a ^ b ^ c, carry = majority(a, b, c).
__device__ __forceinline__ void rx_csa(uint4& s, uint4& carry, const uint4 a,
                                       const uint4 b, const uint4 c) {
    uint4 ab;
    ab.x = a.x ^ b.x; ab.y = a.y ^ b.y; ab.z = a.z ^ b.z; ab.w = a.w ^ b.w;
    carry.x = (a.x & b.x) | (ab.x & c.x);
    carry.y = (a.y & b.y) | (ab.y & c.y);
    carry.z = (a.z & b.z) | (ab.z & c.z);
    carry.w = (a.w & b.w) | (ab.w & c.w);
    s.x = ab.x ^ c.x; s.y = ab.y ^ c.y; s.z = ab.z ^ c.z; s.w = ab.w ^ c.w;
}

// One Harley-Seal step shared by the folds (K1, K2, K9, K10): 16 postings
// rows x[0..15] go through the carry-save adder tree into the ones / twos /
// fours / eights tiers, and the weight-16 carry ripples into the NH binary
// planes.
template <int NH>
__device__ __forceinline__ void rx_hs_fold16(uint4& ones, uint4& twos,
                                             uint4& fours, uint4& eights,
                                             uint4 (&high)[NH],
                                             const uint4 (&x)[16]) {
    uint4 t0, t1, f0, f1, e0, e1, carry;
    rx_csa(ones, t0, ones, x[0], x[1]);
    rx_csa(ones, t1, ones, x[2], x[3]);
    rx_csa(twos, f0, twos, t0, t1);
    rx_csa(ones, t0, ones, x[4], x[5]);
    rx_csa(ones, t1, ones, x[6], x[7]);
    rx_csa(twos, f1, twos, t0, t1);
    rx_csa(fours, e0, fours, f0, f1);
    rx_csa(ones, t0, ones, x[8], x[9]);
    rx_csa(ones, t1, ones, x[10], x[11]);
    rx_csa(twos, f0, twos, t0, t1);
    rx_csa(ones, t0, ones, x[12], x[13]);
    rx_csa(ones, t1, ones, x[14], x[15]);
    rx_csa(twos, f1, twos, t0, t1);
    rx_csa(fours, e1, fours, f0, f1);
    rx_csa(eights, carry, eights, e0, e1);
#pragma unroll
    for (int p = 0; p < NH; ++p) {
        const uint4 plane = high[p];
        high[p].x = plane.x ^ carry.x; carry.x = plane.x & carry.x;
        high[p].y = plane.y ^ carry.y; carry.y = plane.y & carry.y;
        high[p].z = plane.z ^ carry.z; carry.z = plane.z & carry.z;
        high[p].w = plane.w ^ carry.w; carry.w = plane.w & carry.w;
    }
}

// The tiers and planes of one thread's four words, stored as planes
// 0..3 + NH of an output laid out [4 + NH, W4].
template <int NH>
__device__ __forceinline__ void rx_store_planes(uint4* o, long long W4,
                                                const uint4 ones,
                                                const uint4 twos,
                                                const uint4 fours,
                                                const uint4 eights,
                                                const uint4 (&high)[NH]) {
    o[0] = ones;
    o[W4] = twos;
    o[2 * W4] = fours;
    o[3 * W4] = eights;
#pragma unroll
    for (int p = 0; p < NH; ++p) o[(long long)(4 + p) * W4] = high[p];
}
#endif  // __CUDACC__
