// K8 planes_high_counts: the counts above 15, bit-major.
//
// Replaces the TPU kernel of planes_high_counts (ops/planes.py of the JAX
// package). For the tip at (word w, bit):
//     out[b, bit, w] = count  if count > 15  else 0
// where the count is decoded from all P planes. The low nibble of a count
// travels as the four tier planes themselves; this array feeds the overflow
// list of the compressed wire (ops/compress.py). Words past W do not exist
// here, so the TPU kernel's tile-padding mask has no counterpart.
//
// Design for Hopper. One thread loads the P planes of one word into
// registers once and emits its 32 values; for a fixed bit adjacent threads
// write adjacent words, so every store is coalesced. A count exceeds 15
// exactly when a plane at or above 4 has the bit set, so the OR of those
// planes decides per bit whether anything is decoded at all.
//
// Bound: bytes -- the planes are read once (4 P bytes per word), the output
// is 4 bytes per tip (128 bytes per word) and dominates.
#include "rx_common.cuh"

namespace {

constexpr int HIGH_THREADS = 256;
constexpr int MAX_PLANES = 24;

__global__ void __launch_bounds__(HIGH_THREADS)
planes_high_kernel(const uint32_t* __restrict__ planes,  // [B, P, W]
                   int* __restrict__ out,                // [B, 32, W]
                   int P, long long W) {
    const int b = blockIdx.y;
    const long long w = (long long)blockIdx.x * HIGH_THREADS + threadIdx.x;
    if (w >= W) return;
    const uint32_t* base = planes + (long long)b * P * W + w;
    uint32_t pl[MAX_PLANES];
    uint32_t high_or = 0;
#pragma unroll
    for (int p = 0; p < MAX_PLANES; ++p) {
        pl[p] = (p < P) ? base[(long long)p * W] : 0u;
        if (p >= 4) high_or |= pl[p];
    }
    int* o = out + (long long)b * 32 * W + w;
    for (int bit = 0; bit < 32; ++bit) {
        int c = 0;
        if ((high_or >> bit) & 1u) {
#pragma unroll
            for (int p = 0; p < MAX_PLANES; ++p)
                c |= (int)((pl[p] >> bit) & 1u) << p;
        }
        o[(long long)bit * W] = c;
    }
}

}  // namespace

RX_EXPORT int rx_planes_high(const void* planes, void* out, int B, int P,
                             long long W, void* stream) {
    if (B <= 0 || W <= 0) return 0;
    if (P < 1 || P > MAX_PLANES || B > 65535)
        return (int)cudaErrorInvalidValue;
    dim3 grid(rx_div_up(W, HIGH_THREADS), B);
    planes_high_kernel<<<grid, HIGH_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)planes, (int*)out, P, W);
    return (int)cudaGetLastError();
}
