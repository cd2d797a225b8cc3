// K4 planes_probs: per-tip table lookup from counter planes, bit-major.
//
// Replaces the TPU kernel _probs_kernel (ops/planes.py of the JAX package),
// a select tree over the plane bits run once per u32 half of the f64 table.
// Here   out[b, bit, w] = table[b, count of the tip at (word w, bit)]
// in one launch, for a float or a double table:
//   - the count is decoded from the low `mux_bits` planes only (a count
//     masked to its low bits, as the TPU kernel's narrow multiplexer reads
//     it); entries at or past s_max read as 0, like the zero-padded leaves;
//   - with zero_high, a tip with any plane bit at or above mux_bits set gets
//     0 instead.
// With the flat postings layout the bit-major output IS tip order.
//
// Design for Hopper. The block copies the query's table row into shared
// memory (when it fits the 48 KB static limit; else it reads the row through
// L2), each thread loads the planes of one word into registers once and
// emits its 32 values. For a fixed bit, adjacent threads write adjacent
// words, so every store is coalesced.
//
// Bound: bytes, the output write dominates (B * 32 * W values).
#include "rx_common.cuh"

namespace {

constexpr int PROBS_THREADS = 256;
constexpr int PROBS_SMEM_BYTES = 48 * 1024;
constexpr int MAX_PLANES = 24;

// NP: how many planes a thread keeps in registers and decodes (mux_bits
// rounded up to one of a few compiled widths; planes past mux_bits are 0).
template <typename T, bool SMEM, int NP>
__global__ void __launch_bounds__(PROBS_THREADS)
planes_probs_kernel(const uint32_t* __restrict__ planes,  // [B, P, W]
                    const T* __restrict__ table,          // [B, s_max]
                    T* __restrict__ out,                  // [B, 32, W]
                    int P, long long W, int s_max, int mux_bits,
                    int zero_high) {
    extern __shared__ __align__(16) unsigned char sh_raw[];
    T* sh = reinterpret_cast<T*>(sh_raw);
    const int b = blockIdx.y;
    const T* row = table + (long long)b * s_max;
    if (SMEM) {
        for (int i = threadIdx.x; i < s_max; i += PROBS_THREADS)
            sh[i] = row[i];
        __syncthreads();
    }
    const T* tab = SMEM ? sh : row;
    const long long w = (long long)blockIdx.x * PROBS_THREADS + threadIdx.x;
    if (w >= W) return;
    const uint32_t* base = planes + (long long)b * P * W + w;
    uint32_t pl[NP];
#pragma unroll
    for (int p = 0; p < NP; ++p)
        pl[p] = (p < mux_bits) ? base[(long long)p * W] : 0u;
    uint32_t high_or = 0;
    if (zero_high)
        for (int p = mux_bits; p < P; ++p) high_or |= base[(long long)p * W];
    T* o = out + (long long)b * 32 * W + w;
    for (int bit = 0; bit < 32; ++bit) {
        int c = 0;
#pragma unroll
        for (int p = 0; p < NP; ++p)
            c |= (int)((pl[p] >> bit) & 1u) << p;
        T v = (c < s_max) ? tab[c] : T(0);
        if ((high_or >> bit) & 1u) v = T(0);
        o[(long long)bit * W] = v;
    }
}

template <typename T, int NP>
int launch_np(const void* planes, const void* table, void* out, int B, int P,
              long long W, int s_max, int mux_bits, int zero_high,
              cudaStream_t s) {
    dim3 grid(rx_div_up(W, PROBS_THREADS), B);
    const size_t bytes = (size_t)s_max * sizeof(T);
    if (bytes <= (size_t)PROBS_SMEM_BYTES) {
        planes_probs_kernel<T, true, NP><<<grid, PROBS_THREADS, bytes, s>>>(
            (const uint32_t*)planes, (const T*)table, (T*)out, P, W, s_max,
            mux_bits, zero_high);
    } else {
        planes_probs_kernel<T, false, NP><<<grid, PROBS_THREADS, 0, s>>>(
            (const uint32_t*)planes, (const T*)table, (T*)out, P, W, s_max,
            mux_bits, zero_high);
    }
    return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* planes, const void* table, void* out, int B, int P,
           long long W, int s_max, int mux_bits, int zero_high,
           cudaStream_t s) {
    if (mux_bits <= 8)
        return launch_np<T, 8>(planes, table, out, B, P, W, s_max, mux_bits,
                               zero_high, s);
    if (mux_bits <= 12)
        return launch_np<T, 12>(planes, table, out, B, P, W, s_max, mux_bits,
                                zero_high, s);
    if (mux_bits <= 16)
        return launch_np<T, 16>(planes, table, out, B, P, W, s_max, mux_bits,
                                zero_high, s);
    return launch_np<T, MAX_PLANES>(planes, table, out, B, P, W, s_max,
                                    mux_bits, zero_high, s);
}

}  // namespace

// elem_bytes: 4 for a float table, 8 for a double table.
RX_EXPORT int rx_planes_probs(const void* planes, const void* table,
                              void* out, int B, int P, long long W, int s_max,
                              int mux_bits, int zero_high, int elem_bytes,
                              void* stream) {
    if (B <= 0 || W <= 0) return 0;
    if (P < 1 || P > MAX_PLANES || mux_bits < 1 || mux_bits > P ||
        s_max < 1 || B > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (elem_bytes == 8)
        return launch<double>(planes, table, out, B, P, W, s_max, mux_bits,
                              zero_high, s);
    if (elem_bytes == 4)
        return launch<float>(planes, table, out, B, P, W, s_max, mux_bits,
                             zero_high, s);
    return (int)cudaErrorInvalidValue;
}
