// K3 planes_hist: intersection-size histogram straight from counter planes.
//
// Replaces the TPU kernel _hist_kernel (ops/planes.py of the JAX package),
// which has no scatter and therefore ANDs the P planes once per possible
// value. Here each tip's count is decoded from its P plane bits and added to
// a per-block shared-memory histogram; blocks then add their non-empty
// buckets to out[b, :] with integer atomics (integer sums do not depend on
// order, so the result is exact). A thread keeps the P planes of one word in
// registers, counts the word's zero-count tips with one popcount and decodes
// only the set bits of the OR of all planes one by one.
//
// out must be zero-filled by the caller. The pad tips (bit positions past
// num_tips in the 32 * W grid) decode to count 0; they are taken out of
// bucket 0 here. Counts >= s_max cannot occur for a well-formed batch and
// are dropped.
//
// Bound: bytes (the planes are read once: B * P * W words).
#include "rx_common.cuh"

namespace {

constexpr int HIST_THREADS = 256;
constexpr int HIST_WORDS_PER_THREAD = 8;
constexpr int HIST_SMEM_MAX = 12288;  // ints of static-limit dynamic smem
constexpr int MAX_PLANES = 24;

// NP: planes kept in registers (P rounded up to a compiled width).
template <bool SMEM, int NP>
__global__ void __launch_bounds__(HIST_THREADS)
planes_hist_kernel(const uint32_t* __restrict__ planes,  // [B, P, W]
                   int* __restrict__ out,                // [B, s_max]
                   int P, long long W, int s_max, int pad_tips) {
    extern __shared__ int sh[];
    const int b = blockIdx.y;
    int* dst = out + (long long)b * s_max;
    if (SMEM) {
        for (int i = threadIdx.x; i < s_max; i += HIST_THREADS) sh[i] = 0;
        __syncthreads();
    }
    int* acc = SMEM ? sh : dst;
    const uint32_t* base = planes + (long long)b * P * W;
    const long long w0 =
        (long long)blockIdx.x * HIST_THREADS * HIST_WORDS_PER_THREAD;
    int zeros = 0;
    for (int i = 0; i < HIST_WORDS_PER_THREAD; ++i) {
        const long long w = w0 + (long long)i * HIST_THREADS + threadIdx.x;
        if (w >= W) break;
        uint32_t pl[NP];
        uint32_t any = 0;
#pragma unroll
        for (int p = 0; p < NP; ++p) {
            pl[p] = (p < P) ? base[(long long)p * W + w] : 0u;
            any |= pl[p];
        }
        zeros += __popc(~any);
        while (any) {
            const int bit = __ffs(any) - 1;
            any &= any - 1;
            int c = 0;
#pragma unroll
            for (int p = 0; p < NP; ++p)
                c |= (int)((pl[p] >> bit) & 1u) << p;
            if (c < s_max) atomicAdd(&acc[c], 1);
        }
    }
    if (zeros) atomicAdd(&acc[0], zeros);
    if (SMEM) {
        __syncthreads();
        for (int i = threadIdx.x; i < s_max; i += HIST_THREADS) {
            const int v = sh[i];
            if (v) atomicAdd(&dst[i], v);
        }
    }
    if (blockIdx.x == 0 && threadIdx.x == 0 && pad_tips)
        atomicAdd(&dst[0], -pad_tips);
}

template <int NP>
int launch(const void* planes, void* out, int B, int P, long long W,
           int s_max, int pad, cudaStream_t s) {
    dim3 grid(rx_div_up(W, HIST_THREADS * HIST_WORDS_PER_THREAD), B);
    if (s_max <= HIST_SMEM_MAX) {
        planes_hist_kernel<true, NP>
            <<<grid, HIST_THREADS, (size_t)s_max * sizeof(int), s>>>(
                (const uint32_t*)planes, (int*)out, P, W, s_max, pad);
    } else {
        planes_hist_kernel<false, NP><<<grid, HIST_THREADS, 0, s>>>(
            (const uint32_t*)planes, (int*)out, P, W, s_max, pad);
    }
    return (int)cudaGetLastError();
}

}  // namespace

RX_EXPORT int rx_planes_hist(const void* planes, void* out, int B, int P,
                             long long W, int s_max, long long num_tips,
                             void* stream) {
    if (B <= 0 || W <= 0) return 0;
    const long long pad = W * 32 - num_tips;
    if (P < 1 || P > MAX_PLANES || s_max < 1 || B > 65535 || pad < 0 ||
        pad > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int ipad = (int)pad;
    if (P <= 8) return launch<8>(planes, out, B, P, W, s_max, ipad, s);
    if (P <= 12) return launch<12>(planes, out, B, P, W, s_max, ipad, s);
    if (P <= 16) return launch<16>(planes, out, B, P, W, s_max, ipad, s);
    return launch<MAX_PLANES>(planes, out, B, P, W, s_max, ipad, s);
}
