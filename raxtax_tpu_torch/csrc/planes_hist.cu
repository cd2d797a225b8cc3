// K3 planes_hist: intersection-size histogram straight from counter planes.
//
// Replaces the TPU kernel _hist_kernel (ops/planes.py of the JAX package:
// planes_histogram), which has no scatter and counts value v as the
// popcount of the AND of the P planes, each taken plain or complemented by
// v's bits. out[b, v] is the number of tips of query b whose count is v,
// for v < s_max: counts at or past s_max are dropped, and the pad tips (bit
// positions past num_tips in the 32 * W grid, count 0) are taken out of
// bucket 0. out must be zero-filled by the caller.
//
// Bound: bytes -- the planes read once (B * P * W words) and the histogram
// written. Counting takes P + 59 operations per word (the ORs, the minterm
// tree, 16 popcounts and adds: a sixth of the bytes' time at P = 10) and
// 3 P + 1 more per tip of 16 or more.
//
// Design for Hopper. Nearly every count is small (an unrelated reference
// shares a few k-mers with a query), so the kernel splits the counts at 16.
// For each word a thread ORs planes 4..P-1 into hi. The tips outside hi
// have counts below 16 and are counted the TPU's way over the four low
// planes only: 16 minterms (an AND tree of 30 operations on ~hi), one
// popcount each, summed into 16 register counters -- no atomics. The tips in
// hi (counts >= 16: mostly the query's own family) are decoded one by one
// from the planes the thread already holds and added to a shared-memory
// histogram. At the end each warp reduces its 16 counters
// (__reduce_add_sync) into one shared add per bucket, and the CTA adds its
// non-empty buckets to out with one global atomic each. Integer sums do not
// depend on order: the result is exact. A CTA covers HIST_WORDS consecutive
// words of one query; a thread loads every plane of HIST_UNROLL words
// before it counts them, to keep loads in flight. Warp-aggregated tail
// atomics (__match_any_sync, one add per distinct count and step) were
// tried and lost: 3.2 times slower where nearly every tip is in the tail
// with its count spread, 1.1 times where every tip holds one count
// (PERF.md).
#include "rx_common.cuh"

namespace {

constexpr int HIST_THREADS = 128;
constexpr int HIST_UNROLL = 2;  // words a thread loads before counting
constexpr int HIST_ROUNDS = 4;  // such loads per thread
constexpr int HIST_WORDS = HIST_THREADS * HIST_UNROLL * HIST_ROUNDS;
constexpr int HIST_SMEM_MAX = 12288;  // ints of static-limit dynamic smem
constexpr int MAX_PLANES = 24;
constexpr int LOW = 16;  // counts below this are counted by minterms
constexpr unsigned FULL = 0xffffffffu;

// cnt[v] += the bits of m whose count, read from planes x0..x3, is v.
__device__ __forceinline__ void count_low(int (&cnt)[LOW], unsigned m,
                                          unsigned x0, unsigned x1,
                                          unsigned x2, unsigned x3) {
    // index = the count's high bits decided so far
    const unsigned a[2] = {m & ~x3, m & x3};
    unsigned b[4], c[8];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        b[2 * i] = a[i] & ~x2;
        b[2 * i + 1] = a[i] & x2;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        c[2 * i] = b[i] & ~x1;
        c[2 * i + 1] = b[i] & x1;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        cnt[2 * i] += __popc(c[i] & ~x0);
        cnt[2 * i + 1] += __popc(c[i] & x0);
    }
}

// NP: planes the loops unroll over (P rounded up to a compiled width).
template <bool SMEM, int NP>
__global__ void __launch_bounds__(HIST_THREADS)
planes_hist_kernel(const uint32_t* __restrict__ planes,  // [B, P, W]
                   int* __restrict__ out,                // [B, s_max]
                   int P, long long W, int s_max, int pad_tips) {
    extern __shared__ int sh[];
    const int b = blockIdx.y;
    const unsigned lane = threadIdx.x & 31u;
    int* dst = out + (long long)b * s_max;
    if (SMEM) {
        for (int i = threadIdx.x; i < s_max; i += HIST_THREADS) sh[i] = 0;
        __syncthreads();
    }
    int* acc = SMEM ? sh : dst;
    const uint32_t* base = planes + (long long)b * P * W;
    const long long w0 = (long long)blockIdx.x * HIST_WORDS + threadIdx.x;
    const bool tail = s_max > LOW;  // else every count >= 16 is dropped
    int cnt[LOW];
#pragma unroll
    for (int v = 0; v < LOW; ++v) cnt[v] = 0;

#pragma unroll 1
    for (int r = 0; r < HIST_ROUNDS; ++r) {
        uint32_t x[HIST_UNROLL][NP], hi[HIST_UNROLL];
        bool in[HIST_UNROLL];
#pragma unroll
        for (int u = 0; u < HIST_UNROLL; ++u) {
            const long long w =
                w0 + (long long)(r * HIST_UNROLL + u) * HIST_THREADS;
            in[u] = w < W;
#pragma unroll
            for (int p = 0; p < NP; ++p)
                x[u][p] = in[u] && p < P ? __ldg(base + p * W + w) : 0u;
            hi[u] = 0u;
#pragma unroll
            for (int p = 4; p < NP; ++p) hi[u] |= x[u][p];
        }
#pragma unroll
        for (int u = 0; u < HIST_UNROLL; ++u)
            count_low(cnt, in[u] ? ~hi[u] : 0u, x[u][0], x[u][1], x[u][2],
                      x[u][3]);
        if (!tail) continue;
#pragma unroll
        for (int u = 0; u < HIST_UNROLL; ++u) {
            unsigned t = hi[u];  // 0 past the row's end
            if (t == 0u) continue;
            const uint32_t(&pl)[NP] = x[u];
            do {
                const int bit = __ffs(t) - 1;
                t &= t - 1u;
                int c = 0;
#pragma unroll
                for (int p = 0; p < NP; ++p)
                    c |= (int)((pl[p] >> bit) & 1u) << p;
                if (c < s_max) atomicAdd(&acc[c], 1);
            } while (t != 0u);
        }
    }
    // the warp's low counters: one add per bucket, by the lane of its index
#pragma unroll
    for (int v = 0; v < LOW; ++v) {
        const int sum = __reduce_add_sync(FULL, cnt[v]);
        if (lane == (unsigned)v && v < s_max && sum) atomicAdd(&acc[v], sum);
    }
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
    dim3 grid(rx_div_up(W, HIST_WORDS), B);
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
