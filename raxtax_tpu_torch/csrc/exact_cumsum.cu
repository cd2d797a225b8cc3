// K5 exact_cumsum: strictly sequential IEEE f64 prefix sum along tips.
//
// Replaces the TPU kernel _scan_kernel (ops/exactscan.py of the JAX
// package), which has no f64 unit and adds u32 halves in software. Here
//     cum[b, 0] = 0,   cum[b, t + 1] = fl64(cum[b, t] + p[b, t])
// in hardware doubles, one add after the other in tip order: no parallel
// scan, no reassociation, no fused multiply-add (there is no multiply), and
// the file must never be built with --use_fast_math. The result is the bit
// pattern a sequential host loop produces.
//
// Design for Hopper. One thread walks one query's chain and carries the
// running sum in a register. A block owns SCAN_QUERIES queries; all of its
// threads load a tile of SCAN_TILE tips per query into shared memory with
// loads coalesced along tips, the walker threads add through their rows in
// place, and all threads store the tile back coalesced. Few queries per
// block spreads the B chains over more SMs, so more load/store units work
// for the same B.
//
// Bound: the byte bound is one read and one write of B * N doubles, but only
// B chains exist, so the kernel is limited by the dependent-add latency
// times N.
#include "rx_common.cuh"

namespace {

constexpr int SCAN_QUERIES = 8;
constexpr int SCAN_TILE = 256;
constexpr int SCAN_THREADS = 128;

__global__ void __launch_bounds__(SCAN_THREADS)
exact_cumsum_kernel(const double* __restrict__ p,  // [B, N]
                    double* __restrict__ cum,      // [B, N + 1]
                    int B, long long N) {
    // +1 column: the walkers' row strides fall on different banks
    __shared__ double tile[SCAN_QUERIES][SCAN_TILE + 1];
    const int q0 = blockIdx.x * SCAN_QUERIES;
    const int nq = min(SCAN_QUERIES, B - q0);
    double acc = 0.0;
    if (threadIdx.x < nq)
        cum[(long long)(q0 + threadIdx.x) * (N + 1)] = 0.0;
    for (long long t0 = 0; t0 < N; t0 += SCAN_TILE) {
        const int nt = (int)min((long long)SCAN_TILE, N - t0);
        for (int i = threadIdx.x; i < nq * SCAN_TILE; i += SCAN_THREADS) {
            const int r = i / SCAN_TILE, t = i % SCAN_TILE;
            tile[r][t] = (t < nt) ? p[(long long)(q0 + r) * N + t0 + t] : 0.0;
        }
        __syncthreads();
        if (threadIdx.x < nq) {
            double* row = tile[threadIdx.x];
#pragma unroll 8
            for (int t = 0; t < nt; ++t) {
                acc = __dadd_rn(acc, row[t]);
                row[t] = acc;
            }
        }
        __syncthreads();
        for (int i = threadIdx.x; i < nq * SCAN_TILE; i += SCAN_THREADS) {
            const int r = i / SCAN_TILE, t = i % SCAN_TILE;
            if (t < nt)
                cum[(long long)(q0 + r) * (N + 1) + 1 + t0 + t] = tile[r][t];
        }
        __syncthreads();
    }
}

}  // namespace

RX_EXPORT int rx_exact_cumsum(const void* p, void* cum, int B, long long N,
                              void* stream) {
    if (B <= 0) return 0;
    if (N < 0) return (int)cudaErrorInvalidValue;
    exact_cumsum_kernel<<<rx_div_up(B, SCAN_QUERIES), SCAN_THREADS, 0,
                          (cudaStream_t)stream>>>(
        (const double*)p, (double*)cum, B, N);
    return (int)cudaGetLastError();
}
