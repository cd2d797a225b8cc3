// K5 exact_cumsum: strictly sequential IEEE f64 prefix sum along tips.
//
// Replaces the TPU kernel _scan_kernel (raxtax_tpu/ops/exactscan.py:46,
// pallas_call at :117), which has no f64 unit and adds u32 halves in
// software. Here
//     cum[b, 0] = 0,   cum[b, t + 1] = fl64(cum[b, t] + p[b, t])
// in hardware doubles, one add after the other in tip order: no parallel
// scan, no reassociation, no fused multiply-add (there is no multiply), and
// the file must never be built with --use_fast_math. The result is the bit
// pattern a sequential host loop produces.
//
// Bound. The bytes are one read and one write of B * N doubles (1.24 ms at
// B = 256, N = 1,015,808 on an H100 at 3.35 TB/s), but only B chains exist
// and each is a chain of N dependent adds, so the floor is N times the
// latency of one dependent __dadd_rn. rx_dadd_chain below measures that
// latency on the card it runs on (one thread, the addends in registers);
// chip_smoke.py reads it in every run and reports K5's chain_floor_ms.
//
// Design for Hopper. A CTA owns SCAN_CHAINS queries, so B = 256 chains
// spread over 128 CTAs, one per SM, and every SM's load/store path carries
// its share of the bytes. Warp 0 walks: lane c carries chain c's running sum
// in a register and reads its addends from shared memory sixteen at a time
// (eight 16-byte loads into a register batch, filled while the previous
// batch is added), so the loop carries only the DADD -> DADD dependence. The
// sums go to a separate staging tile, each batch stored while the next one
// is added, so no add waits for a store to read the register it rewrites.
// The other warps copy: they keep SCAN_STAGES - 1 tiles of SCAN_TILE tips
// per chain in flight with cp.async into a ring, and drain each finished
// staging tile to global memory while the walker moves on. Walker and copy
// warps meet only on named barriers per ring slot (bar.arrive on one side,
// bar.sync on the other): the walker waits only for a tile that has not
// arrived, never for a store. Ragged edges: the last tile is partial (the
// walker runs its batch past the tail on stale values that are never stored;
// only the last tile is short, so the carried sum is never read after it), a
// CTA may hold fewer chains than SCAN_CHAINS, and N = 0 writes only the zero
// column.
#include "rx_common.cuh"

namespace {

constexpr int SCAN_CHAINS = 2;   // chains per CTA: lanes 0..1 of the walker warp
constexpr int SCAN_TILE = 1024;  // tips per ring slot and chain
constexpr int SCAN_STAGES = 4;   // ring slots (3 and 6 walked slower)
constexpr int SCAN_COPY_WARPS = 3;
constexpr int SCAN_COPIERS = 32 * SCAN_COPY_WARPS;
constexpr int SCAN_THREADS = 32 + SCAN_COPIERS;
// row stride in doubles: the two walkers' 16-byte loads fall on other banks
constexpr int SCAN_ROW = SCAN_TILE + 2;
constexpr int SCAN_BATCH = 16;  // addends per register batch
constexpr int SCAN_SLOT = SCAN_CHAINS * SCAN_ROW;  // doubles per ring slot
constexpr size_t SCAN_SMEM = 2 * SCAN_STAGES * SCAN_SLOT * sizeof(double);
// named barriers 1..STAGES: slot s filled; STAGES+1..2*STAGES: slot s summed
constexpr int BAR_FULL = 1;
constexpr int BAR_DONE = 1 + SCAN_STAGES;
static_assert(SCAN_TILE % SCAN_BATCH == 0, "a tile is whole batches");
static_assert(2 * SCAN_STAGES < 16, "hardware has 16 named barriers");

__device__ __forceinline__ void bar_sync(int id) {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(SCAN_THREADS) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
    asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(SCAN_THREADS) : "memory");
}

__device__ __forceinline__ void cp_async8(double* smem, const double* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(s), "l"(gmem)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Eight 16-byte loads: addends u * 16 .. u * 16 + 15 of one row.
__device__ __forceinline__ void load_batch(double2 (&x)[SCAN_BATCH / 2],
                                           const double2* row, int u) {
#pragma unroll
    for (int i = 0; i < SCAN_BATCH / 2; ++i) x[i] = row[u * (SCAN_BATCH / 2) + i];
}

// Sixteen dependent adds into the register batch y. After each pair, one
// 16-byte store of the previous batch's sums (prev): a register that a store
// still has to read is rewritten only a whole batch later, so no add waits
// for a store.
template <bool STORE_PREV>
__device__ __forceinline__ double add_batch(double acc,
                                            const double2 (&x)[SCAN_BATCH / 2],
                                            double2 (&y)[SCAN_BATCH / 2],
                                            const double2 (&prev)[SCAN_BATCH / 2],
                                            double2* out, int u_prev) {
#pragma unroll
    for (int i = 0; i < SCAN_BATCH / 2; ++i) {
        acc = __dadd_rn(acc, x[i].x);
        y[i].x = acc;
        acc = __dadd_rn(acc, x[i].y);
        y[i].y = acc;
        if (STORE_PREV) out[u_prev * (SCAN_BATCH / 2) + i] = prev[i];
    }
    return acc;
}

__device__ __forceinline__ void store_batch(const double2 (&y)[SCAN_BATCH / 2],
                                            double2* out, int u) {
#pragma unroll
    for (int i = 0; i < SCAN_BATCH / 2; ++i) out[u * (SCAN_BATCH / 2) + i] = y[i];
}

// One chain through one tile of nt tips, in whole batches: the addends of
// batch u + 1 load while batch u adds, the sums of batch u - 1 store.
__device__ __forceinline__ double walk_tile(double acc, const double* in,
                                            double* out, int nt) {
    const double2* in2 = reinterpret_cast<const double2*>(in);
    double2* out2 = reinterpret_cast<double2*>(out);
    const int steps = (nt + SCAN_BATCH - 1) / SCAN_BATCH;
    double2 a[SCAN_BATCH / 2], b[SCAN_BATCH / 2];
    double2 ya[SCAN_BATCH / 2], yb[SCAN_BATCH / 2];
    load_batch(a, in2, 0);
    if (steps > 1) load_batch(b, in2, 1);
    acc = add_batch<false>(acc, a, ya, yb, out2, 0);
    for (int u = 1;; u += 2) {
        if (u >= steps) { store_batch(ya, out2, u - 1); break; }
        if (u + 1 < steps) load_batch(a, in2, u + 1);
        acc = add_batch<true>(acc, b, yb, ya, out2, u - 1);
        if (u + 1 >= steps) { store_batch(yb, out2, u); break; }
        if (u + 2 < steps) load_batch(b, in2, u + 2);
        acc = add_batch<true>(acc, a, ya, yb, out2, u);
    }
    return acc;
}

__global__ void __launch_bounds__(SCAN_THREADS, 1)
exact_cumsum_kernel(const double* __restrict__ p,  // [B, N]
                    double* __restrict__ cum,      // [B, N + 1]
                    int B, long long N) {
    extern __shared__ __align__(16) double smem[];
    double* tin = smem;                             // [STAGES][CHAINS][ROW]
    double* tout = smem + SCAN_STAGES * SCAN_SLOT;  // the same, for the sums
    const int q0 = blockIdx.x * SCAN_CHAINS;
    const int nq = min(SCAN_CHAINS, B - q0);
    const long long n_tiles = (N + SCAN_TILE - 1) / SCAN_TILE;
    auto tips = [&](long long j) {
        return (int)min((long long)SCAN_TILE, N - j * SCAN_TILE);
    };

    if (threadIdx.x < 32) {  // the walker warp
        const int c = threadIdx.x;
        double acc = 0.0;
        if (c < nq) cum[(long long)(q0 + c) * (N + 1)] = 0.0;
        for (long long j = 0; j < n_tiles; ++j) {
            const int s = (int)(j % SCAN_STAGES);
            bar_sync(BAR_FULL + s);
            if (c < nq)
                acc = walk_tile(acc, tin + s * SCAN_SLOT + c * SCAN_ROW,
                                tout + s * SCAN_SLOT + c * SCAN_ROW, tips(j));
            __syncwarp();
            __threadfence_block();
            bar_arrive(BAR_DONE + s);
        }
        return;
    }

    // the copy warps: tile j goes into slot j % STAGES, coalesced along tips
    const int h = threadIdx.x - 32;
    auto load_tile = [&](long long j) {
        double* slot = tin + (j % SCAN_STAGES) * SCAN_SLOT;
        const int nt = tips(j);
        for (int r = 0; r < nq; ++r) {
            const double* src = p + (long long)(q0 + r) * N + j * SCAN_TILE;
            for (int t = h; t < nt; t += SCAN_COPIERS)
                cp_async8(slot + r * SCAN_ROW + t, src + t);
        }
    };
    auto store_tile = [&](long long j) {
        const double* slot = tout + (j % SCAN_STAGES) * SCAN_SLOT;
        const int nt = tips(j);
        for (int r = 0; r < nq; ++r) {
            double* dst = cum + (long long)(q0 + r) * (N + 1) + 1 + j * SCAN_TILE;
            for (int t = h; t < nt; t += SCAN_COPIERS)
                __stcs(dst + t, slot[r * SCAN_ROW + t]);
        }
    };
    for (int j = 0; j < SCAN_STAGES - 1; ++j) {
        if (j < n_tiles) load_tile(j);
        cp_async_commit();
    }
    for (long long j = 0; j < n_tiles; ++j) {
        // one group per tile, committed in order: tile j has landed when at
        // most the STAGES - 2 later groups are still pending
        cp_async_wait<SCAN_STAGES - 2>();
        __threadfence_block();
        bar_arrive(BAR_FULL + (int)(j % SCAN_STAGES));
        if (j > 0) {
            // tile j - 1 summed: drain it, then refill its slot
            bar_sync(BAR_DONE + (int)((j - 1) % SCAN_STAGES));
            store_tile(j - 1);
        }
        if (j + SCAN_STAGES - 1 < n_tiles) load_tile(j + SCAN_STAGES - 1);
        cp_async_commit();
    }
    if (n_tiles > 0) {
        bar_sync(BAR_DONE + (int)((n_tiles - 1) % SCAN_STAGES));
        store_tile(n_tiles - 1);
    }
}

// The chain floor's yardstick: one thread adds the eight addends x[i % 8]
// into one register, steps times (a multiple of DADD_UNROLL), each add
// waiting on the one before, as K5's walker does but with no memory traffic.
// out[0] is the sum (a sequential host loop gives the same bits), out[1]
// the SM cycles the loop took (clock64).
constexpr int DADD_UNROLL = 32;

__global__ void dadd_chain_kernel(const double* __restrict__ x,
                                  double* __restrict__ out, long long steps) {
    double r[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) r[i] = x[i];
    double acc = 0.0;
    const long long t0 = clock64();
    for (long long i = 0; i < steps; i += DADD_UNROLL) {
#pragma unroll
        for (int k = 0; k < DADD_UNROLL; ++k) acc = __dadd_rn(acc, r[k % 8]);
    }
    const long long t1 = clock64();
    out[0] = acc;
    out[1] = (double)(t1 - t0);
}

}  // namespace

RX_EXPORT int rx_dadd_chain(const void* x, void* out, long long steps,
                            void* stream) {
    if (steps < 0 || steps % DADD_UNROLL != 0) return (int)cudaErrorInvalidValue;
    dadd_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
        (const double*)x, (double*)out, steps);
    return (int)cudaGetLastError();
}

RX_EXPORT int rx_exact_cumsum(const void* p, void* cum, int B, long long N,
                              void* stream) {
    if (B <= 0) return 0;
    if (N < 0) return (int)cudaErrorInvalidValue;
    // above 48 KB of dynamic shared memory only by request (per device)
    const cudaError_t e = cudaFuncSetAttribute(
        exact_cumsum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SCAN_SMEM);
    if (e != cudaSuccess) return (int)e;
    exact_cumsum_kernel<<<rx_div_up(B, SCAN_CHAINS), SCAN_THREADS, SCAN_SMEM,
                          (cudaStream_t)stream>>>(
        (const double*)p, (double*)cum, B, N);
    return (int)cudaGetLastError();
}
