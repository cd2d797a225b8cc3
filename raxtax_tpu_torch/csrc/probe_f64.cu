// K11 and K12: the software-f64 probes, on (hi, lo) u32 halves.
//
// K11 rx_probe_f64_ew replaces ew_kernel (scripts/probe_mosaic_f64.py:47,
// pallas_call at :62): per element c = RN(a + b) and RN(c - b), through
// rx_f64_add_u32 / rx_f64_sub_u32 (exactf64.cuh), never the card's f64 unit.
// One thread per element, grid-stride. Bound: its 32 bytes a pair (16 read,
// 16 written) against its integer instructions, about 260 a pair in the
// SASS (the add, the subtraction, the loads and stores); on an H100 the
// bytes weigh more.
//
// K12 rx_probe_f64_scan replaces make_scan/scan_kernel
// (probe_mosaic_f64.py:80-113, pallas_call at :125): a sequential prefix sum
// per lane over tips, cum[g, t, l] = RN(cum[g, t-1, l] + p[g, t, l]), in the
// layout [G, N, 128] of u32 halves (queries = G lane groups of 128). Bound:
// only B chains exist, so the latency of N dependent software adds limits
// it (its chain floor: N times the add's latency, which K13's f64_add_full
// chain measures), not the 16 bytes per (tip, query) it moves.
//
// K12's design is K5's (exact_cumsum.cu) in this layout. A CTA owns the
// SCAN_CHAINS = 32 lanes of one group that one warp holds (4 CTAs a group,
// 8 at B = 256). Warp 0 walks: lane c carries chain c's running sum (two
// registers) and reads its addends from shared memory SCAN_BATCH tips at a
// time into a register batch filled while the previous batch is added, and
// writes each sum to a separate staging tile, so the loop carries only the
// add -> add dependence. The other warps copy: they keep SCAN_STAGES - 1
// tiles of SCAN_TILE tips (both halves, 128 coalesced bytes per tip and
// half) in flight with cp.async into a ring, and drain each finished
// staging tile to global memory with 16-byte stores while the walker moves
// on. Walker and copy warps meet only on named barriers per ring slot
// (bar.arrive on one side, bar.sync on the other). Ragged edges: only the
// last tile is short, and the walker runs its last batch past the tail on
// stale shared words whose sums are never stored (the carried sum is not
// read after it); N = 0 writes nothing. The wrapper passes 16-byte aligned
// tensors.
//
// What the walker's step costs (sm_90a, tools/kernel_ab.py): its SASS
// holds about 70 instructions a step against the 53 of K13's f64_add_full
// step, whose addend is loop-invariant and hoisted; the dependent path is
// the same 14 to 15. One warp issues them in order, so the extra
// instructions show in the step's time (K12 walks at about 1.35 times the
// add's latency). Batches of 8 addends (68 registers) walk a quarter
// faster than batches of 16 (116 registers), batches of 4 within 2 %;
// storing the sums from a second register batch, as K5 does, and preparing
// a batch's addends ahead of its adds did not help (tools/kernel_ab.py on
// an H100).
#include "exactf64.cuh"
#include "rx_common.cuh"

namespace {

constexpr int EW_THREADS = 256;
constexpr int LANES = 128;          // lanes of a group
constexpr int SCAN_CHAINS = 32;     // chains per CTA: the walker warp's lanes
constexpr int SCAN_TILE = 64;       // tips per ring slot
constexpr int SCAN_STAGES = 4;      // ring slots
constexpr int SCAN_COPY_WARPS = 3;
constexpr int SCAN_COPIERS = 32 * SCAN_COPY_WARPS;
constexpr int SCAN_THREADS = 32 + SCAN_COPIERS;
constexpr int SCAN_BATCH = 8;       // addends per register batch
constexpr int SCAN_HALF = SCAN_TILE * SCAN_CHAINS;  // words of one half a slot
constexpr int SCAN_SLOT = 2 * SCAN_HALF;            // hi rows, then lo rows
constexpr int ROW_CHUNKS = SCAN_CHAINS / 4;  // 16-byte chunks a tip and half
constexpr size_t SCAN_SMEM = 2 * SCAN_STAGES * SCAN_SLOT * sizeof(unsigned);
// named barriers 1..STAGES: slot s filled; STAGES+1..2*STAGES: slot s summed
constexpr int BAR_FULL = 1;
constexpr int BAR_DONE = 1 + SCAN_STAGES;
static_assert(SCAN_TILE % SCAN_BATCH == 0, "a tile is whole batches");
static_assert(2 * SCAN_STAGES < 16, "hardware has 16 named barriers");
static_assert(LANES % SCAN_CHAINS == 0, "a group is whole CTAs");

__global__ void __launch_bounds__(EW_THREADS)
probe_f64_ew_kernel(const unsigned* __restrict__ ah,
                    const unsigned* __restrict__ al,
                    const unsigned* __restrict__ bh,
                    const unsigned* __restrict__ bl,
                    unsigned* __restrict__ ch, unsigned* __restrict__ cl,
                    unsigned* __restrict__ dh, unsigned* __restrict__ dl,
                    long long n) {
    const long long stride = (long long)gridDim.x * EW_THREADS;
    for (long long i = (long long)blockIdx.x * EW_THREADS + threadIdx.x; i < n;
         i += stride) {
        const unsigned xbh = bh[i], xbl = bl[i];
        unsigned sh, sl, th, tl;
        rx_f64_add_u32(ah[i], al[i], xbh, xbl, sh, sl);
        rx_f64_sub_u32(sh, sl, xbh, xbl, th, tl);
        ch[i] = sh;
        cl[i] = sl;
        dh[i] = th;
        dl[i] = tl;
    }
}

__device__ __forceinline__ void bar_sync(int id) {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(SCAN_THREADS) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
    asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(SCAN_THREADS) : "memory");
}

// The addends of batch u of lane x's column: both halves, into registers.
__device__ __forceinline__ void load_batch(unsigned (&h)[SCAN_BATCH],
                                           unsigned (&l)[SCAN_BATCH],
                                           const unsigned* in, int x, int u) {
#pragma unroll
    for (int i = 0; i < SCAN_BATCH; ++i) {
        const int t = u * SCAN_BATCH + i;
        h[i] = in[t * SCAN_CHAINS + x];
        l[i] = in[SCAN_HALF + t * SCAN_CHAINS + x];
    }
}

// SCAN_BATCH dependent software adds; each sum goes to the staging tile.
__device__ __forceinline__ void add_batch(unsigned& hi, unsigned& lo,
                                          const unsigned (&h)[SCAN_BATCH],
                                          const unsigned (&l)[SCAN_BATCH],
                                          unsigned* out, int x, int u) {
#pragma unroll
    for (int i = 0; i < SCAN_BATCH; ++i) {
        rx_f64_add_u32(hi, lo, h[i], l[i], hi, lo);
        const int t = u * SCAN_BATCH + i;
        out[t * SCAN_CHAINS + x] = hi;
        out[SCAN_HALF + t * SCAN_CHAINS + x] = lo;
    }
}

// Lane x's chain through one tile of nt tips, in whole batches: the addends
// of batch u + 1 load while batch u adds.
__device__ __forceinline__ void walk_tile(unsigned& hi, unsigned& lo,
                                          const unsigned* in, unsigned* out,
                                          int x, int nt) {
    const int steps = (nt + SCAN_BATCH - 1) / SCAN_BATCH;
    unsigned ah[SCAN_BATCH], al[SCAN_BATCH], bh[SCAN_BATCH], bl[SCAN_BATCH];
    load_batch(ah, al, in, x, 0);
    if (steps > 1) load_batch(bh, bl, in, x, 1);
    add_batch(hi, lo, ah, al, out, x, 0);
    for (int u = 1;; u += 2) {
        if (u >= steps) break;
        if (u + 1 < steps) load_batch(ah, al, in, x, u + 1);
        add_batch(hi, lo, bh, bl, out, x, u);
        if (u + 1 >= steps) break;
        if (u + 2 < steps) load_batch(bh, bl, in, x, u + 2);
        add_batch(hi, lo, ah, al, out, x, u + 1);
    }
}

__global__ void __launch_bounds__(SCAN_THREADS, 1)
probe_f64_scan_kernel(const unsigned* __restrict__ ph,
                      const unsigned* __restrict__ pl,
                      unsigned* __restrict__ oh, unsigned* __restrict__ ol,
                      long long N) {
    extern __shared__ __align__(16) unsigned smem[];
    unsigned* tin = smem;                             // [STAGES][2][TILE][CHAINS]
    unsigned* tout = smem + SCAN_STAGES * SCAN_SLOT;  // the same, for the sums
    const long long n_tiles = (N + SCAN_TILE - 1) / SCAN_TILE;
    auto tips = [&](long long j) {
        return (int)min((long long)SCAN_TILE, N - j * SCAN_TILE);
    };

    if (threadIdx.x < 32) {  // the walker warp
        const int x = threadIdx.x;
        unsigned hi = 0u, lo = 0u;
        for (long long j = 0; j < n_tiles; ++j) {
            const int s = (int)(j % SCAN_STAGES);
            bar_sync(BAR_FULL + s);
            walk_tile(hi, lo, tin + s * SCAN_SLOT, tout + s * SCAN_SLOT, x,
                      tips(j));
            __syncwarp();
            __threadfence_block();
            bar_arrive(BAR_DONE + s);
        }
        return;
    }

    // the copy warps: tile j goes into slot j % STAGES; chunk c of a tile is
    // 16 bytes of tip c / (2 ROW_CHUNKS), half (c / ROW_CHUNKS) % 2
    const int h = threadIdx.x - 32;
    // element (g, t, lane) lies at (g * N + t) * 128 + lane
    const long long base =
        (long long)blockIdx.y * N * LANES + (long long)blockIdx.x * SCAN_CHAINS;
    auto chunk = [&](long long j, int c, long long& at, int& in_slot) {
        const int t = c / (2 * ROW_CHUNKS), k = c % (2 * ROW_CHUNKS);
        const int half = k / ROW_CHUNKS, q = 4 * (k % ROW_CHUNKS);
        at = base + (j * SCAN_TILE + t) * LANES + q;
        in_slot = half * SCAN_HALF + t * SCAN_CHAINS + q;
        return half;
    };
    auto load_tile = [&](long long j) {
        unsigned* slot = tin + (j % SCAN_STAGES) * SCAN_SLOT;
        const int nc = tips(j) * 2 * ROW_CHUNKS;
        for (int c = h; c < nc; c += SCAN_COPIERS) {
            long long at;
            int o;
            const unsigned* src = chunk(j, c, at, o) ? pl : ph;
            rx_cp_async16(reinterpret_cast<uint4*>(slot + o),
                          reinterpret_cast<const uint4*>(src + at), 16);
        }
    };
    auto store_tile = [&](long long j) {
        const unsigned* slot = tout + (j % SCAN_STAGES) * SCAN_SLOT;
        const int nc = tips(j) * 2 * ROW_CHUNKS;
        for (int c = h; c < nc; c += SCAN_COPIERS) {
            long long at;
            int o;
            unsigned* dst = chunk(j, c, at, o) ? ol : oh;
            __stcs(reinterpret_cast<uint4*>(dst + at),
                   *reinterpret_cast<const uint4*>(slot + o));
        }
    };
    for (int j = 0; j < SCAN_STAGES - 1; ++j) {
        if (j < n_tiles) load_tile(j);
        rx_cp_async_commit();
    }
    for (long long j = 0; j < n_tiles; ++j) {
        // one group per tile, committed in order: tile j has landed when at
        // most the STAGES - 2 later groups are still pending
        rx_cp_async_wait<SCAN_STAGES - 2>();
        __threadfence_block();
        bar_arrive(BAR_FULL + (int)(j % SCAN_STAGES));
        if (j > 0) {
            // tile j - 1 summed: drain it, then refill its slot
            bar_sync(BAR_DONE + (int)((j - 1) % SCAN_STAGES));
            store_tile(j - 1);
        }
        if (j + SCAN_STAGES - 1 < n_tiles) load_tile(j + SCAN_STAGES - 1);
        rx_cp_async_commit();
    }
    if (n_tiles > 0) {
        bar_sync(BAR_DONE + (int)((n_tiles - 1) % SCAN_STAGES));
        store_tile(n_tiles - 1);
    }
}

}  // namespace

RX_EXPORT int rx_probe_f64_ew(const void* ah, const void* al, const void* bh,
                              const void* bl, void* ch, void* cl, void* dh,
                              void* dl, long long n, void* stream) {
    if (n <= 0) return 0;
    const long long blocks = (n + EW_THREADS - 1) / EW_THREADS;
    const int grid = (int)(blocks < (1 << 20) ? blocks : (1 << 20));
    probe_f64_ew_kernel<<<grid, EW_THREADS, 0, (cudaStream_t)stream>>>(
        (const unsigned*)ah, (const unsigned*)al, (const unsigned*)bh,
        (const unsigned*)bl, (unsigned*)ch, (unsigned*)cl, (unsigned*)dh,
        (unsigned*)dl, n);
    return (int)cudaGetLastError();
}

RX_EXPORT int rx_probe_f64_scan(const void* ph, const void* pl, void* oh,
                                void* ol, int G, long long N, void* stream) {
    if (G <= 0 || N <= 0) return 0;
    // above 48 KB of dynamic shared memory only by request (per device)
    const cudaError_t e = cudaFuncSetAttribute(
        probe_f64_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SCAN_SMEM);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid(LANES / SCAN_CHAINS, G);
    probe_f64_scan_kernel<<<grid, SCAN_THREADS, SCAN_SMEM,
                            (cudaStream_t)stream>>>(
        (const unsigned*)ph, (const unsigned*)pl, (unsigned*)oh,
        (unsigned*)ol, N);
    return (int)cudaGetLastError();
}
