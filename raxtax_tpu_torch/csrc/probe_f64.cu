// K11 and K12: the software-f64 probes, on (hi, lo) u32 halves.
//
// K11 rx_probe_f64_ew replaces ew_kernel (scripts/probe_mosaic_f64.py:47,
// pallas_call at :62): per element c = RN(a + b) and RN(c - b), through
// rx_f64_add_u32 / rx_f64_sub_u32 (exactf64.cuh), never the card's f64 unit.
// One thread per element, grid-stride. Bound: the integer work, 474 u32
// operations per pair as the algorithm writes them (189 for the add, 285 for
// the subtraction), rather than its 32 bytes (16 read, 16 written).
//
// K12 rx_probe_f64_scan replaces make_scan/scan_kernel
// (probe_mosaic_f64.py:80-113, pallas_call at :125): a sequential prefix sum
// per lane over tips, cum[g, t, l] = RN(cum[g, t-1, l] + p[g, t, l]), in the
// layout [G, N, 128] of u32 halves (queries = G lane groups of 128). Every
// lane of a warp walks its own chain and carries the running sum in
// registers; a CTA is one warp of 32 lanes of one group (8 CTAs at B = 256).
// Each lane loads its column of a tile of SCAN_TILE tips into shared memory
// (each tip is one 128-byte coalesced load per half) and then walks the
// tile, so a tile's loads wait before its first add; stores of the running
// sum go straight out, coalesced along lanes. Bound: only B chains exist, so
// the latency of the dependent software adds times N limits it, not the 16
// bytes per (tip, query) it moves.
#include "exactf64.cuh"
#include "rx_common.cuh"

namespace {

constexpr int EW_THREADS = 256;
constexpr int SCAN_LANES = 32;
constexpr int SCAN_TILE = 128;
constexpr int LANES = 128;

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

__global__ void __launch_bounds__(SCAN_LANES)
probe_f64_scan_kernel(const unsigned* __restrict__ ph,
                      const unsigned* __restrict__ pl,
                      unsigned* __restrict__ oh, unsigned* __restrict__ ol,
                      long long N) {
    __shared__ unsigned tile_h[SCAN_TILE][SCAN_LANES];
    __shared__ unsigned tile_l[SCAN_TILE][SCAN_LANES];
    const int x = threadIdx.x;
    // element (g, t, lane) lies at (g * N + t) * 128 + lane
    const long long base =
        (long long)blockIdx.y * N * LANES + blockIdx.x * SCAN_LANES + x;
    unsigned hi = 0u, lo = 0u;
    for (long long t0 = 0; t0 < N; t0 += SCAN_TILE) {
        const int nt = (int)min((long long)SCAN_TILE, N - t0);
        // every load of the tile is issued before the chain needs it; each
        // thread reads back only its own column, so no barrier is needed
        for (int t = 0; t < nt; ++t) {
            const long long at = base + (t0 + t) * LANES;
            tile_h[t][x] = ph[at];
            tile_l[t][x] = pl[at];
        }
        for (int t = 0; t < nt; ++t) {
            rx_f64_add_u32(hi, lo, tile_h[t][x], tile_l[t][x], hi, lo);
            const long long at = base + (t0 + t) * LANES;
            oh[at] = hi;
            ol[at] = lo;
        }
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
    const dim3 grid(LANES / SCAN_LANES, G);
    probe_f64_scan_kernel<<<grid, SCAN_LANES, 0, (cudaStream_t)stream>>>(
        (const unsigned*)ph, (const unsigned*)pl, (unsigned*)oh,
        (unsigned*)ol, N);
    return (int)cudaGetLastError();
}
