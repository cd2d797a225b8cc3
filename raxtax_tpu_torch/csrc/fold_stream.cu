// K10 fold_planes_stream: counter planes from a row-sorted list of
// (query, postings row) pairs.
//
// Replaces the TPU kernel _stream_kernel (ops/intersect_stream.py of the JAX
// package: _stream_planes). There the postings matrix is streamed through
// the chip once per batch in blocks of rows, and a CSR built on the host
// says which queries fold each row into their on-chip counter planes. What
// is kept is that idea: the pairs are sorted by row, a row is loaded once
// per group of queries and applied to every query of the group that holds
// its k-mer, and the planes stay on chip until they are complete.
// out[b, p, w] holds bit 2^p of the number of query b's rows with bit set,
// for each of the 32 bits of word w: the planes K1 makes, in plain binary.
//
// Bound: bytes. The rows some query of the batch uses are read once
// (4 W bytes each) and B * P * W words are written.
//
// Design for Hopper. A warp owns one 512-byte column slice (a uint4 per
// lane) of one group of G <= 2 queries and keeps every query's planes of
// its words in registers, as K1's Harley-Seal tiers (ones, twos, fours,
// eights and NH binary high planes; plain binary, so the planes are K1's).
// A CTA is that one warp. Schedule: the group is the fastest grid
// dimension, so the CTAs in flight are every group of a few column slices;
// they walk ascending rows nearly in step and a row slice comes from device
// memory once and from L2 after (K1's order). Pairs: the warp reads its
// group's packed pairs 32 at a time (lane i one pair, and the pair before
// it), finds where a row starts, ORs the query bits of the <= G pairs that
// share it with shuffles, and compacts the starts with a ballot into a list
// of (row, query mask) runs in shared memory: no CTA-wide barrier. Rows:
// each lane keeps RING - 1 stages of 16 runs ahead of the fold with
// cp.async into its own ring slots (zero-filled past the end) and reads
// back only its own copies, so the ring needs no barrier either. A stage's
// 16 row slices, each loaded once, are folded into every query of the
// group that holds any of them by one carry-save adder tree step
// (rx_hs_fold16), the slices of the other queries' rows read as zero: a
// ripple carry per (row, query) costs the warp its deepest carry over 4,096
// counters, all P planes, where the adder tree costs about 22 operations per
// row. The query index of a run is a bit of its mask tested in an unrolled
// loop, so every accumulator index is a compile-time constant.
#include "rx_common.cuh"

namespace {

constexpr int ROW_BITS = 17;               // low bits of a packed pair: the row
constexpr int ROW_MASK = (1 << ROW_BITS) - 1;
constexpr int RUNS = 16;                   // runs per ring stage
constexpr int RING = 3;                    // stages per lane
constexpr int CHUNK = 1024;                // pairs decoded per run list
constexpr int MAX_GROUP = 2;  // larger groups fold slower (PERF.md)
constexpr unsigned FULL = 0xffffffffu;

struct WarpSmem {
    uint4 ring[RING][RUNS][32];  // 24 KB: lane l's copies at [.][.][l]
    int runs[CHUNK];             // row | query mask << ROW_BITS
};

// Tiers and high planes of one query's words: ones, twos, fours, eights
// (the low four bits of the count) and NH more binary planes.
template <int NH>
struct Counter {
    uint4 t1, t2, t4, t8, high[NH];
};

template <int G, int NH>
__global__ void __launch_bounds__(32)
fold_stream_kernel(const int* __restrict__ pairs,       // packed, row-sorted
                   const int* __restrict__ group_lo,    // [groups]
                   const int* __restrict__ group_hi,    // [groups]
                   const uint4* __restrict__ kmer_major,  // [rows, W4]
                   uint4* __restrict__ out,             // [B, P, W4]
                   int B, int P, long long W4) {
    extern __shared__ WarpSmem warp_smem[];
    const int lane = threadIdx.x;
    WarpSmem& sm = warp_smem[0];
    const int g = blockIdx.x;
    const long long w = (long long)blockIdx.y * 32 + lane;
    const bool live = w < W4;
    const uint4* col = kmer_major + (live ? w : 0);
    const unsigned lanes_below = (1u << lane) - 1u;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

    Counter<NH> acc[G];
#pragma unroll
    for (int q = 0; q < G; ++q) {
        acc[q].t1 = acc[q].t2 = acc[q].t4 = acc[q].t8 = zero;
#pragma unroll
        for (int p = 0; p < NH; ++p) acc[q].high[p] = zero;
    }

    // a run's pairs are consecutive and at most G long: lanes past STRIDE
    // only complete the masks of runs that start before them
    constexpr int STRIDE = 32 - (G - 1);
    const int lo = group_lo[g], hi = group_hi[g];
    for (int c0 = lo; c0 < hi; c0 += CHUNK) {
        const int c1 = min(hi, c0 + CHUNK);
        // -- decode pairs [c0, c1) into runs --------------------------------
        int n_runs = 0;
        for (int i0 = c0; i0 < c1; i0 += STRIDE) {
            const int i = i0 + lane;
            const int p = i < hi ? __ldg(pairs + i) : 0;
            const int row = i < hi ? (p & ROW_MASK) : -1;
            const int prev = (i < hi && i > lo) ? (__ldg(pairs + i - 1) & ROW_MASK)
                                                : -1;
            unsigned mask = i < hi ? 1u << (p >> ROW_BITS) : 0u;
#pragma unroll
            for (int d = 1; d < G; ++d) {
                const int r2 = __shfl_down_sync(FULL, row, d);
                const unsigned m2 = __shfl_down_sync(FULL, mask, d);
                if (lane + d < 32 && r2 == row) mask |= m2;
            }
            // mask now holds the bits of the pairs from this lane to the end
            // of its run (a pair's own bit is set before the shuffles read it)
            const bool start = lane < STRIDE && i < c1 && row != prev;
            const unsigned starts = __ballot_sync(FULL, start);
            if (start)
                sm.runs[n_runs + __popc(starts & lanes_below)] =
                    row | (int)(mask << ROW_BITS);
            n_runs += __popc(starts);
        }
        __syncwarp();
        // -- fold the runs through the ring ---------------------------------
        const int n_st = (n_runs + RUNS - 1) / RUNS;
        auto fetch = [&](int st) {
#pragma unroll
            for (int k = 0; k < RUNS; ++k) {
                const int j = st * RUNS + k;
                const bool real = live && j < n_runs;
                rx_cp_async16(
                    &sm.ring[st % RING][k][lane],
                    real ? col + (long long)(sm.runs[j] & ROW_MASK) * W4 : col,
                    real ? 16 : 0);
            }
        };
        for (int st = 0; st < RING - 1; ++st) {
            if (st < n_st) fetch(st);
            rx_cp_async_commit();
        }
        for (int st = 0; st < n_st; ++st) {
            rx_cp_async_wait<RING - 2>();  // one group per stage, in order
            // refill the slot folded one step ago (its reads have retired)
            if (st + RING - 1 < n_st) fetch(st + RING - 1);
            rx_cp_async_commit();
            // which runs of the stage each query holds (past the end: none)
            unsigned qmask[G];
#pragma unroll
            for (int q = 0; q < G; ++q) qmask[q] = 0u;
#pragma unroll
            for (int k = 0; k < RUNS; ++k) {
                const int j = st * RUNS + k;
                const unsigned m =
                    j < n_runs ? (unsigned)sm.runs[j] >> ROW_BITS : 0u;
#pragma unroll
                for (int q = 0; q < G; ++q) qmask[q] |= ((m >> q) & 1u) << k;
            }
            const uint4 (&slot)[RUNS][32] = sm.ring[st % RING];
#pragma unroll
            for (int q = 0; q < G; ++q) {
                if (qmask[q] == 0u) continue;  // uniform over the warp
                uint4 x[RUNS];
#pragma unroll
                for (int k = 0; k < RUNS; ++k)
                    x[k] = (qmask[q] >> k) & 1u ? slot[k][lane] : zero;
                rx_hs_fold16<NH>(acc[q].t1, acc[q].t2, acc[q].t4, acc[q].t8,
                                 acc[q].high, x);
            }
        }
        rx_cp_async_wait<0>();
        __syncwarp();  // every lane is done with runs[] before it is rewritten
    }
    if (!live) return;
    const int q0 = g * G;
#pragma unroll
    for (int q = 0; q < G; ++q) {
        if (q0 + q >= B) break;
        uint4* o = out + (long long)(q0 + q) * P * W4 + w;
        const uint4 low[4] = {acc[q].t1, acc[q].t2, acc[q].t4, acc[q].t8};
#pragma unroll
        for (int p = 0; p < 4; ++p)
            if (p < P) o[(long long)p * W4] = low[p];
#pragma unroll
        for (int p = 0; p < NH; ++p)
            if (4 + p < P) o[(long long)(4 + p) * W4] = acc[q].high[p];
    }
}

template <int G, int NH>
int launch(const int* pairs, const int* group_lo, const int* group_hi,
           const uint4* km, uint4* out, int B, int P, long long W4,
           int groups, cudaStream_t stream) {
    const size_t smem = sizeof(WarpSmem);
    cudaError_t err = cudaFuncSetAttribute(
        fold_stream_kernel<G, NH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(groups, rx_div_up(W4, 32LL));  // the group varies fastest
    fold_stream_kernel<G, NH><<<grid, 32, smem, stream>>>(
        pairs, group_lo, group_hi, km, out, B, P, W4);
    return (int)cudaGetLastError();
}

// The high planes are kept in registers in buckets of NH >= P - 4: the
// planes past P only ever see a zero carry when the counts fit P planes,
// and the low P planes are the count modulo 2^P either way.
template <int G>
int launch_nh(const int* pairs, const int* lo, const int* hi, const uint4* km,
              uint4* out, int B, int P, long long W4, int groups,
              cudaStream_t s) {
#define RX_NH(N) launch<G, N>(pairs, lo, hi, km, out, B, P, W4, groups, s)
    if (P <= 8) return RX_NH(4);
    if (P <= 10) return RX_NH(6);
    if (P <= 12) return RX_NH(8);
    return RX_NH(12);
#undef RX_NH
}

}  // namespace

// pairs[i] = (query - group * group_size) << 17 | row, sorted by (group,
// row, query); group g owns pairs[group_lo[g] : group_hi[g]]. Rows must be
// below 2^17, W (words per row) a multiple of 4, group_size 1 or 2,
// n_planes in [1, 16].
RX_EXPORT int rx_fold_stream(const void* pairs, const void* group_lo,
                             const void* group_hi, const void* kmer_major,
                             void* out, int B, int n_planes, long long W,
                             int group_size, void* stream) {
    if (B <= 0 || W <= 0) return 0;
    if (W % 4 != 0 || n_planes < 1 || n_planes > 16 || group_size < 1 ||
        group_size > MAX_GROUP)
        return (int)cudaErrorInvalidValue;
    const int groups = rx_div_up(B, group_size);
    const long long W4 = W / 4;
    if (rx_div_up(W4, 32LL) > 65535) return (int)cudaErrorInvalidValue;
    const int* p = (const int*)pairs;
    const int* lo = (const int*)group_lo;
    const int* hi = (const int*)group_hi;
    const uint4* km = (const uint4*)kmer_major;
    uint4* o = (uint4*)out;
    cudaStream_t s = (cudaStream_t)stream;
    return group_size == 1
               ? launch_nh<1>(p, lo, hi, km, o, B, n_planes, W4, groups, s)
               : launch_nh<2>(p, lo, hi, km, o, B, n_planes, W4, groups, s);
}
