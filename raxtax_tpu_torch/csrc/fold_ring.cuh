// The fold of one list of postings rows into one column slice of counter
// planes: the CTA body shared by K1 (fold_planes.cu) and K2
// (fold_sparse.cu). K1's list is every k-mer of a query, for each slice of
// the row; K2's is the query's k-mers with a posting in one 1,024-word
// block, for the eight slices of that block.
//
// A CTA of FOLD_THREADS threads owns one 512-byte column slice (a uint4 of
// four words a thread) of one query. A thread keeps all 4 + NH planes of its
// four words in registers (the Harley-Seal tiers ones / twos / fours /
// eights and NH binary planes), so no accumulator lives in memory and each
// output word is written once. Staging: the ids come into shared memory in
// chunks of FOLD_ID_CHUNK; each thread keeps FOLD_RING - 1 stages of 16 rows
// of its column in flight with cp.async into its own slots of a
// shared-memory ring (rows past the list are zero-filled, never read), then
// folds a landed stage with the carry-save adder tree (rx_hs_fold16). A
// thread reads back only what it copied itself, so the ring needs no
// barrier; a stage is refilled one step after it was folded. The kernels run
// the query fastest over the grid, so the CTAs in flight are all queries of
// a few slices, and a row slice that several queries fold comes from device
// memory once and from L2 after. Correctness does not depend on the order
// of the ids, only the reuse does.
#pragma once
#include "rx_common.cuh"

constexpr int FOLD_THREADS = 32;  // uint4 columns per CTA: a 512-byte slice
constexpr int FOLD_ROWS = 16;     // rows per stage: one adder-tree step
constexpr int FOLD_RING = 3;      // stages per thread
constexpr int FOLD_ID_CHUNK = 1024;  // ids staged per shared-memory refill
constexpr size_t FOLD_SMEM =
    sizeof(uint4) * FOLD_RING * FOLD_ROWS * FOLD_THREADS;
static_assert(FOLD_SMEM + sizeof(int) * FOLD_ID_CHUNK <= 48 * 1024,
              "the ring fits the default shared-memory limit");

#ifdef __CUDACC__
// Folds the rows list[0, n) into this thread's column. col: the column in
// row 0 of the postings matrix ([rows, W4] uint4); live: whether the column
// lies inside the row; o: the column in plane 0 of the query's output
// ([4 + NH, W4]). ids (FOLD_ID_CHUNK ints) and ring (FOLD_SMEM bytes) are
// the kernel's shared memory. Every thread of the CTA must call it: it holds
// CTA barriers.
template <int NH>
__device__ __forceinline__ void rx_fold_list(const int* __restrict__ list,
                                             int n,
                                             const uint4* __restrict__ col,
                                             long long W4, bool live,
                                             uint4* __restrict__ o, int* ids,
                                             uint4* ring) {
    uint4* mine = ring + threadIdx.x;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    uint4 ones = zero, twos = zero, fours = zero, eights = zero;
    uint4 high[NH];
#pragma unroll
    for (int p = 0; p < NH; ++p) high[p] = zero;

    for (int k0 = 0; k0 < n; k0 += FOLD_ID_CHUNK) {
        const int n_ids = min(FOLD_ID_CHUNK, n - k0);
        __syncthreads();  // previous chunk fully consumed
        for (int i = threadIdx.x; i < n_ids; i += FOLD_THREADS)
            ids[i] = list[k0 + i];
        __syncthreads();
        if (!live) continue;
        const int n_st = (n_ids + FOLD_ROWS - 1) / FOLD_ROWS;
        // stage st (rows st * 16 ..) goes into ring slot st % FOLD_RING
        auto fetch = [&](int st) {
            uint4* slot = mine + (st % FOLD_RING) * FOLD_ROWS * FOLD_THREADS;
#pragma unroll
            for (int i = 0; i < FOLD_ROWS; ++i) {
                const int j = st * FOLD_ROWS + i;
                const bool real = j < n_ids;
                rx_cp_async16(slot + i * FOLD_THREADS,
                              real ? col + (long long)ids[j] * W4 : col,
                              real ? 16 : 0);
            }
        };
        for (int st = 0; st < FOLD_RING - 1; ++st) {
            if (st < n_st) fetch(st);
            rx_cp_async_commit();
        }
        for (int st = 0; st < n_st; ++st) {
            // one group per stage, committed in order
            rx_cp_async_wait<FOLD_RING - 2>();
            const uint4* slot =
                mine + (st % FOLD_RING) * FOLD_ROWS * FOLD_THREADS;
            uint4 x[FOLD_ROWS];
#pragma unroll
            for (int i = 0; i < FOLD_ROWS; ++i) x[i] = slot[i * FOLD_THREADS];
            // refill the slot folded one step ago (its loads have retired)
            if (st + FOLD_RING - 1 < n_st) fetch(st + FOLD_RING - 1);
            rx_cp_async_commit();
            rx_hs_fold16<NH>(ones, twos, fours, eights, high, x);
        }
    }
    if (!live) return;
    rx_store_planes<NH>(o, W4, ones, twos, fours, eights, high);
}

// Launch<NH>::run(args...) for nh in [1, 12], the high planes the folds
// compile.
template <template <int> class Launch, typename... Args>
int rx_fold_by_nh(int nh, Args... args) {
    switch (nh) {
        case 1: return Launch<1>::run(args...);
        case 2: return Launch<2>::run(args...);
        case 3: return Launch<3>::run(args...);
        case 4: return Launch<4>::run(args...);
        case 5: return Launch<5>::run(args...);
        case 6: return Launch<6>::run(args...);
        case 7: return Launch<7>::run(args...);
        case 8: return Launch<8>::run(args...);
        case 9: return Launch<9>::run(args...);
        case 10: return Launch<10>::run(args...);
        case 11: return Launch<11>::run(args...);
        default: return Launch<12>::run(args...);
    }
}
#endif  // __CUDACC__
