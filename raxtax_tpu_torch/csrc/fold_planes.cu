// K1 fold_planes: bit-sliced intersection counters from postings rows.
//
// Replaces the TPU kernel _hs_kernel_fused (raxtax_tpu/ops/
// intersect_pallas.py:144, pallas_call at :243). For query b, out[b, p, w]
// holds bit 2^p of
//     sum over the query's real k-mers k of bit(kmer_major[k, w])
// for each of the 32 bit positions of word w, i.e. 32 vertical counters per
// word, P = 4 + NH planes deep.
//
// Bound: bytes. Every row that some query of the batch names must come from
// device memory once (unique_rows * W * 4 bytes, plus the planes written:
// 2.05 ms at 1M references, B = 256 on an H100 at 3.35 TB/s); if no row
// were shared between queries, all rows_folded rows would stream (3.90 ms).
// The arithmetic is about 6 logic operations per word read.
//
// Design for Hopper. A CTA folds one column slice of FOLD_THREADS uint4 (512
// bytes of every row) for one query; a thread owns four adjacent words and
// keeps all P planes of them in registers, so no accumulator lives in memory
// and each output word is written once. Schedule: the query is the fastest-
// varying grid dimension, so the CTAs in flight are all queries of the same
// few column slices (narrow slices keep more of a row's reuse in L2: 512 bytes
// beat 1 and 2 KB). The k-mer ids of each query come in ascending order, so
// those CTAs walk the rows in nearly the same order, and a slice that several
// queries share is fetched from device memory once and from L2 after. Staging:
// each thread keeps FOLD_RING - 1 stages of 16 rows of its column in flight
// with cp.async into a shared-memory ring (rows past the query's count are
// zero-filled, never read), then folds a landed stage with the Harley-Seal
// carry-save adder tree (rx_hs_fold16 in rx_common.cuh). A thread reads back
// only what it copied itself, so the ring needs no barrier; a stage is
// refilled one step after it was folded. Correctness does not depend on the
// order of the ids, only the reuse does.
#include "rx_common.cuh"

namespace {

constexpr int FOLD_THREADS = 32;  // uint4 columns per CTA: a 512-byte row slice
constexpr int FOLD_ROWS = 16;     // rows per stage: one adder-tree step
constexpr int FOLD_RING = 3;      // stages per thread
constexpr int ID_CHUNK = 1024;    // k-mer ids staged per shared-memory refill
constexpr size_t FOLD_SMEM = sizeof(uint4) * FOLD_RING * FOLD_ROWS * FOLD_THREADS;
static_assert(FOLD_SMEM + sizeof(int) * ID_CHUNK <= 48 * 1024,
              "the ring fits the default shared-memory limit");

__device__ __forceinline__ void cp_async16(uint4* smem, const uint4* gmem,
                                           int src_bytes) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
                 "l"(gmem), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

template <int NH>
__global__ void __launch_bounds__(FOLD_THREADS)
fold_planes_kernel(const int* __restrict__ kmer_idx,      // [B, k_pad]
                   const int* __restrict__ kcounts,       // [B]
                   const uint4* __restrict__ kmer_major,  // [rows, W4]
                   uint4* __restrict__ out,               // [B, 4 + NH, W4]
                   int k_pad, long long W4) {
    __shared__ int ids[ID_CHUNK];
    extern __shared__ uint4 ring[];  // [FOLD_RING][FOLD_ROWS][FOLD_THREADS]
    const int b = blockIdx.x;
    const long long w = (long long)blockIdx.y * FOLD_THREADS + threadIdx.x;
    const bool live = w < W4;
    const int kc = min(kcounts[b], k_pad);
    const int* my_idx = kmer_idx + (long long)b * k_pad;
    const uint4* col = kmer_major + w;
    uint4* mine = ring + threadIdx.x;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

    uint4 ones = zero, twos = zero, fours = zero, eights = zero;
    uint4 high[NH];
#pragma unroll
    for (int p = 0; p < NH; ++p) high[p] = zero;

    for (int k0 = 0; k0 < kc; k0 += ID_CHUNK) {
        const int n_ids = min(ID_CHUNK, kc - k0);
        __syncthreads();  // previous chunk fully consumed
        for (int i = threadIdx.x; i < n_ids; i += FOLD_THREADS)
            ids[i] = my_idx[k0 + i];
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
                cp_async16(slot + i * FOLD_THREADS,
                           real ? col + (long long)ids[j] * W4 : col,
                           real ? 16 : 0);
            }
        };
        for (int st = 0; st < FOLD_RING - 1; ++st) {
            if (st < n_st) fetch(st);
            cp_async_commit();
        }
        for (int st = 0; st < n_st; ++st) {
            // one group per stage, committed in order
            cp_async_wait<FOLD_RING - 2>();
            const uint4* slot = mine + (st % FOLD_RING) * FOLD_ROWS * FOLD_THREADS;
            uint4 x[FOLD_ROWS];
#pragma unroll
            for (int i = 0; i < FOLD_ROWS; ++i) x[i] = slot[i * FOLD_THREADS];
            // refill the slot folded one step ago (its loads have retired)
            if (st + FOLD_RING - 1 < n_st) fetch(st + FOLD_RING - 1);
            cp_async_commit();
            rx_hs_fold16<NH>(ones, twos, fours, eights, high, x);
        }
    }
    if (!live) return;
    uint4* o = out + (long long)b * (4 + NH) * W4 + w;
    rx_store_planes<NH>(o, W4, ones, twos, fours, eights, high);
}

template <int NH>
int launch(const int* kmer_idx, const int* kcounts, const uint4* km,
           uint4* out, int B, int k_pad, long long W4, cudaStream_t stream) {
    dim3 grid(B, rx_div_up(W4, FOLD_THREADS));  // the query varies fastest
    fold_planes_kernel<NH><<<grid, FOLD_THREADS, FOLD_SMEM, stream>>>(
        kmer_idx, kcounts, km, out, k_pad, W4);
    return (int)cudaGetLastError();
}

}  // namespace

// W (words per row) must be a multiple of 4; n_high in [1, 12].
RX_EXPORT int rx_fold_planes(const void* kmer_idx, const void* kcounts,
                             const void* kmer_major, void* out, int B,
                             int k_pad, long long W, int n_high,
                             void* stream) {
    if (B <= 0 || W <= 0) return 0;
    if (W % 4 != 0 || n_high < 1 || n_high > 12 ||
        W / 4 > 65535LL * FOLD_THREADS)
        return (int)cudaErrorInvalidValue;
    const int* ki = (const int*)kmer_idx;
    const int* kc = (const int*)kcounts;
    const uint4* km = (const uint4*)kmer_major;
    uint4* o = (uint4*)out;
    cudaStream_t s = (cudaStream_t)stream;
    const long long W4 = W / 4;
    switch (n_high) {
        case 1: return launch<1>(ki, kc, km, o, B, k_pad, W4, s);
        case 2: return launch<2>(ki, kc, km, o, B, k_pad, W4, s);
        case 3: return launch<3>(ki, kc, km, o, B, k_pad, W4, s);
        case 4: return launch<4>(ki, kc, km, o, B, k_pad, W4, s);
        case 5: return launch<5>(ki, kc, km, o, B, k_pad, W4, s);
        case 6: return launch<6>(ki, kc, km, o, B, k_pad, W4, s);
        case 7: return launch<7>(ki, kc, km, o, B, k_pad, W4, s);
        case 8: return launch<8>(ki, kc, km, o, B, k_pad, W4, s);
        case 9: return launch<9>(ki, kc, km, o, B, k_pad, W4, s);
        case 10: return launch<10>(ki, kc, km, o, B, k_pad, W4, s);
        case 11: return launch<11>(ki, kc, km, o, B, k_pad, W4, s);
        default: return launch<12>(ki, kc, km, o, B, k_pad, W4, s);
    }
}
