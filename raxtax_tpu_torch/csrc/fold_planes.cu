// K1 fold_planes: bit-sliced intersection counters from postings rows.
//
// Replaces the TPU kernel _hs_kernel_fused (ops/intersect_pallas.py of the
// JAX package). For query b, out[b, p, w] holds bit 2^p of
//     sum over the query's real k-mers k of bit(kmer_major[k, w])
// for each of the 32 bit positions of word w, i.e. 32 vertical counters per
// word, P = 4 + NH planes deep.
//
// Design for Hopper. One thread owns four adjacent words (one uint4) of one
// query and keeps all P planes of them in registers, so no accumulator ever
// lives in memory and each output word is written exactly once. The block
// stages the query's k-mer ids in shared memory in chunks, then folds 16
// postings rows per step with the Harley-Seal carry-save adder tree (ones,
// twos, fours, eights tiers; the weight-16 carry ripples into the NH binary
// planes). Adjacent threads read adjacent 16-byte pieces of the same row, so
// each row read is one coalesced 4 KB run per block. Rows past the query's
// real k-mer count are never read (they are zero by contract).
//
// Bound: bytes. The fold reads B * K * W words of postings; arithmetic is
// about 6 logic ops per word read.
#include "rx_common.cuh"

namespace {

constexpr int FOLD_THREADS = 256;
constexpr int ID_CHUNK = 1024;  // k-mer ids staged per shared-memory refill

template <int NH>
__global__ void __launch_bounds__(FOLD_THREADS)
fold_planes_kernel(const int* __restrict__ kmer_idx,      // [B, k_pad]
                   const int* __restrict__ kcounts,       // [B]
                   const uint4* __restrict__ kmer_major,  // [rows, W4]
                   uint4* __restrict__ out,               // [B, 4 + NH, W4]
                   int k_pad, long long W4) {
    __shared__ int ids[ID_CHUNK];
    const int b = blockIdx.y;
    const long long w = (long long)blockIdx.x * FOLD_THREADS + threadIdx.x;
    const bool live = w < W4;
    const int kc = min(kcounts[b], k_pad);
    const int* my_idx = kmer_idx + (long long)b * k_pad;
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
        for (int j0 = 0; j0 < n_ids; j0 += 16) {
            uint4 x[16];
#pragma unroll
            for (int i = 0; i < 16; ++i) {
                x[i] = (j0 + i < n_ids)
                           ? __ldg(kmer_major + (long long)ids[j0 + i] * W4 + w)
                           : zero;
            }
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
    dim3 grid(rx_div_up(W4, FOLD_THREADS), B);
    fold_planes_kernel<NH><<<grid, FOLD_THREADS, 0, stream>>>(
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
    if (W % 4 != 0 || n_high < 1 || n_high > 12 || B > 65535)
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
