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
// Design for Hopper (the CTA body is rx_fold_list in fold_ring.cuh, shared
// with K2). A CTA folds one column slice of FOLD_THREADS uint4 (512 bytes of
// every row) for one query; a thread owns four adjacent words and keeps all
// P planes of them in registers. Schedule: the query is the fastest-varying
// grid dimension, so the CTAs in flight are all queries of the same few
// column slices (narrow slices keep more of a row's reuse in L2: 512 bytes
// beat 1 and 2 KB). The k-mer ids of each query come in ascending order, so
// those CTAs walk the rows in nearly the same order, and a slice that several
// queries share is fetched from device memory once and from L2 after.
// Staging: a per-thread cp.async ring of stages of 16 rows, each folded with
// the Harley-Seal carry-save adder tree (rx_hs_fold16 in rx_common.cuh).
#include "fold_ring.cuh"

namespace {

template <int NH>
__global__ void __launch_bounds__(FOLD_THREADS)
fold_planes_kernel(const int* __restrict__ kmer_idx,      // [B, k_pad]
                   const int* __restrict__ kcounts,       // [B]
                   const uint4* __restrict__ kmer_major,  // [rows, W4]
                   uint4* __restrict__ out,               // [B, 4 + NH, W4]
                   int k_pad, long long W4) {
    __shared__ int ids[FOLD_ID_CHUNK];
    extern __shared__ uint4 ring[];  // [FOLD_RING][FOLD_ROWS][FOLD_THREADS]
    const int b = blockIdx.x;
    const long long w = (long long)blockIdx.y * FOLD_THREADS + threadIdx.x;
    rx_fold_list<NH>(kmer_idx + (long long)b * k_pad, min(kcounts[b], k_pad),
                     kmer_major + w, W4, w < W4,
                     out + (long long)b * (4 + NH) * W4 + w, ids, ring);
}

template <int NH>
struct Launch {
    static int run(const int* kmer_idx, const int* kcounts, const uint4* km,
                   uint4* out, int B, int k_pad, long long W4,
                   cudaStream_t stream) {
        dim3 grid(B, rx_div_up(W4, FOLD_THREADS));  // the query varies fastest
        fold_planes_kernel<NH><<<grid, FOLD_THREADS, FOLD_SMEM, stream>>>(
            kmer_idx, kcounts, km, out, k_pad, W4);
        return (int)cudaGetLastError();
    }
};

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
    return rx_fold_by_nh<Launch>(
        n_high, (const int*)kmer_idx, (const int*)kcounts,
        (const uint4*)kmer_major, (uint4*)out, B, k_pad, W / 4,
        (cudaStream_t)stream);
}
