// K2 fold_planes_sparse: block-sparse postings fold into counter planes.
//
// Replaces the TPU kernel _sparse_kernel (ops/intersect_pallas.py of the JAX
// package: _sparse_planes). A pair (k, blk) names the 8 x 128-word block
// `blk` of postings row `k` that holds at least one posting; for query b
//     out[b, p, w] = bit 2^p of  sum over the query's pairs (k, blk(w)) of
//                    bit(kmer_major[k, w])
// for each of the 32 bit positions of word w, and 0 in every block the query
// has no pair in. The planes are the binary digits of the count, so they are
// bit for bit the planes of the dense fold (K1) over the same k-mers.
//
// Bound: bytes -- the batch's distinct (k-mer, block) pairs x 4 KB read (a
// sub-row several queries fold leaves memory once) plus the planes written;
// the adder tree does about 6 logic operations per word of every pair.
//
// Design for Hopper. The TPU kernel keeps one query's whole [P, S, 128]
// accumulator on chip and adds each pair's block at its own offset with a
// ripple carry (about 2 P operations per word), the price of a per-pair
// offset there. Here the wrapper regroups each query's pairs by block
// (stable, so a block's k-mers stay in ascending order), and the kernel is
// K1 with another row list: a CTA of 32 threads owns one 512-byte slice of
// one block of one query (eight CTAs per 1,024-word block), reads the
// block's bounds blk_off[b, blk], blk_off[b, blk + 1], and folds
// kmer_by_blk[b, lo:hi] with K1's body (rx_fold_list in fold_ring.cuh): a
// per-thread cp.async ring of stages of 16 rows, rows past the list
// zero-filled, each stage through the carry-save adder tree, the planes in
// registers and written once. An empty list writes zero planes, so no
// memset is needed. The query is the fastest grid dimension, as in K1, so a
// sub-row that several queries fold comes from L2 after its first read.
#include "fold_ring.cuh"

namespace {

constexpr int SLICES_PER_BLOCK = 1024 / (4 * FOLD_THREADS);  // 8

template <int NH>
__global__ void __launch_bounds__(FOLD_THREADS)
fold_sparse_kernel(const int* __restrict__ kmer_by_blk,   // [B, p_pad]
                   const int* __restrict__ blk_off,       // [B, n_blocks + 1]
                   const uint4* __restrict__ kmer_major,  // [rows, W4]
                   uint4* __restrict__ out,               // [B, 4 + NH, W4]
                   int p_pad, int n_blocks, long long W4) {
    __shared__ int ids[FOLD_ID_CHUNK];
    extern __shared__ uint4 ring[];  // [FOLD_RING][FOLD_ROWS][FOLD_THREADS]
    const int b = blockIdx.x;
    const int* off = blk_off + (long long)b * (n_blocks + 1) +
                     blockIdx.y / SLICES_PER_BLOCK;
    const int lo = off[0];
    const long long w = (long long)blockIdx.y * FOLD_THREADS + threadIdx.x;
    rx_fold_list<NH>(kmer_by_blk + (long long)b * p_pad + lo, off[1] - lo,
                     kmer_major + w, W4, true,
                     out + (long long)b * (4 + NH) * W4 + w, ids, ring);
}

template <int NH>
struct Launch {
    static int run(const int* kmer_by_blk, const int* blk_off,
                   const uint4* km, uint4* out, int B, int p_pad,
                   int n_blocks, long long W4, cudaStream_t stream) {
        dim3 grid(B, n_blocks * SLICES_PER_BLOCK);  // the query varies fastest
        fold_sparse_kernel<NH><<<grid, FOLD_THREADS, FOLD_SMEM, stream>>>(
            kmer_by_blk, blk_off, km, out, p_pad, n_blocks, W4);
        return (int)cudaGetLastError();
    }
};

}  // namespace

// W (words per row) must be a multiple of 1,024 (whole blocks); n_planes in
// [5, 16]. pair_kmer holds each query's pairs grouped by block; blk_off[b]
// are the n_blocks + 1 group boundaries.
RX_EXPORT int rx_fold_planes_sparse(const void* pair_kmer, const void* blk_off,
                                    const void* kmer_major, void* out, int B,
                                    int p_pad, long long W, int n_planes,
                                    void* stream) {
    if (B <= 0 || W <= 0) return 0;
    if (W % 1024 != 0 || n_planes < 5 || n_planes > 16 || p_pad < 1 ||
        W / 4 > 65535LL * FOLD_THREADS)
        return (int)cudaErrorInvalidValue;
    return rx_fold_by_nh<Launch>(
        n_planes - 4, (const int*)pair_kmer, (const int*)blk_off,
        (const uint4*)kmer_major, (uint4*)out, B, p_pad, (int)(W / 1024),
        W / 4, (cudaStream_t)stream);
}
