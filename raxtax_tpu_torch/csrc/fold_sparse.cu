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
// Design for Hopper. The TPU kernel keeps one query's whole [P, S, 128]
// accumulator on chip for the length of its pair list; that is megabytes at a
// million references and does not fit an SM. Here the wrapper regroups each
// query's pairs by block, and one CTA owns one (query, block): 256 threads,
// one uint4 (four words of the 1,024-word block) each, all P planes of it in
// registers. The CTA stages its k-mer ids in shared memory, keeps eight
// independent 16-byte row loads in flight per thread (each pair is one
// contiguous 4 KB run for the CTA), and adds every row with a ripple carry
// through the P planes. Every (query, block) CTA writes its planes once, so
// blocks without a pair come out zero and no memset is needed.
//
// Bound: bytes -- the batch's distinct (k-mer, block) pairs x 4 KB read (a
// sub-row several queries fold leaves memory once) plus the planes written;
// about 2 P logic operations per word of every pair.
#include "rx_common.cuh"

namespace {

constexpr int SP_THREADS = 256;  // one uint4 each: 8 x 128 words per block
constexpr int SP_IDS = 512;      // k-mer ids staged per shared-memory refill
constexpr int SP_ROWS = 8;       // row loads in flight per thread

template <int P>
__global__ void __launch_bounds__(SP_THREADS)
fold_sparse_kernel(const int* __restrict__ pair_kmer,  // [B, p_pad] by block
                   const int* __restrict__ blk_off,    // [B, n_blocks + 1]
                   const uint4* __restrict__ kmer_major,  // [rows, W4]
                   uint4* __restrict__ out,               // [B, P, W4]
                   int p_pad, int n_blocks, long long W4) {
    __shared__ int ids[SP_IDS];
    const int blk = blockIdx.x;
    const int b = blockIdx.y;
    const int* off = blk_off + (long long)b * (n_blocks + 1);
    const int lo = off[blk];
    const int hi = off[blk + 1];
    const int* my = pair_kmer + (long long)b * p_pad;
    const long long col = (long long)blk * SP_THREADS + threadIdx.x;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

    uint4 acc[P];
#pragma unroll
    for (int p = 0; p < P; ++p) acc[p] = zero;

    for (int p0 = lo; p0 < hi; p0 += SP_IDS) {
        const int n = min(SP_IDS, hi - p0);
        __syncthreads();  // previous chunk fully consumed
        for (int i = threadIdx.x; i < n; i += SP_THREADS) ids[i] = my[p0 + i];
        __syncthreads();
        for (int j0 = 0; j0 < n; j0 += SP_ROWS) {
            uint4 x[SP_ROWS];
#pragma unroll
            for (int i = 0; i < SP_ROWS; ++i) {
                x[i] = (j0 + i < n)
                           ? __ldg(kmer_major + (long long)ids[j0 + i] * W4 + col)
                           : zero;
            }
#pragma unroll
            for (int i = 0; i < SP_ROWS; ++i) {
                uint4 carry = x[i];
#pragma unroll
                for (int p = 0; p < P; ++p) {
                    const uint4 cur = acc[p];
                    acc[p].x = cur.x ^ carry.x; carry.x = cur.x & carry.x;
                    acc[p].y = cur.y ^ carry.y; carry.y = cur.y & carry.y;
                    acc[p].z = cur.z ^ carry.z; carry.z = cur.z & carry.z;
                    acc[p].w = cur.w ^ carry.w; carry.w = cur.w & carry.w;
                }
            }
        }
    }
    uint4* o = out + (long long)b * P * W4 + col;
#pragma unroll
    for (int p = 0; p < P; ++p) o[(long long)p * W4] = acc[p];
}

template <int P>
int launch(const int* pair_kmer, const int* blk_off, const uint4* km,
           uint4* out, int B, int p_pad, int n_blocks, long long W4,
           cudaStream_t stream) {
    dim3 grid(n_blocks, B);
    fold_sparse_kernel<P><<<grid, SP_THREADS, 0, stream>>>(
        pair_kmer, blk_off, km, out, p_pad, n_blocks, W4);
    return (int)cudaGetLastError();
}

}  // namespace

// W (words per row) must be a multiple of 1,024 (whole blocks); n_planes in
// [5, 16]. pair_kmer holds each query's pairs grouped by block; blk_off[b]
// are the n_blocks + 1 group boundaries.
RX_EXPORT int rx_fold_planes_sparse(const void* pair_kmer, const void* blk_off,
                                    const void* kmer_major, void* out, int B,
                                    int p_pad, long long W, int n_planes,
                                    void* stream) {
    if (B <= 0 || W <= 0) return 0;
    if (W % 1024 != 0 || n_planes < 5 || n_planes > 16 || B > 65535 ||
        p_pad < 1)
        return (int)cudaErrorInvalidValue;
    const int* pk = (const int*)pair_kmer;
    const int* bo = (const int*)blk_off;
    const uint4* km = (const uint4*)kmer_major;
    uint4* o = (uint4*)out;
    cudaStream_t s = (cudaStream_t)stream;
    const long long W4 = W / 4;
    const int nb = (int)(W / 1024);
    switch (n_planes) {
        case 5: return launch<5>(pk, bo, km, o, B, p_pad, nb, W4, s);
        case 6: return launch<6>(pk, bo, km, o, B, p_pad, nb, W4, s);
        case 7: return launch<7>(pk, bo, km, o, B, p_pad, nb, W4, s);
        case 8: return launch<8>(pk, bo, km, o, B, p_pad, nb, W4, s);
        case 9: return launch<9>(pk, bo, km, o, B, p_pad, nb, W4, s);
        case 10: return launch<10>(pk, bo, km, o, B, p_pad, nb, W4, s);
        case 11: return launch<11>(pk, bo, km, o, B, p_pad, nb, W4, s);
        case 12: return launch<12>(pk, bo, km, o, B, p_pad, nb, W4, s);
        case 13: return launch<13>(pk, bo, km, o, B, p_pad, nb, W4, s);
        case 14: return launch<14>(pk, bo, km, o, B, p_pad, nb, W4, s);
        case 15: return launch<15>(pk, bo, km, o, B, p_pad, nb, W4, s);
        default: return launch<16>(pk, bo, km, o, B, p_pad, nb, W4, s);
    }
}
