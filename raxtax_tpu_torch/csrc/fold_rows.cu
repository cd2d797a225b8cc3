// K9 fold_planes_gathered: the Harley-Seal fold over rows that were gathered
// beforehand and lie contiguous in memory.
//
// Replaces the TPU kernel _hs_kernel (ops/intersect_pallas.py of the JAX
// package: _hs_planes). rows[b * k_pad + k, w] is the postings row of the
// k-th k-mer slot of query b (all zero in a padding slot); out[b, p, w]
// holds bit 2^p of the column sums over k, 32 vertical counters per word,
// P = 4 + NH planes deep: the same planes K1 (fold_planes.cu) makes from the
// id list.
//
// Design for Hopper. There the 16-row block arrives through a pipeline and
// an accumulator persists over a sequential grid axis; here one thread owns
// four adjacent words (one uint4) of one query, keeps all P planes of them
// in registers and walks the query's k_pad rows 16 at a time through the
// carry-save tree shared with K1 (rx_common.cuh). Row k of a query starts
// W4 uint4s after row k - 1, so a block reads one coalesced 4 KB run per
// row and needs no ids, no shared memory and no step skip: every slot is
// read, as in the TPU kernel.
//
// Bound: bytes. B * k_pad * W words of gathered rows are read once, about
// six logic ops each, and B * P * W words are written.
#include "rx_common.cuh"

namespace {

constexpr int FOLD_THREADS = 256;

template <int NH>
__global__ void __launch_bounds__(FOLD_THREADS)
fold_rows_kernel(const uint4* __restrict__ rows,  // [B * k_pad, W4]
                 uint4* __restrict__ out,         // [B, 4 + NH, W4]
                 int k_pad, long long W4) {
    const int b = blockIdx.y;
    const long long w = (long long)blockIdx.x * FOLD_THREADS + threadIdx.x;
    if (w >= W4) return;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    const uint4* mine = rows + (long long)b * k_pad * W4 + w;

    uint4 ones = zero, twos = zero, fours = zero, eights = zero;
    uint4 high[NH];
#pragma unroll
    for (int p = 0; p < NH; ++p) high[p] = zero;

    for (int k0 = 0; k0 < k_pad; k0 += 16) {
        uint4 x[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) x[i] = __ldg(mine + (long long)(k0 + i) * W4);
        rx_hs_fold16<NH>(ones, twos, fours, eights, high, x);
    }
    uint4* o = out + (long long)b * (4 + NH) * W4 + w;
    rx_store_planes<NH>(o, W4, ones, twos, fours, eights, high);
}

template <int NH>
int launch(const uint4* rows, uint4* out, int B, int k_pad, long long W4,
           cudaStream_t stream) {
    dim3 grid(rx_div_up(W4, FOLD_THREADS), B);
    fold_rows_kernel<NH><<<grid, FOLD_THREADS, 0, stream>>>(rows, out, k_pad, W4);
    return (int)cudaGetLastError();
}

}  // namespace

// W (words per row) must be a multiple of 4, k_pad a multiple of 16;
// n_high in [1, 12].
RX_EXPORT int rx_fold_rows(const void* rows, void* out, int B, int k_pad,
                           long long W, int n_high, void* stream) {
    if (B <= 0 || W <= 0) return 0;
    if (W % 4 != 0 || k_pad < 0 || k_pad % 16 != 0 || n_high < 1 ||
        n_high > 12 || B > 65535)
        return (int)cudaErrorInvalidValue;
    const uint4* r = (const uint4*)rows;
    uint4* o = (uint4*)out;
    cudaStream_t s = (cudaStream_t)stream;
    const long long W4 = W / 4;
    switch (n_high) {
        case 1: return launch<1>(r, o, B, k_pad, W4, s);
        case 2: return launch<2>(r, o, B, k_pad, W4, s);
        case 3: return launch<3>(r, o, B, k_pad, W4, s);
        case 4: return launch<4>(r, o, B, k_pad, W4, s);
        case 5: return launch<5>(r, o, B, k_pad, W4, s);
        case 6: return launch<6>(r, o, B, k_pad, W4, s);
        case 7: return launch<7>(r, o, B, k_pad, W4, s);
        case 8: return launch<8>(r, o, B, k_pad, W4, s);
        case 9: return launch<9>(r, o, B, k_pad, W4, s);
        case 10: return launch<10>(r, o, B, k_pad, W4, s);
        case 11: return launch<11>(r, o, B, k_pad, W4, s);
        default: return launch<12>(r, o, B, k_pad, W4, s);
    }
}
