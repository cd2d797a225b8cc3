// K10 fold_planes_stream: counter planes from a row-sorted list of
// (query, postings row) pairs.
//
// Replaces the TPU kernel _stream_kernel (ops/intersect_stream.py of the JAX
// package: _stream_planes). There the postings matrix is streamed through
// the chip once per batch in blocks of rows, and a CSR built on the host
// says which queries fold each row into their on-chip counter planes. What
// is kept is that idea: the pairs are sorted by row, a row is loaded once
// and applied to every query of the group that holds its k-mer, and the
// planes stay on chip until they are complete. out[b, p, w] holds bit 2^p of
// the number of query b's rows with bit set, for each of the 32 bits of word
// w: the planes K1 makes, in plain binary (ripple-carry) form.
//
// Design for Hopper. A ripple-carry add is a read-modify-write over P
// planes and does not compose under atomics, so a (column tile, query)
// accumulator belongs to exactly one CTA: CTA (t, g) owns columns
// [256 t, 256 t + 256) of the queries of group g and keeps their
// G x P x 256 words in shared memory (the wrapper sizes G so that four CTAs
// fit an SM: a CTA walks its pairs one after the other, so small groups and
// many CTAs in flight are what hides the latency of that walk). Thread i
// owns column i of every accumulator, so no two threads ever touch the same
// word and the only barriers are around the staging of the pair list. The
// CTA walks its group's pairs in row order,
// eight row loads in flight per thread; a thread whose row word is zero
// (most are: a postings row is sparse) skips the pair, the others ripple
// until their carry dies. Rows that no query of the group uses are never
// read. The CTAs of one column tile walk the matrix in the same row order,
// so a row shared between groups is served by L2 to all but the first.
//
// Bound: bytes. The rows some query of the batch uses are read once
// (4 W bytes each) and B * P * W words are written.
#include "rx_common.cuh"

namespace {

constexpr int TILE = 256;        // columns (threads) per CTA
constexpr int STAGE = 1024;      // pairs staged per shared-memory refill
constexpr int ROW_BITS = 17;     // low bits of a packed pair: the row id
constexpr int LOADS = 8;         // row words in flight per thread
constexpr int SMEM_MAX = 232448; // most dynamic shared memory of a block

__global__ void __launch_bounds__(TILE)
fold_stream_kernel(const int* __restrict__ pairs,      // packed, row-sorted
                   const int* __restrict__ group_lo,   // [groups]
                   const int* __restrict__ group_hi,   // [groups]
                   const uint32_t* __restrict__ kmer_major,  // [rows, W]
                   uint32_t* __restrict__ out,          // [B, P, W]
                   int B, int P, long long W, int group_size) {
    extern __shared__ uint32_t smem[];
    uint32_t* acc = smem;                              // [group_size * P][TILE]
    int* stage = (int*)(smem + (size_t)group_size * P * TILE);  // [STAGE]
    const int g = blockIdx.y;
    const int tid = threadIdx.x;
    const long long col = (long long)blockIdx.x * TILE + tid;
    const bool live = col < W;
    const int q0 = g * group_size;
    const int nq = min(group_size, B - q0);

    for (int i = 0; i < nq * P; ++i) acc[i * TILE + tid] = 0u;

    const int lo = group_lo[g], hi = group_hi[g];
    for (int base = lo; base < hi; base += STAGE) {
        const int n = min(STAGE, hi - base);
        __syncthreads();  // previous chunk fully consumed
        for (int i = tid; i < n; i += TILE) stage[i] = pairs[base + i];
        __syncthreads();
        if (!live) continue;
        for (int j0 = 0; j0 < n; j0 += LOADS) {
            uint32_t x[LOADS];
#pragma unroll
            for (int i = 0; i < LOADS; ++i) {
                x[i] = 0u;
                if (j0 + i < n) {
                    const long long row = stage[j0 + i] & ((1 << ROW_BITS) - 1);
                    x[i] = __ldg(kmer_major + row * W + col);
                }
            }
#pragma unroll
            for (int i = 0; i < LOADS; ++i) {
                uint32_t carry = x[i];
                if (carry == 0u) continue;
                const int ql = stage[j0 + i] >> ROW_BITS;
                uint32_t* a = acc + (size_t)ql * P * TILE + tid;
                for (int p = 0; p < P && carry != 0u; ++p) {
                    const uint32_t plane = a[p * TILE];
                    a[p * TILE] = plane ^ carry;
                    carry &= plane;
                }
            }
        }
    }
    if (!live) return;
    // thread i wrote column i of every accumulator itself: no barrier needed
    for (int q = 0; q < nq; ++q)
        for (int p = 0; p < P; ++p)
            out[((long long)(q0 + q) * P + p) * W + col] =
                acc[(q * P + p) * TILE + tid];
}

}  // namespace

// pairs[i] = (query - group * group_size) << 17 | row, sorted by (group,
// row); group g owns pairs[group_lo[g] : group_hi[g]]. Rows must be below
// 2^17 and group_size * n_planes * 1 KB + 4 KB must fit the shared memory.
RX_EXPORT int rx_fold_stream(const void* pairs, const void* group_lo,
                             const void* group_hi, const void* kmer_major,
                             void* out, int B, int n_planes, long long W,
                             int group_size, void* stream) {
    if (B <= 0 || W <= 0) return 0;
    if (n_planes < 1 || group_size < 1 || group_size >= (1 << 14))
        return (int)cudaErrorInvalidValue;
    const long long smem =
        ((long long)group_size * n_planes * TILE + STAGE) * 4;
    const int groups = rx_div_up(B, group_size);
    if (smem > SMEM_MAX || groups > 65535) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        fold_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(rx_div_up(W, TILE), groups);
    fold_stream_kernel<<<grid, TILE, (size_t)smem, (cudaStream_t)stream>>>(
        (const int*)pairs, (const int*)group_lo, (const int*)group_hi,
        (const uint32_t*)kmer_major, (uint32_t*)out, B, n_planes, W,
        group_size);
    return (int)cudaGetLastError();
}
