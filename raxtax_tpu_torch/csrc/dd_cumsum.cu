// K6 / K7 dd_cumsum: double-f32 (TwoSum-compensated) inclusive prefix sum
// along tips.
//
// Replaces the TPU kernels behind dd_cumsum_pallas (K6) and
// dd_cumsum_pallas_bitmajor (K7) (ops/planes.py of the JAX package:
// _dd_scan_kernel). The pair (hi, lo) of every prefix depends on the ORDER
// of the compensated adds, so the kernel follows the TPU kernel's add tree
// exactly, per tile of `rows` rows of 128 tips:
//   1. a shift-in-zero log-step scan along the 128 lanes of each row
//      (steps 1, 2, ..., 64),
//   2. the same over the tile's row totals (steps 1, 2, 4, ... < rows),
//   3. one compensated add of the exclusive row offset,
//   4. one compensated add of the carry from the previous tiles (the last
//      element of the previous tile),
// with rows = min(N / 128, 1024) for K6 and min(N / 128, 256) for K7, so
// the two differ in their bits on the same data. A compensated add of (0, 0)
// is an exact identity and every step looks backward only, so rows past the
// end of a partial last tile are simply read as zero.
//
// Rounding. Every operation is an IEEE f32 add or subtract in the written
// order (__fadd_rn / __fsub_rn, which the compiler neither reassociates nor
// contracts; TwoSum has no multiply, so there is nothing to fuse). The file
// must never be built with --use_fast_math.
//
// Design for Hopper. One CTA walks one query's tiles in order and carries
// (hi, lo) in shared memory. A tile of 1,024 x 128 pairs does not fit an SM,
// but the tree splits: a warp scans one row in registers (four lanes per
// thread, __shfl_sync for the shifts) and leaves the row total in shared
// memory; the CTA scans the <= 1,024 totals there (double buffered); on a
// second sweep each warp reloads its row, repeats the lane scan, adds offset
// and carry and stores. K7 reads the same element from the bit-major layout
// (tip (s * 128 + lane) * 32 + bit sits at [bit, s, lane]): four consecutive
// words of one bit plane per thread, as one 16-byte load.
//
// Bound: bytes -- 4 read and 8 written per tip; the second sweep's reload
// makes it 16 moved.
#include "rx_common.cuh"

namespace {

constexpr int DD_THREADS = 512;
constexpr int DD_WARPS = DD_THREADS / 32;
constexpr int DD_MAX_ROWS = 1024;
constexpr unsigned FULL = 0xffffffffu;

struct DD {
    float hi, lo;
};

__device__ __forceinline__ DD dd_add2(const DD a, const DD b) {
    const float s = __fadd_rn(a.hi, b.hi);
    const float bb = __fsub_rn(s, a.hi);
    const float err = __fadd_rn(__fsub_rn(a.hi, __fsub_rn(s, bb)),
                                __fsub_rn(b.hi, bb));
    DD r;
    r.hi = s;
    r.lo = __fadd_rn(__fadd_rn(err, a.lo), b.lo);
    return r;
}

// Row g of query b into v[0..3]: thread t holds lanes j * 32 + t.
template <bool BITMAJOR>
__device__ __forceinline__ void load_row(const float* __restrict__ x,
                                         long long g, int t, long long W,
                                         DD v[4]) {
    if (BITMAJOR) {
        // lane j*32 + t of row g is tip g*128 + j*32 + t: bit t of word
        // g*4 + j
        const float4 q =
            *reinterpret_cast<const float4*>(x + (long long)t * W + g * 4);
        v[0].hi = q.x; v[1].hi = q.y; v[2].hi = q.z; v[3].hi = q.w;
    } else {
        const float* row = x + g * 128 + t;
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j].hi = row[j * 32];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j].lo = 0.0f;
}

// Inclusive scan along the 128 lanes of one row held by one warp.
__device__ __forceinline__ void scan_row(DD v[4], int t) {
    const DD zero = {0.0f, 0.0f};
#pragma unroll
    for (int k = 1; k < 32; k <<= 1) {
        DD sh[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            sh[j].hi = __shfl_sync(FULL, v[j].hi, (t - k) & 31);
            sh[j].lo = __shfl_sync(FULL, v[j].lo, (t - k) & 31);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const DD src = (t >= k) ? sh[j] : (j > 0 ? sh[j - 1] : zero);
            v[j] = dd_add2(v[j], src);
        }
    }
    // shift by 32 lanes, then by 64: whole register slots
    v[3] = dd_add2(v[3], v[2]);
    v[2] = dd_add2(v[2], v[1]);
    v[1] = dd_add2(v[1], v[0]);
    v[0] = dd_add2(v[0], zero);
    v[3] = dd_add2(v[3], v[1]);
    v[2] = dd_add2(v[2], v[0]);
    v[1] = dd_add2(v[1], zero);
    v[0] = dd_add2(v[0], zero);
}

template <bool BITMAJOR>
__global__ void __launch_bounds__(DD_THREADS)
dd_cumsum_kernel(const float* __restrict__ x, float* __restrict__ out_hi,
                 float* __restrict__ out_lo, long long nr, int rows,
                 long long in_stride, long long out_stride, int out_off,
                 long long W) {
    __shared__ float rt_hi[2][DD_MAX_ROWS];
    __shared__ float rt_lo[2][DD_MAX_ROWS];
    __shared__ float carry[2][2];
    const int b = blockIdx.x;
    const int warp = threadIdx.x >> 5;
    const int t = threadIdx.x & 31;
    const float* xb = x + (long long)b * in_stride;
    float* oh = out_hi + (long long)b * out_stride + out_off;
    float* ol = out_lo + (long long)b * out_stride + out_off;
    const DD zero = {0.0f, 0.0f};
    if (threadIdx.x == 0) {
        carry[0][0] = 0.0f;
        carry[0][1] = 0.0f;
    }
    int cs = 0;
    const long long n_tiles = (nr + rows - 1) / rows;
    for (long long tile = 0; tile < n_tiles; ++tile) {
        const long long g0 = tile * rows;
        __syncthreads();  // the carry is visible, the totals are consumed
        // sweep 1: row totals
        for (int r = warp; r < rows; r += DD_WARPS) {
            DD tot = zero;
            if (g0 + r < nr) {  // uniform over the warp
                DD v[4];
                load_row<BITMAJOR>(xb, g0 + r, t, W, v);
                scan_row(v, t);
                tot = v[3];
            }
            if (t == 31) {
                rt_hi[0][r] = tot.hi;
                rt_lo[0][r] = tot.lo;
            }
        }
        __syncthreads();
        // inclusive scan of the row totals along rows
        int cur = 0;
        for (int k = 1; k < rows; k <<= 1) {
            for (int r = threadIdx.x; r < rows; r += DD_THREADS) {
                DD a, s;
                a.hi = rt_hi[cur][r];
                a.lo = rt_lo[cur][r];
                s = zero;
                if (r >= k) {
                    s.hi = rt_hi[cur][r - k];
                    s.lo = rt_lo[cur][r - k];
                }
                const DD n = dd_add2(a, s);
                rt_hi[cur ^ 1][r] = n.hi;
                rt_lo[cur ^ 1][r] = n.lo;
            }
            __syncthreads();
            cur ^= 1;
        }
        // sweep 2: rows again, plus the exclusive row offset and the carry
        DD c;
        c.hi = carry[cs][0];
        c.lo = carry[cs][1];
        for (int r = warp; r < rows; r += DD_WARPS) {
            const long long g = g0 + r;
            if (g >= nr) continue;
            DD v[4];
            load_row<BITMAJOR>(xb, g, t, W, v);
            scan_row(v, t);
            DD off = zero;
            if (r > 0) {
                off.hi = rt_hi[cur][r - 1];
                off.lo = rt_lo[cur][r - 1];
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                v[j] = dd_add2(v[j], off);
                v[j] = dd_add2(v[j], c);
                oh[g * 128 + j * 32 + t] = v[j].hi;
                ol[g * 128 + j * 32 + t] = v[j].lo;
            }
            if (r == rows - 1 && t == 31) {
                carry[cs ^ 1][0] = v[3].hi;
                carry[cs ^ 1][1] = v[3].lo;
            }
        }
        cs ^= 1;
    }
}

}  // namespace

// x: [B, N] f32 in tip order (bitmajor = 0) or [B, 32, W] bit-major with
// N = 32 * W (bitmajor = 1); N a multiple of 128 (bit-major: W of 4).
// out_hi / out_lo: [B, out_stride] f32; prefix n of query b goes to column
// out_off + n. tile_rows in [1, 1024].
RX_EXPORT int rx_dd_cumsum(const void* x, void* out_hi, void* out_lo, int B,
                           long long N, int tile_rows, int bitmajor,
                           long long out_stride, int out_off, void* stream) {
    if (B <= 0 || N <= 0) return 0;
    if (N % 128 != 0 || tile_rows < 1 || tile_rows > DD_MAX_ROWS ||
        out_off < 0 || out_stride < N + out_off)
        return (int)cudaErrorInvalidValue;
    const long long nr = N / 128;
    cudaStream_t s = (cudaStream_t)stream;
    if (bitmajor) {
        if (N % (32 * 4) != 0) return (int)cudaErrorInvalidValue;
        dd_cumsum_kernel<true><<<B, DD_THREADS, 0, s>>>(
            (const float*)x, (float*)out_hi, (float*)out_lo, nr, tile_rows, N,
            out_stride, out_off, N / 32);
    } else {
        dd_cumsum_kernel<false><<<B, DD_THREADS, 0, s>>>(
            (const float*)x, (float*)out_hi, (float*)out_lo, nr, tile_rows, N,
            out_stride, out_off, 0);
    }
    return (int)cudaGetLastError();
}
