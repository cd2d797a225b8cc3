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
// the two differ in their bits on the same data. Every step looks backward
// only, so rows past the end of a partial last tile are read as zero and
// never stored.
//
// Rounding. Every operation is an IEEE f32 add or subtract in the written
// order (__fadd_rn / __fsub_rn, which the compiler neither reassociates nor
// contracts; TwoSum has no multiply, so there is nothing to fuse). The file
// must never be built with --use_fast_math.
//
// Bound: bytes -- 4 read and 8 written per tip.
//
// Design for Hopper. The TPU kernel walks a query's tiles in order; here a
// chunk of CHUNK = 64 rows of one tile of one query is the unit of work, so
// a query's tiles spread over the whole card (31,744 chunks at 1M tips and
// B = 256, where the TPU-shaped kernel had 256 CTAs). Persistent CTAs take
// chunks from an atomic ticket in the order (tile, chunk, query) and keep
// two chunks' rows in shared memory: while one is scanned, the next one's
// rows arrive by cp.async (each warp copies its own 8 rows, 16 bytes a
// lane), so loads, compute and the streaming stores of the chunk before
// overlap. A warp scans each of its rows along the lanes in registers
// (lane t holds lanes j * 32 + t, j < 4, so the steps of 32 and 64 are
// register moves) and keeps the result there: each row is read from device
// memory once and scanned once. The tree over the row totals is split the
// same way: each chunk computes every level of the tree for its own 64
// rows only, in one warp (two rows a lane: shifts below 32 are shuffles, 32
// a register move), and publishes every level to a scratch buffer. What a
// level needs from before the chunk (level s at r0 + i - 2^s, from 1, 2, 4
// or 8 chunks back) it copies from there into shared memory with cp.async
// while its rows are scanned. The carry into a tile is published by the CTA
// holding the tile's last row as soon as it has its own carry:
// c_{t+1} = dd_add2(T_t, c_t), T_t = the tile's last element before its
// carry add. Every chunk waits only for smaller tickets, so the smallest
// unfinished ticket is always being scanned and no CTA waits on one that
// was never scheduled; with the query fastest, what a chunk waits for was
// taken B tickets earlier and is ready in practice. The output rows begin
// on a 128-byte boundary (the wrapper passes out_off = 32), so each warp
// store is one whole line.
#include "rx_common.cuh"

namespace {

constexpr int DD_WARPS = 8;
constexpr int DD_THREADS = 32 * DD_WARPS;
constexpr int ROWS_PER_WARP = 8;
constexpr int CHUNK = DD_WARPS * ROWS_PER_WARP;  // rows per CTA
constexpr int DD_MAX_ROWS = 1024;
constexpr int MAX_LEVELS = 10;  // shifts 1 .. 512 < DD_MAX_ROWS
static_assert(CHUNK == 64, "the tree warp holds two positions a lane");
constexpr int FLAGS_AT = 32;  // scratch words before the chunk flags
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

// The tree over a tile's row totals has one level per shift k = 1, 2, 4,
// ... < rows; level 0 is the row totals themselves, level n_levels the
// inclusive sums whose exclusive form is each row's offset.
__host__ __device__ inline int n_levels(int rows) {
    int n = 0;
    for (int k = 1; k < rows; k <<= 1) ++n;
    return n;
}

// Scratch words (u32): [0] the ticket, then one flag per chunk in ticket
// order, then per (tile, query) the carry into the tile (hi, lo, flag, -),
// then every level of the tree as (hi, lo) pairs, [tile][query][level][row].
// Everything before `levels` must be zero at the launch.
struct Scratch {
    long long carries, levels, words;
};

__host__ __device__ inline Scratch scratch_layout(long long n_tiles, int B,
                                                  int cpt, int rows) {
    Scratch s;
    s.carries = (FLAGS_AT + n_tiles * B * cpt + 3) & ~3LL;  // 16-byte aligned
    s.levels = s.carries + 4 * n_tiles * B;
    s.words = s.levels + 2 * n_tiles * B * (n_levels(rows) + 1) * rows;
    return s;
}

__device__ __forceinline__ DD load_dd(const float2* p) {
    const float2 f = __ldcg(p);
    return {f.x, f.y};
}

__device__ __forceinline__ void spin_until_set(const unsigned* flag) {
    while (*(volatile const unsigned*)flag == 0u) {
    }
    __threadfence();
}

// cp.async of 16 bytes (cache-global) or 8 bytes (cache-all), zero-filled
// when src_bytes is 0.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
    const unsigned a = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(a),
                 "l"(gmem), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async16_ca(void* smem, const void* gmem,
                                              int src_bytes) {
    const unsigned a = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;" ::"r"(a),
                 "l"(gmem), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem,
                                          int src_bytes) {
    const unsigned a = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(a),
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

__device__ __forceinline__ DD shfl_dd(const DD v, int src) {
    return {__shfl_sync(FULL, v.hi, src), __shfl_sync(FULL, v.lo, src)};
}

// Dynamic shared memory of a CTA: two chunks of rows (the one scanned and
// the one in flight), each warp's 8 rows its own; the chunk's row totals;
// the tree values the chunk reads from earlier chunks; and the inclusive
// sums S[r0 - 1 .. r0 + 63] that give its rows' offsets.
struct DdSmem {
    float rows[2][DD_WARPS][ROWS_PER_WARP][128];  // 64 KB
    DD own[CHUNK];                                 // level 0 of the chunk
    DD halo[MAX_LEVELS][CHUNK];                    // level s at r0 + i - 2^s
    DD soff[CHUNK + 1];                            // S[r0 - 1 + i]
};

// A chunk's place: ticket u = (t * cpt + c) * B + b, tile slowest, then
// chunk, then query, so that what a chunk reads from its tile's earlier
// chunks was published B tickets before.
struct Unit {
    int t, c, b;
    long long g0;  // first row of the tile
    int r0;        // first row of the chunk in the tile
};

__device__ __forceinline__ Unit unit_of(int u, int B, int cpt, int rows) {
    Unit w;
    w.b = u % B;
    w.c = (u / B) % cpt;
    w.t = u / (B * cpt);
    w.g0 = (long long)w.t * rows;
    w.r0 = w.c * CHUNK;
    return w;
}

template <bool BITMAJOR>
__global__ void __launch_bounds__(DD_THREADS, 2)
dd_cumsum_kernel(const float* __restrict__ x, float* __restrict__ out_hi,
                 float* __restrict__ out_lo, unsigned* __restrict__ scratch,
                 int B, long long nr, int rows, int n_tiles, int cpt,
                 long long in_stride, long long out_stride, int out_off,
                 long long W) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    DdSmem& sm = *reinterpret_cast<DdSmem*>(smem_raw);
    __shared__ int s_ticket[2];
    __shared__ DD s_carry;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const DD zero = {0.0f, 0.0f};
    const int units = n_tiles * cpt * B;
    const int L = n_levels(rows);
    const Scratch at = scratch_layout(n_tiles, B, cpt, rows);
    unsigned* flags = scratch + FLAGS_AT;  // by ticket
    unsigned* carries = scratch + at.carries;

    // the rows of ticket u into buffer buf: lane l copies 16 bytes of each
    // of its warp's rows (zero past the end)
    auto fetch = [&](int u, int buf) {
        const Unit w = unit_of(u, B, cpt, rows);
        const float* xb = x + (long long)w.b * in_stride;
#pragma unroll
        for (int k = 0; k < ROWS_PER_WARP; ++k) {
            const int r = w.r0 + warp * ROWS_PER_WARP + k;
            const long long g = w.g0 + r;
            const bool real = r < rows && g < nr;
            float* dst = &sm.rows[buf][warp][k][4 * lane];
            if (BITMAJOR) {
                // lane j*32 + l of row g is bit l of word g*4 + j: lane l
                // copies words g*4 .. g*4 + 3 of bit plane l, and the next
                // row's copy finds the rest of the sector in L1
                cp_async16_ca(dst, real ? xb + (long long)lane * W + g * 4 : x,
                              real ? 16 : 0);
            } else {  // tip order: lane l copies tips 4l .. 4l + 3 of row g
                cp_async16(dst, real ? xb + g * 128 + 4 * lane : x,
                           real ? 16 : 0);
            }
        }
    };

    if (threadIdx.x == 0) s_ticket[0] = (int)atomicAdd(scratch, 1u);
    __syncthreads();
    int cur = s_ticket[0], buf = 0, slot = 1;
    if (cur < units) fetch(cur, buf);
    cp_async_commit();
    while (cur < units) {
        const Unit w = unit_of(cur, B, cpt, rows);
        const bool real = w.g0 + w.r0 < nr;  // a chunk past the end: nothing
        const DD* tree = reinterpret_cast<const DD*>(scratch + at.levels) +
                         ((long long)w.t * B + w.b) * (L + 1) * rows;
        // the next ticket, whose rows load while this one is scanned; the
        // earlier chunks this one reads from (d = 1, 2, 4, 8 chunks back: a
        // shift of 64 d rows, or less than 64 for d = 1) have published
        if (threadIdx.x == 0) s_ticket[slot] = (int)atomicAdd(scratch, 1u);
        if (real && threadIdx.x < 4) {
            const int d = 1 << threadIdx.x;
            if (d <= w.c && (d == 1 || d * CHUNK < rows))
                spin_until_set(flags + cur - (long long)d * B);
        }
        __syncthreads();  // also ends every read of the previous chunk
        const int nxt = s_ticket[slot];
        slot ^= 1;
        // what the tree reads from earlier chunks: level s at r0 + i - 2^s
        // for the first min(2^s, 64) positions i, zero before row 0, and
        // S[r0 - 1]
        if (real) {
#pragma unroll
            for (int e0 = 0; e0 < MAX_LEVELS * CHUNK; e0 += DD_THREADS) {
                const int e = e0 + threadIdx.x, s = e / CHUNK, i = e % CHUNK;
                const int k = 1 << s;
                if (s < L && i < min(k, CHUNK)) {
                    const int q = w.r0 + i - k;
                    cp_async8(&sm.halo[s][i],
                              q >= 0 ? tree + (long long)s * rows + q : tree,
                              q >= 0 ? 8 : 0);
                }
            }
            if (threadIdx.x == 0 && w.r0 > 0)
                cp_async8(&sm.soff[0], tree + (long long)L * rows + w.r0 - 1, 8);
        }
        cp_async_commit();
        if (nxt < units) fetch(nxt, buf ^ 1);
        cp_async_commit();
        cp_async_wait<2>();  // this lane's copies of the current chunk's rows
        __syncwarp();        // ... and its warp's
        const int ub = buf;
        cur = nxt;
        buf ^= 1;
        if (!real) continue;
        const float(&mine)[ROWS_PER_WARP][128] = sm.rows[ub][warp];

        // -- scan each of this warp's rows along its lanes ------------------
        const int rw = w.r0 + warp * ROWS_PER_WARP;  // first row, in the tile
        DD v[ROWS_PER_WARP][4];
#pragma unroll
        for (int k = 0; k < ROWS_PER_WARP; ++k) {
            if (BITMAJOR) {  // the lane's own copy, one 16-byte read
                const float4 q = *reinterpret_cast<const float4*>(&mine[k][4 * lane]);
                v[k][0].hi = q.x; v[k][1].hi = q.y; v[k][2].hi = q.z; v[k][3].hi = q.w;
            } else {
#pragma unroll
                for (int j = 0; j < 4; ++j) v[k][j].hi = mine[k][j * 32 + lane];
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) v[k][j].lo = 0.0f;
            scan_row(v[k], lane);
            if (lane == 31) sm.own[warp * ROWS_PER_WARP + k] = v[k][3];
        }
        cp_async_wait<1>();  // this lane's part of the halo
        __syncthreads();

        // -- the tree over the row totals, for this chunk's 64 rows ---------
        // One warp, positions r0 + i with i = j * 32 + lane: shifts below 32
        // are shuffles (and the halo for the first k positions), 32 is a
        // register move, larger shifts read the halo only. Every level is
        // published for the chunks after this one.
        if (warp == 0) {
            DD* pub = const_cast<DD*>(tree);
            DD cur2[2] = {sm.own[lane], sm.own[32 + lane]};
            const int p0 = w.r0 + lane, p1 = w.r0 + 32 + lane;
            for (int s = 0; s <= L; ++s) {
                if (s > 0) {
                    const int k = 1 << (s - 1);
                    DD src0, src1;
                    if (k < 32) {
                        const DD a0 = shfl_dd(cur2[0], (lane - k) & 31);
                        const DD a1 = shfl_dd(cur2[1], (lane - k) & 31);
                        src1 = lane >= k ? a1 : a0;
                        src0 = lane >= k ? a0 : sm.halo[s - 1][lane];
                    } else if (k == 32) {
                        src1 = cur2[0];
                        src0 = sm.halo[s - 1][lane];
                    } else {
                        src0 = sm.halo[s - 1][lane];
                        src1 = sm.halo[s - 1][32 + lane];
                    }
                    cur2[0] = dd_add2(cur2[0], src0);
                    cur2[1] = dd_add2(cur2[1], src1);
                }
                DD* lvl = pub + (long long)s * rows;
                if (p0 < rows) lvl[p0] = cur2[0];
                if (p1 < rows) lvl[p1] = cur2[1];
            }
            sm.soff[1 + lane] = cur2[0];
            sm.soff[33 + lane] = cur2[1];
            __threadfence();
            __syncwarp();
            if (lane == 0) {
                atomicExch(flags + (long long)(w.t * cpt + w.c) * B + w.b, 1u);
                // the carry into this tile, and the next tile's
                DD cin = zero;
                if (w.t > 0) {
                    unsigned* cs = carries + ((long long)w.t * B + w.b) * 4;
                    spin_until_set(cs + 2);
                    cin = load_dd(reinterpret_cast<const float2*>(cs));
                }
                s_carry = cin;
                if (w.c == cpt - 1 && w.t + 1 < n_tiles) {  // ends a full tile
                    // T_t: the tile's last element before the carry add, as
                    // the stores below compute it
                    const DD last = dd_add2(sm.own[rows - 1 - w.r0],
                                            rows >= 2 ? sm.soff[rows - 1 - w.r0] : zero);
                    const DD next = dd_add2(last, cin);
                    unsigned* cs = carries + ((long long)(w.t + 1) * B + w.b) * 4;
                    *reinterpret_cast<float2*>(cs) = make_float2(next.hi, next.lo);
                    __threadfence();
                    atomicExch(cs + 2, 1u);
                }
            }
        }
        __syncthreads();

        // -- the row offset and the carry, then the stores -----------------
        const DD cin = s_carry;
        float* oh = out_hi + (long long)w.b * out_stride + out_off;
        float* ol = out_lo + (long long)w.b * out_stride + out_off;
#pragma unroll
        for (int k = 0; k < ROWS_PER_WARP; ++k) {
            const int r = rw + k;
            const long long g = w.g0 + r;
            if (r >= rows || g >= nr) break;
            const DD off = r > 0 ? sm.soff[r - w.r0] : zero;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const DD o = dd_add2(dd_add2(v[k][j], off), cin);
                __stcs(oh + g * 128 + j * 32 + lane, o.hi);
                __stcs(ol + g * 128 + j * 32 + lane, o.lo);
            }
        }
    }
    cp_async_wait<0>();
}

}  // namespace

// Words of the scratch buffer rx_dd_cumsum needs (zeroed = 0), or how many
// of them at its start must be zero when it is called (zeroed = 1).
RX_EXPORT long long rx_dd_cumsum_scratch_words(int B, long long N,
                                               int tile_rows, int zeroed) {
    const long long nr = N / 128;
    const long long rows = nr < tile_rows ? nr : tile_rows;
    if (B <= 0 || rows <= 0) return 0;
    const Scratch s = scratch_layout((nr + rows - 1) / rows, B,
                                     (int)((rows + CHUNK - 1) / CHUNK), (int)rows);
    return zeroed ? s.levels : s.words;
}

// x: [B, N] f32 in tip order (bitmajor = 0) or [B, 32, W] bit-major with
// N = 32 * W (bitmajor = 1); N a multiple of 128. out_hi / out_lo:
// [B, out_stride] f32; prefix n of query b goes to column out_off + n.
// tile_rows in [1, 1024]. scratch: rx_dd_cumsum_scratch_words(...) words,
// the first rx_dd_cumsum_scratch_words(..., 1) of them zero.
RX_EXPORT int rx_dd_cumsum(const void* x, void* out_hi, void* out_lo, int B,
                           long long N, int tile_rows, int bitmajor,
                           long long out_stride, int out_off, void* scratch,
                           void* stream) {
    if (B <= 0 || N <= 0) return 0;
    if (N % 128 != 0 || tile_rows < 1 || tile_rows > DD_MAX_ROWS ||
        out_off < 0 || out_stride < N + out_off)
        return (int)cudaErrorInvalidValue;
    const long long nr = N / 128;
    const int rows = (int)(nr < tile_rows ? nr : tile_rows);
    const long long n_tiles = (nr + rows - 1) / rows;
    const int cpt = (rows + CHUNK - 1) / CHUNK;
    const long long units = n_tiles * B * cpt;
    if (units > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    auto kernel = bitmajor ? dd_cumsum_kernel<true> : dd_cumsum_kernel<false>;
    const int smem = (int)sizeof(DdSmem);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int device = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&device);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                            DD_THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    // persistent CTAs: as many as are resident at once, each walking tickets
    const long long grid = units < (long long)sms * per_sm ? units
                                                           : (long long)sms * per_sm;
    kernel<<<(unsigned)(grid > 0 ? grid : 1), DD_THREADS, smem, s>>>(
        (const float*)x, (float*)out_hi, (float*)out_lo, (unsigned*)scratch, B,
        nr, rows, (int)n_tiles, cpt, N, out_stride, out_off,
        bitmajor ? N / 32 : 0);
    return (int)cudaGetLastError();
}
