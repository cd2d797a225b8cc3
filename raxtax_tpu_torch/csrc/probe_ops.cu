// K13 rx_probe_op_chain: register-resident operation chains, for the cost of
// one u32 operation and of one software f64 add on this card.
//
// Replaces run/kernel of scripts/probe_mosaic_perf.py:38-51 (pallas_call at
// :55): an [8, 128] u32 state (a, a + 1) goes through `iters` steps of one
// of seven bodies (probe_mosaic_perf.py:69-96), with no memory traffic in
// the loop, and the XOR of the two state words is stored. One thread per
// element, the body a template parameter, the step count a run-time
// argument.
//
// Keeping the work in the loop. Integer adds reassociate, so the compiler
// would fold u32_add_x1 to st + iters * b, and the eight adds of u32_add_x8
// to one add of a hoisted 4a + 4b, and the timing would measure nothing.
// Every state word therefore passes an empty `asm volatile("" : "+r"(x))`
// after each step, and after each operation of the multi-operation bodies:
// no instruction is emitted, but the compiler no longer knows the value, so
// each operation stays, dependent on the one before. `#pragma unroll 1`
// keeps one step per trip, so the loop's own counter, compare and branch are
// in every step's time (as in the TPU probe's fori_loop). The bits are those
// of the plain version (ops/opchain.py), which checks them.
//
// What `cuobjdump -sass` shows (tools/probe_ops.py --sass, sm_90a): every
// chain's operations are inside its loop, one step per trip, no closed form.
// The barrier binds the compiler's front end only: ptxas still fuses pairs of
// u32_add_x8's adds into four IADD3, and the four shifts of shift_var_x4 keep
// their masks hoisted out of the loop. The loop trip (a uniform-register
// counter, compare and branch) costs more than any one-operation body, so
// those chains time the trip; f64_add_full is the one that times its body.
//
// Bound: the latency of the dependent chain, one step after the other; 1,024
// threads in 8 CTAs leave the card almost idle, which is the point.
#include "exactf64.cuh"
#include "rx_common.cuh"

namespace {

constexpr int CHAIN_THREADS = 128;

__device__ __forceinline__ void opaque(unsigned& x) {
    asm volatile("" : "+r"(x));
}

// the chains, in the order of ops/opchain.py CHAINS
enum Chain {
    U32_ADD_X1 = 0,
    U32_ADD_X8 = 1,
    SHIFT_FIXED_X1 = 2,
    SHIFT_VAR_X1 = 3,
    SHIFT_VAR_X4 = 4,
    CMP_SELECT_X1 = 5,
    F64_ADD_FULL = 6,
};

template <int CHAIN>
__device__ __forceinline__ void step(unsigned& s0, unsigned& s1,
                                     const unsigned a, const unsigned b) {
    if (CHAIN == U32_ADD_X1) {
        s0 = s0 + b;
    } else if (CHAIN == U32_ADD_X8) {
        // st + b + a + b + a + b + a + b + a, left to right
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            s0 = s0 + b;
            opaque(s0);
            s0 = s0 + a;
            opaque(s0);
        }
    } else if (CHAIN == SHIFT_FIXED_X1) {
        s0 = s0 >> 5;
        s1 = s1 + a;
    } else if (CHAIN == SHIFT_VAR_X1) {
        s0 = s0 >> (b & 31u);
        s1 = s1 + a;
    } else if (CHAIN == SHIFT_VAR_X4) {
        s0 = s0 >> (b & 31u);
        opaque(s0);
        s0 = s0 << (b & 15u);
        opaque(s0);
        s0 = s0 >> (b & 7u);
        opaque(s0);
        s0 = s0 << (b & 3u);
        s1 = s1 + a;
    } else if (CHAIN == CMP_SELECT_X1) {
        const unsigned n0 = s0 > b ? s0 + a : s1;
        s1 = s1 + a;
        s0 = n0;
    } else {  // F64_ADD_FULL: the state is one f64 bit pair
        rx_f64_add_u32(s0, s1, a, b, s0, s1);
    }
}

template <int CHAIN>
__global__ void __launch_bounds__(CHAIN_THREADS)
op_chain_kernel(const unsigned* __restrict__ a_in,
                const unsigned* __restrict__ b_in, unsigned* __restrict__ out,
                int n, int iters) {
    const int i = blockIdx.x * CHAIN_THREADS + threadIdx.x;
    if (i >= n) return;
    const unsigned a = a_in[i], b = b_in[i];
    unsigned s0 = a, s1 = a + 1u;
#pragma unroll 1
    for (int it = 0; it < iters; ++it) {
        step<CHAIN>(s0, s1, a, b);
        opaque(s0);
        opaque(s1);
    }
    out[i] = s0 ^ s1;
}

template <int CHAIN>
int launch(const void* a, const void* b, void* out, int n, int iters,
           cudaStream_t stream) {
    op_chain_kernel<CHAIN><<<rx_div_up(n, CHAIN_THREADS), CHAIN_THREADS, 0,
                             stream>>>((const unsigned*)a, (const unsigned*)b,
                                       (unsigned*)out, n, iters);
    return (int)cudaGetLastError();
}

}  // namespace

RX_EXPORT int rx_probe_op_chain(int chain, const void* a, const void* b,
                                void* out, int n, int iters, void* stream) {
    if (n <= 0) return 0;
    if (iters < 0) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    switch (chain) {
        case U32_ADD_X1: return launch<U32_ADD_X1>(a, b, out, n, iters, s);
        case U32_ADD_X8: return launch<U32_ADD_X8>(a, b, out, n, iters, s);
        case SHIFT_FIXED_X1: return launch<SHIFT_FIXED_X1>(a, b, out, n, iters, s);
        case SHIFT_VAR_X1: return launch<SHIFT_VAR_X1>(a, b, out, n, iters, s);
        case SHIFT_VAR_X4: return launch<SHIFT_VAR_X4>(a, b, out, n, iters, s);
        case CMP_SELECT_X1: return launch<CMP_SELECT_X1>(a, b, out, n, iters, s);
        case F64_ADD_FULL: return launch<F64_ADD_FULL>(a, b, out, n, iters, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
