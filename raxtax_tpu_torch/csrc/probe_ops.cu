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
// each operation stays, dependent on the one before. The bits are those of
// the plain version (ops/opchain.py), which checks them.
//
// The loop is unrolled by CHAIN_UNROLL steps a trip, with a remainder loop
// for iters % CHAIN_UNROLL, so the loop's own counter, compare and branch
// cost one sixteenth of a step: a one-operation chain reads the latency of
// its operation, which is what the TPU probe says it isolates
// (probe_mosaic_perf.py:2-7), and f64_add_full reads the latency of one
// software add (rx_f64_add_u32), the floor of K12.
//
// What `cuobjdump -sass` shows (tools/probe_ops.py --sass, sm_90a): each
// chain's main loop holds CHAIN_UNROLL copies of its body, every operation
// of every step inside it, no closed form; the remainder loop one copy. The
// barrier binds the compiler's front end only: ptxas fuses two dependent
// adds into one three-input IADD3 (u32_add_x8's eight adds are four a step,
// u32_add_x1's sixteen are eight a trip, and so are the s1 adds of three
// other chains) and hoists the masks of the variable shifts and the
// addend's half of f64_add_full. With an immediate shift amount it merged
// shift_fixed_x1's sixteen shifts of a trip into one shift by 80, a
// constant 0, so that chain shifts by a run-time 5 (one SHF a step, as the
// immediate form is). tools/probe_ops.py chain_sass counts the instructions
// and the dependent instructions a step from the SASS, and
// tools/kernel_batch.py turns them into each chain's floor.
//
// Bound: the latency of the dependent chain, one step after the other; 1,024
// threads in 8 CTAs leave the card almost idle, which is the point.
#include "exactf64.cuh"
#include "rx_common.cuh"

namespace {

constexpr int CHAIN_THREADS = 128;
constexpr int CHAIN_UNROLL = 16;  // steps a trip of the main loop

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

// One step of chain CHAIN; five is 5, a value ptxas cannot see (below).
template <int CHAIN>
__device__ __forceinline__ void step(unsigned& s0, unsigned& s1,
                                     const unsigned a, const unsigned b,
                                     const unsigned five) {
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
        s0 = s0 >> five;
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
    // ptxas folds sixteen shifts by an immediate 5 into one shift by 80,
    // which is 0; the entry refuses iters < 0, so this is 5 at run time
    const unsigned five = 5u + ((unsigned)iters >> 31);
    int it = 0;
#pragma unroll 1
    for (; it + CHAIN_UNROLL <= iters; it += CHAIN_UNROLL) {
#pragma unroll
        for (int u = 0; u < CHAIN_UNROLL; ++u) {
            step<CHAIN>(s0, s1, a, b, five);
            opaque(s0);
            opaque(s1);
        }
    }
#pragma unroll 1
    for (; it < iters; ++it) {
        step<CHAIN>(s0, s1, a, b, five);
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
