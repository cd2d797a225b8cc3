// Shared by every kernel source of the port. Each .cu file builds into its
// own shared library with a plain C interface (loaded with ctypes): pointers
// and the stream arrive as void*, every entry point returns
// cudaGetLastError() right after its launch, and nothing synchronises or
// allocates here.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define RX_EXPORT extern "C" __attribute__((visibility("default")))

// Text of a CUDA error code, for the Python wrapper's exception message.
RX_EXPORT const char* rx_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

static inline int rx_div_up(long long a, long long b) {
    return (int)((a + b - 1) / b);
}
