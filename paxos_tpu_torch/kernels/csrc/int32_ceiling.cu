// int32 ALU ceiling probe for Hopper (sm_90a).
//
// Replaces: scripts/roofline.py::vpu_ceiling, the Pallas kernel that runs
// 8 dependent int32 operations per element per iteration over a carry
// resident in VMEM, so that the time difference between two iteration
// counts gives the attainable int32 operation rate.
//
// Body per element and iteration (all arithmetic wraps as int32; computed
// in uint32 so nothing overflows as signed, with an arithmetic >> 7):
//   x += 0x9E3779B9; x ^= x << 13; x ^= x >> 7; x = max(x, x * 5); x += i
// which the reference counts as 8 operations.
//
// Design: the carry lives in registers.  Each thread carries kIlp
// independent elements, so consecutive instructions of one thread do not
// wait on each other and the timing measures throughput rather than the
// latency of one dependent chain (the reference warns of a ~12x gap).
// Bound on this card: operations; the 2 x 4 B per element it moves are
// read and written once per launch, whatever the iteration count.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kIlp = 8;

__device__ __forceinline__ uint32_t body(uint32_t x, uint32_t i) {
  x += 0x9E3779B9u;
  x ^= x << 13;
  x ^= static_cast<uint32_t>(static_cast<int32_t>(x) >> 7);
  const uint32_t y = x * 5u;
  x = static_cast<int32_t>(x) >= static_cast<int32_t>(y) ? x : y;  // signed max
  return x + i;
}

__global__ void __launch_bounds__(kThreads)
int32_ceiling_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, int64_t n,
                     int iters) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads * kIlp + threadIdx.x;
  uint32_t x[kIlp];
#pragma unroll
  for (int k = 0; k < kIlp; ++k) {
    const int64_t e = base + static_cast<int64_t>(k) * kThreads;
    x[k] = e < n ? static_cast<uint32_t>(in[e]) : 0u;
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < kIlp; ++k) x[k] = body(x[k], static_cast<uint32_t>(it));
  }
#pragma unroll
  for (int k = 0; k < kIlp; ++k) {
    const int64_t e = base + static_cast<int64_t>(k) * kThreads;
    if (e < n) out[e] = static_cast<int32_t>(x[k]);
  }
}

}  // namespace

// C entry point, loaded with ctypes: `iters` iterations of the body over
// the n int32 elements of `in`, written to `out` (device pointers), on
// `stream`.  Returns the launch's cudaGetLastError().
extern "C" int int32_ceiling_launch(const void* in, void* out, long long n, int iters,
                                    void* stream) {
  if (n <= 0 || iters < 0) return cudaErrorInvalidValue;
  const int64_t per_block = static_cast<int64_t>(kThreads) * kIlp;
  const auto grid = static_cast<unsigned>((n + per_block - 1) / per_block);
  int32_ceiling_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(in), static_cast<int32_t*>(out), n, iters);
  return cudaGetLastError();
}
