// Delegate bitmask combine: K-way word OR into `prev`, optionally with the
// per-word popcount of the newly set bits.
//
// Replaces: src/repro/kernels/mask_reduce.py::mask_reduce -- both Pallas
// bodies: `_kernel_fold` (with_count=False, pallas_call at line 92) and
// `_kernel` (with_count=True, pallas_call at line 101).
//
// What bounds it on an H100: memory. It reads (K+1)*NW*4 bytes and writes
// NW*4 (2*NW*4 with the count) and does K ORs and one popcount per word.
//
// Design: one thread per word, a loop over the K partials inside the
// thread, neighbouring threads on neighbouring words so every load and
// store of a warp is one coalesced 128-byte line. The TPU version tiles
// words into VMEM blocks and unrolls the K chain; on Hopper the grid-wide
// loop needs no tiling, and K (the partition count) stays a runtime loop.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool COUNT>
__global__ void __launch_bounds__(kThreads)
mask_reduce_kernel(const int* __restrict__ partials,  // [K, NW]
                   const int* __restrict__ prev,      // [NW]
                   int* __restrict__ out,             // [NW]
                   int* __restrict__ count,           // [NW] or unused
                   int K, long long NW) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= NW) return;
  const unsigned before = (unsigned)prev[i];
  unsigned combined = before;
  for (int k = 0; k < K; ++k) combined |= (unsigned)partials[k * NW + i];
  out[i] = (int)combined;
  if (COUNT) count[i] = __popc(combined & ~before);
}

}  // namespace

// Returns the launch's cudaError_t (0 = launched). `count` may be null:
// then only the OR fold runs (the with_count=False variant).
extern "C" int mask_reduce(const void* partials, const void* prev, void* out,
                           void* count, int K, long long NW, void* stream) {
  if (NW == 0) return (int)cudaSuccess;
  const long long blocks = (NW + kThreads - 1) / kThreads;
  const int* pa = static_cast<const int*>(partials);
  const int* pv = static_cast<const int*>(prev);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (count != nullptr) {
    mask_reduce_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(
        pa, pv, o, static_cast<int*>(count), K, NW);
  } else {
    mask_reduce_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        pa, pv, o, nullptr, K, NW);
  }
  return (int)cudaGetLastError();
}
