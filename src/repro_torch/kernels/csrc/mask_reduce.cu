// Delegate combine folds: K-way word OR into `prev` (optionally with the
// per-word popcount of the newly set bits), and its payload sibling, the
// K-way int32 min into `prev` (optionally with a 0/1 improved flag).
//
// Replaces: src/repro/kernels/mask_reduce.py -- all four Pallas bodies:
// mask_reduce's `_kernel_fold` (with_count=False, pallas_call at line 92)
// and `_kernel` (with_count=True, line 101); payload_min_fold's
// `_kernel_min_fold` (with_count=False, line 145) and `_kernel_min`
// (with_count=True, line 154).
//
// What bounds them on an H100: memory. Each reads (K+1)*NW*4 bytes and
// writes NW*4 (2*NW*4 with the count/flag) and does K ORs or mins and one
// popcount or compare per element.
//
// Design (both kernels): one thread per element, a loop over the K
// partials inside the thread, neighbouring threads on neighbouring
// elements so every load and store of a warp is one coalesced 128-byte
// line. The TPU version tiles elements into VMEM blocks and unrolls the K
// chain; on Hopper the grid-wide loop needs no tiling, and K (the
// partition count) stays a runtime loop. The `with_count` variants are a
// template flag, so the fold-only launch carries no second output.
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

template <bool FLAG>
__global__ void __launch_bounds__(kThreads)
payload_min_fold_kernel(const int* __restrict__ partials,  // [K, NW]
                        const int* __restrict__ prev,      // [NW]
                        int* __restrict__ out,             // [NW]
                        int* __restrict__ improved,        // [NW] or unused
                        int K, long long NW) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= NW) return;
  const int before = prev[i];
  int combined = before;
  for (int k = 0; k < K; ++k) combined = min(combined, partials[k * NW + i]);
  out[i] = combined;
  if (FLAG) improved[i] = combined < before ? 1 : 0;
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

// Returns the launch's cudaError_t (0 = launched). `improved` may be null:
// then only the min fold runs (the with_count=False variant).
extern "C" int payload_min_fold(const void* partials, const void* prev,
                                void* out, void* improved, int K,
                                long long NW, void* stream) {
  if (NW == 0) return (int)cudaSuccess;
  const long long blocks = (NW + kThreads - 1) / kThreads;
  const int* pa = static_cast<const int*>(partials);
  const int* pv = static_cast<const int*>(prev);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (improved != nullptr) {
    payload_min_fold_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(
        pa, pv, o, static_cast<int*>(improved), K, NW);
  } else {
    payload_min_fold_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        pa, pv, o, nullptr, K, NW);
  }
  return (int)cudaGetLastError();
}
