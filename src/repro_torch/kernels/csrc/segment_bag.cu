// EmbeddingBag: per-bag weighted sum of gathered table rows.
//
//     out[b, :] = sum_{l : indices[b, l] >= 0} weights[b, l] * table[indices[b, l], :]
//
// Replaces: src/repro/kernels/segment_bag.py::segment_bag (the Pallas
// `_kernel`, pallas_call at line 55).
//
// What bounds it on an H100: memory. Per valid slot it reads one table row
// (D values) at a random row index, plus the slot's 4-byte index and
// weight; it does 2*D flops per slot, far below the card's rate.
//
// Design: the TPU kernel keeps the table's [V, TD] column block resident
// in VMEM and gathers a [TB, L] tile of bags from it. An H100 table does
// not fit in shared memory, so rows are gathered from device memory (L2
// catches the hot rows): one warp per bag. The warp loads up to 32 of the
// bag's slot indices and weights at once (coalesced) and broadcasts each
// with __shfl_sync, so each row index is read once per slot; the lanes
// then read the row's D columns coalesced (lane = column, D > 32 loops over
// column groups). Sums accumulate in float32 and are rounded once to the
// table's type (float32 or bfloat16). Slots with index -1 add nothing; a
// null weights pointer means weights of 1. With D = 10, 22 lanes of each
// warp idle; packing several bags per warp is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_bag_kernel(const T* __restrict__ table,        // [V, D]
                   const int* __restrict__ indices,    // [B, L], -1 padded
                   const float* __restrict__ weights,  // [B, L] or null
                   T* __restrict__ out,                // [B, D]
                   long long B, int L, int D) {
  const int lane = threadIdx.x & 31;
  const long long bag =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (bag >= B) return;  // uniform per warp
  const int* idx_row = indices + bag * L;
  const float* w_row = weights ? weights + bag * L : nullptr;
  for (int d0 = 0; d0 < D; d0 += 32) {
    const int d = d0 + lane;
    float acc = 0.f;
    for (int l0 = 0; l0 < L; l0 += 32) {
      const int l = l0 + lane;
      const int my_idx = l < L ? idx_row[l] : -1;
      const float my_w = (l < L && w_row) ? w_row[l] : 1.f;
      const int slots = min(32, L - l0);
      for (int s = 0; s < slots; ++s) {
        const int row = __shfl_sync(kFull, my_idx, s);
        const float wv = __shfl_sync(kFull, my_w, s);
        if (row >= 0 && d < D)
          acc = fmaf(wv, to_float(table[(long long)row * D + d]), acc);
      }
    }
    if (d < D) out[bag * D + d] = from_float<T>(acc);
  }
}

template <typename T>
int launch(const void* table, const void* indices, const void* weights,
           void* out, long long B, int L, int D, void* stream) {
  if (B == 0 || D == 0) return (int)cudaSuccess;
  if (L < 0 || D < 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  segment_bag_kernel<T><<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(table), static_cast<const int*>(indices),
      static_cast<const float*>(weights), static_cast<T*>(out), B, L, D);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the launch's cudaError_t (0 = launched). `weights` may be null
// (all ones). The caller owns every buffer; the kernel runs on `stream`
// and does not synchronise.
extern "C" int segment_bag_f32(const void* table, const void* indices,
                               const void* weights, void* out, long long B,
                               int L, int D, void* stream) {
  return launch<float>(table, indices, weights, out, B, L, D, stream);
}

extern "C" int segment_bag_bf16(const void* table, const void* indices,
                                const void* weights, void* out, long long B,
                                int L, int D, void* stream) {
  return launch<__nv_bfloat16>(table, indices, weights, out, B, L, D, stream);
}
