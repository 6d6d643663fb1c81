// Per-lane min-plus pull over ELL-padded parent lists:
//
//     out[r, q] = min(2**30, min_{k : parents[r,k] >= 0}
//                              payload[parents[r,k], q] + weights[r,k])
//     out[r, q] = 2**30 where active[r, q] == 0
//
// (2**30 is the identity of the min_plus combine, core/comm/base.py.)
//
// Replaces: src/repro/kernels/ell_pull_payload.py::ell_pull_payload (the
// Pallas `_kernel`, pallas_call at line 64).
//
// What bounds it on an H100: memory. Per valid parent slot it reads the
// parent's W-lane payload row (128 bytes at W = 32) at a random row index,
// and per row its K parent ids and weights and its W active flags; it does
// two integer operations per slot and lane.
//
// Design: the TPU kernel keeps the whole payload table in VMEM and runs an
// unrolled min chain over a [TR, K, W] tile. Here one warp owns one row
// and lane q owns payload lane q: at W = 32 (the warp width) each parent's
// payload row is one coalesced 128-byte read. The warp loads 32 of the
// row's parent ids and weights at once (coalesced) and broadcasts each with
// __shfl_sync; -1 slots are skipped. W != 32 loops over groups of 32 lanes
// (the reference's tests use W = 8, which leaves lanes idle). payload +
// weight is added in unsigned arithmetic and cast back, so it wraps as the
// reference's int32 add does (signed overflow is undefined in C++).
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kIdent = 1 << 30;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ell_pull_payload_kernel(const int* __restrict__ parents,   // [R, K], -1 pad
                        const int* __restrict__ payload,   // [N, W]
                        const int* __restrict__ weights,   // [R, K]
                        const int* __restrict__ active,    // [R, W]
                        int* __restrict__ out,             // [R, W]
                        long long R, int K, int W) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= R) return;  // uniform per warp
  const int* p_row = parents + row * K;
  const int* w_row = weights + row * K;
  for (int q0 = 0; q0 < W; q0 += 32) {
    const int q = q0 + lane;
    int acc = kIdent;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int k = k0 + lane;
      const int my_parent = k < K ? p_row[k] : -1;
      const int my_weight = k < K ? w_row[k] : 0;
      const int slots = min(32, K - k0);
      for (int s = 0; s < slots; ++s) {
        const int u = __shfl_sync(kFull, my_parent, s);
        const int wv = __shfl_sync(kFull, my_weight, s);
        if (u >= 0 && q < W) {
          const int v = (int)((unsigned)payload[(long long)u * W + q] +
                              (unsigned)wv);
          acc = min(acc, v);
        }
      }
    }
    if (q < W) out[row * W + q] = active[row * W + q] != 0 ? acc : kIdent;
  }
}

}  // namespace

// Returns the launch's cudaError_t (0 = launched). The caller owns every
// buffer; the kernel runs on `stream` and does not synchronise.
extern "C" int ell_pull_payload(const void* parents, const void* payload,
                                const void* weights, const void* active,
                                void* out, long long R, int K, int W,
                                void* stream) {
  if (R == 0 || W == 0) return (int)cudaSuccess;
  if (K < 0 || W < 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  ell_pull_payload_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(parents), static_cast<const int*>(payload),
      static_cast<const int*>(weights), static_cast<const int*>(active),
      static_cast<int*>(out), R, K, W);
  return (int)cudaGetLastError();
}
