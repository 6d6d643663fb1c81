// Weight gradient of one fused CIN step of xDeepFM:
//
//     dW[h, i*Fk + j] = sum_{b, d} dOut[b, h, d] * x0[b, i, d] * xk[b, j, d]
//
// Replaces: the weight half of JAX's autodiff of
// src/repro/kernels/cin_fused.py::cin_fused (the Pallas `_kernel`,
// pallas_call at line 57). The reference has no backward kernel of its own
// (the training path differentiates its oracle with jax.grad); the port's
// forward is a CUDA kernel torch cannot differentiate, so its backward is
// two kernels: this one and cin_fused_bwd_x.cu.
//
// Read as a GEMM whose A operand is never written to device memory:
//     dW^T[k, h] = Z[k, n] . dOut[n, h],   n = (b, d) (B*D rows), k = (i, j),
//     Z[(i, j), (b, d)] = x0[b, i, d] * xk[b, j, d].
// Materialising Z is what the plain version does: B*D*F0*Fk floats, 20.4 GB
// per layer at the train_batch shape (B = 65,536, F0 = 39, Fk = 200, D = 10).
//
// Arithmetic: float32-grade results on the TF32 tensor cores (3xTF32), as
// the forward (cin_fused.cu): Z and dOut split into TF32 hi and lo, the
// float32 accumulators take lo*hi + hi*lo + hi*hi per product.
//
// What bounds it on an H100: operations. 2*H*F0*Fk*B*D flops (the
// forward's count), three TF32 products each at the 495 TFLOP/s dense TF32
// peak: 2.04 TFLOP a 200-wide layer at train_batch, 12.4 ms at that rate
// (30.5 ms for one float32 product each on the CUDA cores, 67 TFLOP/s).
//
// Design (the forward's pipeline with the roles of the operands swapped):
//   * the MMA's M is k = (i, j) (128 rows a block, two warpgroups of 64),
//     N is H (208 channels, H = 200 in one tile), K runs over n in steps
//     of 8 (zero past the last row);
//   * dOut is split into TF32 hi and lo once per call by a first kernel,
//     straight into the order the MMAs read: per (H tile, n step) one
//     13 KB pair of [208 x 8] K-major tiles, streamed through a ring of 6
//     shared-memory buffers by bulk asynchronous copies on mbarriers,
//     issued by one thread 3 steps ahead (tf32x3_wgmma.cuh);
//   * each thread's two A rows k (so its i and j) are fixed; its A
//     elements x0[n, i] * xk[n, j] for an n step are read from global
//     memory (L1 / L2) one step ahead, formed and split in registers while
//     the MMAs two steps back retire (A double-buffered);
//   * every kChunk n steps a thread adds its accumulators into its own
//     float32 slots in shared memory and starts them again from zero: the
//     tensor cores' accumulation drifts with the length of the chain (on an
//     H100, against float32 sums: 3.4e-6 of max|dW| after 58 steps, 6.5e-6
//     after 113, 4.1e-4 after the 7,447 a block of layer 0 runs at
//     train_batch without promotions);
//   * the n steps are split over `splits` blocks per tile (gridDim.z), as
//     many as fill the card's multiprocessors in whole waves; each split
//     writes its partial dW to its own slab and a third kernel adds the
//     slabs in a fixed order. No float atomics: two calls on the same
//     inputs give bit-equal outputs.
#include <cuda_runtime.h>

#include <cstdint>

#include "tf32x3_wgmma.cuh"

namespace {

using namespace tf32x3;

constexpr int kBM = 128;                     // dW columns k per block
constexpr int kThreads = 256;                // two warpgroups
constexpr int kRing = 6;                     // dOut buffers (one n step each)
constexpr int kAhead = 3;                    // n steps a copy runs ahead
constexpr int kADepth = 2;                   // A buffers = MMA groups in flight
constexpr int kRingFloats = kRing * kStep;
constexpr int kBarBytes = 128;               // 2 * kRing mbarriers, padded
constexpr int kAcc = 104;                    // accumulators a thread
constexpr int kChunk = 16;                   // n steps between promotions
constexpr int kSmemBytes = 4 * (kRingFloats + kAcc * kThreads) + kBarBytes;
constexpr int kMaxSplits = 32;
constexpr int kMinStepsPerSplit = 16;

static_assert(kRing - kAhead >= kADepth + 1 && 2 * kRing * 8 <= kBarBytes,
              "a refilled buffer's last reader retired a step before");
static_assert(kChunk % kADepth == 0, "a promotion starts an A buffer pair");

// dOut [B, H, D] -> per (H tile, n step q) the pair of [208 x 8] tiles
// (hi, then lo) of dOut^T[h, n], n = b*D + d, in the core-matrix order of
// b_desc; zero past H and past the last row. One thread per element of a
// hi tile.
__global__ void __launch_bounds__(256)
cin_g_split_kernel(const float* __restrict__ g, float* __restrict__ g2,
                   long long ncols, int H, int D, long long total,
                   long long n) {
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < n; idx += (long long)gridDim.x * blockDim.x) {
    const int e = (int)(idx % kBTile);
    const long long tq = idx / kBTile;     // H tile * total + q
    const long long q = tq % total;
    const int h = (int)(tq / total) * kBN + tile_row(e);
    const long long c = q * 8 + tile_col(e);
    float v = 0.f;
    if (h < H && c < ncols) {
      const long long b = c / D;
      v = g[(b * H + h) * D + (c - b * D)];
    }
    uint32_t hi, lo;
    split(v, hi, lo);
    g2[tq * kStep + e] = __uint_as_float(hi);
    g2[tq * kStep + kBTile + e] = __uint_as_float(lo);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
cin_bwd_w_kernel(const float* __restrict__ x0,   // [B, F0, D]
                 const float* __restrict__ xk,   // [B, Fk, D]
                 const float* __restrict__ g2,   // split dOut, see above
                 float* __restrict__ out,        // [splits][H, F0*Fk]
                 long long ncols, int F0, int Fk, int H, int D, int splits) {
  extern __shared__ __align__(128) float smem[];
  const uint32_t ring_addr = smem_addr(smem);
  const uint32_t bars = smem_addr(smem + kRingFloats);  // full, then empty
  // the promoted sums: slot e of thread tid at tot[e * kThreads + tid]
  float* tot = smem + kRingFloats + kBarBytes / 4;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;                 // fragment row
  const int t = lane & 3;                  // fragment K index
  const long long K = (long long)F0 * Fk;
  const long long k0 = (long long)blockIdx.x * kBM;
  const long long total = (ncols + 7) / 8;  // n steps
  const long long q0 = total * blockIdx.z / splits;
  const int nsteps = (int)(total * (blockIdx.z + 1) / splits - q0);
  const float* gsrc = g2 + ((long long)blockIdx.y * total + q0) * kStep;
  auto full = [&](int b) { return bars + 8 * b; };
  auto empty = [&](int b) { return bars + 8 * (kRing + b); };

  if (tid == 0) {
    for (int b = 0; b < kRing; ++b) {
      mbar_init(full(b), 1);
      mbar_init(empty(b), 2);              // one arrival per warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int u = 0; u < kRing && u < nsteps; ++u)
      load_step(ring_addr + u * kStepBytes, gsrc + (long long)u * kStep,
                full(u));
  }
  __syncthreads();   // barriers initialised

  // This thread's A rows: k = k0 + row + 8r (r = 0, 1), fixed; its A
  // columns: n = 8q + t + 4s (s = 0, 1), as sample nb[s] and offset nd[s].
  const int row = (warp >> 2) * 64 + (warp & 3) * 16 + g;
  int xo[2], ko[2];                        // i * D, j * D
  bool rok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long k = k0 + row + 8 * r;
    rok[r] = k < K;
    const int i = rok[r] ? (int)(k / Fk) : 0;
    xo[r] = i * D;
    ko[r] = rok[r] ? (int)(k - (long long)i * Fk) * D : 0;
  }
  long long nb[2];
  int nd[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const long long n = 8 * q0 + t + 4 * s;
    nb[s] = n / D;
    nd[s] = (int)(n - nb[s] * D);
  }
  // x0 and xk values of the next step's A elements, element 2s + r
  float xv[4], kv[4];
  auto fetch = [&]() {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const bool ok = nb[s] * D + nd[s] < ncols;
      const float* xr = x0 + nb[s] * F0 * D + nd[s];
      const float* kr = xk + nb[s] * Fk * D + nd[s];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        xv[2 * s + r] = ok && rok[r] ? xr[xo[r]] : 0.f;
        kv[2 * s + r] = ok && rok[r] ? kr[ko[r]] : 0.f;
      }
      nd[s] += 8;
      while (nd[s] >= D) {
        nd[s] -= D;
        ++nb[s];
      }
    }
  };
  if (nsteps > 0) fetch();

  float acc[kAcc];
#pragma unroll
  for (int e = 0; e < kAcc; ++e) {
    acc[e] = 0.f;
    tot[e * kThreads + tid] = 0.f;
  }

  const bool releaser = (tid & 127) == 0;  // one thread per warpgroup
  uint32_t ahi[kADepth][4] = {}, alo[kADepth][4] = {};  // A, u % kADepth
  for (int u0 = 0; u0 < nsteps; u0 += kADepth) {
#pragma unroll
    for (int p = 0; p < kADepth; ++p) {
      const int u = u0 + p;
      if (u >= nsteps) break;
      const int b = u % kRing;
      // A in the m16n8k8 layout: (row, col t), (row + 8, t), (row, t + 4),
      // (row + 8, t + 4) = elements 0, 1, 2, 3
      float z[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) z[e] = xv[e] * kv[e];
      if (u + 1 < nsteps) fetch();         // in flight during this step
      wgmma_wait<kADepth - 1>();           // step u - kADepth retired
      if (u > 0 && u % kChunk == 0) {      // promote: every MMA retired
        wgmma_wait<0>();
        pin(acc);
#pragma unroll
        for (int e = 0; e < kAcc; ++e) {
          tot[e * kThreads + tid] += acc[e];
          acc[e] = 0.f;
        }
      }
      keep(ahi[p], alo[p]);                // live (unreused) until here
      if (releaser && u >= kADepth) mbar_arrive(empty((u - kADepth) % kRing));
      const int v = u + kAhead;            // the step to load now
      if (tid == 0 && v >= kRing && v < nsteps) {
        // its buffer's last step, v - kRing < u - kADepth, is released by
        // both warpgroups (each releases step x at step x + kADepth)
        const int rb = v % kRing;
        mbar_wait(empty(rb), (v / kRing - 1) & 1);
        load_step(ring_addr + rb * kStepBytes, gsrc + (long long)v * kStep,
                  full(rb));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) split(z[e], ahi[p][e], alo[p][e]);
      mbar_wait(full(b), (u / kRing) & 1);
      const uint32_t bt = ring_addr + b * kStepBytes;
      const uint64_t dhi = b_desc(bt);
      const uint64_t dlo = b_desc(bt + kBTile * 4);
      wgmma_fence();
      pin(acc);
      wgmma_n208(acc, alo[p], dhi);
      wgmma_n208(acc, ahi[p], dlo);
      wgmma_n208(acc, ahi[p], dhi);
      wgmma_commit();
      pin(acc);
    }
  }
  wgmma_wait<0>();
  pin(acc);
#pragma unroll
  for (int p = 0; p < kADepth; ++p) keep(ahi[p], alo[p]);

  // Epilogue: acc[4j + e] (plus its promoted sum) is row `row` (e < 2) or
  // row + 8, channel 8j + 2t + (e & 1) of this block's H tile.
  float* dst = out + (long long)blockIdx.z * H * K;
  const int h0 = blockIdx.y * kBN;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long k = k0 + row + half * 8;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int h = h0 + 8 * j + 2 * t;
      const int e = 4 * j + 2 * half;
      if (h < H)
        dst[(long long)h * K + k] = tot[e * kThreads + tid] + acc[e];
      if (h + 1 < H)
        dst[(long long)(h + 1) * K + k] =
            tot[(e + 1) * kThreads + tid] + acc[e + 1];
    }
  }
}

// out[e] = sum_s partial[s][e], s in order: the deterministic reduction of
// the split sums.
__global__ void __launch_bounds__(256)
cin_bwd_w_sum_kernel(const float* __restrict__ partial,
                     float* __restrict__ out, long long n, int splits) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    float s = partial[e];
    for (int k = 1; k < splits; ++k) s += partial[k * n + e];
    out[e] = s;
  }
}

__host__ __device__ constexpr long long g2_floats(long long ncols, int H) {
  return (long long)((H + kBN - 1) / kBN) * ((ncols + 7) / 8) * kStep;
}

int configured_device = -1;   // device whose smem limit was raised

unsigned grid_1d(long long n) {
  const long long blocks = (n + 255) / 256;
  return (unsigned)(blocks < 8192 ? blocks : 8192);
}

}  // namespace

// How many blocks share one dW tile's n steps: the fewest that fill the
// card's `sms` multiprocessors (one block each) in whole waves to within
// 1% of the best count up to kMaxSplits, with at least kMinStepsPerSplit
// n steps a block.
extern "C" int cin_fused_bwd_w_splits(long long ncols, int F0, int Fk, int H,
                                      int sms) {
  const long long K = (long long)F0 * Fk;
  const long long tiles = ((K + kBM - 1) / kBM) * ((H + kBN - 1) / kBN);
  const long long steps = (ncols + 7) / 8;
  if (tiles <= 0 || sms <= 0) return 1;
  int best = 1;
  double best_fill = 0.0;
  for (int s = 1; s <= kMaxSplits; ++s) {
    if (s > 1 && steps / s < kMinStepsPerSplit) break;
    const long long blocks = tiles * s;
    const double fill =
        (double)blocks / (double)(((blocks + sms - 1) / sms) * sms);
    if (fill > best_fill + 0.01) {
      best = s;
      best_fill = fill;
    }
  }
  return best;
}

// Floats of scratch one call needs: the split dOut, then (splits > 1) one
// [H, F0*Fk] partial slab per split.
extern "C" long long cin_fused_bwd_w_work_floats(long long B, int F0, int Fk,
                                                 int H, int D, int splits) {
  return g2_floats(B * D, H) +
         (splits > 1 ? (long long)splits * H * F0 * Fk : 0);
}

// Returns the launch's cudaError_t (0 = launched). The caller owns every
// buffer: dw [H, F0*Fk], work cin_fused_bwd_w_work_floats(...) floats. The
// kernels run on `stream` and do not synchronise.
extern "C" int cin_fused_bwd_w(const void* x0, const void* xk, const void* g,
                               void* dw, void* work, long long B, int F0,
                               int Fk, int H, int D, int splits,
                               void* stream) {
  const long long K = (long long)F0 * Fk;
  if (K == 0 || H == 0) return (int)cudaSuccess;
  if (F0 <= 0 || Fk <= 0 || D <= 0 || B < 0 || splits < 1 ||
      splits > kMaxSplits ||
      (work == nullptr && cin_fused_bwd_w_work_floats(B, F0, Fk, H, D,
                                                      splits) > 0))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev != configured_device) {
    err = cudaFuncSetAttribute(cin_bwd_w_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured_device = dev;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long ncols = B * D;
  float* g2 = static_cast<float*>(work);
  const long long ng2 = g2_floats(ncols, H) / 2;   // hi elements
  if (ng2 > 0) {
    cin_g_split_kernel<<<grid_1d(ng2), 256, 0, s>>>(
        static_cast<const float*>(g), g2, ncols, H, D, (ncols + 7) / 8, ng2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((K + kBM - 1) / kBM),
                  (unsigned)((H + kBN - 1) / kBN), (unsigned)splits);
  float* partial = splits > 1 ? g2 + g2_floats(ncols, H)
                              : static_cast<float*>(dw);
  cin_bwd_w_kernel<<<grid, kThreads, kSmemBytes, s>>>(
      static_cast<const float*>(x0), static_cast<const float*>(xk), g2,
      partial, ncols, F0, Fk, H, D, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long n = (long long)H * K;
  cin_bwd_w_sum_kernel<<<grid_1d(n), 256, 0, s>>>(
      partial, static_cast<float*>(dw), n, splits);
  return (int)cudaGetLastError();
}
