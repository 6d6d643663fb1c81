// Input gradients of one fused CIN step of xDeepFM. With
//
//     G[b, i, j, d] = sum_h W[h, i*Fk + j] * dOut[b, h, d],
//     dxk[b, j, d]  = sum_i x0[b, i, d] * G[b, i, j, d],
//     dx0[b, i, d]  = sum_j xk[b, j, d] * G[b, i, j, d].
//
// Replaces: the input half of JAX's autodiff of
// src/repro/kernels/cin_fused.py::cin_fused (the Pallas `_kernel`,
// pallas_call at line 57); see cin_fused_bwd_w.cu for the weight half.
//
// G is never written to device memory: one sample's G is F0*Fk*D floats,
// 312 KB at F0 = 39, Fk = 200, D = 10, more than a block's shared memory,
// and the plain version's [B, F0*Fk, D] is 20.4 GB a layer at B = 65,536.
// What bounds it on an H100: operations. 2*H*F0*Fk*B*D flops for G (the
// forward's count) and 4*F0*Fk*B*D for the two contractions, against dOut,
// x0, xk and W read once and dx0, dxk written once. This is the plain
// float32 design (CUDA cores, 67 TFLOP/s peak).
//
// Design:
//   * a block owns 128 columns n = (b, d) and stages their dOut rows
//     [H x 128] in shared memory once (100 KB at H = 200): every G tile of
//     the block reads them;
//   * it walks j in chunks of 64 (a thread: 8 columns x 4 j) and, inside a
//     chunk, every field i: G[n, (i, j-chunk)] = dOut^T . W[:, i, j-chunk]
//     accumulated in registers over H in steps of 40 channels, the W slice
//     of the next step loaded into registers while this step's FMAs run
//     (double-buffered shared memory, one __syncthreads a step);
//   * then, still in registers: dxk[n, j] += x0[n, i] * G (held across the
//     i loop, written once a chunk) and dx0[n, i] += sum_j xk[n, j] * G (the
//     16 threads of a column group reduce by warp shuffles in a fixed
//     order into a [F0 x 128] shared-memory sum, written at the end);
//   * every output element has one writer and a fixed summation order: no
//     atomics, two calls on the same inputs give bit-equal outputs.
#include <cuda_runtime.h>

namespace {

constexpr int kTN = 16;                 // threads along n (8 columns each)
constexpr int kTJ = 16;                 // threads along j (4 each)
constexpr int kThreads = kTN * kTJ;     // 256
constexpr int kBN = kTN * 8;            // columns per block
constexpr int kBJ = kTJ * 4;            // j per chunk
constexpr int kHC = 40;                 // channels per W step
constexpr int kWFloats = kHC * kBJ;     // 2,560
constexpr int kWLoads = kWFloats / kThreads;   // 10 a thread
constexpr int kMaxSmem = 232448;        // per block, sm_90

static_assert(kWFloats % kThreads == 0, "W step: whole loads a thread");

__host__ __device__ constexpr int hpad(int H) {
  return (H + kHC - 1) / kHC * kHC;
}

__host__ __device__ constexpr long long smem_bytes(int F0, int H) {
  return 4LL * ((long long)hpad(H) * kBN + (long long)F0 * kBN +
                2LL * kWFloats);
}

__global__ void __launch_bounds__(kThreads, 1)
cin_bwd_x_kernel(const float* __restrict__ x0,   // [B, F0, D]
                 const float* __restrict__ xk,   // [B, Fk, D]
                 const float* __restrict__ w,    // [H, F0*Fk]
                 const float* __restrict__ g,    // dOut [B, H, D]
                 float* __restrict__ dx0,        // [B, F0, D]
                 float* __restrict__ dxk,        // [B, Fk, D]
                 long long ncols, int F0, int Fk, int H, int D) {
  extern __shared__ __align__(16) float smem[];
  const int hp = hpad(H);
  float* gs = smem;                         // [hp][kBN], rows past H zero
  float* dx0s = gs + (long long)hp * kBN;   // [F0][kBN]
  float* ws = dx0s + F0 * kBN;              // [2][kHC][kBJ]

  const int tid = threadIdx.x;
  const int tj = tid % kTJ;
  const int tn = tid / kTJ;
  const long long n0 = (long long)blockIdx.x * kBN;
  const long long K = (long long)F0 * Fk;
  const long long HD = (long long)H * D;

  for (int e = tid; e < hp * kBN; e += kThreads) {
    const int h = e / kBN;
    const long long n = n0 + (e % kBN);
    float v = 0.f;
    if (h < H && n < ncols) {
      const long long b = n / D;
      v = g[b * HD + (long long)h * D + (n - b * D)];
    }
    gs[e] = v;
  }
  for (int e = tid; e < F0 * kBN; e += kThreads) dx0s[e] = 0.f;

  // this thread's columns n_first + r, r < 8
  const long long n_first = n0 + tn * 8;
  const int nj = (Fk + kBJ - 1) / kBJ;
  const int nhc = hp / kHC;
  const int steps = F0 * nhc;               // (i, channel step) pairs

  float wv[kWLoads];
  // W step t of chunk j0: rows hc..hc+39 of field i's columns j0..j0+63.
  auto fetch = [&](int t, int j0) {
    const int i = t / nhc;
    const int hc = (t - i * nhc) * kHC;
#pragma unroll
    for (int m = 0; m < kWLoads; ++m) {
      const int e = tid + m * kThreads;
      const int h = hc + e / kBJ;
      const int j = j0 + e % kBJ;
      wv[m] = (h < H && j < Fk) ? w[(long long)h * K + (long long)i * Fk + j]
                                : 0.f;
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int m = 0; m < kWLoads; ++m)
      ws[buf * kWFloats + tid + m * kThreads] = wv[m];
  };

  for (int jc = 0; jc < nj; ++jc) {
    const int j0 = jc * kBJ;
    float xkv[8][4], dk[8][4], gacc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const long long n = n_first + r;
      const bool ok = n < ncols;
      const long long b = ok ? n / D : 0;
      const long long d = ok ? n - b * D : 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = j0 + tj * 4 + q;
        xkv[r][q] = (ok && j < Fk) ? xk[(b * Fk + j) * D + d] : 0.f;
        dk[r][q] = 0.f;
        gacc[r][q] = 0.f;
      }
    }
    fetch(0, j0);
    __syncthreads();          // gs / dx0s staged; the last chunk's ws read
    stash(0);
    __syncthreads();
    int buf = 0;
    for (int t = 0; t < steps; ++t) {
      const bool more = t + 1 < steps;
      if (more) fetch(t + 1, j0);         // in flight during the FMAs
      const int i = t / nhc;
      const int hc = (t - i * nhc) * kHC;
      const float* gsr = gs + (long long)hc * kBN + tn * 8;
      const float* wsr = ws + buf * kWFloats + tj * 4;
#pragma unroll 8
      for (int hh = 0; hh < kHC; ++hh) {
        const float4 a0 = *reinterpret_cast<const float4*>(gsr + hh * kBN);
        const float4 a1 = *reinterpret_cast<const float4*>(gsr + hh * kBN + 4);
        const float4 wq = *reinterpret_cast<const float4*>(wsr + hh * kBJ);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float wj[4] = {wq.x, wq.y, wq.z, wq.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            gacc[r][q] = fmaf(av[r], wj[q], gacc[r][q]);
      }
      if (t - i * nhc == nhc - 1) {       // field i's G tile is complete
        float part[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const long long n = n_first + r;
          float xv = 0.f;
          if (n < ncols) {
            const long long b = n / D;
            xv = x0[(b * F0 + i) * D + (n - b * D)];
          }
          float p = 0.f;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            dk[r][q] = fmaf(xv, gacc[r][q], dk[r][q]);
            p = fmaf(xkv[r][q], gacc[r][q], p);
            gacc[r][q] = 0.f;
          }
          part[r] = p;
        }
        // sum over the 16 j-threads of this column group (lanes tj of one
        // half warp), in a fixed order
#pragma unroll
        for (int off = 1; off < kTJ; off <<= 1)
#pragma unroll
          for (int r = 0; r < 8; ++r)
            part[r] += __shfl_xor_sync(0xffffffffu, part[r], off);
        if (tj == 0) {
#pragma unroll
          for (int r = 0; r < 8; ++r) dx0s[i * kBN + tn * 8 + r] += part[r];
        }
      }
      if (more) stash(buf ^ 1);
      __syncthreads();
      buf ^= 1;
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const long long n = n_first + r;
      if (n >= ncols) continue;
      const long long b = n / D;
      const long long d = n - b * D;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = j0 + tj * 4 + q;
        if (j < Fk) dxk[(b * Fk + j) * D + d] = dk[r][q];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < F0 * kBN; e += kThreads) {
    const int i = e / kBN;
    const long long n = n0 + (e % kBN);
    if (n < ncols) {
      const long long b = n / D;
      dx0[(b * F0 + i) * D + (n - b * D)] = dx0s[e];
    }
  }
}

int configured_device = -1;   // device whose smem limit was raised

}  // namespace

// Shared memory one block needs (bytes); the launch refuses more than an
// sm_90 block may have.
extern "C" long long cin_fused_bwd_x_smem_bytes(int F0, int H) {
  return smem_bytes(F0, H);
}

// Returns the launch's cudaError_t (0 = launched). The caller owns every
// buffer: dx0 [B, F0, D], dxk [B, Fk, D]. The kernel runs on `stream` and
// does not synchronise.
extern "C" int cin_fused_bwd_x(const void* x0, const void* xk, const void* w,
                               const void* g, void* dx0, void* dxk,
                               long long B, int F0, int Fk, int H, int D,
                               void* stream) {
  const long long ncols = B * D;
  if (ncols == 0) return (int)cudaSuccess;
  if (F0 <= 0 || Fk <= 0 || D <= 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  const long long smem = smem_bytes(F0, H);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev != configured_device) {
    err = cudaFuncSetAttribute(cin_bwd_x_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    configured_device = dev;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)((ncols + kBN - 1) / kBN);
  cin_bwd_x_kernel<<<blocks, kThreads, (size_t)smem, s>>>(
      static_cast<const float*>(x0), static_cast<const float*>(xk),
      static_cast<const float*>(w), static_cast<const float*>(g),
      static_cast<float*>(dx0), static_cast<float*>(dxk), ncols, F0, Fk, H,
      D);
  return (int)cudaGetLastError();
}
