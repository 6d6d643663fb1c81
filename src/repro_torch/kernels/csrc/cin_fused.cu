// One fused CIN (Compressed Interaction Network) step of xDeepFM:
//
//     out[b, h, d] = sum_{i, j} W[h, i*Fk + j] * x0[b, i, d] * xk[b, j, d]
//
// Replaces: src/repro/kernels/cin_fused.py::cin_fused (the Pallas `_kernel`,
// pallas_call at line 57).
//
// Read as a GEMM whose B operand is never written to device memory:
//     Out[h, (b,d)] = W[h, k] . Z[k, (b,d)],   k = (i, j), K = F0*Fk,
//     Z[(i,j), (b,d)] = x0[b,i,d] * xk[b,j,d].
// Materialising Z is what the plain version does: K*B*D floats, 160 MB per
// layer at B=512 and 82 GB at B=262,144 for the FULL config (F0=39, Fk=200,
// D=10).
//
// What bounds it on an H100: operations. 2*H*F0*Fk*D flops per sample
// (68.5 MFLOP a sample over the three FULL layers) against x0, xk, W and
// out read or written once (about 10 KB a sample plus W's 6.2 MB, which
// stays in L2). At the float32 non-tensor peak of 67 TFLOP/s that is
// 0.52 ms at B=512. The kernel keeps full float32 (FMA on the CUDA cores);
// TF32 tensor cores would change the numbers and are a later decision.
//
// Design: the TPU kernel keeps a [TB, F0*Fk, D] outer-product tile in VMEM
// and feeds the MXU one [H, F0*Fk] x [F0*Fk, TB*D] product per tile. On
// Hopper a block has at most 227 KB of shared memory, too little for W
// (6.2 MB) or a Z tile of useful depth, so the sum is split by field i:
//     out[h, c] = sum_i x0[i, c] * (sum_j W[h, i*Fk + j] * xk[j, c])
// (c = (b, d) flattened). The inner sum is a plain GEMM over j whose B
// operand is xk itself, so Z is never formed at all:
//   * a block owns a kBM x kBN output tile: kBM channels h by kBN flattened
//     (b, d) columns (columns run over the whole batch, so D = 10 needs no
//     padding and the ragged (b, d) edge is a mask, not padded memory);
//   * it stages the x0 and xk slices of its columns in shared memory once
//     ([F0][kBN] and [Fk][kBN], 61 KB at FULL widths: three blocks fit on
//     an SM, so B=512 runs in one wave);
//   * for each field i it walks j in kKT-deep stages: the next W tile
//     (rows of W contiguous in j) is loaded into registers while the
//     current one, stored transposed ([kKT][kBM]), is multiplied from
//     shared memory, and 256 threads each accumulate a 4 x 4 register block
//     of the inner sum;
//   * a warp covers 4 x 8 threads (16 rows by 32 columns), so each step's
//     W and xk reads are one 16-byte load per thread from 64 and 128
//     contiguous bytes: one shared-memory wavefront each per 16 FMAs, and
//     the FMAs, not shared memory, set the pace;
//   * after the last stage of field i each thread folds that block into
//     its output block, scaled by x0[i, c].
// Threads whose rows all lie past H (the last row tile holds 8 of H = 200's
// rows) skip the arithmetic but keep loading tiles for the block.
// The sum runs in another order than the plain version's (W . (x0 * xk)):
// both are float32, and they differ by rounding only.
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;        // output channels per block
constexpr int kBN = 64;        // flattened (b, d) columns per block
constexpr int kKT = 40;        // j per stage: Fk = 200 is 5 stages, 39 is 1
constexpr int kTM = 4;         // rows per thread
constexpr int kTN = 4;         // columns per thread
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);   // 256
constexpr int kWStride = kBM + 4;                     // padded W^T rows
constexpr int kWLoads = kBM * kKT / kThreads;         // W values per thread
constexpr int kMaxSmem = 232448;                      // per block, sm_90

static_assert(kThreads == 256, "16 x 16 threads");
static_assert(kBM * kKT % kThreads == 0, "whole W tile per stage");

__host__ __device__ constexpr long long smem_bytes(int F0, int Fk) {
  return 4LL * ((long long)(F0 + Fk) * kBN + kKT * kWStride);
}

__global__ void __launch_bounds__(kThreads, 3)
cin_fused_kernel(const float* __restrict__ x0,   // [B, F0, D]
                 const float* __restrict__ xk,   // [B, Fk, D]
                 const float* __restrict__ w,    // [H, F0*Fk]
                 float* __restrict__ out,        // [B, H, D]
                 long long ncols, int F0, int Fk, int H, int D) {
  extern __shared__ float smem[];
  float* x0s = smem;                      // [F0][kBN]
  float* xks = x0s + F0 * kBN;            // [Fk][kBN]
  float* ws = xks + Fk * kBN;             // W^T tile [kKT][kWStride]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int tx = (warp & 1) * 8 + (lane & 7);     // columns tx*kTN ..
  const int ty = (warp >> 1) * 4 + (lane >> 3);   // rows ty*kTM ..
  const long long n0 = (long long)blockIdx.x * kBN;
  const int h0 = blockIdx.y * kBM;
  const long long K = (long long)F0 * Fk;
  const int n_jt = (Fk + kKT - 1) / kKT;   // stages per field
  const int stages = F0 * n_jt;
  const bool live = h0 + ty * kTM < H;     // this thread owns a real row

  // Stage this block's columns of x0 and xk (zeros past the last column).
  for (int e = tid; e < (F0 + Fk) * kBN; e += kThreads) {
    const int f = e / kBN;
    const int c = e - f * kBN;
    const long long n = n0 + c;
    float v = 0.f;
    if (n < ncols) {
      const long long b = n / D;
      const int d = (int)(n - b * D);
      v = f < F0 ? x0[(b * F0 + f) * D + d] : xk[(b * Fk + (f - F0)) * D + d];
    }
    x0s[e] = v;   // x0s and xks are contiguous: row f of the pair
  }

  // W tile of stage s into registers: element e = m * kKT + kk is
  // W[h0 + m, i*Fk + j0 + kk] (zero past H and past Fk).
  float wreg[kWLoads];
  auto load_w = [&](int s) {
    const int i = s / n_jt;
    const int j0 = (s - i * n_jt) * kKT;
#pragma unroll
    for (int r = 0; r < kWLoads; ++r) {
      const int e = tid + r * kThreads;
      const int m = e / kKT;
      const int kk = e - m * kKT;
      const int h = h0 + m;
      const int j = j0 + kk;
      wreg[r] = (h < H && j < Fk) ? w[h * K + (long long)i * Fk + j] : 0.f;
    }
  };

  float acc[kTM][kTN];
  float part[kTM][kTN];
#pragma unroll
  for (int m = 0; m < kTM; ++m)
#pragma unroll
    for (int n = 0; n < kTN; ++n) acc[m][n] = part[m][n] = 0.f;

  load_w(0);
  for (int s = 0; s < stages; ++s) {
    __syncthreads();   // the previous tile is consumed (and x0s/xks staged)
#pragma unroll
    for (int r = 0; r < kWLoads; ++r) {
      const int e = tid + r * kThreads;
      const int m = e / kKT;
      ws[(e - m * kKT) * kWStride + m] = wreg[r];
    }
    __syncthreads();
    if (s + 1 < stages) load_w(s + 1);   // in flight during the FMAs below
    const int i = s / n_jt;
    const int j0 = (s - i * n_jt) * kKT;
    const int depth = min(kKT, Fk - j0);
    if (live) {
      const float* xrow = xks + j0 * kBN + tx * kTN;
#pragma unroll 8
      for (int kk = 0; kk < depth; ++kk) {
        const float4 av =
            *reinterpret_cast<const float4*>(&ws[kk * kWStride + ty * kTM]);
        const float a[kTM] = {av.x, av.y, av.z, av.w};
        const float4 bv = *reinterpret_cast<const float4*>(xrow + kk * kBN);
        const float bb[kTN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int m = 0; m < kTM; ++m)
#pragma unroll
          for (int n = 0; n < kTN; ++n)
            part[m][n] = fmaf(a[m], bb[n], part[m][n]);
      }
    }
    if (j0 + kKT >= Fk) {   // last stage of field i: fold x0[i, c] in
      const float4 xv =
          *reinterpret_cast<const float4*>(&x0s[i * kBN + tx * kTN]);
      const float xx[kTN] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int m = 0; m < kTM; ++m)
#pragma unroll
        for (int n = 0; n < kTN; ++n) {
          acc[m][n] = fmaf(xx[n], part[m][n], acc[m][n]);
          part[m][n] = 0.f;
        }
    }
  }

#pragma unroll
  for (int n = 0; n < kTN; ++n) {
    const long long col = n0 + tx * kTN + n;
    if (col >= ncols) continue;
    const long long b = col / D;
    const int d = (int)(col - b * D);
#pragma unroll
    for (int m = 0; m < kTM; ++m) {
      const int h = h0 + ty * kTM + m;
      if (h < H) out[(b * H + h) * D + d] = acc[m][n];
    }
  }
}

}  // namespace

// Shared memory one block needs for these field counts (bytes); the
// launch refuses more than an sm_90 block may have.
extern "C" long long cin_fused_smem_bytes(int F0, int Fk) {
  return smem_bytes(F0, Fk);
}

// Returns the launch's cudaError_t (0 = launched). The caller owns every
// buffer; the kernel runs on `stream` and does not synchronise.
extern "C" int cin_fused(const void* x0, const void* xk, const void* w,
                         void* out, long long B, int F0, int Fk, int H, int D,
                         void* stream) {
  const long long ncols = B * D;
  if (ncols == 0 || H == 0) return (int)cudaSuccess;
  if (F0 <= 0 || Fk <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const long long smem = smem_bytes(F0, Fk);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      cin_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((ncols + kBN - 1) / kBN),
                  (unsigned)((H + kBM - 1) / kBM));
  cin_fused_kernel<<<grid, kThreads, (size_t)smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x0), static_cast<const float*>(xk),
      static_cast<const float*>(w), static_cast<float*>(out), ncols, F0, Fk,
      H, D);
  return (int)cudaGetLastError();
}
