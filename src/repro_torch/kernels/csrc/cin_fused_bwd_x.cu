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
// Read G as a GEMM whose output never reaches device memory:
//     G^T[n, (i, j)] = dOut^T[n, h] . W[h, (i, j)],   n = (b, d) (B*D rows),
// M = n, K = h, N = (i, j). One sample's G is F0*Fk*D floats (312 KB at
// F0 = 39, Fk = 200, D = 10) and the plain version's [B, F0*Fk, D] is
// 20.4 GB a layer at B = 65,536; here each [64 x 200] G tile is
// contracted with x0 and xk straight from the accumulators.
//
// Arithmetic: float32-grade results on the TF32 tensor cores (3xTF32), as
// the forward (cin_fused.cu): dOut and W split into TF32 hi and lo, the
// float32 accumulators take lo*hi + hi*lo + hi*hi per product
// (tf32x3_wgmma.cuh). The contractions run in float32 on the CUDA cores.
//
// What bounds it on an H100: operations. 2*H*F0*Fk*B*D flops for G, three
// TF32 products each at the 495 TFLOP/s dense TF32 peak (12.4 ms a
// 200-wide layer at B = 65,536), against dOut, x0, xk and W read once and
// dx0, dxk written once (1.1 GB, 0.3 ms). The contractions' 4*F0*Fk*B*D
// flops run on the CUDA cores beside the tensor cores (0.3 ms at 67
// TFLOP/s).
//
// Design:
//   * a block owns 128 rows n, two warpgroups of 64, and stages their dOut
//     [h x 128] in shared memory (rows padded to 136 floats: the A reads
//     are conflict-free); every G tile of the block reads its A fragments
//     from there and splits them in registers, so W is the only stream;
//   * a G tile is kP = 5 fields by kJ = 40 j (wgmma N = 200): one tile of
//     layer 0 (Fk = 39) holds five of its fields, a 200-wide layer's j run
//     in five tiles, each over the fields five at a time. (A tile of one
//     field would be 104 j wide at most: its 52 accumulators, the 52 dxk
//     sums held across the fields and the 52 xk values of the dx0 dot fill
//     the registers, and layer 0 would run m64n40 MMAs: 13.3 ms on an
//     H100, slower than cuBLAS's G.) Registers a thread: 100 accumulators,
//     20 dxk sums, 20 xk values, 10 x0 values, 16 A words;
//   * W is split into TF32 hi and lo once per call by a first kernel,
//     straight into the order the MMAs read: per (j tile, h chunk, field
//     group, h step of 8) one 12.8 KB pair of [200 x 8] K-major tiles over
//     (field, j) (the transpose of the forward's W tiles), zero past F0,
//     Fk and H; they stream through a ring of 6 shared-memory buffers by
//     `cp.async.bulk` on full / empty mbarriers, issued by one thread 3 K
//     steps ahead: the forward's pipeline (A double-buffered);
//   * per tile, straight from the accumulators: dxk[n, j] += x0[n, i] * G
//     (held in registers across the field groups, written once a j tile)
//     and dx0[n, i] += sum_j xk[n, j] * G (a quad shuffle in a fixed order
//     into a [F0 x 128] shared-memory sum, written once at the end);
//   * shared memory at F0 = 39, H = 200: dOut 108,800 bytes + the ring
//     76,800 + the dx0 sums 19,968 + the mbarriers 128 = 205,696 of
//     232,448. Where H is too large for one stage (H = 400) the h steps run
//     in chunks of equal length, dOut staged again for each; G is linear
//     in dOut, so each chunk's partial G is contracted on its own. A
//     tile's accumulation chain is one chunk: at most 31 K steps at F0 =
//     39 (dW measured 3.4e-6 of max|dW| drift after 58; no promotion);
//   * every output element has one writer and a fixed summation order: no
//     atomics, two calls on the same inputs give bit-equal outputs.
#include <cuda_runtime.h>

#include <cstdint>

#include "tf32x3_wgmma.cuh"

namespace {

using namespace tf32x3;

constexpr int kBM = 128;                 // rows n per block
constexpr int kThreads = 256;            // two warpgroups of 64 rows
constexpr int kJ = 40;                   // j of a tile
constexpr int kP = 5;                    // fields of a tile
constexpr int kN = kP * kJ;              // wgmma N
constexpr int kAcc = kN / 2;             // accumulators a thread
constexpr int kJAcc = kJ / 2;            // of them, one field's
constexpr int kTile = kN * 8;            // floats of one [200 x 8] tile
constexpr int kStepF = 2 * kTile;        // hi, lo: one K step
constexpr unsigned kStepB = kStepF * 4;  // 12,800
constexpr int kRing = 6;                 // W buffers (one K step each)
constexpr int kAhead = 3;                // K steps a copy runs ahead
constexpr int kADepth = 2;               // A buffers = MMA groups in flight
constexpr int kRingFloats = kRing * kStepF;
constexpr int kBarBytes = 128;           // 2 * kRing mbarriers, padded
constexpr int kGS = kBM + 8;             // padded dOut rows in shared memory
constexpr int kMaxSmem = 232448;         // per block, sm_90

static_assert(kJ % 8 == 0, "a field's columns are whole 8-column groups");
static_assert(kRing - kAhead >= kADepth + 1 && 2 * kRing * 8 <= kBarBytes,
              "a refilled buffer's last reader retired a step before");

// One launch's tiling: h steps (of 8) a chunk stages, chunks, and the
// shared memory one block needs (above kMaxSmem: no tiling fits).
struct Plan {
  int sc, nh;
  long long smem;
};

Plan plan(int F0, int H) {
  const long long fixed = 4LL * kRingFloats + kBarBytes + 4LL * F0 * kBM;
  const long long row8 = 4LL * 8 * kGS;          // one h step of dOut
  const int h8 = H > 0 ? (H + 7) / 8 : 1;
  long long most = (kMaxSmem - fixed) / row8;
  if (most < 1) most = 1;                        // reported as too large
  Plan p;
  p.nh = (int)((h8 + most - 1) / most);
  p.sc = (h8 + p.nh - 1) / p.nh;
  p.smem = fixed + row8 * p.sc;
  return p;
}

// K steps of one block: j tiles x h chunks x field groups x steps a chunk.
long long steps(const Plan& p, int F0, int Fk) {
  return (long long)((Fk + kJ - 1) / kJ) * p.nh * ((F0 + kP - 1) / kP) *
         p.sc;
}

// W [H, F0*Fk] -> per K step q = ((j tile * nh + h chunk) * groups +
// field group) * sc + s the pair of [200 x 8] tiles (hi, then lo) of W[h,
// i*Fk + j], tile row c = tile_row(e): field i = group*kP + c / kJ, j =
// jt*kJ + c % kJ; K index h = (chunk*sc + s)*8 + tile_col(e); in the
// core-matrix order of b_desc, zero past F0, Fk and H. One thread per
// element of a hi tile.
__global__ void __launch_bounds__(256)
cin_wt_split_kernel(const float* __restrict__ w, float* __restrict__ w2,
                    int F0, int Fk, int H, int sc, int nh, long long n) {
  const int groups = (F0 + kP - 1) / kP;
  const long long K = (long long)F0 * Fk;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < n; idx += (long long)gridDim.x * blockDim.x) {
    const int e = (int)(idx % kTile);
    const long long q = idx / kTile;
    const int s = (int)(q % sc);
    const long long r = q / sc;
    const int fg = (int)(r % groups);
    const long long c = r / groups;              // j tile * nh + h chunk
    const int row = tile_row(e);
    const int i = fg * kP + row / kJ;
    const int j = (int)(c / nh) * kJ + row % kJ;
    const int h = ((int)(c % nh) * sc + s) * 8 + tile_col(e);
    const float v = (h < H && i < F0 && j < Fk)
                        ? w[(long long)h * K + (long long)i * Fk + j]
                        : 0.f;
    uint32_t hi, lo;
    split(v, hi, lo);
    w2[q * kStepF + e] = __uint_as_float(hi);
    w2[q * kStepF + kTile + e] = __uint_as_float(lo);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
cin_bwd_x_kernel(const float* __restrict__ x0,   // [B, F0, D]
                 const float* __restrict__ xk,   // [B, Fk, D]
                 const float* __restrict__ w2,   // split W, see above
                 const float* __restrict__ g,    // dOut [B, H, D]
                 float* __restrict__ dx0,        // [B, F0, D]
                 float* __restrict__ dxk,        // [B, Fk, D]
                 long long ncols, int F0, int Fk, int H, int D, int sc,
                 int nh) {
  extern __shared__ __align__(128) float smem[];
  const uint32_t ring_addr = smem_addr(smem);
  const uint32_t bars = smem_addr(smem + kRingFloats);  // full, then empty
  float* gs = smem + kRingFloats + kBarBytes / 4;       // [sc*8][kGS] dOut
  float* dx0s = gs + sc * 8 * kGS;                      // [F0][kBM]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;                // fragment row
  const int t = lane & 3;                  // fragment K index / column pair
  const long long n0 = (long long)blockIdx.x * kBM;
  const int nj = (Fk + kJ - 1) / kJ;
  const int groups = (F0 + kP - 1) / kP;
  const int total = nj * nh * groups * sc; // K steps of the block
  auto full = [&](int b) { return bars + 8 * b; };
  auto empty = [&](int b) { return bars + 8 * (kRing + b); };

  if (tid == 0) {
    for (int b = 0; b < kRing; ++b) {
      mbar_init(full(b), 1);
      mbar_init(empty(b), 2);              // one arrival per warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int u = 0; u < kRing && u < total; ++u)
      load_bytes(ring_addr + u * kStepB, w2 + (long long)u * kStepF, kStepB,
                 full(u));
  }
  for (int e = tid; e < F0 * kBM; e += kThreads) dx0s[e] = 0.f;

  // This thread's rows: col (r = 0) and col + 8 (r = 1) of the block, as
  // sample rb[r] and offset rd[r].
  const int col = (warp >> 2) * 64 + (warp & 3) * 16 + gq;
  bool rok[2];
  long long rb[2];
  int rd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long n = n0 + col + 8 * r;
    rok[r] = n < ncols;
    rb[r] = rok[r] ? n / D : 0;
    rd[r] = rok[r] ? (int)(n - rb[r] * D) : 0;
  }

  // acc[4c + e]: row r = e >> 1, tile column 8c + 2t + (e & 1), i.e. field
  // p = c / (kJ / 8) of the group and j = j0 + 8 (c % (kJ / 8)) + 2t +
  // (e & 1); dk and xkv hold one field's columns: dk[4 (c % (kJ/8)) + e]
  float acc[kAcc], dk[kJAcc], xkv[kJAcc];
  const bool releaser = (tid & 127) == 0;  // one thread per warpgroup
  uint32_t ahi[kADepth][4] = {}, alo[kADepth][4] = {};  // A, s % kADepth
  int u = 0;                               // the block's K step
  for (int jt = 0; jt < nj; ++jt) {
    const int j0 = jt * kJ;
#pragma unroll
    for (int c = 0; c < kJ / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int j = j0 + 8 * c + 2 * t + (e & 1);
        xkv[4 * c + e] =
            rok[r] && j < Fk ? xk[(rb[r] * Fk + j) * D + rd[r]] : 0.f;
        dk[4 * c + e] = 0.f;
      }
    for (int hc = 0; hc < nh; ++hc) {
      if (jt == 0 || nh > 1) {
        // stage dOut rows h = hc*sc*8 + hr of this block's columns (zero
        // past H and past the last row)
        __syncthreads();                   // the last chunk's A reads done
        const int hb = hc * sc * 8;
        for (int e = tid; e < sc * 8 * kBM; e += kThreads) {
          const int hr = e / kBM;
          const int c = e - hr * kBM;
          const long long n = n0 + c;
          const int h = hb + hr;
          float v = 0.f;
          if (h < H && n < ncols) {
            const long long b = n / D;
            v = g[(b * H + h) * D + (n - b * D)];
          }
          gs[hr * kGS + c] = v;
        }
        __syncthreads();                   // staged; barriers initialised
      }
      for (int fg = 0; fg < groups; ++fg) {
        // the group's x0 for the epilogue, read while the MMAs run
        float xv[kP][2];
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          const int i = fg * kP + p;
#pragma unroll
          for (int r = 0; r < 2; ++r)
            xv[p][r] = rok[r] && i < F0 ? x0[(rb[r] * F0 + i) * D + rd[r]]
                                        : 0.f;
        }
#pragma unroll
        for (int e = 0; e < kAcc; ++e) acc[e] = 0.f;
        for (int s0 = 0; s0 < sc; s0 += kADepth) {
#pragma unroll
          for (int p = 0; p < kADepth; ++p) {
            const int s = s0 + p;
            if (s >= sc) break;
            const int b = u % kRing;
            // A in the m16n8k8 layout: (col, t), (col + 8, t), (col, t + 4),
            // (col + 8, t + 4) = dOut^T[n, h] at gs[h][n]
            const float* ar = gs + (s * 8 + t) * kGS + col;
            const float a0 = ar[0];
            const float a1 = ar[8];
            const float a2 = ar[4 * kGS];
            const float a3 = ar[4 * kGS + 8];
            wgmma_wait<kADepth - 1>();     // K step u - kADepth retired
            keep(ahi[p], alo[p]);          // live (unreused) until here
            if (releaser && u >= kADepth)
              mbar_arrive(empty((u - kADepth) % kRing));
            const int v = u + kAhead;      // the step to load now
            if (tid == 0 && v >= kRing && v < total) {
              // its buffer's last step, v - kRing < u - kADepth, is
              // released by both warpgroups
              const int rb2 = v % kRing;
              mbar_wait(empty(rb2), (v / kRing - 1) & 1);
              load_bytes(ring_addr + rb2 * kStepB,
                         w2 + (long long)v * kStepF, kStepB, full(rb2));
            }
            split(a0, ahi[p][0], alo[p][0]);
            split(a1, ahi[p][1], alo[p][1]);
            split(a2, ahi[p][2], alo[p][2]);
            split(a3, ahi[p][3], alo[p][3]);
            mbar_wait(full(b), (u / kRing) & 1);
            const uint32_t bt = ring_addr + b * kStepB;
            const uint64_t dhi = b_desc(bt);
            const uint64_t dlo = b_desc(bt + kTile * 4);
            wgmma_fence();
            pin(acc);
            wgmma_n200(acc, alo[p], dhi);
            wgmma_n200(acc, ahi[p], dlo);
            wgmma_n200(acc, ahi[p], dhi);
            wgmma_commit();
            pin(acc);
            ++u;
          }
        }
        wgmma_wait<0>();                   // the group's G tile is complete
        pin(acc);
#pragma unroll
        for (int p = 0; p < kADepth; ++p) keep(ahi[p], alo[p]);
        float part[kP][2];
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          part[p][0] = part[p][1] = 0.f;
#pragma unroll
          for (int c = 0; c < kJ / 8; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int k = 4 * c + e;
              const float a = acc[p * kJAcc + k];
              dk[k] = fmaf(xv[p][e >> 1], a, dk[k]);
              part[p][e >> 1] = fmaf(xkv[k], a, part[p][e >> 1]);
            }
        }
        // sum over the quad's four column pairs, in a fixed order
#pragma unroll
        for (int off = 1; off < 4; off <<= 1)
#pragma unroll
          for (int p = 0; p < kP; ++p)
#pragma unroll
            for (int r = 0; r < 2; ++r)
              part[p][r] += __shfl_xor_sync(0xffffffffu, part[p][r], off);
        if (t == 0) {
#pragma unroll
          for (int p = 0; p < kP; ++p) {
            const int i = fg * kP + p;
            if (i < F0) {
              dx0s[i * kBM + col] += part[p][0];
              dx0s[i * kBM + col + 8] += part[p][1];
            }
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kJ / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int j = j0 + 8 * c + 2 * t + (e & 1);
        if (rok[r] && j < Fk) dxk[(rb[r] * Fk + j) * D + rd[r]] = dk[4 * c + e];
      }
  }
  __syncthreads();
  for (int e = tid; e < F0 * kBM; e += kThreads) {
    const int i = e / kBM;
    const long long n = n0 + (e - i * kBM);
    if (n < ncols) {
      const long long b = n / D;
      dx0[(b * F0 + i) * D + (n - b * D)] = dx0s[e];
    }
  }
}

int configured_device = -1;   // device whose smem limit was raised

unsigned grid_1d(long long n) {
  const long long blocks = (n + 255) / 256;
  return (unsigned)(blocks < 8192 ? blocks : 8192);
}

}  // namespace

// Shared memory one block needs for these sizes (bytes); above 232,448
// (what an sm_90 block may have) no tiling fits and the launch refuses.
extern "C" long long cin_fused_bwd_x_smem_bytes(int F0, int H) {
  return plan(F0, H).smem;
}

// Floats of scratch one call needs: W split into TF32 hi and lo tiles.
extern "C" long long cin_fused_bwd_x_work_floats(int F0, int Fk, int H) {
  return steps(plan(F0, H), F0, Fk) * kStepF;
}

// Returns the launch's cudaError_t (0 = launched). The caller owns every
// buffer: dx0 [B, F0, D], dxk [B, Fk, D], work cin_fused_bwd_x_work_floats
// floats. The kernels run on `stream` and do not synchronise.
extern "C" int cin_fused_bwd_x(const void* x0, const void* xk, const void* w,
                               const void* g, void* dx0, void* dxk,
                               void* work, long long B, int F0, int Fk, int H,
                               int D, void* stream) {
  const long long ncols = B * D;
  if (ncols == 0) return (int)cudaSuccess;
  if (F0 <= 0 || Fk <= 0 || D <= 0 || H <= 0 || work == nullptr)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(F0, H);
  if (p.smem > kMaxSmem) return (int)cudaErrorInvalidValue;
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
  float* w2 = static_cast<float*>(work);
  const long long nw2 = steps(p, F0, Fk) * kTile;   // hi elements
  cin_wt_split_kernel<<<grid_1d(nw2), 256, 0, s>>>(
      static_cast<const float*>(w), w2, F0, Fk, H, p.sc, p.nh, nw2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((ncols + kBM - 1) / kBM);
  cin_bwd_x_kernel<<<blocks, kThreads, (size_t)p.smem, s>>>(
      static_cast<const float*>(x0), static_cast<const float*>(xk), w2,
      static_cast<const float*>(g), static_cast<float*>(dx0),
      static_cast<float*>(dxk), ncols, F0, Fk, H, D, p.sc, p.nh);
  return (int)cudaGetLastError();
}
