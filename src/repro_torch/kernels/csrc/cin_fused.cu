// One fused CIN (Compressed Interaction Network) step of xDeepFM:
//
//     out[b, h, d] = sum_{i, j} W[h, i*Fk + j] * x0[b, i, d] * xk[b, j, d]
//
// Replaces: src/repro/kernels/cin_fused.py::cin_fused (the Pallas `_kernel`,
// pallas_call at line 57; its MXU dot_general at line 34).
//
// Read as a GEMM whose A operand is never written to device memory:
//     Out^T[(b,d), h] = Z^T[(b,d), k] . W^T[k, h],   k = (i, j), K = F0*Fk,
//     Z[(i,j), (b,d)] = x0[b,i,d] * xk[b,j,d].
// Materialising Z is what the plain version does: K*B*D floats, 160 MB per
// layer at B=512 and 82 GB at B=262,144 for the FULL config (F0=39, Fk=200,
// D=10).
//
// Arithmetic: float32-grade results on the TF32 tensor cores (3xTF32).
// Each Z element is formed in float32 as x0*xk, then Z and W are split
// into hi = rna(x) and lo = rna(x - hi) (cvt.rna.tf32.f32), and the
// float32 accumulators of `wgmma.mma_async ... .tf32` take lo*hi + hi*lo +
// hi*hi per product; lo*lo (below float32's last bit) is dropped. One TF32
// product alone keeps about 3 decimal digits, 2.5e-4 of max|out| at FULL
// widths; three keep the error at float32's own order.
//
// What bounds it on an H100: operations. 2*H*F0*Fk*D flops per sample
// (68.5 MFLOP a sample over the three FULL layers) against x0, xk, W and
// out read or written once (about 10 KB a sample plus W's 6.2 MB, which
// stays in L2). Three TF32 products per float32 product at the 495 TFLOP/s
// dense TF32 peak: 0.2125 ms a forward at B=512 (the float32 CUDA-core
// bound, 67 TFLOP/s, is 0.5233 ms).
//
// Design:
//   * the MMA's M is the flattened (b, d) column (D = 10 needs no padding;
//     the ragged edge is a mask), N is H, K runs over (i, j) in steps of 8
//     j inside one field i (a field's last step is zero-padded: xk rows
//     past Fk are zeros in shared memory, the split W is zero past Fk);
//   * a block owns 128 columns by 208 channels (H = 200 in one tile): two
//     warpgroups of 64 columns, each issuing `wgmma` m64n208k8 with A (the
//     Z tile, hi or lo) from registers and B (W, hi or lo) from shared
//     memory, 104 float32 accumulators a thread;
//   * W is split into TF32 hi and lo once per call by a first kernel,
//     straight into the order the MMAs read: per (H tile, k step) one
//     13 KB pair of [208 x 8] K-major tiles in the no-swizzle core-matrix
//     layout (8 rows x 16 bytes), zero past H and past Fk;
//   * the block stages its columns of x0 and xk in shared memory once
//     ([F0][136] and [Fk rounded to 8][136]; the 8-float pad makes the A
//     reads conflict-free); each A element is x0[i, c] * xk[j, c], formed
//     and split in registers while the previous k step's MMAs run (A is
//     double-buffered: a k step waits only for the MMAs two steps back);
//   * the W tile pairs stream through a ring of 6 shared-memory buffers by
//     bulk asynchronous copies (`cp.async.bulk`, completion counted on a
//     "full" mbarrier per buffer), issued by one thread 3 k steps ahead; a
//     buffer is refilled once both warpgroups have retired the MMAs that
//     read it (an "empty" mbarrier per buffer). No thread stages W itself
//     and no __syncthreads runs in the k loop;
//   * at B = 512 the 40 column tiles cannot fill 132 SMs, so the k steps
//     are split over `splits` blocks per tile (gridDim.z); each writes its
//     partial sum to its own slab and a third kernel adds the slabs in a
//     fixed order (deterministic: no float atomics). At B = 262,144 there
//     are 20,480 tiles and splits = 1 writes `out` directly.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 128;                     // columns per block
constexpr int kBN = 208;                     // channels per block (wgmma N)
constexpr int kThreads = 256;                // two warpgroups
constexpr int kRing = 6;                     // W buffers (one k step each)
constexpr int kAhead = 3;                    // k steps a copy runs ahead
constexpr int kADepth = 2;                   // A buffers = MMA groups in flight
constexpr int kXStride = kBM + 8;            // padded x0 / xk rows
constexpr int kBTile = kBN * 8;              // floats of one [208 x 8] tile
constexpr int kStep = 2 * kBTile;            // floats per k step (hi, lo)
constexpr unsigned kStepBytes = kStep * 4;   // 13,312
constexpr int kRingFloats = kRing * kStep;
constexpr int kBarBytes = 128;               // 2 * kRing mbarriers, padded
constexpr int kMaxSmem = 232448;             // per block, sm_90
constexpr int kMaxSplits = 8;
constexpr int kMinStepsPerSplit = 16;

static_assert(kThreads == 2 * kBM, "x staging: two fields per pass");
static_assert(kRing - kAhead >= kADepth + 1 && 2 * kRing * 8 <= kBarBytes,
              "a refilled buffer's last reader retired a step before");

__host__ __device__ constexpr int round8(int x) { return (x + 7) & ~7; }

__host__ __device__ constexpr long long smem_bytes(int F0, int Fk) {
  return 4LL * kRingFloats + kBarBytes +
         4LL * (F0 + round8(Fk)) * kXStride;
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + (below float32's precision): both TF32, hi = rna(x).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Descriptor of a [208 x 8] K-major B tile at shared address `addr`, no
// swizzle: core matrices of 8 rows x 16 bytes, the two along K 128 bytes
// apart (leading byte offset), successive 8-row groups 256 bytes apart
// (stride byte offset); all fields in 16-byte units.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P, [%0], %1;\n"
      "@!P bra WAIT;\n}\n" ::"r"(bar), "r"(parity) : "memory");
}
// One k step's W tile pair, global -> shared, counted on `bar`.
__device__ __forceinline__ void load_step(uint32_t dst, const float* src,
                                          uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(kStepBytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst), "l"(src), "r"(kStepBytes),
      "r"(bar) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// An A fragment read by an MMA still in flight: a use here keeps its
// registers from being reused before the wait that retires that MMA.
__device__ __forceinline__ void keep(const uint32_t (&hi)[4],
                                     const uint32_t (&lo)[4]) {
  asm volatile("" ::"r"(hi[0]), "r"(hi[1]), "r"(hi[2]), "r"(hi[3]),
               "r"(lo[0]), "r"(lo[1]), "r"(lo[2]), "r"(lo[3]));
}
// Keep the accumulators in place across the asynchronous MMAs.
__device__ __forceinline__ void pin(float (&d)[104]) {
#pragma unroll
  for (int i = 0; i < 104; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// acc += a . B for one m64n208k8 TF32 warpgroup MMA: a from registers
// (the m16n8k8 A layout, one 16-row slice per warp), B [208 x 8] K-major
// in shared memory, addressed by `desc`.
__device__ __forceinline__ void wgmma_n208(float (&d)[104], const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %109, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n208k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, "
      "%39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, "
      "%65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, "
      "%78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, "
      "%91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103"
      "}, {%104, %105, %106, %107}, %108, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// W [H, F0*Fk] -> per (H tile, k step q = i * nj + j / 8) the pair of
// [208 x 8] tiles (hi, then lo) in the core-matrix order of b_desc; zero
// past H and past Fk. One thread per element of a hi tile.
__global__ void __launch_bounds__(256)
cin_w_split_kernel(const float* __restrict__ w, float* __restrict__ w2,
                   int F0, int Fk, int H, long long n) {
  const int nj = round8(Fk) / 8;
  const int total = F0 * nj;
  const long long K = (long long)F0 * Fk;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < n; idx += (long long)gridDim.x * blockDim.x) {
    const int e = (int)(idx % kBTile);
    const long long tq = idx / kBTile;     // H tile * total + q
    const int q = (int)(tq % total);
    const int h = (int)(tq / total) * kBN + (e >> 6) * 8 + ((e >> 2) & 7);
    const int i = q / nj;
    const int j = (q - i * nj) * 8 + ((e >> 5) & 1) * 4 + (e & 3);
    const float v = (h < H && j < Fk) ? w[h * K + (long long)i * Fk + j] : 0.f;
    uint32_t hi, lo;
    split(v, hi, lo);
    w2[tq * kStep + e] = __uint_as_float(hi);
    w2[tq * kStep + kBTile + e] = __uint_as_float(lo);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
cin_fused_kernel(const float* __restrict__ x0,   // [B, F0, D]
                 const float* __restrict__ xk,   // [B, Fk, D]
                 const float* __restrict__ w2,   // split W, see above
                 float* __restrict__ out,        // [splits][B, H, D]
                 long long ncols, int F0, int Fk, int H, int D, int splits) {
  extern __shared__ __align__(128) float smem[];
  const int fk8 = round8(Fk);
  float* ring = smem;                                   // kRing k steps
  const uint32_t bars = smem_addr(smem + kRingFloats);  // full, then empty
  float* xs = smem + kRingFloats + kBarBytes / 4;       // x0 rows, xk rows
  const float* x0s = xs;
  const float* xks = xs + F0 * kXStride;
  const uint32_t ring_addr = smem_addr(ring);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;                 // fragment row / n index
  const int t = lane & 3;                  // fragment k index
  const long long n0 = (long long)blockIdx.x * kBM;
  const int h0 = blockIdx.y * kBN;
  const int nj = fk8 / 8;                  // k8 steps per field
  const int total = F0 * nj;
  const int q0 = (int)((long long)total * blockIdx.z / splits);
  const int q1 = (int)((long long)total * (blockIdx.z + 1) / splits);
  const int nsteps = q1 - q0;
  const float* wsrc = w2 + ((long long)blockIdx.y * total + q0) * kStep;
  auto full = [&](int b) { return bars + 8 * b; };
  auto empty = [&](int b) { return bars + 8 * (kRing + b); };

  if (tid == 0) {
    for (int b = 0; b < kRing; ++b) {
      mbar_init(full(b), 1);
      mbar_init(empty(b), 2);              // one arrival per warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int u = 0; u < kRing && u < nsteps; ++u)
      load_step(ring_addr + u * kStepBytes, wsrc + (long long)u * kStep,
                full(u));
  }

  // Stage this block's columns of x0 and xk (zeros past the last column
  // and in xk's padding rows): one column per thread, every other field.
  {
    const int c = tid % kBM;
    const long long n = n0 + c;
    const bool ok = n < ncols;
    const long long b = ok ? n / D : 0;
    const int d = ok ? (int)(n - b * D) : 0;
    const float* x0c = x0 + b * F0 * D + d;
    const float* xkc = xk + b * Fk * D + d;
    for (int f = tid / kBM; f < F0 + fk8; f += kThreads / kBM) {
      float v = 0.f;
      if (ok) {
        if (f < F0) v = x0c[f * D];
        else if (f - F0 < Fk) v = xkc[(f - F0) * D];
      }
      xs[f * kXStride + c] = v;
    }
  }
  __syncthreads();   // x0 / xk staged, barriers initialised

  float acc[104];
#pragma unroll
  for (int e = 0; e < 104; ++e) acc[e] = 0.f;

  int ci = q0 / nj;                        // field of the current k step
  int cjs = q0 - ci * nj;                  // its j step in the field
  const int col = (warp >> 2) * 64 + (warp & 3) * 16 + g;  // first A row
  const bool releaser = (tid & 127) == 0;  // one thread per warpgroup
  uint32_t ahi[kADepth][4] = {}, alo[kADepth][4] = {};  // A, u % kADepth
  for (int u0 = 0; u0 < nsteps; u0 += kADepth) {
#pragma unroll
    for (int p = 0; p < kADepth; ++p) {
      const int u = u0 + p;
      if (u >= nsteps) break;
      const int b = u % kRing;
      const float* xr = x0s + ci * kXStride + col;
      const float* kr = xks + (cjs * 8 + t) * kXStride + col;
      const float xa = xr[0];
      const float xb = xr[8];
      const float z0 = xa * kr[0];
      const float z1 = xb * kr[8];
      const float z2 = xa * kr[4 * kXStride];
      const float z3 = xb * kr[4 * kXStride + 8];
      wgmma_wait<kADepth - 1>();           // k step u - kADepth retired
      keep(ahi[p], alo[p]);                // live (unreused) until here
      if (releaser && u >= kADepth) mbar_arrive(empty((u - kADepth) % kRing));
      const int v = u + kAhead;            // the step to load now
      if (tid == 0 && v >= kRing && v < nsteps) {
        // its buffer's last step, v - kRing < u - kADepth, is released by
        // both warpgroups (each releases step x at step x + kADepth)
        const int rb = v % kRing;
        mbar_wait(empty(rb), (v / kRing - 1) & 1);
        load_step(ring_addr + rb * kStepBytes, wsrc + (long long)v * kStep,
                  full(rb));
      }
      split(z0, ahi[p][0], alo[p][0]);
      split(z1, ahi[p][1], alo[p][1]);
      split(z2, ahi[p][2], alo[p][2]);
      split(z3, ahi[p][3], alo[p][3]);
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
      if (++cjs == nj) { cjs = 0; ++ci; }
    }
  }
  wgmma_wait<0>();
  pin(acc);
#pragma unroll
  for (int p = 0; p < kADepth; ++p) keep(ahi[p], alo[p]);

  // Epilogue: acc[4j + e] is row g (e < 2) or g + 8 of this warp's 16,
  // channel 8j + 2t + (e & 1).
  float* dst = out + (long long)blockIdx.z * ncols * H;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long n = n0 + col + half * 8;
    if (n >= ncols) continue;
    const long long b = n / D;
    const int d = (int)(n - b * D);
    float* row = dst + b * H * D + d;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int h = h0 + 8 * j + 2 * t;
      if (h < H) row[(long long)h * D] = acc[4 * j + 2 * half];
      if (h + 1 < H) row[(long long)(h + 1) * D] = acc[4 * j + 2 * half + 1];
    }
  }
}

// out[e] = sum_s partial[s][e], s in order: the deterministic reduction of
// the split sums.
__global__ void __launch_bounds__(256)
cin_split_sum_kernel(const float* __restrict__ partial,
                     float* __restrict__ out, long long n, int splits) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    float s = partial[e];
    for (int k = 1; k < splits; ++k) s += partial[k * n + e];
    out[e] = s;
  }
}

__host__ __device__ constexpr long long w2_floats(int F0, int Fk, int H) {
  return (long long)((H + kBN - 1) / kBN) * F0 * (round8(Fk) / 8) * kStep;
}

int configured_device = -1;   // device whose smem limit was raised

unsigned grid_1d(long long n) {
  const long long blocks = (n + 255) / 256;
  return (unsigned)(blocks < 8192 ? blocks : 8192);
}

}  // namespace

// Shared memory one block needs for these field counts (bytes); the
// launch refuses more than an sm_90 block may have.
extern "C" long long cin_fused_smem_bytes(int F0, int Fk) {
  return smem_bytes(F0, Fk);
}

// How many blocks share one output tile's k steps: enough that the card's
// `sms` multiprocessors get a block each, at most kMaxSplits and no fewer
// than kMinStepsPerSplit k steps a block. 1 once the tiles fill the card.
extern "C" int cin_fused_splits(long long ncols, int F0, int Fk, int H,
                                int sms) {
  const long long tiles = ((ncols + kBM - 1) / kBM) * ((H + kBN - 1) / kBN);
  if (tiles <= 0 || tiles >= sms) return 1;
  long long s = sms / tiles;
  const long long steps = (long long)F0 * (round8(Fk) / 8);
  if (s > kMaxSplits) s = kMaxSplits;
  if (s > steps / kMinStepsPerSplit) s = steps / kMinStepsPerSplit;
  return s < 1 ? 1 : (int)s;
}

// Floats of scratch one call needs: the split W, then (splits > 1) one
// [B, H, D] partial slab per split.
extern "C" long long cin_fused_work_floats(long long B, int F0, int Fk, int H,
                                           int D, int splits) {
  return w2_floats(F0, Fk, H) + (splits > 1 ? splits * B * H * D : 0);
}

// Returns the launch's cudaError_t (0 = launched). The caller owns every
// buffer; `work` holds cin_fused_work_floats(...) floats. The kernels run
// on `stream` and do not synchronise.
extern "C" int cin_fused(const void* x0, const void* xk, const void* w,
                         void* out, void* work, long long B, int F0, int Fk,
                         int H, int D, int splits, void* stream) {
  const long long ncols = B * D;
  if (ncols == 0 || H == 0) return (int)cudaSuccess;
  if (F0 <= 0 || Fk <= 0 || D <= 0 || splits < 1 || splits > kMaxSplits ||
      work == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long smem = smem_bytes(F0, Fk);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev != configured_device) {
    err = cudaFuncSetAttribute(cin_fused_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    configured_device = dev;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w2 = static_cast<float*>(work);
  const long long nw2 = w2_floats(F0, Fk, H) / 2;   // hi elements
  cin_w_split_kernel<<<grid_1d(nw2), 256, 0, s>>>(
      static_cast<const float*>(w), w2, F0, Fk, H, nw2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  float* partial = w2 + w2_floats(F0, Fk, H);
  const dim3 grid((unsigned)((ncols + kBM - 1) / kBM),
                  (unsigned)((H + kBN - 1) / kBN), (unsigned)splits);
  cin_fused_kernel<<<grid, kThreads, (size_t)smem, s>>>(
      static_cast<const float*>(x0), static_cast<const float*>(xk), w2,
      splits > 1 ? partial : static_cast<float*>(out), ncols, F0, Fk, H, D,
      splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long n = ncols * H;
  cin_split_sum_kernel<<<grid_1d(n), 256, 0, s>>>(
      partial, static_cast<float*>(out), n, splits);
  return (int)cudaGetLastError();
}
