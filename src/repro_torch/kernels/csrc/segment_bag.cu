// EmbeddingBag: per-bag weighted sum of gathered table rows.
//
//     out[b, :] = sum_{l : indices[b, l] >= 0} weights[b, l] * table[indices[b, l], :]
//
// Replaces: src/repro/kernels/segment_bag.py::segment_bag (the Pallas
// `_kernel`, pallas_call at line 55).
//
// What bounds it on an H100: memory. Per bag it streams L indices, L
// weights and one D-wide output row; per valid slot it gathers one table
// row (D values, 40 bytes at D = 10 in float32) at a random row index, from
// L1 / L2 where the table is the model's hot table (10.5 MB). It does 2*D
// flops per slot, far below the card's rate. At the model's D = 10 one warp
// a bag would leave 22 of 32 lanes idle on every load and FMA, and a
// 40-byte row costs two 32-byte sectors: at 61 M slots a call that is
// 3.9 GB of row sectors against a 1.07 GB byte bound, so the time goes to
// L1 hits and L2 sector throughput, not to HBM.
//
// Design: the TPU kernel keeps the table's [V, TD] column block resident
// in VMEM and gathers a [TB, L] tile of bags from it. An H100 table does
// not fit in shared memory, so rows are gathered from device memory and
// L1 / L2 keep the hot ones.
//  (a) Lanes packed by row width: a lane reads VD columns of a row at once
//      (VD = 4, 2 or 1 in float32, 8, 4, 2 or 1 in bfloat16: the widest
//      vector that divides D and the table's alignment), S = D / VD lanes
//      hold a bag (at most 32) and 32 / S bags share a warp: at D = 10, 5
//      lanes read a row as 5 float2 (or 5 bfloat162) and 6 bags share a
//      warp, 30 lanes busy. D / VD > 32 loops over column groups.
//  (b) Each lane of a bag reads the bag's indices and weights itself (the
//      S lanes of one load hit one address: one request), 4 slots a 16-byte
//      (bfloat16 weights: 8-byte) vector where L % 4 == 0 and the pointers
//      allow, and issues the kSlots row loads of a chunk with no branch
//      between them before it sums any: a -1 slot (or one past L) reads row
//      0, which stays in L1, with weight 0, as the plain version multiplies
//      row 0 by 0 for a -1 slot. Any other L is read slot by slot.
//  (c) Weights are read in their own type (float32 or bfloat16, the kernel
//      is a template on it), so a bfloat16 call is one launch; a null
//      weights pointer means weights of 1. Sums run in float32, one fused
//      multiply-add a slot in slot order (a -1 slot adds 0 * row 0), and
//      are rounded once to the table's type: another order than the plain
//      version's, so the two differ within the error of a float32 sum,
//      which scales with sum_l |w_l row_l| (the tests' tolerance). Measured
//      8% faster than the card plain's order of 4 rounded partial sums.
//  (d) L2: indices and weights are read with an evict-first L2 policy
//      (per instruction, createpolicy; they stay in L1, where the second
//      16-byte half of a bag's 32-byte sector finds them), and the output
//      is stored streaming (st.global.cs, the 6 bags of a warp are one
//      contiguous 240-byte run at D = 10), so the streams do not push the
//      hot table (normal policy) out of L2.
//  (e) Blocks of 64 threads: a block that finishes frees its slot on the
//      SM at once (measured faster than 256, PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 2;
constexpr int kSlots = 4;           // row loads issued before they are summed

// The raw bits of VD values of a table row (loaded in one instruction).
template <int Bytes> struct Raw;
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<4> { using type = unsigned; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

__device__ __forceinline__ uint64_t evict_first() {
  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ unsigned ld_stream(const void* p, uint64_t policy) {
  unsigned v;
  asm("ld.global.nc.L2::cache_hint.b32 %0, [%1], %2;"
      : "=r"(v) : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ unsigned short ld_stream16(const void* p,
                                                      uint64_t policy) {
  unsigned short v;
  asm("ld.global.nc.L2::cache_hint.b16 %0, [%1], %2;"
      : "=h"(v) : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ uint2 ld_stream_v2(const void* p, uint64_t policy) {
  uint2 v;
  asm("ld.global.nc.L2::cache_hint.v2.b32 {%0, %1}, [%2], "
      "%3;" : "=r"(v.x), "=r"(v.y) : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ uint4 ld_stream_v4(const void* p, uint64_t policy) {
  uint4 v;
  asm("ld.global.nc.L2::cache_hint.v4.b32 {%0, %1, %2, %3}, "
      "[%4], %5;" : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ void st_stream(unsigned short* p, unsigned short v) {
  asm volatile("st.global.cs.b16 [%0], %1;" ::"l"(p), "h"(v) : "memory");
}
__device__ __forceinline__ void st_stream(unsigned* p, unsigned v) {
  asm volatile("st.global.cs.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ void st_stream(uint2* p, uint2 v) {
  asm volatile("st.global.cs.v2.b32 [%0], {%1, %2};" ::"l"(p), "r"(v.x),
               "r"(v.y) : "memory");
}
__device__ __forceinline__ void st_stream(uint4* p, uint4 v) {
  asm volatile("st.global.cs.v4.b32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}

// float32 <-> the bits of T (bfloat16 to float32 is exact: a shift).
__device__ __forceinline__ float bits_to_float(unsigned b, float*) {
  return __uint_as_float(b);
}
__device__ __forceinline__ float bits_to_float(unsigned b, __nv_bfloat16*) {
  return __uint_as_float(b << 16);
}
__device__ __forceinline__ unsigned float_to_bits(float x, float*) {
  return __float_as_uint(x);
}
__device__ __forceinline__ unsigned float_to_bits(float x, __nv_bfloat16*) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// The 32-bit words of a raw vector, and back.
template <typename R> struct Words {
  static constexpr int n = sizeof(R) < 4 ? 1 : sizeof(R) / 4;
  __device__ __forceinline__ static void split(const R& r, unsigned (&w)[n]) {
    if constexpr (sizeof(R) == 2) w[0] = r;
    else if constexpr (sizeof(R) == 4) w[0] = r;
    else if constexpr (sizeof(R) == 8) w[0] = r.x, w[1] = r.y;
    else w[0] = r.x, w[1] = r.y, w[2] = r.z, w[3] = r.w;
  }
  __device__ __forceinline__ static R join(const unsigned (&w)[n]) {
    if constexpr (sizeof(R) == 2) return (unsigned short)w[0];
    else if constexpr (sizeof(R) == 4) return w[0];
    else if constexpr (sizeof(R) == 8) return make_uint2(w[0], w[1]);
    else return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// Value i of the VD values of type T packed in words w.
template <typename T>
__device__ __forceinline__ float value(const unsigned* w, int i) {
  if constexpr (sizeof(T) == 4) return bits_to_float(w[i], (T*)nullptr);
  else
    return bits_to_float((i & 1) ? w[i >> 1] >> 16 : w[i >> 1] & 0xffffu,
                         (T*)nullptr);
}

// Slots l..l+3 of a bag: indices (-1 beyond L) and weights (1 where none).
template <typename WT>
__device__ __forceinline__ void load_quad(const int* idx_row,
                                          const WT* w_row, int l, int L,
                                          bool vec, uint64_t policy,
                                          int* id, float* wv) {
  if (vec && l + 4 <= L) {
    const uint4 i4 = ld_stream_v4(idx_row + l, policy);
    id[0] = (int)i4.x, id[1] = (int)i4.y, id[2] = (int)i4.z, id[3] = (int)i4.w;
    wv[0] = wv[1] = wv[2] = wv[3] = 1.f;
    if (w_row != nullptr) {
      if constexpr (sizeof(WT) == 4) {
        const uint4 w4 = ld_stream_v4(w_row + l, policy);
        wv[0] = __uint_as_float(w4.x), wv[1] = __uint_as_float(w4.y);
        wv[2] = __uint_as_float(w4.z), wv[3] = __uint_as_float(w4.w);
      } else {
        const uint2 w2 = ld_stream_v2(w_row + l, policy);
        wv[0] = __uint_as_float(w2.x << 16);
        wv[1] = __uint_as_float(w2.x & 0xffff0000u);
        wv[2] = __uint_as_float(w2.y << 16);
        wv[3] = __uint_as_float(w2.y & 0xffff0000u);
      }
    }
    return;
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    id[u] = l + u < L ? (int)ld_stream(idx_row + l + u, policy) : -1;
    wv[u] = 1.f;
    if (w_row != nullptr && id[u] >= 0) {
      if constexpr (sizeof(WT) == 4)
        wv[u] = __uint_as_float(ld_stream(w_row + l + u, policy));
      else
        wv[u] = __uint_as_float((unsigned)ld_stream16(w_row + l + u, policy)
                                << 16);
    }
  }
}

template <typename T, typename WT, int VD>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_bag_kernel(const T* __restrict__ table,        // [V, D]
                   const int* __restrict__ indices,    // [B, L], -1 padded
                   const WT* __restrict__ weights,     // [B, L] or null
                   T* __restrict__ out,                // [B, D]
                   long long B, int L, int D, int S, bool vec) {
  using R = typename Raw<VD * sizeof(T)>::type;
  using Wd = Words<R>;
  const uint64_t policy = evict_first();
  const int lane = threadIdx.x & 31;
  const int g = lane / S, s = lane - g * S;
  const long long bag =
      ((long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) *
          (32 / S) + g;
  if (g >= 32 / S || bag >= B) return;   // no warp collective below
  const int* idx_row = indices + bag * L;
  const WT* w_row = weights ? weights + bag * L : nullptr;
  const R* rows = reinterpret_cast<const R*>(table);
  const int nvec = D / VD;                   // vectors a row
  for (int c = s; c < nvec; c += S) {        // one pass unless D / VD > 32
    float acc[VD];
#pragma unroll
    for (int i = 0; i < VD; ++i) acc[i] = 0.f;
    for (int l0 = 0; l0 < L; l0 += kSlots) {
      int id[kSlots];
      float wv[kSlots];
#pragma unroll
      for (int h = 0; h < kSlots; h += 4)
        load_quad<WT>(idx_row, w_row, l0 + h, L, vec, policy, id + h, wv + h);
      // kSlots row loads with no branch between them: a -1 slot reads row
      // 0 and adds 0 * row 0, as the plain version does
#pragma unroll
      for (int u = 0; u < kSlots; ++u) wv[u] = id[u] >= 0 ? wv[u] : 0.f;
      R r[kSlots];
#pragma unroll
      for (int u = 0; u < kSlots; ++u)
        r[u] = __ldg(rows + (long long)max(id[u], 0) * nvec + c);
#pragma unroll
      for (int u = 0; u < kSlots; ++u) {
        unsigned w[Wd::n];
        Wd::split(r[u], w);
#pragma unroll
        for (int i = 0; i < VD; ++i)
          acc[i] = fmaf(wv[u], value<T>(w, i), acc[i]);
      }
    }
    unsigned w[Wd::n];
#pragma unroll
    for (int i = 0; i < Wd::n; ++i) w[i] = 0;
#pragma unroll
    for (int i = 0; i < VD; ++i) {
      const unsigned b = float_to_bits(acc[i], (T*)nullptr);
      if constexpr (sizeof(T) == 4) w[i] = b;
      else w[i >> 1] |= (i & 1) ? b << 16 : b;
    }
    st_stream(reinterpret_cast<R*>(out) + bag * nvec + c, Wd::join(w));
  }
}

template <typename T, typename WT, int VD>
int launch_vd(const void* table, const void* indices, const void* weights,
              void* out, long long B, int L, int D, bool vec,
              cudaStream_t stream) {
  const int S = D / VD < 32 ? D / VD : 32;   // lanes a bag
  const long long warps = (B + 32 / S - 1) / (32 / S);
  const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  segment_bag_kernel<T, WT, VD><<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                                  stream>>>(
      static_cast<const T*>(table), static_cast<const int*>(indices),
      static_cast<const WT*>(weights), static_cast<T*>(out), B, L, D, S, vec);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, int bytes) {
  return (uintptr_t)p % (uintptr_t)bytes == 0;
}

// The widest VD (up to 16 bytes) that divides D and both row pointers'
// alignment.
template <typename T, typename WT>
int launch(const void* table, const void* indices, const void* weights,
           void* out, long long B, int L, int D, cudaStream_t stream) {
  const bool vec = L % 4 == 0 && aligned(indices, 16) &&
                   (weights == nullptr || aligned(weights, 4 * sizeof(WT)));
  constexpr int kMax = 16 / sizeof(T);
  auto fits = [&](int vd) {
    return D % vd == 0 && aligned(table, vd * sizeof(T)) &&
           aligned(out, vd * sizeof(T));
  };
  if (fits(kMax))
    return launch_vd<T, WT, kMax>(table, indices, weights, out, B, L, D, vec,
                                  stream);
  if (fits(kMax / 2))
    return launch_vd<T, WT, kMax / 2>(table, indices, weights, out, B, L, D,
                                      vec, stream);
  if constexpr (kMax >= 8) {
    if (fits(kMax / 4))
      return launch_vd<T, WT, kMax / 4>(table, indices, weights, out, B, L, D,
                                        vec, stream);
  }
  return launch_vd<T, WT, 1>(table, indices, weights, out, B, L, D, vec,
                             stream);
}

}  // namespace

// Returns the launch's cudaError_t (0 = launched). `table_bf16`: the table
// (and output) is bfloat16, else float32; `weights_bf16`: the weights are
// bfloat16 (a bfloat16 table only), else float32; `weights` may be null
// (all ones). The caller owns every buffer; the kernel runs on `stream` and
// does not synchronise.
extern "C" int segment_bag(const void* table, const void* indices,
                           const void* weights, void* out, long long B, int L,
                           int D, int table_bf16, int weights_bf16,
                           void* stream) {
  if (B == 0 || D == 0) return (int)cudaSuccess;
  if (L < 0 || D < 0 || (weights_bf16 && !table_bf16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!table_bf16)
    return launch<float, float>(table, indices, weights, out, B, L, D, st);
  if (weights_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(table, indices, weights, out,
                                                B, L, D, st);
  return launch<__nv_bfloat16, float>(table, indices, weights, out, B, L, D,
                                      st);
}
