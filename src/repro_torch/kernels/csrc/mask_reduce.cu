// Delegate combine folds over the int32 words of K rows: the K-way word OR
// (optionally into `prev`, with the per-word popcount of the newly set
// bits) and its payload sibling, the K-way int32 min (optionally into
// `prev`, with a 0/1 improved flag); and each fold fused with the step code
// that consumes it (the `*_apply` entries), so that a sweep's delegate
// update is one launch from the gathered words to the new delegate state.
//
// Replaces: src/repro/kernels/mask_reduce.py -- all four Pallas bodies:
// mask_reduce's `_kernel_fold` (with_count=False, pallas_call at line 92)
// and `_kernel` (with_count=True, line 101); payload_min_fold's
// `_kernel_min_fold` (with_count=False, line 145) and `_kernel_min`
// (with_count=True, line 154), all four as instances of one template,
// fold_rows_kernel. The apply entries replace the fold-only bodies (lines
// 92 and 145) in a sweep's last fold, together with the jnp code the
// reference steps run on the fold's output (src/repro/core/msbfs.py:853-965,
// src/repro/core/bfs.py:445-447).
//
// What bounds them on an H100: memory. A fold of K rows of n words reads
// K*n*4 bytes and writes n*4 (with `prev`, n*4 more read; with the count
// or flag, n*4 more written) and does K ORs or mins and one popcount or
// compare a word, under one operation a byte. At the delegate shapes (K =
// 2, n = 60,561) the prev-less fold moves 0.73 MB, 0.22 us at 3.35 TB/s:
// a fraction of a launch, so the standalone folds are latency-bound, and
// their design is about one round trip to memory a thread, no byte read
// twice and no block more than the SMs take in one wave.
// mask_reduce_apply reads the gathered words once (K*D*NW*4 bytes), the
// delegate plane [P, D, W] (int32 levels, or bool visited bytes), the
// target plane [P, D, W] bool where targets are on, and writes the new
// plane (and the bool frontier plane with visited planes) plus
// P*(2*ceil(W/4)+1) flag words. payload_min_fold_apply reads K*D*4 +
// P*D*4 bytes and writes P*D*4 plus ceil(P/4) flag words. At the serving
// shapes (P=K=2, D=60,561, W=32, int32 levels with targets) that is
// 35.4 MB, about 10.6 us at 3.35 TB/s: what the fusion saves is the dozen
// torch operators that used to pass over the [P, D, W] planes after the
// fold (unpack, AND, any, where, the target scan), each with its own
// launch and host dispatch, and the identity `prev` each fold allocated.
//
// Design of the standalone folds (fold_rows_kernel, one template for the
// four bodies). Rows are read in place through two strides: out[g] = the
// fold over i < K of rows[g*gs + i*ks]. So one C entry, fold_rows, serves
// the public folds ([K, n] partials into `prev`), the prev-less fold of a
// gathered [K, n], and the group fold of the emulated stacked rows [p, n],
// whose axis groups' K members are read where they lie and folded into one
// row a group: no permute copy before the fold and no expand copy after it.
// Without `prev` the op's identity (OR 0, min INT_MAX) is a register
// constant: nothing is read or allocated for it. A thread takes one unit
// of a row: 4 words as one int4 (16-byte loads and stores) where every
// row, `prev`, out and count start 16-byte aligned (n and the strides
// multiples of 4), else one word, so a warp's loads stay whole 128-byte
// lines at any word phase (an odd n, a view one word off) with no ragged
// head or tail. K = 1..4 is a template parameter, so a thread issues
// every load before its first combine; above 4, a runtime loop. The
// block is the fewest threads, 128 to 1,024, that cover a row with one
// block an SM (119 blocks of 512 at n = 60,561; 119 of 128 int4 units at
// n = 60,560); longer rows take more blocks, no thread loops. On the card
// (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py's fold phases) an empty
// launch takes 0.87 us; a first design of int4 groups aligned to the
// output, whose input rows at another word phase took two int4 loads and
// a pick, with a ragged head and tail, took 1.84-2.17 us at an odd n, and
// a grid-stride loop cost more than the wave it never needed at these
// shapes. The `with_count` bodies are the same template with the second
// output.
//
// Design of the apply kernels: a memory-bound pass, grid (blocks, P) with
// about 8 blocks of 256 threads an SM in all, each thread striding over
// vectors of its row. mask_reduce_apply gives a thread V neighbouring
// lanes of one delegate (16-byte loads: V=4 int32 levels, V=16 bool
// bytes, where W and the pointers allow; V=1 otherwise), so one warp reads
// whole 128-byte lines of the plane; the K gathered words of a delegate
// are read by the W/V threads that share them, served from L1/L2 (the
// pack wrote them just before). Lane flags (a lane marked a delegate; a
// lane's target still unvisited) are ORed in registers across a thread's
// vectors, over the warp with __reduce_or_sync where NW=1, then in shared
// memory, and leave the block as one atomicOr per 4 lanes into flag words
// whose bytes are the step's bool [P, W] flags (byte j of a word is lane
// 4*word+j), so nothing unpacks them afterwards; the last word of a row is
// the row's "some delegate was marked" flag. payload_min_fold_apply takes
// groups of 4 elements aligned to 16 bytes in the [P, D] state plane (the
// row head and tail elements one by one), min-folds the K gathered values
// into them, and ORs its improved flag over the block with
// __syncthreads_or, then one atomicOr a block into the row's flag byte.
// Both C entries clear their flag words with cudaMemsetAsync on the
// launch's stream before the launch, in the same call. Writes are out of
// place: the caller's state is never changed.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kFoldMaxThreads = 1024;
constexpr int kOr = 0, kMin = 1;

// A fold's unit: one int32 word, or 4 neighbouring words as one int4 where
// every row is 16-byte aligned.
template <bool VEC> struct Unit;
template <> struct Unit<false> { using type = int; };
template <> struct Unit<true> { using type = int4; };

template <int OP> struct FoldOp;
template <> struct FoldOp<kOr> {
  static constexpr int kIdentity = 0;
  static __device__ __forceinline__ int f(int a, int b) { return a | b; }
  // the popcount of the newly set bits
  static __device__ __forceinline__ int extra(int c, int before) {
    return __popc(c & ~before);
  }
};
template <> struct FoldOp<kMin> {
  static constexpr int kIdentity = INT_MAX;
  static __device__ __forceinline__ int f(int a, int b) { return min(a, b); }
  // the improved flag
  static __device__ __forceinline__ int extra(int c, int before) {
    return c < before;
  }
};

// F::f and F::extra on a unit, word by word
template <class F> __device__ __forceinline__ int fold(int a, int b) {
  return F::f(a, b);
}
template <class F> __device__ __forceinline__ int4 fold(int4 a, int4 b) {
  return make_int4(F::f(a.x, b.x), F::f(a.y, b.y), F::f(a.z, b.z),
                   F::f(a.w, b.w));
}
template <class F> __device__ __forceinline__ int extra(int c, int b) {
  return F::extra(c, b);
}
template <class F> __device__ __forceinline__ int4 extra(int4 c, int4 b) {
  return make_int4(F::extra(c.x, b.x), F::extra(c.y, b.y),
                   F::extra(c.z, b.z), F::extra(c.w, b.w));
}
template <class U> __device__ __forceinline__ U splat(int x);
template <> __device__ __forceinline__ int splat<int>(int x) { return x; }
template <> __device__ __forceinline__ int4 splat<int4>(int x) {
  return make_int4(x, x, x, x);
}

// out[g] = the fold of (prev,) rows[g*gs + i*ks] over i < K for g =
// blockIdx.y, unit u of every row by thread u of the grid; count[g] = the
// popcount of the newly set bits / the improved flag. KT = K for K = 1..4
// (every load issued before the first combine), 0: a runtime loop over K.
// Strides and n count words; VEC: units of 4 words.
template <int OP, int KT, bool PREV, bool COUNT, bool VEC>
__global__ void __launch_bounds__(kFoldMaxThreads)
fold_rows_kernel(const int* __restrict__ rows, const int* __restrict__ prev,
                 int* __restrict__ out, int* __restrict__ count, int K,
                 long long ks, long long gs, long long n) {
  using F = FoldOp<OP>;
  using U = typename Unit<VEC>::type;
  constexpr int W = VEC ? 4 : 1;
  const long long g = blockIdx.y;
  const U* src = reinterpret_cast<const U*>(rows + g * gs);
  const U* pv = reinterpret_cast<const U*>(prev);
  U* o = reinterpret_cast<U*>(out + g * n);
  U* c = reinterpret_cast<U*>(COUNT ? count + g * n : nullptr);
  const long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= n / W) return;
  const long long kstep = ks / W;
  U acc = splat<U>(F::kIdentity), before = acc;
  if constexpr (KT > 0) {
    U v[KT];
#pragma unroll
    for (int k = 0; k < KT; ++k) v[k] = __ldg(src + k * kstep + u);
    if constexpr (PREV) before = __ldg(pv + u);
#pragma unroll
    for (int k = 0; k < KT; ++k) acc = fold<F>(acc, v[k]);
  } else {
    if constexpr (PREV) before = __ldg(pv + u);
    for (int k = 0; k < K; ++k) acc = fold<F>(acc, __ldg(src + k * kstep + u));
  }
  if constexpr (PREV) acc = fold<F>(acc, before);
  o[u] = acc;
  if constexpr (COUNT) c[u] = extra<F>(acc, before);
}

__global__ void empty_kernel() {}

int sm_count() {
  static int sms[64] = {0};            // per device, read once
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (sms[dev] == 0) {
    int s = 132;
    cudaDeviceGetAttribute(&s, cudaDevAttrMultiProcessorCount, dev);
    sms[dev] = s > 0 ? s : 132;
  }
  return sms[dev];
}

template <int OP, int KT, bool VEC>
void launch_fold(dim3 grid, unsigned threads, cudaStream_t s, const int* rows,
                 const int* prev, int* out, int* count, int K, long long ks,
                 long long gs, long long n) {
  if (count != nullptr) {
    fold_rows_kernel<OP, KT, true, true, VEC><<<grid, threads, 0, s>>>(
        rows, prev, out, count, K, ks, gs, n);
  } else if (prev != nullptr) {
    fold_rows_kernel<OP, KT, true, false, VEC><<<grid, threads, 0, s>>>(
        rows, prev, out, nullptr, K, ks, gs, n);
  } else {
    fold_rows_kernel<OP, KT, false, false, VEC><<<grid, threads, 0, s>>>(
        rows, nullptr, out, nullptr, K, ks, gs, n);
  }
}

template <int OP, bool VEC>
void dispatch_k(dim3 grid, unsigned threads, cudaStream_t s, const int* rows,
                const int* prev, int* out, int* count, int K, long long ks,
                long long gs, long long n) {
#define MR_FOLD(KT) launch_fold<OP, KT, VEC>(grid, threads, s, rows, prev, \
                                             out, count, K, ks, gs, n)
  switch (K) {
    case 1: MR_FOLD(1); break;
    case 2: MR_FOLD(2); break;
    case 3: MR_FOLD(3); break;
    case 4: MR_FOLD(4); break;
    default: MR_FOLD(0);
  }
#undef MR_FOLD
}

// ---------------------------------------------------------------- apply

constexpr int kBlocksPerSM = 8;   // 2,048 resident threads an SM / kThreads

// The load / store type of B bytes, and V elements of T seen through it.
template <int B> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<1> { using type = unsigned char; };

template <typename T, int V>
union Pack {
  typename Raw<sizeof(T) * V>::type raw;
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load_vec(const T* base, long long v) {
  Pack<T, V> a;
  a.raw = reinterpret_cast<const typename Raw<sizeof(T) * V>::type*>(base)[v];
  return a;
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* base, long long v,
                                          const Pack<T, V>& a) {
  reinterpret_cast<typename Raw<sizeof(T) * V>::type*>(base)[v] = a.raw;
}

// One sweep's delegate update from the gathered lane words. T = int: the
// plane holds levels (inf = unvisited), newly marked lanes get it[r] + 1;
// T = unsigned char: the plane holds bool visited bytes, newly marked
// lanes are set, and the frontier plane is the newly marked lanes.
template <typename T, int V, bool TARGET>
__global__ void __launch_bounds__(kThreads)
mask_reduce_apply_kernel(const unsigned* __restrict__ gathered,  // [K, D*NW]
                         const T* __restrict__ level,            // [P, D, W]
                         const int* __restrict__ it,             // [P]
                         const unsigned char* __restrict__ target,  // [P, D, W]
                         T* __restrict__ level_out,              // [P, D, W]
                         unsigned char* __restrict__ frontier_out,  // [P, D, W]
                         unsigned* __restrict__ flags,  // [P, 2*ceil(W/4)+1]
                         int K, long long D, int W, int NW, int inf) {
  constexpr bool kLevels = sizeof(T) == 4;
  extern __shared__ unsigned s_bits[];        // [2, NW]: newly, unhit
  for (int j = threadIdx.x; j < 2 * NW; j += kThreads) s_bits[j] = 0;
  __syncthreads();

  const int r = blockIdx.y;
  const long long plane = D * W;
  const T* lv = level + r * plane;
  T* lo = level_out + r * plane;
  const unsigned char* tg = TARGET ? target + r * plane : nullptr;
  unsigned char* fo = kLevels ? nullptr : frontier_out + r * plane;
  const long long gstride = D * NW;
  const int nxt = kLevels ? it[r] + 1 : 0;

  int cur = -1;                  // word of the lane bits held in acc_*
  unsigned acc_n = 0, acc_u = 0;
  for (long long v = (long long)blockIdx.x * kThreads + threadIdx.x;
       v < plane / V; v += (long long)gridDim.x * kThreads) {
    const long long e = v * V;
    const long long i = e / W;                 // delegate
    const int q0 = (int)(e - i * W);           // first lane; W % V == 0
    const int qw = q0 >> 5, sh = q0 & 31;      // V lanes in one word
    const unsigned* gp = gathered + i * NW + qw;
    unsigned g = 0;
    for (int k = 0; k < K; ++k) g |= __ldg(gp + k * gstride);
    const unsigned bits = g >> sh;
    const Pack<T, V> a = load_vec<T, V>(lv, v);
    Pack<unsigned char, V> t;
    if constexpr (TARGET) t = load_vec<unsigned char, V>(tg, v);
    Pack<T, V> o;
    Pack<unsigned char, V> f;
    unsigned nb = 0, ub = 0;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const bool unvis = kLevels ? a.v[j] == inf : a.v[j] == 0;
      const bool newly = unvis && ((bits >> j) & 1u);
      nb |= (unsigned)newly << j;
      if constexpr (TARGET)
        ub |= (unsigned)(unvis && !newly && t.v[j] != 0) << j;
      if constexpr (kLevels) {
        o.v[j] = newly ? nxt : a.v[j];
      } else {
        o.v[j] = a.v[j] | (T)newly;
        f.v[j] = newly;
      }
    }
    store_vec<T, V>(lo, v, o);
    if constexpr (!kLevels) store_vec<unsigned char, V>(fo, v, f);
    if (qw != cur) {
      if (acc_n) atomicOr(&s_bits[cur], acc_n);
      if (acc_u) atomicOr(&s_bits[NW + cur], acc_u);
      cur = qw;
      acc_n = acc_u = 0;
    }
    acc_n |= nb << sh;
    acc_u |= ub << sh;
  }
  if (NW == 1) {                 // every lane of the block in one word
    acc_n = __reduce_or_sync(0xffffffffu, acc_n);
    acc_u = __reduce_or_sync(0xffffffffu, acc_u);
    if ((threadIdx.x & 31) == 0) {
      if (acc_n) atomicOr(&s_bits[0], acc_n);
      if (acc_u) atomicOr(&s_bits[1], acc_u);
    }
  } else {
    if (acc_n) atomicOr(&s_bits[cur], acc_n);
    if (acc_u) atomicOr(&s_bits[NW + cur], acc_u);
  }
  __syncthreads();

  // flag words: [F4 newly][F4 unhit][1 any], byte j of word g = lane 4g+j
  const int f4 = (W + 3) >> 2;
  unsigned* fr = flags + (long long)r * (2 * f4 + 1);
  for (int j = threadIdx.x; j < 2 * f4 + 1; j += kThreads) {
    unsigned m = 0;
    if (j == 2 * f4) {
      for (int w = 0; w < NW; ++w) m |= s_bits[w];
      m = m != 0u;
    } else {
      const int pl = j >= f4;                  // 0 newly, 1 unhit
      const int q = (j - pl * f4) * 4;
      const unsigned b = (s_bits[pl * NW + (q >> 5)] >> (q & 31)) & 0xFu;
      m = (b & 1u) | ((b & 2u) << 7) | ((b & 4u) << 14) | ((b & 8u) << 21);
    }
    if (m) atomicOr(fr + j, m);
  }
}

// out[r] = min(prev[r], min_k gathered[k]) and improved byte r = any
// element of row r improved. SVEC: prev / out 16-byte aligned, so groups
// of 4 aligned in the flat [P, D] plane load and store as int4; GVEC: D %
// 4 == 0 as well, so the gathered rows share that alignment.
template <bool SVEC, bool GVEC>
__global__ void __launch_bounds__(kThreads)
payload_min_fold_apply_kernel(const int* __restrict__ gathered,  // [K, D]
                              const int* __restrict__ prev,      // [P, D]
                              int* __restrict__ out,             // [P, D]
                              unsigned* __restrict__ improved,  // [ceil(P/4)]
                              int K, long long D) {
  const int r = blockIdx.y;
  const long long base = r * D;
  const int a = SVEC ? (int)(base & 3) : 0;    // row start within its group
  const long long groups = (D + a + 3) / 4;
  bool imp = false;
  for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
       t < groups; t += (long long)gridDim.x * kThreads) {
    const long long i0 = 4 * t - a;
    const bool full = i0 >= 0 && i0 + 4 <= D;
    int p[4], m[4] = {INT_MAX, INT_MAX, INT_MAX, INT_MAX};
    if (SVEC && full) {
      const int4 x = *reinterpret_cast<const int4*>(prev + base + i0);
      p[0] = x.x; p[1] = x.y; p[2] = x.z; p[3] = x.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long i = i0 + j;
        p[j] = (i >= 0 && i < D) ? prev[base + i] : INT_MAX;
      }
    }
    for (int k = 0; k < K; ++k) {
      const int* gk = gathered + k * D;
      if (GVEC && full) {
        const int4 x = __ldg(reinterpret_cast<const int4*>(gk + i0));
        m[0] = min(m[0], x.x); m[1] = min(m[1], x.y);
        m[2] = min(m[2], x.z); m[3] = min(m[3], x.w);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const long long i = i0 + j;
          if (i >= 0 && i < D) m[j] = min(m[j], __ldg(gk + i));
        }
      }
    }
    int o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o[j] = min(p[j], m[j]);
      imp |= o[j] < p[j];        // out-of-row slots: INT_MAX, never improve
    }
    if (SVEC && full) {
      *reinterpret_cast<int4*>(out + base + i0) = make_int4(o[0], o[1], o[2],
                                                            o[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long i = i0 + j;
        if (i >= 0 && i < D) out[base + i] = o[j];
      }
    }
  }
  if (__syncthreads_or(imp) && threadIdx.x == 0)
    atomicOr(improved + (r >> 2), 1u << (8 * (r & 3)));
}

bool aligned(const void* p, int bytes) {
  return p == nullptr || reinterpret_cast<std::uintptr_t>(p) % bytes == 0;
}

// blocks along a row: enough to cover it, at most ~kBlocksPerSM an SM in all
long long row_blocks(long long work, long long P) {
  long long cap = (long long)sm_count() * kBlocksPerSM / P;
  if (cap < 1) cap = 1;
  const long long need = (work + kThreads - 1) / kThreads;
  return need < cap ? need : cap;
}

// fold_rows_kernel's launch over `groups` rows of `units` units each: a
// unit a thread, and the fewest threads a block (128 to 1,024) that cover
// every row with at most one block an SM in all (119 blocks of 512 at n =
// 60,561 words); longer rows take more blocks of 1,024.
struct FoldLaunch {
  dim3 grid;
  unsigned threads;
};

FoldLaunch fold_launch(long long groups, long long units) {
  long long per_row = sm_count() / groups;
  if (per_row < 1) per_row = 1;
  long long t = 128;
  while (t < kFoldMaxThreads && (units + t - 1) / t > per_row) t *= 2;
  return {dim3((unsigned)((units + t - 1) / t), (unsigned)groups),
          (unsigned)t};
}

template <typename T, int V>
int launch_apply(const void* gathered, const void* level, const void* it,
                 const void* target, void* level_out, void* frontier_out,
                 void* flags, int K, long long P, long long D, int W, int inf,
                 cudaStream_t s) {
  const int NW = (W + 31) / 32;
  const dim3 grid((unsigned)row_blocks(D * W / V, P), (unsigned)P);
  const size_t smem = 2 * NW * sizeof(unsigned);
  const unsigned* g = static_cast<const unsigned*>(gathered);
  const T* lv = static_cast<const T*>(level);
  const int* itp = static_cast<const int*>(it);
  const unsigned char* tg = static_cast<const unsigned char*>(target);
  T* lo = static_cast<T*>(level_out);
  unsigned char* fo = static_cast<unsigned char*>(frontier_out);
  unsigned* fl = static_cast<unsigned*>(flags);
  if (tg != nullptr) {
    mask_reduce_apply_kernel<T, V, true><<<grid, kThreads, smem, s>>>(
        g, lv, itp, tg, lo, fo, fl, K, D, W, NW, inf);
  } else {
    mask_reduce_apply_kernel<T, V, false><<<grid, kThreads, smem, s>>>(
        g, lv, itp, nullptr, lo, fo, fl, K, D, W, NW, inf);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// fold_rows: out [groups, n] int32, out[g] = the fold (op 0: OR, 1: min) of
// `prev` [n] (none where null: the op's identity) and rows[g*gs + i*ks] for
// i < K (strides in words; each row n words); `count` [groups, n] (null:
// none; needs `prev`) the popcount of the newly set bits / the 0/1 improved
// flag. The one C entry of the four standalone bodies: mask_reduce and
// payload_min_fold ([K, n] partials into `prev`, ks = n, one group) and the
// prev-less group fold. Returns the launch's cudaError_t (0 = launched).
extern "C" int fold_rows(const void* rows, const void* prev, void* out,
                         void* count, int op, int K, long long ks,
                         long long groups, long long gs, long long n,
                         void* stream) {
  if (n == 0 || groups == 0) return (int)cudaSuccess;
  if (K < 1 || groups < 0 || groups > 65535 || (op != kOr && op != kMin)
      || (count != nullptr && prev == nullptr))
    return (int)cudaErrorInvalidValue;
  // int4 units where every row (and prev, out, count) starts 16-byte aligned
  const bool vec = aligned(rows, 16) && aligned(out, 16)
                   && (prev == nullptr || aligned(prev, 16))
                   && (count == nullptr || aligned(count, 16))
                   && ks % 4 == 0 && gs % 4 == 0 && n % 4 == 0;
  const FoldLaunch l = fold_launch(groups, vec ? n / 4 : n);
  const int* r = static_cast<const int*>(rows);
  const int* pv = static_cast<const int*>(prev);
  int* o = static_cast<int*>(out);
  int* c = static_cast<int*>(count);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MR_FOLD(OP, VEC) dispatch_k<OP, VEC>(l.grid, l.threads, s, r, pv, \
                                             o, c, K, ks, gs, n)
  if (op == kOr) {
    if (vec) MR_FOLD(kOr, true); else MR_FOLD(kOr, false);
  } else {
    if (vec) MR_FOLD(kMin, true); else MR_FOLD(kMin, false);
  }
#undef MR_FOLD
  return (int)cudaGetLastError();
}

// fold_empty: fold_rows' signature, one block of an empty kernel -- the
// launch floor of the fold wrappers' path. Returns the cudaError_t.
extern "C" int fold_empty(const void*, const void*, void*, void*, int, int,
                          long long, long long, long long, long long,
                          void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

// mask_reduce_apply: gathered [K, D*ceil(W/32)] int32 words, level
// [P, D, W] (int32 levels where visited == 0, bool bytes where 1), it [P]
// int32, target [P, D, W] bool or null -> level_out [P, D, W], frontier_out
// [P, D, W] bool (visited planes only), flags [P, 2*ceil(W/4)+1] words of
// bool bytes (cleared here first). Returns the first cudaError_t.
extern "C" int mask_reduce_apply(const void* gathered, const void* level,
                                 const void* it, const void* target,
                                 void* level_out, void* frontier_out,
                                 void* flags, int K, long long P, long long D,
                                 int W, int visited, int inf, void* stream) {
  if (P <= 0) return (int)cudaSuccess;
  if (P > 65535 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long words = P * (2 * ((W + 3) / 4) + 1);
  cudaError_t err = cudaMemsetAsync(flags, 0, words * sizeof(unsigned), s);
  if (err != cudaSuccess || D == 0) return (int)err;
#define APPLY(T, V)                                                        \
  launch_apply<T, V>(gathered, level, it, target, level_out, frontier_out, \
                     flags, K, P, D, W, inf, s)
  if (!visited) {
    if (W % 4 == 0 && aligned(level, 16) && aligned(level_out, 16) &&
        aligned(target, 4))
      return APPLY(int, 4);
    return APPLY(int, 1);
  }
  if (W % 16 == 0 && aligned(level, 16) && aligned(level_out, 16) &&
      aligned(frontier_out, 16) && aligned(target, 16))
    return APPLY(unsigned char, 16);
  if (W % 4 == 0 && aligned(level, 4) && aligned(level_out, 4) &&
      aligned(frontier_out, 4) && aligned(target, 4))
    return APPLY(unsigned char, 4);
  return APPLY(unsigned char, 1);
#undef APPLY
}

// payload_min_fold_apply: gathered [K, D] int32, prev [P, D] int32 ->
// out [P, D] int32, improved [4*ceil(P/4)] bool bytes (cleared here
// first). Returns the first cudaError_t.
extern "C" int payload_min_fold_apply(const void* gathered, const void* prev,
                                      void* out, void* improved, int K,
                                      long long P, long long D, void* stream) {
  if (P <= 0) return (int)cudaSuccess;
  if (P > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(improved, 0, (P + 3) / 4 * sizeof(unsigned),
                                    s);
  if (err != cudaSuccess || D == 0) return (int)err;
  const bool svec = aligned(prev, 16) && aligned(out, 16);
  const bool gvec = svec && D % 4 == 0 && aligned(gathered, 16);
  const dim3 grid((unsigned)row_blocks((D + 3) / 4 + 1, P), (unsigned)P);
  const int* g = static_cast<const int*>(gathered);
  const int* pv = static_cast<const int*>(prev);
  int* o = static_cast<int*>(out);
  unsigned* imp = static_cast<unsigned*>(improved);
  if (gvec) {
    payload_min_fold_apply_kernel<true, true><<<grid, kThreads, 0, s>>>(
        g, pv, o, imp, K, D);
  } else if (svec) {
    payload_min_fold_apply_kernel<true, false><<<grid, kThreads, 0, s>>>(
        g, pv, o, imp, K, D);
  } else {
    payload_min_fold_apply_kernel<false, false><<<grid, kThreads, 0, s>>>(
        g, pv, o, imp, K, D);
  }
  return (int)cudaGetLastError();
}
