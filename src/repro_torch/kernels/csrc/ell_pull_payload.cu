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
// What bounds it on an H100: memory. Per row it streams W active flags and
// W outputs, and for a row with an active lane its K parent ids; per valid
// parent slot it reads the slot's weight and gathers the parent's W-lane
// payload row (128 bytes at W = 32) at a random row index. It does two
// integer operations per slot and lane. On the ELL of a power-law graph
// most slots are -1 padding (84% at scale 20, K = 64), so a walk over
// every slot spends its time on slots that gather nothing, and one gather
// in flight per warp leaves the memory system idle.
//
// Design: the TPU kernel keeps the whole payload table in VMEM and runs an
// unrolled min chain over a [TR, K, W] tile. Here a lane owns P consecutive
// payload lanes (P = 4 where W % 4 == 0 and the tensors allow, else 2 or
// 1), a group of S lanes owns a row (S the power of two >= W / P, at most
// 32: 4 rows share a warp at W = 32; wider rows loop over groups of 32 P
// lanes), so each gather is one 16-byte load a lane and a warp has 4 rows'
// loads in flight.
//  (a) Idle rows: the group reads the row's W active flags first; a row
//      with none set writes the identity and reads no parents, weights or
//      payload (a warp with no active row skips straight to its store).
//  (b) Compaction: the group reads the row's ids in vectors (V = 8 a lane
//      where K % 8 == 0 and the ids allow, else 4, 2 or 1: at K = 64 one
//      pass brings the whole row), and a __ballot_sync of id >= 0 packs the
//      valid (id, slot) pairs into a per-group list in shared memory. The
//      gather loop then runs over the valid slots only, wherever the -1
//      slots lie in the row.
//  (c) Parallel gathers: kInFlight payload loads are issued, predicated,
//      before any is folded into the min; each valid slot's weight is
//      loaded beside its payload row, so only the weights of valid slots
//      are read (12.3 MB of 75 at scale 20) and the chain a row waits on
//      stays flags, ids, gathers.
//  (d) L2: the streamed inputs (ids, weights, flags) are read with an
//      evict-first L2 policy (per instruction: createpolicy, no access
//      window that would outlive the call), ids and flags without L1
//      allocation, and the output is stored streaming (st.global.cs), so
//      the stream does not push the gathered payload rows (normal policy)
//      out of L2.
//  (e) Blocks of 64 threads, at least kMinBlocks of them a SM: a block that
//      finishes frees its slot at once, and the register cap (64 a thread)
//      keeps 32 warps a SM in flight; 6 gathers in flight a lane fit that
//      cap (each measured faster than 128 and 256 threads, no cap, and 2,
//      4 or 8 in flight, PERF.md).
// What limits it now: L2 traffic, not HBM bytes (inferred, PERF.md): at
// scale 20 its 3.08 M gathers move 395 MB from L2 to the SMs beside about
// 165 MB of streams, while the bound counts 200 MB of HBM; reading the ids
// with the flags, one step less a row waits on, gained 2%.
// payload + weight is added in unsigned arithmetic and cast back, so it
// wraps as the reference's int32 add does (signed overflow is undefined in
// C++).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 2;
constexpr int kMinBlocks = 16;  // blocks a SM: caps registers at 64 a thread
constexpr unsigned kFull = 0xffffffffu;
constexpr int kIdent = 1 << 30;
constexpr int kInFlight = 6;   // payload loads a lane issues before folding

__device__ __forceinline__ uint64_t evict_first() {
  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

// N consecutive ints at p (N = 1, 2, 4, 8; p aligned to 4 min(N, 4) bytes):
// streamed (evict-first in L2, not kept in L1), read-only gathered, stored
// streaming.
template <int N>
__device__ __forceinline__ void ld_stream(const int* p, uint64_t policy,
                                          int* v) {
  if constexpr (N == 8) {
    ld_stream<4>(p, policy, v);
    ld_stream<4>(p + 4, policy, v + 4);
  } else if constexpr (N == 1)
    asm("ld.global.nc.L1::no_allocate.L2::cache_hint.s32 %0, [%1], %2;"
        : "=r"(v[0]) : "l"(p), "l"(policy));
  else if constexpr (N == 2)
    asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v2.s32 {%0, %1}, [%2], "
        "%3;" : "=r"(v[0]), "=r"(v[1]) : "l"(p), "l"(policy));
  else
    asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.s32 {%0, %1, %2, "
        "%3}, [%4], %5;" : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
        : "l"(p), "l"(policy));
}

// One edge weight: evict-first in L2 but kept in L1, where the other
// valid slots of the row (a 32-byte sector holds 8) find it.
__device__ __forceinline__ int ld_weight(const int* p, uint64_t policy) {
  int v;
  asm("ld.global.nc.L2::cache_hint.s32 %0, [%1], %2;"
      : "=r"(v) : "l"(p), "l"(policy));
  return v;
}

template <int N>
__device__ __forceinline__ void ld_gather(const int* p, int* v) {
  if constexpr (N == 1) {
    v[0] = __ldg(p);
  } else if constexpr (N == 2) {
    const int2 x = __ldg(reinterpret_cast<const int2*>(p));
    v[0] = x.x, v[1] = x.y;
  } else {
    const int4 x = __ldg(reinterpret_cast<const int4*>(p));
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  }
}

template <int N>
__device__ __forceinline__ void st_stream(int* p, const int* v) {
  if constexpr (N == 1)
    asm volatile("st.global.cs.s32 [%0], %1;" ::"l"(p), "r"(v[0]) : "memory");
  else if constexpr (N == 2)
    asm volatile("st.global.cs.v2.s32 [%0], {%1, %2};" ::"l"(p), "r"(v[0]),
                 "r"(v[1]) : "memory");
  else
    asm volatile("st.global.cs.v4.s32 [%0], {%1, %2, %3, %4};" ::"l"(p),
                 "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]) : "memory");
}

// This lane's V slots k..k+V-1 of a row's ids (-1 beyond K), in vector
// loads issued together (V > 1 only where K % V == 0 and the rows are
// aligned).
template <int V>
__device__ __forceinline__ void load_ids(const int* p_row, int k, int K,
                                         bool load, uint64_t policy,
                                         int (&id)[V]) {
#pragma unroll
  for (int v = 0; v < V; ++v) id[v] = -1;
  if (!load || k >= K) return;
  ld_stream<V>(p_row + k, policy, id);
}

template <int V, int P>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kMinBlocks)
ell_pull_payload_kernel(const int* __restrict__ parents,   // [R, K], -1 pad
                        const int* __restrict__ payload,   // [N, W]
                        const int* __restrict__ weights,   // [R, K]
                        const int* __restrict__ active,    // [R, W]
                        int* __restrict__ out,             // [R, W]
                        long long R, int K, int W, int S) {
  __shared__ int2 lists[kWarpsPerBlock][32 * V];
  const uint64_t policy = evict_first();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane / S, s = lane - g * S;
  const long long row =
      ((long long)blockIdx.x * kWarpsPerBlock + warp) * (32 / S) + g;
  const bool in_row = row < R;      // false for a last warp's spare groups
  const unsigned group = S == 32 ? kFull : ((1u << S) - 1u) << (g * S);
  const unsigned below = (1u << lane) - 1u;
  const int* p_row = parents + (in_row ? row : 0) * K;
  const int* w_row = weights + (in_row ? row : 0) * K;
  int2* list = lists[warp] + g * S * V;
  for (int q0 = 0; q0 < W; q0 += S * P) {      // one pass unless W > 32 P
    const int q = q0 + s * P;                  // this lane's P payload lanes
    const bool mine = in_row && q < W;         // W % P == 0
    int flag[P];
#pragma unroll
    for (int j = 0; j < P; ++j) flag[j] = 0;
    if (mine) ld_stream<P>(active + row * W + q, policy, flag);
    bool on = false;
#pragma unroll
    for (int j = 0; j < P; ++j) on |= flag[j] != 0;
    const unsigned warp_on = __ballot_sync(kFull, on);
    int acc[P];
#pragma unroll
    for (int j = 0; j < P; ++j) acc[j] = kIdent;
    if (warp_on != 0) {                        // uniform per warp
      const bool row_on = (warp_on & group) != 0;
      for (int c = 0; c < K; c += S * V) {     // uniform per warp
        int id[V];
        load_ids<V>(p_row, c + s * V, K, row_on, policy, id);
        int n = 0;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const unsigned valid = __ballot_sync(kFull, id[v] >= 0) & group;
          if (id[v] >= 0)
            list[n + __popc(valid & below)] = make_int2(id[v], c + s * V + v);
          n += __popc(valid);
        }
        __syncwarp();
        for (int i = 0; i < n; i += kInFlight) {
          // a valid slot's payload row and weight, loaded together; the
          // others stay at the identity + 0
          int val[kInFlight][P], wt[kInFlight];
#pragma unroll
          for (int u = 0; u < kInFlight; ++u) {
#pragma unroll
            for (int j = 0; j < P; ++j) val[u][j] = kIdent;
            wt[u] = 0;
            if (on && i + u < n) {
              const int2 e = list[i + u];
              ld_gather<P>(payload + (long long)e.x * W + q, val[u]);
              wt[u] = ld_weight(w_row + e.y, policy);
            }
          }
#pragma unroll
          for (int u = 0; u < kInFlight; ++u)
#pragma unroll
            for (int j = 0; j < P; ++j)
              acc[j] = min(acc[j],
                           (int)((unsigned)val[u][j] + (unsigned)wt[u]));
        }
        __syncwarp();
      }
    }
    if (mine) {
#pragma unroll
      for (int j = 0; j < P; ++j) acc[j] = flag[j] != 0 ? acc[j] : kIdent;
      st_stream<P>(out + row * W + q, acc);
    }
  }
}

template <int V, int P>
int launch(const int* parents, const int* payload, const int* weights,
           const int* active, int* out, long long R, int K, int W,
           cudaStream_t stream) {
  int S = 1;                                   // lanes a row
  while (S * P < W && S < 32) S <<= 1;
  const long long warps = (R + 32 / S - 1) / (32 / S);
  const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  ell_pull_payload_kernel<V, P><<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                                  stream>>>(parents, payload, weights, active,
                                            out, R, K, W, S);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, int bytes) {
  return (uintptr_t)p % (uintptr_t)bytes == 0;
}

// The widest P (payload lanes a lane owns) that divides W and the payload,
// flag and output alignment.
template <int V>
int launch_v(const int* parents, const int* payload, const int* weights,
             const int* active, int* out, long long R, int K, int W,
             cudaStream_t stream) {
  int P = 4;
  while (P > 1 && (W % P != 0 || !aligned(payload, 4 * P) ||
                   !aligned(active, 4 * P) || !aligned(out, 4 * P)))
    P /= 2;
  if (P == 4)
    return launch<V, 4>(parents, payload, weights, active, out, R, K, W,
                        stream);
  if (P == 2)
    return launch<V, 2>(parents, payload, weights, active, out, R, K, W,
                        stream);
  return launch<V, 1>(parents, payload, weights, active, out, R, K, W, stream);
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
  // The widest V (ids a lane reads at once, in 16-byte vectors at most)
  // that divides K and the ids' alignment.
  int V = 8;
  while (V > 1 && (K % V != 0 || !aligned(parents, 4 * (V < 4 ? V : 4))))
    V /= 2;
  auto p = static_cast<const int*>(parents);
  auto pl = static_cast<const int*>(payload);
  auto w = static_cast<const int*>(weights);
  auto a = static_cast<const int*>(active);
  auto o = static_cast<int*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (V == 8) return launch_v<8>(p, pl, w, a, o, R, K, W, st);
  if (V == 4) return launch_v<4>(p, pl, w, a, o, R, K, W, st);
  if (V == 2) return launch_v<2>(p, pl, w, a, o, R, K, W, st);
  return launch_v<1>(p, pl, w, a, o, R, K, W, st);
}
