// Early-exit bottom-up pull over a stacked CSR, scheduled by row length.
//
// One design, two instantiations (the gather is a template parameter):
//   BitGather        -- ell_pull.cu (replaces src/repro/kernels/ell_pull.py,
//                       pallas_call at line 54, with the chunk loop of
//                       src/repro/core/bfs.py::_pull_rows): a vertex's word
//                       is bit (c & 31) of mask[c >> 5]; a row's need is its
//                       active flag.
//   WordGather<NW>   -- ell_pull_multi.cu (replaces
//                       src/repro/kernels/ell_pull_multi.py, pallas_call at
//                       line 60, with the chunk loop of
//                       src/repro/core/msbfs.py::_pull_rows_multi): NW lane
//                       words at frontier[c * NW], NW = 1..4.
//
// What it computes, for every row r of every subgraph g and partition k:
//     found = (OR over the parents u of r of word(u)) & need
//     work  = in-row slots of every chunk the reference enters
// The reference enters chunk c while (need & ~acc) != 0 and c*chunk < len.
// Coverage only grows along the row, so found is the OR of the WHOLE row
// masked by the need (covered: found == need), and only `work` depends on
// where the row stops: if j* is the first in-row slot at which the running
// OR covers the need, the row stops after chunk c* = j* / chunk and
// work = min(len, (c* + 1) * chunk); never covered: work = len. So a group
// may read slots ahead of the stop, in any grouping, and still reproduce
// the reference's work_fwd / work_bwd counters bit for bit. A row with need
// 0 (or inactive) has found 0 and work 0. Columns < 0 (the ELL contract's
// -1 padding) gather nothing but count as slots. Words are int32 bit
// patterns; lane 31 is the sign bit and every test here is bitwise.
//
// What bounds it on an H100: memory latency and imbalance, not bytes. Per
// entered slot it reads one 4-byte column id (a stream) and gathers one bit
// or NW words at random from a table that sits in L1 / L2; the byte bound of
// one sweep is 2.5-18 us at scale 20, but row lengths run from 1 to 55,281
// slots, and a one-warp-per-row walk that waits on each chunk's column load,
// gather and reduce before the next is latency bound on its longest row and
// leaves lanes idle on its shortest.
//
// Design:
//  (a) latency: every lane of a group issues U independent column loads
//      (U = 4 to 16) before its gathers, and a group tests coverage once
//      per step of G*U slots with one __reduce_or_sync per word; the exact
//      stop slot is searched only in the one step that covers. Long rows
//      (> 1,024 slots) get a block of 256 threads (2,048 slots a step),
//      medium rows (65..1,024) a warp (128 slots a step), short rows
//      (1..64) one lane (16 slots a step for one word, 4 for four), so 32
//      short rows share a warp and find their stop slot without a shuffle.
//      A warp reads the schedule entries (row id and slot span) and need
//      words of a batch of rows at once (4 medium or 32 short rows), one
//      lane a row, writes the zero result of an inactive row itself and
//      pulls only the active ones, so a row's chain is: its columns, its
//      gathers, the test. Medium and long rows load the next step's
//      columns before they gather the current step's.
//  (b) imbalance: a schedule built once per CSR on the device
//      (kernels/pull_schedule.py) sorts the rows by class: long (longest
//      first), medium, short, empty. The grid gives long rows the first
//      blocks, merged across the subgraphs of a sweep, so the longest rows
//      start first; empty rows cost one thread each.
//  (c) launches: one launch pulls the three subgraphs of a sweep; the host
//      passes one struct (Sweep), prepared once per tuple of CSRs, and the
//      grid's segments are laid out here.
//  The bit masks (7.6 KB for the delegates, 64 KB for a partition's
//  normals at scale 20) are read through L1: staging them in shared memory
//  measured slower (PERF.md), as 64 KB of dynamic shared memory costs
//  every block of the launch occupancy. The word tables (0.24 MB and 2 MB)
//  stay in L2 behind read-only loads. The column stream is read with the
//  evict-first hint so it does not push the tables out of L1.
#pragma once
#include <cuda_runtime.h>

namespace pull {

constexpr int kThreads = 256;                 // every block
constexpr int kWarps = kThreads / 32;
constexpr int kMediumLoads = 4;               // U of a medium row (G = 32)
constexpr int kLongLoads = 8;                 // U of a long row (G = 256)
constexpr int kMediumBatch = 4;               // medium rows a warp takes
constexpr int kShortBatch = 32;               // short rows a warp takes
constexpr int kMediumRowsPerBlock = kWarps * kMediumBatch;   // 32
constexpr int kShortRowsPerBlock = kWarps * kShortBatch;     // 256
constexpr int kEmptyRowsPerBlock = kThreads * 4;             // 1024
constexpr int kMaxGraphs = 3;
constexpr int kSegments = 1 + 3 * kMaxGraphs;

// classes, in the order of a schedule (kernels/pull_schedule.py)
enum { kLong = 0, kMedium = 1, kShort = 2, kEmpty = 3 };

struct Graph {            // one subgraph of a sweep (layout: pull_schedule.py)
  const int* offsets;     // [p, R+1]
  const int* cols;        // [p, E]
  const int* order;       // [p*R] flat row ids (k*R + r), class by class
  const int2* span;       // [p*R] (first slot in the partition, length)
  const int* frontier;    // bits: mask [p, N]; words: [p, N, NW]
  const int* need;        // bits: active [p, R]; words: [p, R, NW]
  int* found;             // bits: [p, R]; words: [p, R, NW]
  int* work;              // [p, R]
  long long E;
  int R;
  int N;                  // bits: mask words per partition; words: vertices
  int count[4];           // rows per class, over all partitions
  int start[4];           // first position of each class in `order`
};

struct Sweep {
  Graph g[kMaxGraphs];
  const int* long_items;  // [n_long] position * 4 + graph, longest first
  int n_graphs;
  int chunk;
  int nw;
  int seg_start[kSegments + 1];  // first block of each grid segment
};

__device__ __forceinline__ int stop_work(int len, int j, int chunk) {
  const long long w = ((long long)(j / chunk) + 1) * chunk;
  return w < len ? (int)w : len;
}

struct BitGather {
  static constexpr int NW = 1;
  static constexpr int kMinBlocks = 4;        // <= 64 registers
  static constexpr int kShortLoads = 16;      // U of a short row (G = 1)
  __device__ static const unsigned* table(const Graph& g, int part) {
    return reinterpret_cast<const unsigned*>(g.frontier) + (long long)part * g.N;
  }
  __device__ static void need(const Graph& g, long long flat, unsigned* nd) {
    nd[0] = g.need[flat] == 1 ? 1u : 0u;
  }
  __device__ static void word(const unsigned* t, int c, unsigned* w) {
    w[0] = (t[c >> 5] >> (c & 31)) & 1u;
  }
  __device__ static void store(const Graph& g, long long flat,
                               const unsigned* f, int work) {
    g.found[flat] = (int)f[0];
    g.work[flat] = work;
  }
};

template <int NW_>
struct WordGather {
  static constexpr int NW = NW_;
  static constexpr int kMinBlocks = NW <= 2 ? 4 : 2;
  static constexpr int kShortLoads = 16 / NW;
  __device__ static const unsigned* table(const Graph& g, int part) {
    return reinterpret_cast<const unsigned*>(g.frontier) +
           (long long)part * g.N * NW;
  }
  __device__ static void need(const Graph& g, long long flat, unsigned* nd) {
#pragma unroll
    for (int i = 0; i < NW; ++i) nd[i] = (unsigned)g.need[flat * NW + i];
  }
  __device__ static void word(const unsigned* t, int c, unsigned* w) {
    const unsigned* p = t + (long long)c * NW;
#pragma unroll
    for (int i = 0; i < NW; ++i) w[i] = __ldg(p + i);
  }
  __device__ static void store(const Graph& g, long long flat,
                               const unsigned* f, int work) {
#pragma unroll
    for (int i = 0; i < NW; ++i) g.found[flat * NW + i] = (int)f[i];
    g.work[flat] = work;
  }
};

template <int NW>
__device__ __forceinline__ bool covers(const unsigned* nd, const unsigned* a,
                                       const unsigned* b) {
  unsigned miss = 0u;
#pragma unroll
  for (int i = 0; i < NW; ++i) miss |= nd[i] & ~(a[i] | b[i]);
  return miss == 0u;
}

template <int NW>
__device__ __forceinline__ bool any_word(const unsigned* nd) {
  unsigned v = 0u;
#pragma unroll
  for (int i = 0; i < NW; ++i) v |= nd[i];
  return v != 0u;
}

// U independent column loads a lane: slot base + u*G + lane (-1 past the
// row's end). The evict-first hint keeps the stream out of the way of the
// frontier tables in L1.
template <int G, int U>
__device__ __forceinline__ void load_cols(const int* __restrict__ rcols,
                                          int len, int base, int lane,
                                          int (&c)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = base + u * G + lane;
    c[u] = j < len ? __ldcs(rcols + j) : -1;
  }
}

template <class Gt, int U>
__device__ __forceinline__ void gather(const unsigned* t, const int (&c)[U],
                                       unsigned (&w)[U][Gt::NW]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (c[u] >= 0) {
      Gt::word(t, c[u], w[u]);
    } else {
#pragma unroll
      for (int i = 0; i < Gt::NW; ++i) w[u][i] = 0u;
    }
  }
}

// A warp pulls one medium row whose need words `nd` are not all 0 (slot
// base + u*32 + lane of each step); returns its work and leaves its found
// words in `found`. Each step's columns are in flight while the previous
// step is gathered and tested.
template <class Gt>
__device__ __forceinline__ int pull_warp(const int* __restrict__ rcols,
                                         int len, const unsigned* t,
                                         const unsigned* nd, int lane,
                                         int chunk, unsigned* found) {
  constexpr int NW = Gt::NW, U = kMediumLoads, G = 32;
  int c[U];
  load_cols<G, U>(rcols, len, 0, lane, c);
  unsigned acc[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) acc[i] = 0u;
  for (int base = 0; base < len; base += G * U) {
    int cn[U];
    const bool more = base + G * U < len;
    if (more) load_cols<G, U>(rcols, len, base + G * U, lane, cn);
    unsigned w[U][NW];
    gather<Gt, U>(t, c, w);
    unsigned so[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      unsigned v = 0u;
#pragma unroll
      for (int u = 0; u < U; ++u) v |= w[u][i];
      so[i] = __reduce_or_sync(0xffffffffu, v);
    }
    if (covers<NW>(nd, acc, so)) {
      // the covering step: the first slot whose running OR covers
#pragma unroll
      for (int u = 0; u < U; ++u) {
        unsigned sc[NW];
#pragma unroll
        for (int i = 0; i < NW; ++i) {
          unsigned v = w[u][i];
#pragma unroll
          for (int d = 1; d < G; d <<= 1) {
            const unsigned o = __shfl_up_sync(0xffffffffu, v, d);
            if (lane >= d) v |= o;
          }
          sc[i] = v;
        }
        const unsigned hit = __ballot_sync(0xffffffffu, covers<NW>(nd, acc, sc));
        if (hit) {
#pragma unroll
          for (int i = 0; i < NW; ++i) found[i] = nd[i];
          return stop_work(len, base + u * G + __ffs(hit) - 1, chunk);
        }
#pragma unroll
        for (int i = 0; i < NW; ++i) acc[i] |= __shfl_sync(0xffffffffu, sc[i], G - 1);
      }
    }
#pragma unroll
    for (int i = 0; i < NW; ++i) acc[i] |= so[i];
    if (more) {
#pragma unroll
      for (int u = 0; u < U; ++u) c[u] = cn[u];
    }
  }
#pragma unroll
  for (int i = 0; i < NW; ++i) found[i] = acc[i] & nd[i];
  return len;
}

// One lane pulls one short row whose need words are not all 0, U slots a
// step (U independent column loads, then the gathers); the first covering
// slot falls out of the lane's own running OR, with no shuffle.
template <class Gt>
__device__ __forceinline__ int pull_lane(const int* __restrict__ rcols,
                                         int len, const unsigned* t,
                                         const unsigned* nd, int chunk,
                                         unsigned* found) {
  constexpr int NW = Gt::NW, U = Gt::kShortLoads;
  unsigned acc[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) acc[i] = 0u;
  for (int base = 0; base < len; base += U) {
    int c[U];
    load_cols<1, U>(rcols, len, base, 0, c);
    unsigned w[U][NW];
    gather<Gt, U>(t, c, w);
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int i = 0; i < NW; ++i) acc[i] |= w[u][i];
      if (covers<NW>(nd, acc, acc)) {
#pragma unroll
        for (int i = 0; i < NW; ++i) found[i] = nd[i];
        return stop_work(len, base + u, chunk);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NW; ++i) found[i] = acc[i] & nd[i];
  return len;
}

// A block of kThreads pulls one long row: a step is kThreads * U slots
// (slot base + u*kThreads + tid); each warp ORs its 32 slots of each u into
// shared memory, warp 0 scans those U * kWarps entries in row order and
// publishes the first covering entry, and only that entry's warp scans its
// lanes for the stop slot. The next step's columns are in flight meanwhile.
// The row's need is read first: long rows are few, and an inactive one
// would otherwise read 8 KB of columns for nothing.
template <class Gt, int U>
__device__ __forceinline__ void pull_block(const Graph& g, long long flat,
                                           const int* __restrict__ rcols,
                                           int len, const unsigned* t,
                                           int chunk) {
  constexpr int NW = Gt::NW;
  constexpr int kEntries = U * kWarps;
  static_assert(kEntries % 32 == 0, "whole warps of entries");
  __shared__ unsigned seg[kEntries][NW];
  __shared__ unsigned total[NW];
  __shared__ unsigned before[NW];
  __shared__ int hit_entry;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned nd[NW];
  Gt::need(g, flat, nd);
  if (!any_word<NW>(nd)) {  // an inactive long row reads no column
    if (tid == 0) Gt::store(g, flat, nd, 0);
    return;
  }
  int c[U];
  load_cols<kThreads, U>(rcols, len, 0, tid, c);
  unsigned acc[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) acc[i] = 0u;
  for (int base = 0; base < len; base += kThreads * U) {
    int cn[U];
    const bool more = base + kThreads * U < len;
    if (more) load_cols<kThreads, U>(rcols, len, base + kThreads * U, tid, cn);
    unsigned w[U][NW];
    gather<Gt, U>(t, c, w);
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int i = 0; i < NW; ++i) {
        const unsigned v = __reduce_or_sync(0xffffffffu, w[u][i]);
        if (lane == 0) seg[u * kWarps + warp][i] = v;
      }
    }
    __syncthreads();
    if (warp == 0) {
      unsigned run[NW];
#pragma unroll
      for (int i = 0; i < NW; ++i) run[i] = acc[i];
      int h = -1;
#pragma unroll
      for (int e0 = 0; e0 < kEntries; e0 += 32) {
        unsigned sc[NW];
#pragma unroll
        for (int i = 0; i < NW; ++i) {
          unsigned v = seg[e0 + lane][i];
#pragma unroll
          for (int d = 1; d < 32; d <<= 1) {
            const unsigned o = __shfl_up_sync(0xffffffffu, v, d);
            if (lane >= d) v |= o;
          }
          sc[i] = v;
        }
        const unsigned hit = __ballot_sync(0xffffffffu, covers<NW>(nd, run, sc));
        if (hit) {
          const int first = __ffs(hit) - 1;
#pragma unroll
          for (int i = 0; i < NW; ++i) {
            const unsigned prev = __shfl_sync(0xffffffffu, sc[i],
                                              first > 0 ? first - 1 : 0);
            if (lane == 0) before[i] = first > 0 ? run[i] | prev : run[i];
          }
          h = e0 + first;
          break;
        }
#pragma unroll
        for (int i = 0; i < NW; ++i)
          run[i] |= __shfl_sync(0xffffffffu, sc[i], 31);
      }
      if (lane == 0) {
        hit_entry = h;
#pragma unroll
        for (int i = 0; i < NW; ++i) total[i] = run[i];
      }
    }
    __syncthreads();
    const int h = hit_entry;
    if (h >= 0) {
      if (warp == h % kWarps) {
        const int uh = h / kWarps;
        unsigned carry[NW];
#pragma unroll
        for (int i = 0; i < NW; ++i) carry[i] = before[i];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (u != uh) continue;
          unsigned sc[NW];
#pragma unroll
          for (int i = 0; i < NW; ++i) {
            unsigned v = w[u][i];
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
              const unsigned o = __shfl_up_sync(0xffffffffu, v, d);
              if (lane >= d) v |= o;
            }
            sc[i] = v;
          }
          const unsigned hit =
              __ballot_sync(0xffffffffu, covers<NW>(nd, carry, sc));
          if (lane == __ffs(hit) - 1)
            Gt::store(g, flat, nd,
                      stop_work(len, base + u * kThreads + warp * 32 + lane,
                                chunk));
        }
      }
      return;
    }
#pragma unroll
    for (int i = 0; i < NW; ++i) acc[i] = total[i];
    if (more) {
#pragma unroll
      for (int u = 0; u < U; ++u) c[u] = cn[u];
    }
  }
  if (tid == 0) {
    unsigned f[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) f[i] = acc[i] & nd[i];
    Gt::store(g, flat, f, len);
  }
}

template <class Gt>
__global__ void __launch_bounds__(kThreads, Gt::kMinBlocks)
pull_rows_kernel(const __grid_constant__ Sweep s) {
  constexpr int NW = Gt::NW;
  const int b = blockIdx.x;
  int k = 0;
  while (b >= s.seg_start[k + 1]) ++k;  // uniform over the block
  const int local = b - s.seg_start[k];
  const int tid = threadIdx.x, lane = tid & 31;

  if (k == 0) {  // long row: one block
    const int item = s.long_items[local];
    const Graph& g = s.g[item & 3];
    const int pos = item >> 2;
    const int flat = g.order[pos];
    const int2 sp = g.span[pos];
    const int part = flat / g.R;
    pull_block<Gt, kLongLoads>(g, flat, g.cols + part * g.E + sp.x, sp.y,
                               Gt::table(g, part), s.chunk);
    return;
  }

  const int cls = 1 + (k - 1) / kMaxGraphs;
  const Graph& g = s.g[(k - 1) % kMaxGraphs];
  const int* order = g.order + g.start[cls];
  const int2* span = g.span + g.start[cls];
  const int n = g.count[cls];

  if (cls == kEmpty) {
    const unsigned zero[NW] = {};
    for (int q = 0; q < kEmptyRowsPerBlock; q += kThreads) {
      const int pos = local * kEmptyRowsPerBlock + q + tid;
      if (pos < n) Gt::store(g, order[pos], zero, 0);
    }
    return;
  }

  // Each warp takes a batch of rows (4 medium or 32 short), one lane a
  // row: the lane reads the schedule entry and the need words together
  // and writes the zero result of an inactive row itself. A short row is
  // then pulled by its lane; an active medium row is parked in shared
  // memory and pulled by the whole warp, one after the other.
  __shared__ int s_flat[kWarps][kMediumBatch];
  __shared__ int2 s_span[kWarps][kMediumBatch];
  __shared__ unsigned s_need[kWarps][kMediumBatch][NW];
  const int batch = cls == kMedium ? kMediumBatch : kShortBatch;
  const int first = local * batch * kWarps;
  const int last = min(first + batch * kWarps, n);
  const int warp = tid >> 5;
  const int pos = first + warp * batch + lane;
  bool act = false;
  int flat = 0;
  int2 sp = make_int2(0, 0);
  unsigned nd[NW], found[NW];
  if (lane < batch && pos < last) {
    flat = order[pos];
    sp = span[pos];
    Gt::need(g, flat, nd);
    act = sp.y > 0 && any_word<NW>(nd);
    if (!act) {
#pragma unroll
      for (int i = 0; i < NW; ++i) found[i] = 0u;
      Gt::store(g, flat, found, 0);
    }
  }
  if (cls == kShort) {
    if (act) {
      const int part = flat / g.R;
      const int work = pull_lane<Gt>(g.cols + part * g.E + sp.x, sp.y,
                                     Gt::table(g, part), nd,
                                     s.chunk, found);
      Gt::store(g, flat, found, work);
    }
    return;
  }
  if (act) {
    s_flat[warp][lane] = flat;
    s_span[warp][lane] = sp;
#pragma unroll
    for (int i = 0; i < NW; ++i) s_need[warp][lane][i] = nd[i];
  }
  for (unsigned todo = __ballot_sync(0xffffffffu, act); todo; todo &= todo - 1) {
    __syncwarp();
    const int r = __ffs(todo) - 1;
    flat = s_flat[warp][r];
    sp = s_span[warp][r];
#pragma unroll
    for (int i = 0; i < NW; ++i) nd[i] = s_need[warp][r][i];
    const int part = flat / g.R;
    const int work = pull_warp<Gt>(g.cols + part * g.E + sp.x, sp.y,
                                   Gt::table(g, part), nd, lane, s.chunk,
                                   found);
    if (lane == 0) Gt::store(g, flat, found, work);
  }
}

__host__ inline int rows_per_block(int cls) {
  return cls == kMedium ? kMediumRowsPerBlock
                        : cls == kShort ? kShortRowsPerBlock : kEmptyRowsPerBlock;
}

// Lays out the grid (long items, then medium, short and empty rows of each
// subgraph) and launches. Returns the launch's cudaError_t.
template <class Gt>
int launch_sweep(const Sweep* in, cudaStream_t stream) {
  Sweep s = *in;
  if (s.n_graphs < 1 || s.n_graphs > kMaxGraphs) return (int)cudaErrorInvalidValue;
  if (s.chunk <= 0) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  for (int gi = 0; gi < s.n_graphs; ++gi) {
    Graph& g = s.g[gi];
    int at = 0;
    for (int c = 0; c < 4; ++c) {
      g.start[c] = at;
      at += g.count[c];
    }
    blocks += g.count[kLong];
  }
  s.seg_start[0] = 0;
  s.seg_start[1] = blocks;
  for (int k = 1; k < kSegments; ++k) {
    const int cls = 1 + (k - 1) / kMaxGraphs, gi = (k - 1) % kMaxGraphs;
    const int n = gi < s.n_graphs ? s.g[gi].count[cls] : 0;
    const int per = rows_per_block(cls);
    blocks += (n + per - 1) / per;
    s.seg_start[k + 1] = blocks;
  }
  if (blocks == 0) return (int)cudaSuccess;
  pull_rows_kernel<Gt><<<blocks, kThreads, 0, stream>>>(s);
  return (int)cudaGetLastError();
}

}  // namespace pull
