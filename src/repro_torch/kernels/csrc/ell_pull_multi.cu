// Lane-word pull with word-OR early exit, fused with the chunk loop.
//
// Replaces: src/repro/kernels/ell_pull_multi.py::ell_pull_multi (the Pallas
// `_kernel`, pallas_call at line 60) together with the chunk-by-chunk
// lax.while_loop around it in src/repro/core/msbfs.py::_pull_rows_multi.
//
// Computes, for every row r of every stacked partition k:
//     acc   = OR over the parents u of r, chunk by chunk, of frontier[k][u]
//     found = acc & need[k][r]
//     work  = valid parent slots of every chunk entered
// A row enters chunk c only while (need & ~acc) != 0 and c*chunk < degree:
// exactly the per-row condition of _pull_rows_multi, so `work` reproduces
// the reference's work_bwd counter bit for bit. Columns < 0 are skipped
// (the ELL contract's -1 padding); CSR columns are never negative.
//
// What bounds it on an H100: memory. Per entered slot it reads one 4-byte
// column id (coalesced, 128 bytes per warp per chunk of 32) and gathers
// nw 4-byte frontier words at random; there is no arithmetic to speak of.
// The frontier tables of the main path (d x nw and n_local x nw words,
// 0.24 MB and 2 MB at scale 20) sit in the 50 MB L2, so the gathers mostly
// hit L2 and device memory sees the column stream plus the row words.
//
// Design: one warp per row, the grid over all p*R rows (one launch pulls
// one subgraph for every emulated partition). The TPU kernel keeps the
// whole frontier table in VMEM and unrolls the OR over a fixed row width;
// here the early exit is the point: each lane ORs its slots of the chunk,
// __reduce_or_sync combines the 32 lanes, and the warp tests its need word
// before the next chunk, so satisfied rows stop reading columns. The warp
// state is uniform, so the loop never diverges inside a warp. nw (lane
// words per vertex) is a template parameter so the accumulators stay in
// registers.
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <int NW>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ell_pull_chunked_kernel(const int* __restrict__ offsets,   // [p, R+1]
                        const int* __restrict__ cols,      // [p, E]
                        const int* __restrict__ frontier,  // [p, N, NW]
                        const int* __restrict__ need,      // [p, R, NW]
                        int* __restrict__ found,           // [p, R, NW]
                        int* __restrict__ work,            // [p, R]
                        int p, int R, long long E, int N, int chunk) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= (long long)p * R) return;  // uniform per warp
  const long long part = row / R;
  const long long r = row - part * R;
  const int* off = offsets + part * (R + 1);
  const int start = off[r];
  const int end = off[r + 1];
  const int* pcols = cols + part * E;
  const int* pfront = frontier + part * (long long)N * NW;

  unsigned nd[NW], acc[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    nd[w] = (unsigned)need[row * NW + w];
    acc[w] = 0u;
  }
  int slots = 0;
  for (int base = start; base < end; base += chunk) {
    unsigned unsat = 0u;
#pragma unroll
    for (int w = 0; w < NW; ++w) unsat |= nd[w] & ~acc[w];
    if (unsat == 0u) break;
    const int stop = min(base + chunk, end);
    unsigned mine[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) mine[w] = 0u;
    for (int j = base + lane; j < stop; j += 32) {
      const int c = pcols[j];
      if (c >= 0) {
        const int* fw = pfront + (long long)c * NW;
#pragma unroll
        for (int w = 0; w < NW; ++w) mine[w] |= (unsigned)fw[w];
      }
    }
#pragma unroll
    for (int w = 0; w < NW; ++w)
      acc[w] |= __reduce_or_sync(0xffffffffu, mine[w]);
    slots += stop - base;
  }
  if (lane == 0) {
#pragma unroll
    for (int w = 0; w < NW; ++w) found[row * NW + w] = (int)(acc[w] & nd[w]);
    work[row] = slots;
  }
}

template <int NW>
cudaError_t launch(const int* offsets, const int* cols, const int* frontier,
                   const int* need, int* found, int* work, int p, int R,
                   long long E, int N, int chunk, cudaStream_t stream) {
  const long long rows = (long long)p * R;
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  ell_pull_chunked_kernel<NW><<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                                stream>>>(offsets, cols, frontier, need,
                                          found, work, p, R, E, N, chunk);
  return cudaGetLastError();
}

}  // namespace

// Returns the launch's cudaError_t (0 = launched). The caller owns every
// buffer; the kernel runs on `stream` and does not synchronise.
extern "C" int ell_pull_chunked(const void* offsets, const void* cols,
                                const void* frontier, const void* need,
                                void* found, void* work, int p, int R,
                                long long E, int N, int nw, int chunk,
                                void* stream) {
  if ((long long)p * R == 0) return (int)cudaSuccess;
  if (chunk <= 0) return (int)cudaErrorInvalidValue;
  const int* o = static_cast<const int*>(offsets);
  const int* c = static_cast<const int*>(cols);
  const int* f = static_cast<const int*>(frontier);
  const int* n = static_cast<const int*>(need);
  int* fo = static_cast<int*>(found);
  int* wk = static_cast<int*>(work);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nw) {
    case 1: return (int)launch<1>(o, c, f, n, fo, wk, p, R, E, N, chunk, s);
    case 2: return (int)launch<2>(o, c, f, n, fo, wk, p, R, E, N, chunk, s);
    case 3: return (int)launch<3>(o, c, f, n, fo, wk, p, R, E, N, chunk, s);
    case 4: return (int)launch<4>(o, c, f, n, fo, wk, p, R, E, N, chunk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
