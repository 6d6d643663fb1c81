// Single-source bit pull with early exit, fused with the chunk loop.
//
// Replaces: src/repro/kernels/ell_pull.py::ell_pull (the Pallas `_kernel`,
// pallas_call at line 54) together with the chunk-by-chunk lax.while_loop
// around the pull in src/repro/core/bfs.py::_pull_rows.
//
// Computes, for every row r of every stacked partition k:
//     found = active[k][r] == 1 and some parent u of r, in the chunks
//             entered, has bit (u & 31) of word (u >> 5) of mask[k] set
//     work  = in-row parent slots of every chunk entered
// A row enters chunk c only while it is active, has found no frontier
// parent, and c*chunk < degree: exactly the per-row condition of
// _pull_rows, so `work` counts the slots after the hit in the hit's chunk
// too and reproduces the reference's work_bwd counter bit for bit. Columns
// < 0 are skipped (the ELL contract's -1 padding); CSR columns are never
// negative.
//
// What bounds it on an H100: memory. Per entered slot it reads one 4-byte
// column id (coalesced, 128 bytes per warp per 32 slots) and one 4-byte mask
// word at random; there is no arithmetic to speak of. The frontier mask of
// the main path is ceil(N/32) words (8 KB for the delegates, 64 KB for the
// normals of one partition at scale 20), so its words stay in L1/L2 and
// device memory sees the column stream plus the per-row words.
//
// Design: one warp per row, the grid over all p*R rows (one launch pulls
// one subgraph for every emulated partition). The TPU kernel holds a
// degree-bucketed [TR, W] tile and the whole mask in VMEM and ORs a full
// row; here the early exit is the point: the lanes stride the chunk's
// slots, __any_sync tells the warp whether the chunk held a hit, and the
// warp stops before the next chunk. The chunk's slot count is added
// arithmetically. Row state is uniform across the warp, so the loop never
// diverges inside it. Rows shorter than 32 leave lanes idle; packing
// several short rows per warp, or the mask in shared memory, is later work.
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ell_pull_bits_kernel(const int* __restrict__ offsets,      // [p, R+1]
                     const int* __restrict__ cols,         // [p, E]
                     const unsigned* __restrict__ mask,    // [p, NWm]
                     const int* __restrict__ active,       // [p, R]
                     int* __restrict__ found,              // [p, R]
                     int* __restrict__ work,               // [p, R]
                     long long rows, int R, long long E, int NWm, int chunk) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform per warp
  const long long part = row / R;
  const long long r = row - part * R;
  int hit = 0;
  int slots = 0;
  if (active[row] == 1) {
    const int* off = offsets + part * (R + 1);
    const int start = off[r];
    const int end = off[r + 1];
    const int* pcols = cols + part * E;
    const unsigned* pmask = mask + part * (long long)NWm;
    for (int base = start; base < end && !hit; base += chunk) {
      const int stop = min(base + chunk, end);
      unsigned mine = 0u;
      for (int j = base + lane; j < stop; j += 32) {
        const int c = pcols[j];
        if (c >= 0) mine |= (pmask[c >> 5] >> (c & 31)) & 1u;
      }
      hit = __any_sync(0xffffffffu, mine != 0u);
      slots += stop - base;
    }
  }
  if (lane == 0) {
    found[row] = hit ? 1 : 0;
    work[row] = slots;
  }
}

}  // namespace

// Returns the launch's cudaError_t (0 = launched). The caller owns every
// buffer; the kernel runs on `stream` and does not synchronise.
extern "C" int ell_pull_bits(const void* offsets, const void* cols,
                             const void* mask, const void* active,
                             void* found, void* work, int p, int R,
                             long long E, int NWm, int chunk, void* stream) {
  const long long rows = (long long)p * R;
  if (rows == 0) return (int)cudaSuccess;
  if (chunk <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  ell_pull_bits_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(offsets), static_cast<const int*>(cols),
      static_cast<const unsigned*>(mask), static_cast<const int*>(active),
      static_cast<int*>(found), static_cast<int*>(work), rows, R, E, NWm,
      chunk);
  return (int)cudaGetLastError();
}
