// Single-source bit pull with early exit: the paper's backward visit.
//
// Replaces: src/repro/kernels/ell_pull.py::ell_pull (the Pallas `_kernel`,
// pallas_call at line 54) together with the chunk-by-chunk lax.while_loop
// around the pull in src/repro/core/bfs.py::_pull_rows.
//
// The design, its bound and its exactness argument are in pull_rows.cuh;
// this file instantiates it with the bit gather (a vertex's word is bit
// (c & 31) of mask[c >> 5], a row's need is active == 1; found is 0/1).
#include "pull_rows.cuh"

// One launch pulls the n_graphs (1..3) subgraphs of `*sweep` on `stream`.
// Returns the launch's cudaError_t (0 = launched). The caller owns every
// buffer; the kernel does not synchronise.
extern "C" int ell_pull_bits_sweep(const pull::Sweep* sweep, void* stream) {
  return pull::launch_sweep<pull::BitGather>(
      sweep, static_cast<cudaStream_t>(stream));
}
