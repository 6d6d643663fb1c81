// Lane-word pull with word-OR early exit: the multi-query bottom-up visit.
//
// Replaces: src/repro/kernels/ell_pull_multi.py::ell_pull_multi (the Pallas
// `_kernel`, pallas_call at line 60) together with the chunk-by-chunk
// lax.while_loop around it in src/repro/core/msbfs.py::_pull_rows_multi.
//
// The design, its bound and its exactness argument are in pull_rows.cuh;
// this file instantiates it with the word gather: nw (1..4) int32 lane
// words per vertex at frontier[c * nw], a row's need is its nw need words,
// found = (OR of the row's words) & need.
#include "pull_rows.cuh"

// One launch pulls the n_graphs (1..3) subgraphs of `*sweep` on `stream`,
// each with sweep->nw words per vertex. Returns the launch's cudaError_t
// (0 = launched). The caller owns every buffer; the kernel does not
// synchronise.
extern "C" int ell_pull_words_sweep(const pull::Sweep* sweep, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (sweep->nw) {
    case 1: return pull::launch_sweep<pull::WordGather<1>>(sweep, s);
    case 2: return pull::launch_sweep<pull::WordGather<2>>(sweep, s);
    case 3: return pull::launch_sweep<pull::WordGather<3>>(sweep, s);
    case 4: return pull::launch_sweep<pull::WordGather<4>>(sweep, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
