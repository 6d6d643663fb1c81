"""Plain PyTorch oracle of the ELL-contract pull, under the reference
package's ``repro.kernels.ref`` name: written directly over the ``[R, K]``
tile, independent of the chunked plain version the wrapper runs on the
CPU. Words are int32 bit patterns."""
from __future__ import annotations

import torch

from .mask_reduce import or_fold


def ell_pull_multi_ref(parents: torch.Tensor, frontier_words: torch.Tensor,
                       active_words: torch.Tensor) -> torch.Tensor:
    """Lane-word pull over an ELL tile: OR of the valid (>= 0) parents'
    frontier words, masked by ``active``."""
    valid = parents >= 0
    w = frontier_words[parents.clamp(min=0).long()]       # [R, K, NW]
    w = torch.where(valid[..., None], w, 0)
    return or_fold(w, 1) & active_words
