"""Synthetic integer edge weights for the weighted-traversal query kinds.

The partitioned graph carries no weights; a weighted SSSP lane hashes each
edge's endpoint global ids into a weight instead, symmetrically (the hash
combines the endpoints through their sum and xor), so ``w(u, v) ==
w(v, u)`` and the weighted graph stays undirected. Weights are in ``[1,
SSSP_WMAX]``, equal to the reference package's hash bit for bit.

The hash is uint32 arithmetic with wraparound and logical right shifts.
PyTorch has no usable uint32 arithmetic on CUDA, so the tensor form runs
in int64 and keeps the low 32 bits with ``& 0xFFFFFFFF`` after every
multiply and before every shift: a product of two 32-bit values may pass
the int64 maximum, but its low 32 bits are still right once masked. The
numpy form (for host arrays, the oracle's) runs in uint32 as the
reference does.
"""
from __future__ import annotations

import numpy as np
import torch

# weight range and the delta-stepping bucket width used by the serving
# layer; delta divides the range so each bucket holds a few weight steps
SSSP_WMAX = 15
SSSP_DELTA = 4

_M32 = 0xFFFFFFFF
_K1, _K2, _K3, _K4 = 0x9E3779B1, 0x85EBCA77, 0x2C1B3C6D, 0x297A2D39


def _weights_numpy(u, v) -> np.ndarray:
    a = np.asarray(u).astype(np.uint32)
    b = np.asarray(v).astype(np.uint32)
    with np.errstate(over="ignore"):   # uint32 wraparound is the hash
        h = (a + b) * np.uint32(_K1) ^ (a ^ b) * np.uint32(_K2)
        h = h ^ (h >> 15)
        h = h * np.uint32(_K3)
        h = h ^ (h >> 12)
        h = h * np.uint32(_K4)
        h = h ^ (h >> 15)
        return (h % np.uint32(SSSP_WMAX)).astype(np.int32) + 1


def _weights_torch(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    a = u.to(torch.int64) & _M32          # the uint32 value of the id
    b = v.to(torch.int64) & _M32
    h = ((((a + b) & _M32) * _K1) & _M32) ^ (((a ^ b) * _K2) & _M32)
    h = h ^ (h >> 15)
    h = (h * _K3) & _M32
    h = h ^ (h >> 12)
    h = (h * _K4) & _M32
    h = h ^ (h >> 15)
    return (h % SSSP_WMAX).to(torch.int32) + 1


def edge_weights(u, v):
    """Symmetric deterministic weight in ``[1, SSSP_WMAX]`` per edge.

    ``u`` / ``v`` are integer endpoint *global* ids: tensors (on any
    device; the result is an int32 tensor there) or numpy arrays (an int32
    array), broadcast against each other."""
    if isinstance(u, torch.Tensor) or isinstance(v, torch.Tensor):
        dev = u.device if isinstance(u, torch.Tensor) else v.device
        return _weights_torch(torch.as_tensor(u, device=dev),
                              torch.as_tensor(v, device=dev))
    return _weights_numpy(u, v)
