"""Communication subsystem (paper Section V) over the emulated partition
axis.

Two classes of traffic, exactly as the paper prescribes:

* **delegates** -- visited status combined with a global bitwise-OR
  reduction (all-gather + the ``mask_reduce`` fold kernel, :mod:`.reduce`);
* **normal vertices** -- newly visited vertices of cutting nn edges
  exchanged point-to-point over the static slot plan (:mod:`.exchange`).

:mod:`.base` holds the strategy config and the wire-byte formulas,
:mod:`.wire` the lane-word packing that is the wire format itself.
"""
from .base import (
    COMBINE_SPECS,
    DELEGATE_STRATEGIES,
    NN_FORMATS,
    CombineSpec,
    CommConfig,
    CommPlan,
    plan_for,
)
from .exchange import nn_exchange_words
from .reduce import delegate_combine, lane_any_reduce
from .wire import n_words, pack_lanes, unpack_lanes

__all__ = [
    "COMBINE_SPECS", "DELEGATE_STRATEGIES", "NN_FORMATS", "CombineSpec",
    "CommConfig", "CommPlan", "delegate_combine", "lane_any_reduce",
    "n_words", "nn_exchange_words", "pack_lanes", "plan_for",
    "unpack_lanes",
]
