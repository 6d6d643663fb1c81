"""Communication subsystem (paper Section V) over the emulated partition
axis or a ``torch.distributed`` mesh (:mod:`.dist`).

Two classes of traffic, exactly as the paper prescribes:

* **delegates** -- visited status combined with a global bitwise-OR
  reduction (all-gather + the ``mask_reduce`` fold kernel), or, on the
  single-source path and the payload plane, values with a min reduction
  (:mod:`.reduce`);
* **normal vertices** -- newly visited vertices (or the payload plane's
  per-slot minimums) of cutting nn edges exchanged point-to-point, over
  the static slot plan or in runtime-binned id lists (:mod:`.exchange`).

:mod:`.base` holds the strategy config and the wire-byte formulas,
:mod:`.wire` the lane-word packing that is the wire format itself,
:mod:`.codec` the compressed nn format's varint streams and their exact
byte counts.
"""
from . import codec, dist
from .base import (
    COMBINE_SPECS,
    DELEGATE_STRATEGIES,
    NN_FORMATS,
    CombineSpec,
    CommConfig,
    CommPlan,
    plan_for,
)
from .codec import (compressed_wire_bytes, delta_decode_ids,
                    delta_encode_ids, delta_stream_bytes, rle_decode,
                    rle_encode, rle_stream_bytes)
from .exchange import (bin_by_owner, exchange_normal, exchange_payload,
                       exchange_values, exchange_words, nn_exchange_bits,
                       nn_exchange_payload, nn_exchange_words)
from .reduce import (any_reduce, delegate_allreduce_min,
                     delegate_allreduce_or, delegate_allreduce_sum,
                     delegate_combine, delegate_min_apply, delegate_or_apply,
                     lane_any_reduce, lane_fold_reduce)
from .wire import n_words, pack_lanes, unpack_lanes

__all__ = [
    "COMBINE_SPECS", "DELEGATE_STRATEGIES", "NN_FORMATS", "CombineSpec",
    "CommConfig", "CommPlan", "any_reduce", "bin_by_owner", "codec",
    "compressed_wire_bytes", "delegate_allreduce_min",
    "delegate_allreduce_or", "delegate_allreduce_sum", "delegate_combine",
    "delegate_min_apply", "delegate_or_apply", "delta_decode_ids",
    "delta_encode_ids", "delta_stream_bytes", "dist", "exchange_normal",
    "exchange_payload", "exchange_values", "exchange_words",
    "lane_any_reduce", "lane_fold_reduce", "n_words", "nn_exchange_bits",
    "nn_exchange_payload", "nn_exchange_words", "pack_lanes", "plan_for",
    "rle_decode", "rle_encode", "rle_stream_bytes", "unpack_lanes",
]
