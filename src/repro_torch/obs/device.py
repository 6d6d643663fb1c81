"""Device-plane telemetry harvest: per-sweep, per-shard traversal sensors.

The sweeps accumulate their telemetry on the device
(``MSBFSConfig(telemetry=True)`` / ``BFSConfig(telemetry=True)`` carry the
``tm_*`` leaves through the state, see ``core/msbfs.py``); this module is
the host side: :func:`harvest_telemetry` reads a *finished* traversal
state into a :class:`SweepTelemetry` snapshot, and
:func:`export_shard_metrics` turns it into the ``shard``-labelled gauges
and histograms of the registry.

No device sync of its own: the engine harvests only where it already
reads the state on the host (batch completion, session close), in one
copy of the leaves it needs, and the leaves belong to a finished
traversal -- the harvest can never change the schedule or any
``ServeStats`` counter.

Per-shard series live under ``device.shard.<i>.*``
(:func:`~repro_torch.obs.metrics.shard_metric`), cross-shard skew under
plain ``device.*`` gauges. Skew is ``max / mean`` across shards: 1.0 is
balanced.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from .metrics import BYTES_BUCKETS, RATIO_BUCKETS, shard_metric

#: the leaves a harvest reads, in the order they are copied
_LEAVES = ("it", "tm_frontier_n", "tm_frontier_d", "tm_backward",
           "wire_delegate", "wire_nn", "nn_sparse", "nn_overflow")


@dataclass
class SweepTelemetry:
    """Host-side (numpy) snapshot of one finished traversal's telemetry.

    ``S`` below is the state's ``max_iters`` slot count; refill sessions
    running past it accumulate into the last slot (the wire-counter
    convention), so *sums* over the sweep axis stay exact even then.
    ``frontier_d`` content is replicated across shards (delegates are
    global); ``frontier_n``, the wire splits and ``nn_overflow`` are
    per shard. ``dir_backward`` is the per-sweep direction record: packed
    ``[p, S, 3, n_words]`` uint32 lane words for msBFS (the state's int32
    bit patterns), a ``[p, S]`` int32 bitmask (bits 1/2/4 = dd/dn/nd
    pulled) for single-source BFS.
    """

    sweeps: int               # executed sweep count (device `it`)
    frontier_n: np.ndarray    # [p, S] int32
    frontier_d: np.ndarray    # [p, S] int32 (replicated content)
    dir_backward: np.ndarray  # [p, S, 3, nw] uint32 | [p, S] int32
    wire_delegate: np.ndarray  # [p, S] int32 bytes
    wire_nn: np.ndarray        # [p, S] int32 bytes
    nn_sparse: np.ndarray      # [S] int32 (global decision, row 0)
    nn_overflow: np.ndarray    # [p, S] int32

    @property
    def p(self) -> int:
        return self.frontier_n.shape[0]

    def shard_frontier(self) -> np.ndarray:
        """Per-shard total frontier work: [p] int64 (normal frontier only --
        the delegate frontier is replicated, so it carries no imbalance)."""
        return self.frontier_n.sum(axis=1, dtype=np.int64)

    def shard_wire_bytes(self) -> np.ndarray:
        """Per-shard total wire bytes (delegate + nn): [p] int64."""
        return (self.wire_delegate.sum(axis=1, dtype=np.int64)
                + self.wire_nn.sum(axis=1, dtype=np.int64))


def skew(per_shard) -> float:
    """max/mean imbalance of a per-shard series (1.0 = balanced; 0.0 for
    an all-zero series, where imbalance is meaningless)."""
    x = np.asarray(per_shard, dtype=np.float64)
    m = x.mean() if x.size else 0.0
    return float(x.max() / m) if m > 0 else 0.0


def harvest_telemetry(state: Any, mesh=None) -> SweepTelemetry | None:
    """Read a finished traversal state's telemetry on the host.

    Returns ``None`` when the state was built without telemetry (the
    ``tm_*`` leaves are zero-width; known from the shape, without a read)
    or has no telemetry leaves at all. Works for ``MSBFSState`` and
    ``BFSState`` alike (the shared field names). The leaves go to the host
    in one copy; a sharded state (``mesh``, one partition per rank) first
    all-gathers them, so every rank gets every shard's rows -- every rank
    must call it alike.
    """
    tm = getattr(state, "tm_frontier_n", None)
    if tm is None or tm.shape[-1] == 0:
        return None
    parts = [getattr(state, k) for k in _LEAVES]
    flat = torch.cat([x.reshape(-1).to(torch.int32) for x in parts])
    if mesh is not None:
        from repro_torch.core.comm import dist

        flat = dist.all_gather(mesh, flat)
    host = flat.cpu().numpy().reshape(flat.shape[0] if mesh is not None
                                      else 1, -1)
    out, at = {}, 0
    for k, x in zip(_LEAVES, parts):
        n = x.numel()
        # a rank's rows, stacked in rank (= partition) order
        out[k] = host[:, at:at + n].reshape(-1, *x.shape[1:])
        at += n
    back = out["tm_backward"]
    if back.ndim == 4:                   # msBFS lane words: uint32 patterns
        back = back.view(np.uint32)
    return SweepTelemetry(
        sweeps=int(out["it"].reshape(-1)[0]),
        frontier_n=out["tm_frontier_n"],
        frontier_d=out["tm_frontier_d"],
        dir_backward=back,
        wire_delegate=out["wire_delegate"],
        wire_nn=out["wire_nn"],
        nn_sparse=out["nn_sparse"][0],
        nn_overflow=out["nn_overflow"],
    )


def export_shard_metrics(obs, tel: SweepTelemetry) -> None:
    """Mirror one traversal's telemetry into the metrics registry.

    Per shard ``i``: ``device.shard.<i>.frontier_total`` /
    ``device.shard.<i>.wire_bytes`` gauges (this traversal's totals) and a
    ``device.shard.<i>.frontier_per_sweep`` histogram fed the executed
    sweeps' frontier popcounts. Cross-shard: ``device.frontier_skew`` /
    ``device.wire_skew`` last-traversal gauges plus ``device.*_skew_dist``
    histograms (one sample per traversal), and ``device.sweeps`` /
    ``device.nn_sparse_sweeps``.
    """
    if obs is None or not obs.enabled:
        return
    m = obs.metrics
    n_exec = min(tel.sweeps, tel.frontier_n.shape[1])
    ftot = tel.shard_frontier()
    wtot = tel.shard_wire_bytes()
    for i in range(tel.p):
        m.gauge(shard_metric(i, "frontier_total")).set(int(ftot[i]))
        m.gauge(shard_metric(i, "wire_bytes")).set(int(wtot[i]))
        h = m.histogram(shard_metric(i, "frontier_per_sweep"), BYTES_BUCKETS)
        for v in tel.frontier_n[i, :n_exec]:
            h.record(int(v))
    f_skew, w_skew = skew(ftot), skew(wtot)
    m.gauge("device.frontier_skew").set(f_skew)
    m.gauge("device.wire_skew").set(w_skew)
    m.histogram("device.frontier_skew_dist", RATIO_BUCKETS).record(f_skew)
    m.histogram("device.wire_skew_dist", RATIO_BUCKETS).record(w_skew)
    m.gauge("device.sweeps").set(tel.sweeps)
    m.gauge("device.nn_sparse_sweeps").set(int(tel.nn_sparse.sum()))
