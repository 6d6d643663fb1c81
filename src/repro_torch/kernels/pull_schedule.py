"""Row schedule and launch of the two early-exit pulls (``ell_pull`` and
``ell_pull_multi``), which share one CUDA design (``csrc/pull_rows.cuh``).

Row lengths of a degree-separated partition span four orders of magnitude
(1 to 55,281 slots in the scale-20 dd subgraph), so the kernel gives each
row a group sized by its length: one lane to a short row (32 rows a
warp), a warp to a medium one, a block of 256 threads to a long one. :func:`build_schedule`
sorts the rows of a stacked CSR into those classes once, on the device
(``core.bfs.device_view`` keeps it in ``CSR.sched``); the only host read
is the four class counts, once per CSR. :func:`launch` then pulls one to
three subgraphs in one launch, long rows first across all of them.

The class limits are constants of the kernel design, not settings.
"""
from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass, field

import torch

from . import _build

#: row classes, in schedule order (``csrc/pull_rows.cuh``)
LONG, MEDIUM, SHORT, EMPTY = 0, 1, 2, 3
#: 1..SHORT_MAX slots: one lane a row (32 rows a warp), 16 / nw loads a
#: step
SHORT_MAX = 64
#: SHORT_MAX+1..MEDIUM_MAX slots: a warp a row (128 slots a step); longer
#: rows get a block (2,048 slots a step)
MEDIUM_MAX = 1024
MAX_GRAPHS = 3          # subgraphs one launch pulls (a sweep's three)


def row_class(length):
    """Class of rows of ``length`` slots (a tensor or an int)."""
    if isinstance(length, int):
        return (EMPTY if length == 0 else SHORT if length <= SHORT_MAX
                else MEDIUM if length <= MEDIUM_MAX else LONG)
    return torch.where(length == 0, EMPTY,
                       torch.where(length <= SHORT_MAX, SHORT,
                                   torch.where(length <= MEDIUM_MAX, MEDIUM,
                                               LONG)))


@dataclass(eq=False)
class PullSchedule:
    """The rows of a stacked CSR ``[p, R+1]`` by class.

    ``order [p*R]`` int32 holds flat row ids ``k*R + r``: the long rows,
    longest first, then the medium, short and empty rows, each class in
    flat-id order. ``span [p*R, 2]`` int32 holds, position by position,
    the row's first slot in its partition's columns and its length.
    ``long_len`` holds the long rows' lengths in order; ``counts`` the
    rows of each class (host ints)."""

    order: torch.Tensor
    span: torch.Tensor
    long_len: torch.Tensor
    counts: tuple
    #: launch structs prepared for this schedule and the others of a
    #: launch (see launch)
    prepared: dict = field(default_factory=dict, repr=False)


def _check_size(p: int, r: int) -> None:
    if p * r >= 2**29:
        raise ValueError(f"pull schedule: {p} x {r} rows; a long work item "
                         "packs position * 4 + graph into an int32")


def build_schedule(offsets: torch.Tensor) -> PullSchedule:
    """The schedule of a stacked CSR's ``offsets [p, R+1]``, built on their
    device (one host read: the class counts)."""
    p, r1 = offsets.shape
    _check_size(p, r1 - 1)
    deg = (offsets[:, 1:] - offsets[:, :-1]).reshape(-1).long()
    cls = row_class(deg)
    key = (cls << 32) + torch.where(cls == LONG, 2**31 - 1 - deg, 0)
    order = torch.argsort(key, stable=True)
    counts = tuple(int(c) for c in torch.bincount(cls, minlength=4).tolist())
    span = torch.stack([offsets[:, :-1].reshape(-1)[order], deg[order]], 1)
    return PullSchedule(order=order.to(torch.int32),
                        span=span.to(torch.int32).contiguous(),
                        long_len=deg[order[: counts[LONG]]].to(torch.int32),
                        counts=counts)


def uniform_schedule(p: int, r: int, length: int, device) -> PullSchedule:
    """The schedule of ``p * r`` rows of ``length`` slots each (the ELL
    contract), with no host read."""
    _check_size(p, r)
    counts = [0, 0, 0, 0]
    counts[row_class(int(length))] = p * r
    n_long = counts[LONG]
    rows = torch.arange(p * r, dtype=torch.int32, device=device)
    return PullSchedule(
        order=rows,
        span=torch.stack([(rows % max(r, 1)) * length,
                          torch.full_like(rows, length)], 1),
        long_len=torch.full((n_long,), length, dtype=torch.int32,
                            device=device),
        counts=tuple(counts))


def long_items(scheds) -> torch.Tensor:
    """The long rows of one launch's subgraphs as ``position * 4 +
    graph`` int32 (``position`` in that graph's schedule), longest first
    across all of them, built on the device."""
    parts = [torch.arange(s.counts[LONG], dtype=torch.int32,
                          device=s.order.device) * 4 + i
             for i, s in enumerate(scheds)]
    items = torch.cat(parts)
    if len(scheds) > 1:
        lens = torch.cat([s.long_len for s in scheds])
        items = items[torch.argsort(-lens.long(), stable=True)]
    return items


class Graph(ctypes.Structure):
    """``pull::Graph`` of ``csrc/pull_rows.cuh``."""

    _fields_ = [("offsets", ctypes.c_void_p), ("cols", ctypes.c_void_p),
                ("order", ctypes.c_void_p), ("span", ctypes.c_void_p),
                ("frontier", ctypes.c_void_p), ("need", ctypes.c_void_p),
                ("found", ctypes.c_void_p), ("work", ctypes.c_void_p),
                ("E", ctypes.c_longlong), ("R", ctypes.c_int),
                ("N", ctypes.c_int), ("count", ctypes.c_int * 4),
                ("start", ctypes.c_int * 4)]


class Sweep(ctypes.Structure):
    """``pull::Sweep`` of ``csrc/pull_rows.cuh`` (the kernel lays out
    ``start`` and ``seg_start`` itself)."""

    _fields_ = [("g", Graph * MAX_GRAPHS), ("long_items", ctypes.c_void_p),
                ("n_graphs", ctypes.c_int), ("chunk", ctypes.c_int),
                ("nw", ctypes.c_int),
                ("seg_start", ctypes.c_int * (2 + 3 * MAX_GRAPHS))]


ARGTYPES = (ctypes.POINTER(Sweep), ctypes.c_void_p)


class _Prepared:
    """A launch's struct with the fields that stay from call to call (the
    CSRs, their schedules, the merged long list) set once."""

    def __init__(self, what, graphs):
        self.graphs = graphs                  # keeps the ids of the key alive
        self.dev = _build.require(
            what, torch.int32, ("offsets", "cols", "order", "span") * len(graphs),
            *(t for o, c, sc in graphs for t in (o, c, sc.order, sc.span)))
        self.items = long_items([sc for _, _, sc in graphs])
        self.sweep = s = Sweep()
        s.n_graphs = len(graphs)
        s.long_items = self.items.data_ptr()
        for g, (offsets, cols, sched) in zip(s.g, graphs):
            g.offsets, g.cols = offsets.data_ptr(), cols.data_ptr()
            g.order, g.span = sched.order.data_ptr(), sched.span.data_ptr()
            g.E, g.R = cols.shape[1], offsets.shape[1] - 1
            g.count[:] = sched.counts
        self.ref = ctypes.byref(s)
        self.lock = threading.Lock()        # one struct serves every call


def launch(what: str, entry: str, graphs, fronts, needs, outs, chunk: int,
           nw: int, n_rows) -> None:
    """One launch of ``csrc/<what>.cu``'s ``entry`` over one to three
    subgraphs: ``graphs`` holds ``(offsets, cols, sched)``, ``fronts`` /
    ``needs`` / ``outs`` (found, work) the per-call tensors, ``n_rows`` the
    frontier's rows per partition (mask words for the bit gather). The
    caller has checked the per-call tensors; the CSRs and schedules are
    checked once, when their struct is prepared (they must not change
    afterwards). Raises if the launch fails. One struct per tuple of CSRs
    serves every call, filled and launched under its lock."""
    key = (what,) + tuple(id(t) for gr in graphs for t in gr)
    prep = graphs[0][2].prepared.get(key)
    if prep is None:
        prep = graphs[0][2].prepared[key] = _Prepared(what, graphs)
    dev = _build.require(what, torch.int32, ("frontier", "need") * len(fronts),
                         *(t for pair in zip(fronts, needs) for t in pair))
    if dev != prep.dev:
        raise ValueError(f"{what}: frontier and need on cuda:{dev}, the CSRs "
                         f"on cuda:{prep.dev}")
    fn = _build.function(what, entry, ARGTYPES)
    with prep.lock:
        s = prep.sweep
        for g, f, n, (found, work), rows in zip(s.g, fronts, needs, outs,
                                                n_rows):
            g.frontier, g.need = f.data_ptr(), n.data_ptr()
            g.found, g.work = found.data_ptr(), work.data_ptr()
            g.N = rows
        s.chunk, s.nw = chunk, nw
        _build.launch(what, fn, dev, prep.ref)
