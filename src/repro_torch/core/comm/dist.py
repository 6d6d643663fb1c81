"""The ``torch.distributed`` backend: one graph partition per process.

The emulated backend stacks every partition on the leading axis of one
device's tensors. Here each process (rank) holds one partition -- its
tensors keep a leading axis of 1 -- and the collectives run over a
process group: ``gloo`` on the CPU, ``nccl`` on cards (``gloo`` also
carries CUDA tensors for the collectives it implements for them).

* :class:`PartitionMesh` lays the world's ranks out over named axes
  (for example ``("rank", "gpu")`` of sizes ``(p_rank, p_gpu)``); rank
  ``r`` owns partition ``r``, the row-major index of its coordinates, as a
  partition spec over those axes splits the leading dimension. It holds
  one process subgroup per group of axes (every rank creates them in the
  same order), so a strategy can reduce over one axis (ring) or a group of
  axes (hierarchical) as well as over the world.
* The collectives the port uses: :func:`all_gather`, :func:`all_to_all`
  (and its variable-split form :func:`all_to_all_v`),
  :func:`all_reduce` (``"max"`` / ``"min"`` / ``"sum"``) and
  :func:`ppermute` (the ring's hop: an ``all_to_all_single`` whose split
  sizes are non-zero only for the neighbours, so the wire carries exactly
  the ring's chunk, on ``gloo`` and ``nccl`` alike). There is no OR
  reduction: neither NCCL nor the emulated backend has one, so the OR
  combine stays an all-gather and the ``mask_reduce`` fold everywhere.
* :class:`AllToAll` / :class:`AllToAllV` are the all-to-alls that
  autograd differentiates (the reverse all-to-all); the delegate sum's
  counterpart is :func:`repro_torch.core.comm.reduce.delegate_allreduce_sum`.
* Tensor parallelism's operators over a group of axes:
  :class:`CopyToGroup` (identity forward, all-reduce backward),
  :class:`ReduceFromGroup` (all-reduce forward, identity backward) and
  :class:`GatherFromGroup` (FSDP: all-gather forward, reduce-scatter
  backward), each adding the bytes it sends to a tally.
* :func:`spawn` starts a world of processes on one host with a ``file://``
  rendezvous under a fresh temporary directory and a hard timeout: a rank
  that hangs or fails fails the call, and every process is stopped.
"""
from __future__ import annotations

import itertools
import math
import multiprocessing as mp
import os
import queue as _queue
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Callable, Sequence

import torch
import torch.distributed as dist


class PartitionMesh:
    """The world's ranks over named axes, with a subgroup per axis group.

    Must be built by every rank of an initialised default process group,
    in the same order relative to other group creations; the product of
    ``sizes`` must equal the world size. ``backend``: the backend whose
    code paths the collectives take (default the process group's; the
    dry run's ``fake`` group takes NCCL's, ``launch.dryrun``)."""

    def __init__(self, axes: Sequence[str], sizes: Sequence[int],
                 backend: str | None = None):
        if not dist.is_initialized():
            raise RuntimeError("PartitionMesh needs an initialised process "
                               "group (torch.distributed.init_process_group)")
        self.axes, self.sizes = tuple(axes), tuple(int(s) for s in sizes)
        if len(self.axes) != len(self.sizes) or len(set(self.axes)) != len(
                self.axes):
            raise ValueError(f"axes {axes} and sizes {sizes} do not match")
        self.world = dist.get_world_size()
        if math.prod(self.sizes) != self.world:
            raise ValueError(f"mesh {dict(zip(self.axes, self.sizes))} spans "
                             f"{math.prod(self.sizes)} ranks, world has "
                             f"{self.world}")
        self.rank = dist.get_rank()
        self.backend = backend or dist.get_backend()
        self.coords = _unravel(self.rank, self.sizes)
        # one subgroup per non-empty set of axes, created by every rank in
        # the same order (a rank creates the groups it is not in as well)
        self._groups: dict = {}
        for n in range(1, len(self.axes) + 1):
            for sub in itertools.combinations(range(len(self.axes)), n):
                names = tuple(self.axes[i] for i in sub)
                if n == len(self.axes):
                    self._groups[names] = (None, list(range(self.world)))
                    continue
                rest = [i for i in range(len(self.axes)) if i not in sub]
                mine = None
                for other in itertools.product(*(range(self.sizes[i])
                                                  for i in rest)):
                    ranks = []
                    for pos in itertools.product(*(range(self.sizes[i])
                                                   for i in sub)):
                        c = [0] * len(self.axes)
                        for i, v in zip(rest, other):
                            c[i] = v
                        for i, v in zip(sub, pos):
                            c[i] = v
                        ranks.append(_ravel(c, self.sizes))
                    g = dist.new_group(ranks)
                    if self.rank in ranks:
                        mine = (g, ranks)
                self._groups[names] = mine

    @property
    def p(self) -> int:
        return self.world

    def _key(self, axes) -> tuple:
        axes = self.axes if axes is None else (
            (axes,) if isinstance(axes, str) else tuple(axes))
        # a group is named by its axes in the mesh's order
        key = tuple(a for a in self.axes if a in axes)
        if len(key) != len(axes):
            raise ValueError(f"axes {axes} not all in the mesh {self.axes}")
        return key

    def group(self, axes=None):
        """This rank's process group over ``axes`` (None: the world)."""
        return self._groups[self._key(axes)][0]

    def size(self, axes=None) -> int:
        return len(self._groups[self._key(axes)][1])

    def members(self, axes=None) -> list:
        """The world ranks of this rank's group over ``axes``, in group
        order."""
        return list(self._groups[self._key(axes)][1])

    def index(self, axes=None) -> int:
        """This rank's position in its group over ``axes`` (the row-major
        index of its coordinates on those axes)."""
        return self._groups[self._key(axes)][1].index(self.rank)

    def check_axes(self, partition_axes) -> None:
        """Partition axes (None: all) must be the mesh's axes in its order,
        so that rank ``r`` holds partition ``r``."""
        axes = (self.axes if partition_axes is None else
                ((partition_axes,) if isinstance(partition_axes, str)
                 else tuple(partition_axes)))
        if axes != self.axes:
            raise ValueError(f"partition axes {axes} must be the mesh's axes "
                             f"{self.axes}, in order")

    def __repr__(self) -> str:
        return (f"PartitionMesh({dict(zip(self.axes, self.sizes))}, "
                f"rank={self.rank}, backend={self.backend})")


def _ravel(coords, sizes) -> int:
    r = 0
    for c, s in zip(coords, sizes):
        r = r * s + c
    return r


def _unravel(r: int, sizes) -> tuple:
    out = []
    for s in reversed(sizes):
        out.append(r % s)
        r //= s
    return tuple(reversed(out))


# -----------------------------------------------------------------------------
# Collectives (bool tensors travel as uint8)


def _wire(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    return x.view(torch.uint8) if x.dtype == torch.bool else x


def _unwire(x: torch.Tensor, dtype) -> torch.Tensor:
    return x.view(torch.bool) if dtype == torch.bool else x


def all_gather(mesh: PartitionMesh, x: torch.Tensor, axes=None
               ) -> torch.Tensor:
    """Every member's ``x`` over the group of ``axes`` -> ``[K, *x.shape]``
    in group order."""
    k = mesh.size(axes)
    src = _wire(x)
    out = src.new_empty((k,) + tuple(src.shape))
    if mesh.backend == "nccl":
        dist.all_gather_into_tensor(out, src, group=mesh.group(axes))
    else:
        dist.all_gather(list(out.unbind(0)), src, group=mesh.group(axes))
    return _unwire(out, x.dtype)


def all_to_all(mesh: PartitionMesh, x: torch.Tensor, axes=None
               ) -> torch.Tensor:
    """``x [K, ...]``: row ``j`` goes to member ``j``; returns ``[K, ...]``
    whose row ``j`` came from member ``j``."""
    src = _wire(x)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=mesh.group(axes))
    return _unwire(out, x.dtype)


_OPS = {"max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
        "sum": dist.ReduceOp.SUM}


def all_reduce(mesh: PartitionMesh, x: torch.Tensor, op: str, axes=None
               ) -> torch.Tensor:
    """Elementwise ``op`` (``"max"``, ``"min"`` or ``"sum"``) of every
    member's ``x`` (bool travels as uint8) -> a new tensor."""
    out = _wire(x).clone()
    dist.all_reduce(out, op=_OPS[op], group=mesh.group(axes))
    return _unwire(out, x.dtype)


def ppermute(mesh: PartitionMesh, x: torch.Tensor, axis: str
             ) -> torch.Tensor:
    """One hop of the ring along ``axis``: member ``i`` sends ``x`` to
    member ``i + 1`` and receives member ``i - 1``'s (modulo the axis
    size). One ``all_to_all_single`` whose splits are non-zero only for the
    two neighbours."""
    k, i = mesh.size(axis), mesh.index(axis)
    src = _wire(x).reshape(-1)
    out = torch.empty_like(src)
    isz, osz = [0] * k, [0] * k
    isz[(i + 1) % k] = src.numel()
    osz[(i - 1) % k] = src.numel()
    dist.all_to_all_single(out, src, output_split_sizes=osz,
                           input_split_sizes=isz, group=mesh.group(axis))
    return _unwire(out.reshape(x.shape), x.dtype)


def all_to_all_v(mesh: PartitionMesh, x: torch.Tensor, send: Sequence[int],
                 recv: Sequence[int], tally: dict | None = None,
                 key: str = "", axes=None) -> torch.Tensor:
    """Variable-split all-to-all over the group of ``axes`` (None: the
    world), along the leading dimension: the first ``send[0]`` rows of
    ``x`` go to member 0, the next ``send[1]`` to member 1, ...; returns
    ``[sum(recv), ...]``, member ``j``'s rows in block ``j`` (``recv[j]``
    of them). The splits are host integers (a variable exchange needs its
    counts on the host before it starts). With ``tally``, ``tally[key]``
    grows by the bytes of ``x`` that leave this rank (the rows for the
    other members)."""
    src = _wire(x)
    send, recv = [int(c) for c in send], [int(c) for c in recv]
    if src.shape[0] != sum(send):
        raise ValueError(f"{src.shape[0]} rows to send, splits {send}")
    out = src.new_empty((sum(recv),) + tuple(src.shape[1:]))
    dist.all_to_all_single(out, src, output_split_sizes=recv,
                           input_split_sizes=send, group=mesh.group(axes))
    if tally is not None:
        row = math.prod(src.shape[1:]) * src.element_size()
        tally[key] = tally.get(key, 0) + (
            src.shape[0] - send[mesh.index(axes)]) * row
    return _unwire(out, x.dtype)


# -----------------------------------------------------------------------------
# Differentiable collectives (the transposes JAX gives ``psum`` and
# ``all_to_all``): the distributed training step's backward runs through
# them, one rank's ``backward()`` at a time in every rank.


class AllToAll(torch.autograd.Function):
    """:func:`all_to_all` whose backward is the reverse all-to-all (row
    ``j`` of the incoming gradient goes back to member ``j``): the same
    collective, since the exchange is its own inverse."""

    @staticmethod
    def forward(ctx, x, mesh, axes=None):
        ctx.mesh, ctx.axes = mesh, axes
        return all_to_all(mesh, x, axes)

    @staticmethod
    def backward(ctx, grad):
        return all_to_all(ctx.mesh, grad.contiguous(), ctx.axes), None, None


class AllToAllV(torch.autograd.Function):
    """:func:`all_to_all_v` whose backward is the reverse exchange: the
    gradient of each received row goes back to the rank that sent it
    (the splits swapped). ``tally`` counts the bytes each direction puts
    on the wire under ``keys`` (forward, backward)."""

    @staticmethod
    def forward(ctx, x, mesh, send, recv, tally=None, keys=("fwd", "bwd"),
                axes=None):
        ctx.mesh, ctx.send, ctx.recv, ctx.axes = mesh, send, recv, axes
        ctx.tally, ctx.key = tally, keys[1]
        return all_to_all_v(mesh, x, send, recv, tally=tally, key=keys[0],
                            axes=axes)

    @staticmethod
    def backward(ctx, grad):
        return (all_to_all_v(ctx.mesh, grad.contiguous(), ctx.recv, ctx.send,
                             tally=ctx.tally, key=ctx.key, axes=ctx.axes),
                None, None, None, None, None, None)


# -----------------------------------------------------------------------------
# Tensor-parallel operators (Megatron's f and g, and FSDP's gather): each
# adds the bytes this rank sends to ``tally[key]`` under the ring model
# (:func:`ring_allreduce_bytes`, :func:`ring_gather_bytes`); a checkpointed
# layer's recompute runs its forward collectives again and counts them
# again.


def ring_allreduce_bytes(numel: int, itemsize: int, k: int) -> int:
    """Bytes one rank sends in a ring all-reduce of ``numel`` elements over
    ``k`` ranks: ``2 (k - 1)`` chunks of ``ceil(numel / k)`` (the model of
    :meth:`repro_torch.core.comm.base.CommPlan.delegate_bytes`)."""
    return 2 * (k - 1) * -(-numel // k) * itemsize if k > 1 else 0


def ring_gather_bytes(chunk_numel: int, itemsize: int, k: int) -> int:
    """Bytes one rank sends in a ring all-gather (or reduce-scatter) whose
    chunks hold ``chunk_numel`` elements: ``k - 1`` chunks."""
    return (k - 1) * chunk_numel * itemsize


def tally_bytes(tally: dict | None, key: str, nbytes: int) -> None:
    """``tally[key] += nbytes`` (nothing without a tally)."""
    if tally is not None:
        tally[key] = tally.get(key, 0) + nbytes


def _allreduce_sum(mesh, x, axes, tally, key):
    k = mesh.size(axes)
    tally_bytes(tally, key, ring_allreduce_bytes(x.numel(), x.element_size(),
                                                 k))
    return all_reduce(mesh, x, "sum", axes)


class CopyToGroup(torch.autograd.Function):
    """Identity forward, all-reduce (sum) backward over the group of
    ``axes``: where a tensor that every member holds whole feeds a
    computation split over the group, each member's gradient is a part,
    and their sum is the tensor's gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axes, tally=None, key="copy"):
        ctx.mesh, ctx.axes, ctx.tally, ctx.key = mesh, axes, tally, key
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return (_allreduce_sum(ctx.mesh, grad.contiguous(), ctx.axes,
                               ctx.tally, ctx.key), None, None, None, None)


class ReduceFromGroup(torch.autograd.Function):
    """All-reduce (sum) forward, identity backward over the group of
    ``axes``: the members' partial results summed into the whole, which
    every member then holds, so the gradient of each part is the whole's."""

    @staticmethod
    def forward(ctx, x, mesh, axes, tally=None, key="reduce"):
        return _allreduce_sum(mesh, x, axes, tally, key)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None, None, None


def _split_sizes(n: int, k: int) -> list:
    """``torch.tensor_split``'s sizes of ``n`` over ``k``."""
    q, r = divmod(n, k)
    return [q + (i < r) for i in range(k)]


def gather_dim(mesh, x, dim: int, n: int, axes, tally=None,
               key: str = "gather") -> torch.Tensor:
    """The whole tensor of which each member of the group of ``axes`` holds
    its ``torch.tensor_split`` block of ``n`` along ``dim`` (ragged blocks
    travel padded to the largest)."""
    k = mesh.size(axes)
    sizes = _split_sizes(n, k)
    dim = dim % x.dim()
    m = sizes[0]
    if x.shape[dim] != sizes[mesh.index(axes)]:
        raise ValueError(f"block of {x.shape[dim]} along dim {dim}, split "
                         f"{sizes}")
    src = torch.nn.functional.pad(
        x.movedim(dim, 0), (0, 0) * (x.dim() - 1) + (0, m - x.shape[dim]))
    tally_bytes(tally, key, ring_gather_bytes(src.numel(), src.element_size(),
                                              k))
    out = all_gather(mesh, src.contiguous(), axes)          # [k, m, ...]
    parts = [out[j, :sizes[j]] for j in range(k)]
    return torch.cat(parts, 0).movedim(0, dim)


def reduce_scatter_dim(mesh, x, dim: int, axes, tally=None,
                       key: str = "scatter") -> torch.Tensor:
    """The sum over the group of ``axes`` of every member's whole ``x``,
    of which this member keeps its ``torch.tensor_split`` block along
    ``dim``. NCCL reduce-scatters (ragged blocks padded to the largest);
    gloo all-reduces and slices."""
    k, i = mesh.size(axes), mesh.index(axes)
    dim = dim % x.dim()
    sizes = _split_sizes(x.shape[dim], k)
    lo = sum(sizes[:i])
    if mesh.backend != "nccl":
        whole = _allreduce_sum(mesh, x.contiguous(), axes, tally, key)
        return whole.narrow(dim, lo, sizes[i]).contiguous()
    m = sizes[0]
    src = x.movedim(dim, 0)
    blocks = torch.stack([torch.nn.functional.pad(
        b, (0, 0) * (x.dim() - 1) + (0, m - b.shape[0]))
        for b in src.split(sizes)])                          # [k, m, ...]
    out = torch.empty_like(blocks[0])
    tally_bytes(tally, key, ring_gather_bytes(out.numel(), out.element_size(),
                                              k))
    dist.reduce_scatter_tensor(out, blocks.contiguous(), group=mesh.group(axes))
    return out[:sizes[i]].movedim(0, dim).contiguous()


class GatherFromGroup(torch.autograd.Function):
    """:func:`gather_dim` forward, :func:`reduce_scatter_dim` backward: a
    leaf sharded along ``dim`` (FSDP) gathered whole for a computation
    that every member runs on its own rows; each member's gradient of the
    whole is its rows' part, and the sum over the group of the block it
    holds is its block's gradient."""

    @staticmethod
    def forward(ctx, x, mesh, dim, n, axes, tally=None,
                keys=("gather", "scatter")):
        ctx.mesh, ctx.dim, ctx.axes, ctx.tally = mesh, dim, axes, tally
        ctx.key = keys[1]
        return gather_dim(mesh, x, dim, n, axes, tally, keys[0])

    @staticmethod
    def backward(ctx, grad):
        return (reduce_scatter_dim(ctx.mesh, grad, ctx.dim, ctx.axes,
                                   ctx.tally, ctx.key),
                None, None, None, None, None, None)


# -----------------------------------------------------------------------------
# Launcher


def _child(fn, rank: int, world: int, init: str, backend: str,
           timeout: float, args: tuple, results) -> None:
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.set_num_threads(1)
    try:
        if backend == "nccl":          # rank r drives card r (of those seen)
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=init, rank=rank,
                                world_size=world,
                                timeout=timedelta(seconds=timeout))
        out = fn(rank, world, *args)
    except Exception:                          # reported to the parent
        results.put((rank, False, traceback.format_exc()))
        return
    # the result goes out before the teardown: a process group whose
    # communicators were captured in CUDA graphs can hang in its teardown,
    # and the parent stops a child that outlives its result
    results.put((rank, True, out))
    dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: tuple = (), *,
          backend: str = "gloo", timeout: float = 120.0) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes joined
    by ``backend`` and return each rank's (picklable) result, in rank
    order. ``fn`` must be importable by the child (a module-level function
    of a module on ``sys.path``). Under ``nccl`` rank ``r`` drives card
    ``r`` (modulo the cards it sees). Rendezvous is a ``file://`` path in a
    fresh temporary directory, so concurrent worlds never collide. A rank
    that raises fails the call with its traceback; a world that has not
    finished within ``timeout`` seconds is killed and raises
    ``TimeoutError``."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_torch_world_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_child, daemon=True,
                             args=(fn, r, world, init, backend, timeout, args,
                                   results))
                 for r in range(world)]
        for pr in procs:
            pr.start()
        deadline = time.monotonic() + timeout
        got: dict = {}
        try:
            while len(got) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"world of {world} did not finish in {timeout} s; "
                        f"ranks done: {sorted(got)}")
                try:
                    rank, ok, out = results.get(timeout=min(left, 1.0))
                except _queue.Empty:
                    dead = [r for r, pr in enumerate(procs)
                            if r not in got and not pr.is_alive()
                            and pr.exitcode not in (0, None)]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} and no result")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{out}")
                got[rank] = out
        finally:
            for pr in procs:
                pr.join(timeout=5)
                if pr.is_alive():
                    pr.kill()
                    pr.join()
    return [got[r] for r in range(world)]
