"""The dry run: one rank's step of every (architecture x shape) cell on the
production mesh, on fake tensors -- the port of ``repro.launch.dryrun``.

The reference lowers and compiles each cell's SPMD program on 256 (or 512)
forced host devices and reads XLA's ``cost_analysis``, ``memory_analysis``
and the collectives of the partitioned HLO. The port has no SPMD
compiler: its program is one rank's explicit program. So the dry run runs
**the step a real rank runs** (``launch.cells``) on rank 0 of the
production mesh -- a real :class:`~repro_torch.core.comm.dist.PartitionMesh`
over torch's ``fake`` process-group backend (no peers, no wire), taking
NCCL's code paths -- with every large tensor a ``FakeTensor`` (shapes,
dtypes and devices, no storage), and counts at the dispatcher
(:class:`StepCounter`):

* flops: ``torch.utils.flop_counter``'s formulas, split by the dtype of
  the operands;
* bytes accessed: each dispatched operator's input and output bytes
  (views, allocations and operators that return no tensor, such as a
  device query, move none). Eager torch fuses nothing, so every operator
  reads and writes device memory: the sum is the step's traffic (the
  twelve largest operators kept by name);
* collectives by kind and by the mesh axes of their group: operand bytes
  (the reference's quantity) and ring-model wire bytes (what
  ``models.common.Parallel`` tallies: ``2 (k - 1) ceil(n / k)`` elements
  an all-reduce, ``k - 1`` chunks an all-gather or reduce-scatter, the
  rows that leave the rank an all-to-all), and the first 500 of them;
* memory: the arguments' bytes (the rank's parameters, optimizer state,
  batch and cache) and the peak of live storage during the step.

Inputs that routing reads on the host stay real (the recsys ids, whose
owner counts the step reads): a collective of real tensors is answered as
if every peer held this rank's value (an all-gather tiles it; an
all-to-all fills what it receives -- as many rows as the tiled counts
say -- with what it sends, cyclically; an all-reduce, whose value no host
read depends on, keeps it); a collective's receive buffer is made from
what it sends, so it is real where that is. A host read of a fake value
reads false: the BFS sweep loop checks the synthesized state's ``it``
and ``done`` first (real, from numpy: true), sweeps once, and then reads
a fake ``done`` -- a BFS record is one sweep's, as XLA's cost of a while
loop is its body's. A kernel wrapper
given fake tensors (``kernels.ops.FAKE_HOOK``) neither launches nor takes
its plain version: it counts its inputs read once and its outputs written
once, the traffic its bound counts, and its flops (the CIN kernels' on
3xTF32, ``"tf32x3"``). Every layer is
dispatched, so there is no scan correction (the reference's
``_scan_corrected``); ``--unroll-layers L`` runs a shallow copy.

Usage (in a process of its own: it initialises a ``fake`` default process
group):

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --cell gemma3-1b/decode_32k --cell xdeepfm/serve_bulk
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] [--mesh 32,8] [--jobs 8] [--out runs/dryrun_torch]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
import weakref

import torch

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "broadcast")

_KIND = {"allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
         "allgather_": "all-gather", "_allgather_base_": "all-gather",
         "allgather_into_tensor_coalesced_": "all-gather",
         "reduce_scatter_": "reduce-scatter",
         "_reduce_scatter_base_": "reduce-scatter",
         "reduce_scatter_tensor_coalesced_": "reduce-scatter",
         "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
         "broadcast_": "broadcast"}

_DEVICE_QUERY = torch.ops.prim.device.default

#: reshaping views whose fake strides can differ from the kernel's
_RESHAPES = (torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default)


def _kernel_strides(func, args, out):
    """A fake reshaping view with the strides the C++ kernel gives it:
    FakeTensor's ``view`` strides a size-1 dimension otherwise, and
    ``matmul`` folds a batch into ``mm`` by those strides, or calls
    ``bmm`` with a copy -- other operators and bytes than a real rank's."""
    from torch.utils._python_dispatch import _disable_current_modes

    src = args[0]
    with _disable_current_modes():
        want = func(torch.empty_strided(src.shape, src.stride(),
                                        dtype=src.dtype, device="meta"),
                    *args[1:]).stride()
    if out.stride() == want:
        return out
    return torch.ops.aten.as_strided.default(src, out.shape, want,
                                             out.storage_offset())


_DTYPE = {torch.bfloat16: "bf16", torch.float16: "f16",
          torch.float32: "f32", torch.float64: "f64"}

#: the production mesh: ``model`` one HGX H100 node's 8 cards on NVLink,
#: ``data`` the rest of 256 ranks
PRODUCTION = (32, 8)

#: the collectives a record lists one by one (the reference's
#: ``hlo_collective_lines``)
MAX_LINES = 500


def _tensors(tree) -> list:
    """The tensors of an operator's (nested lists / tuples / dicts of)
    arguments or outputs, in order."""
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
    walk(tree)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tree_bytes(tree) -> int:
    """Bytes of the distinct storages of a tree's tensors (dataclasses such
    as a partition or a BFS state included)."""
    seen, total = set(), 0
    for t in _leaf_tensors(tree):
        st = t.untyped_storage()
        key = (st.data_ptr(), st.nbytes()) if not _is_fake(t) else id(st)
        if key not in seen:
            seen.add(key)
            total += st.nbytes()
    return total


def _leaf_tensors(tree) -> list:
    import dataclasses

    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
    walk(tree)
    return out


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)


_VIEW: dict = {}


def _is_view(func) -> bool:
    """The operator returns a view (an alias it does not write): it moves
    no bytes. Cached a func."""
    v = _VIEW.get(func)
    if v is None:
        v = _VIEW[func] = func.overloadpacket.__name__ == "_unsafe_view" or any(
            r.alias_info is not None and not r.alias_info.is_write
            for r in func._schema.returns)
    return v


class StepCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts what a step dispatches: flops by dtype, bytes accessed,
    collectives by kind and mesh axes (operand and wire bytes), live
    storage and its peak, host reads. On real tensors too (a real rank's
    step, against which the tests hold the dry run); ``symmetric``: the
    dry run's answers for collectives of real tensors and host reads of
    fake values (see the module)."""

    def __init__(self, mesh, symmetric: bool = False):
        super().__init__()
        import torch.distributed as dist

        self.mesh, self.symmetric = mesh, symmetric
        self.flops: dict = {}
        self.bytes_accessed = 0
        self.collectives = {k: {"count": 0, "operand_bytes": 0,
                                "result_bytes": 0, "wire_bytes": 0}
                            for k in COLLECTIVES}
        self.by_axes: dict = {}
        self.lines: list = []
        self.host_reads = 0
        self.kernels: dict = {}
        self.bytes_by_op: dict = {}
        self.live = self.peak = 0
        self._seen = weakref.WeakSet()
        self._axes = {}
        for names, entry in mesh._groups.items():
            if entry is not None:
                g = entry[0] if entry[0] is not None else dist.group.WORLD
                self._axes[id(g)] = names

    # ----------------------------------------------------------- storage
    def hold(self, tree) -> int:
        """Count ``tree``'s storages as live (the step's arguments);
        returns their bytes."""
        n = 0
        for t in _leaf_tensors(tree):
            n += self._track(t)
        return n

    def _track(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        if st in self._seen:
            return 0
        self._seen.add(st)
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)
        return n

    def _free(self, n: int) -> None:
        self.live -= n

    def kernel(self, name: str, ins: list, outs: list, flops: dict) -> None:
        """A kernel wrapper's call on fake tensors (``kernels.ops.
        FAKE_HOOK``): its inputs read once and outputs written once, its
        flops by arithmetic (``"tf32x3"``: the CIN kernels)."""
        self.kernels[name] = self.kernels.get(name, 0) + 1
        n = sum(_nbytes(t) for t in ins + outs)
        self.bytes_accessed += n
        self.bytes_by_op[name] = self.bytes_by_op.get(name, 0) + n
        for t in outs:
            self._track(t)
        for k, n in flops.items():
            self.flops[k] = self.flops.get(k, 0) + int(n)

    def __enter__(self):
        from repro_torch.kernels import ops

        self._hook, ops.FAKE_HOOK = ops.FAKE_HOOK, self.kernel
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        ops.FAKE_HOOK = self._hook
        return super().__exit__(*exc)

    # -------------------------------------------------------- dispatcher
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils._python_dispatch import _disable_current_modes

        if func is _DEVICE_QUERY:
            # a fake tensor's ``.device`` is dispatched (most of the
            # step's dispatches): it moves nothing and counts nothing
            return func(*args)
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if func.namespace == "c10d" and name in _KIND:
            return self._collective(func, name, args, kwargs)
        ins = _tensors((args, kwargs))
        if name == "_local_scalar_dense" and ins and _is_fake(ins[0]):
            return self._host_read(ins[0])
        # an op of real tensors only stays real (a collective's receive
        # buffer is made from what it sends), and so does a python scalar
        # made a tensor: their fake twins would lose the values routing
        # reads on the host
        if self.symmetric and (name == "scalar_tensor" or ins and not any(
                _is_fake(t) for t in ins)):
            with _disable_current_modes():
                out = func(*args, **kwargs)
        else:
            out = func(*args, **kwargs)
            if func in _RESHAPES and _is_fake(out):
                out = _kernel_strides(func, args, out)
        outs = _tensors(out)
        for t in outs:
            self._track(t)
        if outs and not _is_view(func) and not name.startswith(
                ("empty", "new_empty")):
            ids = {id(t) for t in ins}
            n = sum(_nbytes(t) for t in ins) + sum(
                _nbytes(t) for t in outs if id(t) not in ids)
            self.bytes_accessed += n
            self.bytes_by_op[name] = self.bytes_by_op.get(name, 0) + n
        from torch.utils.flop_counter import flop_registry

        if func.overloadpacket in flop_registry:
            n = flop_registry[func.overloadpacket](*args, **kwargs,
                                                   out_val=out)
            key = _DTYPE.get(ins[0].dtype, str(ins[0].dtype)) if ins else "?"
            self.flops[key] = self.flops.get(key, 0) + int(n)
        return out

    def _host_read(self, t):
        if t.dtype != torch.bool or not self.symmetric:
            raise RuntimeError(f"host read of a fake {t.dtype} value: the "
                               "dry run answers only a loop's condition")
        # the condition of a loop whose state turned fake: stop
        self.host_reads += 1
        return False

    def _group_axes(self, pg) -> tuple:
        import torch.distributed as dist

        if isinstance(pg, torch.ScriptObject):
            pg = dist.ProcessGroup.unbox(pg)
        return self._axes.get(id(pg), ("?",))

    def _collective(self, func, name, args, kwargs):
        from repro_torch.core.comm.dist import (ring_allreduce_bytes,
                                                ring_gather_bytes)

        kind = _KIND[name]
        pg = next(a for a in args if isinstance(a, torch.ScriptObject))
        axes = self._group_axes(pg)
        k = self.mesh.size(axes) if axes != ("?",) else 1
        if name.startswith("allreduce"):
            ins = _tensors(args[0])
            outs = ins
            wire = sum(ring_allreduce_bytes(t.numel(), t.element_size(), k)
                       for t in ins)
        elif kind in ("all-gather", "reduce-scatter"):
            outs, ins = _tensors(args[0]), _tensors(args[1])
            # the chunk a rank sends k - 1 times: its input (a gather) or
            # its output block (a reduce-scatter)
            chunk = ins if kind == "all-gather" else outs
            wire = sum(ring_gather_bytes(t.numel(), t.element_size(), k)
                       for t in chunk)
        elif name == "alltoall_base_":
            out, src = args[0], args[1]
            outs, ins = [out], [src]
            splits = list(args[4]) if len(args) > 4 and args[4] else []
            row = _nbytes(src) // max(src.shape[0], 1) if src.dim() else 0
            i = self.mesh.index(axes) if axes != ("?",) else 0
            wire = ((sum(splits) - splits[i]) * row if splits
                    else _nbytes(src) * (k - 1) // k)
        else:
            ins, outs = _tensors(args[1]), _tensors(args[0])
            wire = sum(_nbytes(t) for t in ins) * (k - 1)
        op_bytes = sum(_nbytes(t) for t in ins)
        c = self.collectives[kind]
        c["count"] += 1
        c["operand_bytes"] += op_bytes
        c["result_bytes"] += sum(_nbytes(t) for t in outs)
        c["wire_bytes"] += wire
        key = "+".join(axes)
        a = self.by_axes.setdefault(key, {"count": 0, "operand_bytes": 0,
                                          "wire_bytes": 0})
        a["count"] += 1
        a["operand_bytes"] += op_bytes
        a["wire_bytes"] += wire
        if len(self.lines) < MAX_LINES:
            self.lines.append(f"{kind} axes={key} k={k} dtype="
                              f"{ins[0].dtype if ins else '-'} "
                              f"operand_bytes={op_bytes} wire_bytes={wire}")
        out = func(*args, **kwargs)
        if self.symmetric:
            self._fill(name, args, k)
        return out

    def _fill(self, name, args, k):
        """A collective of real tensors, answered as if every peer held
        this rank's value."""
        from torch.utils._python_dispatch import _disable_current_modes

        real = [t for t in _tensors(args) if not _is_fake(t)]
        if not real:
            return
        with _disable_current_modes():
            if name == "allgather_":
                for o in _tensors(args[0]):
                    o.copy_(args[1][0])
            elif name == "_allgather_base_":
                args[0].copy_(args[1].repeat((k,) + (1,) * (args[1].dim() - 1))
                              .reshape(args[0].shape))
            elif name == "alltoall_base_":
                out, src = args[0].reshape(-1), args[1].reshape(-1)
                if out.numel() and src.numel():
                    reps = -(-out.numel() // src.numel())
                    out.copy_(src.repeat(reps)[:out.numel()])
            # an all-reduce of a real tensor (a constant such as a token
            # count) keeps this rank's value: no host read depends on it

    def record(self) -> dict:
        coll = {k: dict(v) for k, v in self.collectives.items()}
        coll["total_bytes"] = sum(v["operand_bytes"] for v in
                                  self.collectives.values())
        coll["total_wire_bytes"] = sum(v["wire_bytes"] for v in
                                       self.collectives.values())
        coll["by_axes"] = {k: dict(v) for k, v in self.by_axes.items()}
        top = sorted(self.bytes_by_op.items(), key=lambda kv: -kv[1])[:12]
        return {"cost": {"flops": sum(self.flops.values()),
                         "flops_by_dtype": dict(self.flops),
                         "bytes accessed": self.bytes_accessed,
                         "bytes_by_op": dict(top)},
                "collectives": coll, "host_reads": self.host_reads,
                "kernels": dict(self.kernels),
                "hlo_collective_lines": list(self.lines)}


# ------------------------------------------------------------- command line
def mesh_tag(sizes: tuple, multi_pod: bool) -> str:
    return "x".join(str(s) for s in ((2,) if multi_pod else ()) + tuple(sizes))


def init_fake_world(world: int) -> None:
    """A ``fake`` default process group of ``world`` ranks, this process
    rank 0 (raises where torch has no ``fake`` backend)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str,
             sizes: tuple = PRODUCTION, unroll_layers: int = 0,
             smoke: bool = False) -> dict:
    """Rank 0's step of one cell on the production mesh (``sizes`` =
    ``(data, model)``, a pod axis of 2 in front with ``multi_pod``) over a
    fake world, its arguments fake, drawn as from seed 0 on the CPU,
    counted by :class:`StepCounter`; the record is written to
    ``out_dir/<arch>__<shape>__<mesh>.json``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core.comm.dist import PartitionMesh
    from repro_torch.launch.cells import build_cell

    from .mesh import mesh_layout

    world = math.prod(sizes) * (2 if multi_pod else 1)
    tag = mesh_tag(sizes, multi_pod)
    if unroll_layers:
        tag += f"_L{unroll_layers}"
    rec = {"arch": arch, "shape": shape, "mesh": tag, "ok": False,
           "unroll_layers": unroll_layers, "world": world, "smoke": smoke, "backend": "fake (nccl paths)"}
    t0 = time.time()
    try:
        init_fake_world(world)
        axes, msizes = mesh_layout(world, multi_pod, sizes)
        mesh = PartitionMesh(axes, msizes, backend="nccl")
        cell = build_cell(arch, shape, mesh, smoke=smoke,
                          layers_override=unroll_layers)
        rec["build_s"] = time.time() - t0
        with FakeTensorMode(allow_non_fake_inputs=True):
            counter = StepCounter(mesh, symmetric=True)
            with counter:
                args = cell.dry_args(0, "cpu")
            counter = StepCounter(mesh, symmetric=True)
            arg_bytes = counter.hold(args)
            t1 = time.time()
            with counter:
                out = cell.step(*args)
            rec["step_s"] = time.time() - t1
            out_bytes = tree_bytes(out)
        rec.update(counter.record())
        rec["memory"] = {"argument_size_in_bytes": arg_bytes,
                         "output_size_in_bytes": out_bytes,
                         "peak_size_in_bytes": counter.peak,
                         "temp_size_in_bytes": max(counter.peak - arg_bytes,
                                                   0)}
        par = getattr(cell, "par", None)
        if par is not None:
            rec["tally"] = dict(par.tally)
        rec["ok"] = True
        c = rec["cost"]
        print(f"[{arch}/{shape}/{tag}] flops={c['flops']:.4e} "
              f"{c['flops_by_dtype']} bytes={c['bytes accessed']:.4e} "
              f"args={arg_bytes:.4e} peak={counter.peak:.4e} wire="
              f"{rec['collectives']['total_wire_bytes']}", flush=True)
    except Exception as e:  # noqa: BLE001
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        print(f"[{arch}/{shape}/{tag}] FAILED: {rec['error']}", flush=True)
    rec["total_s"] = time.time() - t0
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{arch}__{shape}__{tag}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--cell", action="append", default=[],
                    help="ARCH/SHAPE (repeatable): these cells")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--mesh", default=",".join(map(str, PRODUCTION)),
                    help="DATA,MODEL (default 32,8: 256 ranks)")
    ap.add_argument("--out", default="runs/dryrun_torch")
    ap.add_argument("--unroll-layers", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke configs (a quick check of the dry run)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each worker a process of its "
                         "own with its own fake world")
    args = ap.parse_args(argv)
    sizes = tuple(int(s) for s in args.mesh.split(","))
    from repro_torch.launch.cells import all_cells

    if args.all:
        cells = [(a, s) for a, s, skip in all_cells() if skip is None]
    elif args.cell:
        cells = [tuple(c.split("/", 1)) for c in args.cell]
    else:
        cells = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    t0 = time.time()
    todo = [(arch, shape, mp, args.out, sizes, args.unroll_layers, args.smoke)
            for mp in meshes for arch, shape in cells]
    if args.jobs > 1:
        import multiprocessing as mproc

        with mproc.get_context("spawn").Pool(args.jobs,
                                             maxtasksperchild=1) as pool:
            oks = pool.starmap(_run_ok, todo, chunksize=1)
    else:
        oks = [_run_ok(*t) for t in todo]
    failures = oks.count(False)
    print(f"dry-run complete; failures: {failures}; wall {time.time() - t0:.1f}"
          " s")
    return 1 if failures else 0


def _run_ok(*args) -> bool:
    return run_cell(*args)["ok"]


if __name__ == "__main__":
    raise SystemExit(main())
