"""The training mesh: the world's ranks over named axes -- the port of
``repro.launch.mesh``.

The reference's production mesh is one pod's 16 x 16 chips over
``("data", "model")``, or two pods over ``("pod", "data", "model")``. Here
the sizes come from the world: ``model`` is by default the ranks of one
host (``LOCAL_WORLD_SIZE``, the cards one NVLink domain joins), ``data``
the rest, and ``pod`` two when the mesh is multi-pod. Rank ``r`` sits at
the row-major coordinates of ``r``, so a model group is consecutive ranks
(one host). Built by every rank of an initialised process group
(:class:`repro_torch.core.comm.dist.PartitionMesh`).
"""
from __future__ import annotations

import os
from typing import Sequence


def mesh_layout(world: int, multi_pod: bool = False,
                sizes: Sequence[int] | None = None) -> tuple:
    """``(axes, sizes)`` of the production mesh of ``world`` ranks.
    ``sizes`` (``(data, model)``, as ``--mesh`` gives them) fixes the data
    and model sizes (with ``multi_pod``, ``pod`` is what is left);
    otherwise ``model`` is ``LOCAL_WORLD_SIZE`` (else 1) and ``data`` the
    rest (``pod`` two with ``multi_pod``)."""
    if sizes is not None:
        data, model = (int(s) for s in sizes)
        if data < 1 or model < 1 or world % (data * model):
            raise ValueError(f"mesh {data} x {model} does not divide a world "
                             f"of {world}")
        pod = world // (data * model)
        if pod > 1 and not multi_pod:
            raise ValueError(f"mesh {data} x {model} spans {data * model} "
                             f"ranks, world has {world}")
    else:
        model = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
        if world % model:
            raise ValueError(f"a world of {world} does not split into model "
                             f"groups of LOCAL_WORLD_SIZE {model} ranks; lay "
                             f"it out with --mesh DATA,MODEL")
        pod = 2 if multi_pod else 1
        if world % (pod * model):
            raise ValueError(f"a world of {world} does not split into {pod} "
                             f"pods of {model}-rank model groups")
        data = world // (pod * model)
    if multi_pod:
        return ("pod", "data", "model"), (pod, data, model)
    return ("data", "model"), (data, model)


def make_production_mesh(*, multi_pod: bool = False,
                         sizes: Sequence[int] | None = None):
    """The :class:`~repro_torch.core.comm.dist.PartitionMesh` of
    :func:`mesh_layout` over the initialised world."""
    import torch.distributed as dist

    from repro_torch.core.comm.dist import PartitionMesh

    axes, shape = mesh_layout(dist.get_world_size(), multi_pod, sizes)
    return PartitionMesh(axes, shape)


def make_test_mesh(shape=(2, 2), axes=("data", "model")):
    """A small mesh over the initialised world (its size the product of
    ``shape``)."""
    from repro_torch.core.comm.dist import PartitionMesh

    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    return PartitionMesh(axes, shape)


def data_axes(mesh) -> tuple:
    """The pure-DP axes of a mesh (pod+data)."""
    return tuple(a for a in mesh.axes if a in ("pod", "data"))


def all_axes(mesh) -> tuple:
    return tuple(mesh.axes)
