"""Meshes over the ranks of a process group.

The port of ``repro.launch.mesh``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` whose ``mesh_dim_names``
are the reference's axis names, on the device type of the caller's
``device`` (``cuda`` unless the caller passes ``"cpu"``).  JAX's mesh
spans the devices of one controller; here each rank is a process, so a
mesh needs an initialised ``torch.distributed`` group of exactly its
size, and these functions raise without one (``DeviceMesh`` would start
a group of its own).  Everything is a function: importing this module
touches no device and no group.

``rank_device`` names the card a rank computes on.  With a group, a
``"cuda"`` without an index becomes ``cuda:LOCAL_RANK`` (the launcher's
variable) and raises when ``LOCAL_RANK`` is unset: no rank picks card 0
behind the caller's back.  An explicit ``cuda:<i>`` is taken as given,
so several ranks may share one card.

``mesh_coords`` gives a rank its ``(data, model)`` coordinate on a
``("data", "model")`` mesh and the mesh's data and model process groups:
the ranks of its row and of its column, in the mesh's own rank order
(``local_mesh(m)`` puts global rank ``r`` at ``(r // m, r % m)``).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..kernels.ops import resolve_device

__all__ = ["make_production_mesh", "make_mesh", "local_mesh", "rank_device", "MeshCoords",
           "mesh_coords"]


def rank_device(device="cuda") -> torch.device:
    """The device this process computes on (see the module doc); a CUDA
    device becomes the process's current device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None and dist.is_initialized():
            if "LOCAL_RANK" not in os.environ:
                raise ValueError(
                    f"rank {dist.get_rank()} of {dist.get_world_size()}: name its card "
                    "(cuda:<index>) or set LOCAL_RANK"
                )
            dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        if dev.index is not None:
            torch.cuda.set_device(dev)
    return dev


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], device="cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the ranks of the
    initialised group, whose world size must be the mesh's size."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh spans the ranks of a process group: call "
            "torch.distributed.init_process_group first"
        )
    size = 1
    for n in shape:
        size *= n
    if size != dist.get_world_size():
        raise ValueError(f"mesh {shape} needs {size} ranks, the group has "
                         f"{dist.get_world_size()}")
    dev = rank_device(device)
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """16x16 single-pod (256 ranks) or 2x16x16 two-pod (512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def local_mesh(model_parallel: int = 1, device="cuda"):
    """``("data", "model")`` over every rank of the initialised group,
    ``model_parallel`` ranks a model replica."""
    if not dist.is_initialized():
        raise RuntimeError(
            "local_mesh spans the ranks of a process group: call "
            "torch.distributed.init_process_group first"
        )
    n = dist.get_world_size()
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide {n} rank(s)")
    return make_mesh((n // model_parallel, model_parallel), ("data", "model"), device)


class MeshCoords(NamedTuple):
    """A rank's place on a ``("data", "model")`` mesh."""

    data: int  # its data coordinate: the block of the global batch it takes
    model: int  # its model coordinate
    dp: int  # the mesh's data size
    mp: int  # the mesh's model size
    data_group: object  # the ranks at its model coordinate, by data coordinate
    model_group: object  # the ranks at its data coordinate, by model coordinate


def mesh_coords(mesh) -> MeshCoords:
    """This rank's :class:`MeshCoords` on ``mesh``, whose axes must be
    ``("data", "model")``."""
    if tuple(mesh.mesh_dim_names) != ("data", "model"):
        raise ValueError(f"mesh axes {mesh.mesh_dim_names}, not ('data', 'model')")
    d, m = mesh.get_coordinate()
    dp, mp = mesh.mesh.shape
    return MeshCoords(int(d), int(m), int(dp), int(mp), mesh.get_group("data"),
                      mesh.get_group("model"))
