"""The (data, model) device mesh over torch.distributed ranks.

Port of `relpose_gnn_tpu/parallel/mesh.py`.  In PyTorch one process drives
one device, so a mesh is a grid of ranks: `create_mesh` builds a 2-D
`torch.distributed.device_mesh.DeviceMesh` with dimensions ("data",
"model").  The data axis splits batches (data parallelism, the gradient
all-reduce of DistributedDataParallel over its group); the model axis
splits the wide GNN matrices (parallel/sharding.py).

The mesh is an object the caller passes to the code that needs it; nothing
here sets a global mesh.  With no process group and a world of one,
`create_mesh` returns a `LocalMesh`, a 1x1 mesh of this process alone that
needs no `init_process_group`: the single-card path.  Code that takes a
mesh reads it through `axis_size`, `axis_rank` and `axis_group`, which
accept both kinds.
"""

from __future__ import annotations

import logging

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, MODEL_AXIS)


class LocalMesh:
    """A 1x1 (data, model) mesh of this process alone, for a process with
    no process group: every axis has size 1, rank 0 and no group, so no
    collective is ever issued over it."""

    mesh_dim_names = AXES

    def size(self, mesh_dim: int | str = None) -> int:
        return 1

    def get_local_rank(self, mesh_dim: int | str = None) -> int:
        return 0

    def get_group(self, mesh_dim: int | str = None):
        return None

    def __repr__(self) -> str:
        return "LocalMesh(data=1, model=1)"


def _device_type() -> str:
    """The device type of the default process group's tensors: 'cuda'
    under NCCL, else 'cpu' (gloo stages CUDA tensors itself)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def create_mesh(n_data: int | None = None, n_model: int = 1):
    """A (data, model) mesh over the world's ranks, rank-major: ranks
    [0, n_model) form data row 0, and so on.

    With `n_data=None` the data axis takes every rank the model axis does
    not.  A mesh smaller than the world is allowed and logged: the ranks
    past it sit idle.  With no process group, the world is this process,
    and the result is a `LocalMesh`."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_data is None:
        if world % n_model:
            raise ValueError(f"the world's {world} ranks do not divide "
                             f"into a model axis of {n_model}")
        n_data = world // n_model
    want = n_data * n_model
    if n_data < 1 or n_model < 1 or want > world:
        raise ValueError(f"a mesh of data={n_data} x model={n_model} needs "
                         f"{want} ranks; the world has {world} (launch one "
                         "process per device)")
    if want < world:
        # a typo'd config on a real multi-GPU machine would otherwise
        # quietly idle the remaining cards
        logging.getLogger("relpose_gnn_tpu_torch").warning(
            "mesh uses %d of %d available devices (data=%d x model=%d); "
            "%d device(s) will sit idle", want, world, n_data, n_model,
            world - want)
    if not dist.is_initialized():
        return LocalMesh()
    from torch.distributed.device_mesh import DeviceMesh
    ranks = torch.arange(want, dtype=torch.int64).reshape(n_data, n_model)
    return DeviceMesh(_device_type(), ranks, mesh_dim_names=AXES)


def single_device_mesh():
    """1x1 mesh of this process (bench / single-card eval)."""
    if not dist.is_initialized():
        return LocalMesh()
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(_device_type(), torch.tensor([[dist.get_rank()]]),
                      mesh_dim_names=AXES)


def axis_size(mesh, axis: str) -> int:
    return int(mesh.size(mesh.mesh_dim_names.index(axis)))


def axis_rank(mesh, axis: str) -> int:
    """This process's index along `axis`."""
    return int(mesh.get_local_rank(mesh.mesh_dim_names.index(axis)))


def axis_group(mesh, axis: str):
    """The process group of this rank's line along `axis` (None in a
    LocalMesh: nothing to communicate)."""
    return mesh.get_group(mesh.mesh_dim_names.index(axis))


def in_mesh(mesh) -> bool:
    """Whether this process holds a place in `mesh`."""
    if isinstance(mesh, LocalMesh):
        return True
    return mesh.get_coordinate() is not None
