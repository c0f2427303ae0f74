"""Process start-up and placement: the layer above the device mesh.

Port of `relpose_gnn_tpu/parallel/multihost.py`.  In PyTorch every device
has its own process, on one host or several:

    initialize(coordinator, num_processes, process_id)   (once, first)
      -> create_mesh(...)                 (parallel/mesh.py, every rank)
      -> put_like(host_array, mesh, ...)  (each rank keeps ITS rows)
      -> host_read(result, group)         (every rank sees the whole)

`put_like` is the one placement primitive: from a host array that every
process holds identically (parameters from one seed, a seeded batch),
each rank keeps its own block and moves it to its device, so no rank
uploads rows it does not own.  A rank's block is contiguous by
construction (rank r of n holds rows [r m / n, (r + 1) m / n)), so the JAX
module's `_local_block` contiguity check has nothing to check here.
`host_read` is the inverse for results split over ranks.

The backend follows the device: NCCL for CUDA, gloo for the CPU; an
explicit `backend=` wins (two gloo ranks can share one card, where NCCL
refuses two ranks on one device).  The ranks meet at the coordinator's
TCP port, or through a `store` (a `torch.distributed.FileStore` needs no
port, so two jobs on one host cannot collide).  Gloo takes CUDA tensors in every
collective used here (`all_reduce`, `all_gather`, `broadcast`, and
DistributedDataParallel's), staging them through the host (checked on the
H100 with torch 2.11).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from relpose_gnn_tpu_torch.parallel.mesh import (DATA_AXIS, axis_group,
                                                 axis_rank, axis_size)


def initialize(coordinator: str, num_processes: int, process_id: int,
               local_device_count: int | None = None,
               backend: str | None = None,
               device: torch.device | str | None = None,
               store: dist.Store | None = None) -> None:
    """Join a multi-process job (call before any device use).

    `coordinator` is process 0's `host:port`; with `store` the ranks meet
    through it instead.  With `num_processes` <= 1 nothing is started:
    the single-process path needs no process group.  `local_device_count`
    > 1 is the JAX package's virtual-devices-per-process knob; a torch
    process drives one device, so that many processes must be launched
    instead.  `device` None means the card (NCCL; this process then
    takes card `process_id` modulo the cards on its host), "cpu" means
    gloo."""
    if local_device_count is not None and local_device_count > 1:
        raise ValueError(
            f"local_device_count={local_device_count}: a PyTorch process "
            f"drives one device, so launch {local_device_count} processes "
            "per host (one per device, each with its own --process-id) "
            "instead of virtual devices in one")
    if num_processes <= 1:
        return
    if not coordinator and store is None:
        raise ValueError(f"{num_processes} processes need a coordinator "
                         "(host:port of process 0)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} is outside [0, "
                         f"{num_processes})")
    on_card = device is None or torch.device(device).type == "cuda"
    if backend is None:
        backend = "nccl" if on_card else "gloo"
    if on_card and torch.cuda.is_available():
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    meet = (dict(store=store) if store is not None
            else dict(init_method=f"tcp://{coordinator}"))
    dist.init_process_group(backend, world_size=num_processes,
                            rank=process_id, **meet)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """Rank 0, or the only process: the one that writes shared files."""
    return not dist.is_initialized() or dist.get_rank() == 0


def block(n: int, parts: int, index: int) -> slice:
    """The rows [index n / parts, (index + 1) n / parts) of n rows split
    into `parts` equal blocks; n must divide."""
    if n % parts:
        raise ValueError(f"{n} rows do not split into {parts} equal blocks")
    per = n // parts
    return slice(index * per, (index + 1) * per)


def put_like(x, mesh, placement: str = "replicate",
             device: torch.device | str | None = None) -> torch.Tensor:
    """A host array (identical on every process) placed as `placement`
    says, on `device` (None: the current card): "replicate" keeps the
    whole tensor on every rank; "data" keeps this rank's rows of the
    leading dim, split over the mesh's data axis."""
    from relpose_gnn_tpu_torch import resolve_device
    t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
    if placement == DATA_AXIS:
        if t.dim() == 0:
            raise ValueError("a 0-d tensor has no rows to split")
        t = t[block(t.shape[0], axis_size(mesh, DATA_AXIS),
                    axis_rank(mesh, DATA_AXIS))]
    elif placement != "replicate":
        raise ValueError(f"placement {placement!r} (want 'replicate' or "
                         f"{DATA_AXIS!r})")
    return t.to(resolve_device(device))


def all_gather_blocks(x: torch.Tensor, group) -> torch.Tensor:
    """The blocks of every rank of `group`, stacked rank-major: [n, *x]
    (each rank passes a tensor of the same shape and dtype), bit for bit
    what each rank passed, -0.0 included."""
    if group is None or dist.get_world_size(group) == 1:
        return x[None]
    if x.dtype in (torch.bfloat16, torch.float16):
        # gloo gathers no 16-bit types on the CPU; widening is exact
        return all_gather_blocks(x.float(), group).to(x.dtype)
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x, group=group)
    return torch.stack(out)


def gather_rows(x: torch.Tensor, mesh, axis: str = DATA_AXIS
                ) -> torch.Tensor:
    """The ranks' row blocks of a tensor split over `axis`, concatenated
    in rank order, on every rank's device."""
    if axis_size(mesh, axis) == 1:
        return x
    blocks = all_gather_blocks(x, axis_group(mesh, axis))
    return blocks.reshape((-1,) + tuple(x.shape[1:]))


def host_read(x: torch.Tensor, mesh=None, axis: str = DATA_AXIS
              ) -> np.ndarray:
    """A result split over `axis` of `mesh` by rows, as one host array on
    every rank (the ranks' blocks concatenated in rank order).  Without a
    mesh, over an axis of one rank, or for a 0-d tensor (a scalar is
    whole on every rank), a plain `.cpu().numpy()`.  bfloat16 comes back
    as float32 (exactly: numpy has no bfloat16)."""
    x = x.detach()
    if x.dtype == torch.bfloat16:   # numpy has none; widening is exact
        x = x.float()
    if mesh is None or x.dim() == 0:
        return x.cpu().numpy()
    return gather_rows(x, mesh, axis).cpu().numpy()
