"""Batch splitting and the tensor-parallel parameter layout.

Port of `relpose_gnn_tpu/parallel/sharding.py`.  The JAX module returns
`NamedSharding`s that XLA's compiler turns into collectives; in PyTorch
each rank holds its own part and the collectives are written out:

  * data parallelism: a batch's leading dim splits over the mesh's "data"
    axis (`shard_batch`: this rank's rows), parameters and optimizer state
    are whole on every rank (`multihost.put_like(x, mesh, "replicate")`
    places a host array so), and DistributedDataParallel all-reduces the
    gradients over the data group (training/trainer.py::make_train_step).
    `DataShard` tells the code
    that must see the global batch where this rank's rows sit in it: the
    train-mode BatchNorm statistics (models/resnet.py), the dropout masks
    (models/posenet.py) and the masked L1's count (training/criterion.py);
  * tensor parallelism: `param_sharding` gives the Megatron-style layout
    the JAX `_gnn_kernel_spec` encodes, as torch `Placement`s over the
    mesh's (data, model) axes: the GNN MLPs' first linear (weight and
    bias) and `proj_edge`'s weight column-parallel (their output features
    split over "model"), the GNN MLPs' second linear row-parallel (its
    input features split, closed by one all-reduce), everything else
    whole.  The port's `MLP2` / `PairMLP2` name their linears `0` and `2`
    (the reference's `Seq(Linear, ReLU, Linear)`) where the JAX tree says
    `fc1` / `fc2` (models/convert.py); torch stores a linear's weight as
    [out, in], so a column split is dim 0 and a row split dim 1.
    `TensorParallel` applies that layout to a train state in place (each
    rank keeps its block of every split parameter and of its Adam
    moments) and tells the split modules their `ModelShard`; their
    forward then brackets the split with Megatron's three operators:
    `copy_to_model` (identity, gradients summed over the model group),
    `reduce_from_model` (the row-parallel sum) and `gather_from_model`
    (`proj_edge`'s columns, whose consumers need the whole width).
    `full_state_dict` gathers the blocks again for a checkpoint, which is
    then the single-device layout.
"""

from __future__ import annotations

import dataclasses
import re

import torch
import torch.distributed as dist

from relpose_gnn_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                                 axis_group, axis_rank,
                                                 axis_size)
from relpose_gnn_tpu_torch.parallel.multihost import block


@dataclasses.dataclass(frozen=True)
class DataShard:
    """This rank's place on the data axis: the global batch is `size`
    equal blocks, this rank holds block `rank`; `group` is the data
    axis's process group."""

    group: object
    size: int
    rank: int

    def rows(self, local: int) -> slice:
        """This rank's rows of a global batch of `size * local` rows."""
        return slice(self.rank * local, (self.rank + 1) * local)


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """This rank's place on the model axis: a split parameter is `size`
    equal blocks along its split dim, this rank holds block `rank`;
    `group` is the model axis's process group."""

    group: object
    size: int
    rank: int

    def cols(self, n: int) -> slice:
        """This rank's block of `n` features (n / size of them)."""
        return block(n, self.size, self.rank)


def model_shard(mesh) -> ModelShard | None:
    """The ModelShard of this rank in `mesh`; None where the model axis
    has one rank."""
    if mesh is None or axis_size(mesh, MODEL_AXIS) == 1:
        return None
    return ModelShard(axis_group(mesh, MODEL_AXIS),
                      axis_size(mesh, MODEL_AXIS),
                      axis_rank(mesh, MODEL_AXIS))


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank):
        ctx.cols = slice(rank * x.shape[-1], (rank + 1) * x.shape[-1])
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        return grad[..., ctx.cols].contiguous(), None, None


def copy_to_model(x: torch.Tensor, ms: ModelShard) -> torch.Tensor:
    """x unchanged; its gradient summed over the model group (the input of
    a column-parallel layer, which every model rank reads whole)."""
    return _CopyToModel.apply(x, ms.group)


def reduce_from_model(x: torch.Tensor, ms: ModelShard) -> torch.Tensor:
    """The sum of x over the model group (a row-parallel layer's
    partials); the gradient passes unchanged."""
    return _ReduceFromModel.apply(x, ms.group)


def gather_from_model(x: torch.Tensor, ms: ModelShard) -> torch.Tensor:
    """The model group's blocks of the last dim concatenated in rank
    order; the gradient keeps this rank's block."""
    return _GatherFromModel.apply(x, ms.group, ms.rank)


def data_shard(mesh) -> DataShard | None:
    """The DataShard of this rank in `mesh`; None where the data axis has
    one rank (nothing to reduce, the single-device code runs as it is)."""
    if mesh is None or axis_size(mesh, DATA_AXIS) == 1:
        return None
    return DataShard(axis_group(mesh, DATA_AXIS),
                     axis_size(mesh, DATA_AXIS), axis_rank(mesh, DATA_AXIS))


def batch_rows(mesh, n: int) -> slice:
    """This rank's rows of a batch of `n`, split over the data axis."""
    parts = axis_size(mesh, DATA_AXIS)
    if n % parts:
        raise ValueError(f"a batch of {n} rows must be divisible by the "
                         f"data axis of the mesh ({parts} ranks)")
    return block(n, parts, axis_rank(mesh, DATA_AXIS))


def shard_batch(mesh, batch: dict) -> dict:
    """This rank's rows of every array of a batch (host arrays stay on the
    host: the feed uploads them)."""
    rows = None
    out = {}
    for k, v in batch.items():
        if rows is None:
            rows = batch_rows(mesh, len(v))
        out[k] = v[rows]
    return out


# -- tensor-parallel parameter layout ----------------------------------------

_GNN_LINEAR = re.compile(
    r"^gnn\d+\.(edge_model\.edge_mlp|mlp|mlp_updating)\.(0|2)\.(weight|bias)$")


def _placement(name: str, ndim: int):
    """(data, model) placements of one parameter, keyed on its name as the
    JAX spec is keyed on its tree path."""
    from torch.distributed.tensor import Replicate, Shard
    whole = (Replicate(), Replicate())
    if name == "proj_edge.weight":
        return (Replicate(), Shard(0))              # column parallel
    m = _GNN_LINEAR.match(name)
    if m is None:
        return whole
    layer, kind = m.group(2), m.group(3)
    if layer == "0":                                # fc1: column parallel
        return (Replicate(), Shard(0))
    if kind == "weight" and ndim == 2:              # fc2: row parallel
        return (Replicate(), Shard(1))
    return whole


def param_sharding(model: torch.nn.Module, mesh=None,
                   tensor_parallel: bool = True) -> dict:
    """{parameter name: (data placement, model placement)} for `model`:
    whole everywhere, or the tensor-parallel layout over "model" (module
    docstring).  A split dim must divide the model axis's size; the call
    sites choose widths accordingly (2048 divides any small axis)."""
    from torch.distributed.tensor import Replicate
    out = {}
    n_model = 1 if mesh is None else axis_size(mesh, MODEL_AXIS)
    for name, p in model.named_parameters():
        pl = (_placement(name, p.dim()) if tensor_parallel
              else (Replicate(), Replicate()))
        dim = getattr(pl[1], "dim", None)
        if dim is not None and p.shape[dim] % n_model:
            raise ValueError(f"{name}: dim {dim} of {tuple(p.shape)} does "
                             f"not split over a model axis of {n_model}")
        out[name] = pl
    return out


class TensorParallel:
    """`param_sharding`'s layout over the model axis of `mesh`, applied to
    a train state (`.model`, `.optimizer`) built whole on every rank."""

    def __init__(self, model: torch.nn.Module, mesh):
        self.shard = model_shard(mesh)
        if self.shard is None:
            raise ValueError("TensorParallel needs a model axis of more "
                             "than one rank")
        self.dims = {name: pl[1].dim
                     for name, pl in param_sharding(model, mesh).items()
                     if getattr(pl[1], "dim", None) is not None}

    def _block(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        return t.narrow(dim, self.shard.rank * (t.shape[dim]
                                                // self.shard.size),
                        t.shape[dim] // self.shard.size).clone()

    def cut(self, model: torch.nn.Module) -> None:
        """Keep this rank's block of every split parameter of `model` (the
        same Parameter objects, their data cut), and hand the split
        modules their ModelShard."""
        params = dict(model.named_parameters())
        with torch.no_grad():
            for name, dim in self.dims.items():
                params[name].data = self._block(params[name].data, dim)
        model.set_model_shard(self.shard)

    def apply(self, state) -> None:
        """`cut` the state's model, and keep this rank's block of the
        split parameters' Adam moments and accumulated gradients."""
        self.cut(state.model)
        opt = state.optimizer
        for i, (name, p) in enumerate(zip(opt.names, opt.params)):
            dim = self.dims.get(name.removeprefix("model."))
            if dim is None or not name.startswith("model."):
                continue
            st = opt.adam.state.get(p, {})
            for k in ("exp_avg", "exp_avg_sq"):
                if k in st:
                    st[k] = self._block(st[k], dim)
            if opt.acc is not None:
                opt.acc[i] = self._block(opt.acc[i], dim)

    def _whole(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        parts = [torch.empty_like(t) for _ in range(self.shard.size)]
        dist.all_gather(parts, t.contiguous(), group=self.shard.group)
        return torch.cat(parts, dim=dim)

    def full_state_dict(self, state) -> dict:
        """`state.state_dict()` with every split tensor gathered whole:
        the layout of a single-device run (every rank takes part)."""
        sd = state.state_dict()
        for name, dim in self.dims.items():
            sd["model"][name] = self._whole(sd["model"][name], dim)
            st = sd["optimizer"]["adam"].get(f"model.{name}", {})
            for k in ("exp_avg", "exp_avg_sq"):
                if k in st:
                    st[k] = self._whole(st[k], dim)
            acc = sd["optimizer"]["acc"]
            if acc is not None:
                acc[f"model.{name}"] = self._whole(acc[f"model.{name}"],
                                                   dim)
        return sd
