"""Train and eval steps, the optimizer, pose fusion (PyTorch).

Port of `relpose_gnn_tpu/training/trainer.py`.  The JAX train step is one
jitted program (forward, masked homoscedastic L1, gradients, Adam); here it
is the same work in eager PyTorch on the card:

  * `TrainState` holds the model, the two learnable criterion sets
    (`criterion` for the absolute head, `criterion_R` for the relative
    one), the `Optimizer` and the number of train steps taken.
  * `make_optimizer` is optax's chain around one `torch.optim.Adam`:
    `zero_nans` (NaN -> 0 on the gradients, infinities left alone) if
    `filter_nans`, `add_decayed_weights` (torch Adam's `weight_decay`, on
    every parameter, criterion scalars included), `scale_by_adam`, and the
    reference's staircase decay (x `lr_decay` every `lr_decay_step`
    epochs), counted in OPTIMIZER updates; `grad_accum` > 1 averages k
    micro-batches first, as `optax.MultiSteps` does (running mean).
  * Dropout and edge dropout draw from `torch.Generator`s seeded by
    (seed, step), the counterpart of `fold_in(rng, state.step)`: a step's
    draws depend on the step alone, so a resumed run draws what the
    uninterrupted one did.  The draws are the port's own; `jax.random`'s
    cannot be reproduced.

Over several GPUs (`make_train_step(cfg, mesh)`, parallel/mesh.py), each
rank takes its rows of the global batch and the step computes what one
process computes on the whole batch, as the JAX trainer does under a batch
split over the data axis:

  * the forward and the loss run as one module (model and criterion
    scalars, `_StepLoss`) wrapped in DistributedDataParallel over the data
    group, which all-reduces the gradients and divides by the number of
    ranks (exact at one rank); Adam's state is whole on every rank and
    takes the same update there;
  * train-mode BatchNorm normalises with the global batch's statistics
    (models/resnet.py), dropout keeps this rank's rows of the global
    batch's masks (models/posenet.py), and the masked L1 divides by the
    global count (training/criterion.py), through the step's
    `parallel/sharding.py::DataShard`;
  * the metrics are the global batch's, the same on every rank.

Quirk (train.py:238-247): the reference's train-time edge dropout masks only
`data.edge_attr`, which the production model never reads: a no-op.
`edge_dropout_effective=False` (default) keeps that; True applies the mask
to the adjacency.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
import torch.nn as nn

from relpose_gnn_tpu_torch.models.posenet import RelPoseGNN
from relpose_gnn_tpu_torch.ops import graph as graph_ops
from relpose_gnn_tpu_torch.parallel.mesh import DATA_AXIS, axis_group
from relpose_gnn_tpu_torch.parallel.sharding import data_shard
from relpose_gnn_tpu_torch.retrieval.subsample import fold_in
from relpose_gnn_tpu_torch.training import criterion as crit
from relpose_gnn_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """Hyperparameters; the JAX TrainerConfig's fields and defaults
    (train.py:44-77 and its argparse)."""

    lr: float = 1e-4
    lr_decay: float = 0.1
    lr_decay_step: int = 50          # epochs between decays
    weight_decay: float = 5e-4
    sax: float = 0.0
    saq: float = -2.0
    srx: float = 0.0
    srq: float = -2.0
    lambda_ap: float = 0.0           # absolute-pose loss weight
    use_vo_loss: bool = True
    edge_keep_factor: float = 0.5
    edge_dropout_effective: bool = False  # replicate the no-op quirk
    filter_nans: bool = False        # zero NaN gradients before Adam
    steps_per_epoch: int = 1000
    grad_accum: int = 1


class Optimizer:
    """What `make_optimizer` returns: optax's chain (module docstring)
    around one `torch.optim.Adam` whose param groups are the reference's
    three (model, criterion, criterion_R).

    `updates` counts optimizer updates (the schedule's count), `mini_step`
    the micro-batches folded into `acc` since the last update."""

    def __init__(self, cfg: TrainerConfig,
                 named_groups: list[list[tuple[str, nn.Parameter]]]):
        self.cfg = cfg
        self.names = [n for group in named_groups for n, _ in group]
        self.params = [p for group in named_groups for _, p in group]
        self.adam = torch.optim.Adam(
            [{"params": [p for _, p in group]} for group in named_groups],
            lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=cfg.weight_decay)
        updates_per_epoch = max(1, cfg.steps_per_epoch
                                // max(1, cfg.grad_accum))
        self.transition = cfg.lr_decay_step * updates_per_epoch
        self.updates = 0
        self.mini_step = 0
        self.acc: list[torch.Tensor] | None = None

    def lr(self) -> float:
        """The learning rate of the next update (staircase decay)."""
        if self.transition <= 0:
            return self.cfg.lr
        return self.cfg.lr * self.cfg.lr_decay ** (self.updates
                                                   // self.transition)

    def step(self) -> bool:
        """Take the gradients in `.grad` (after a backward); update the
        parameters if this completes `grad_accum` micro-batches.  Returns
        whether they were updated."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        k = self.cfg.grad_accum
        if k > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(p) for p in self.params]
            n = self.mini_step
            self.acc = [a + (g - a) / (n + 1) for a, g in zip(self.acc,
                                                              grads)]
            self.mini_step = (n + 1) % k
            if self.mini_step:
                return False
            grads, self.acc = self.acc, None
        for p, g in zip(self.params, grads):
            if self.cfg.filter_nans:
                g = torch.where(torch.isnan(g), torch.zeros_like(g), g)
            p.grad = g
        lr = self.lr()
        for group in self.adam.param_groups:
            group["lr"] = lr
        self.adam.step()
        self.updates += 1
        return True

    def state_dict(self) -> dict:
        """Adam's moments and step by parameter name, the counts and the
        accumulated gradients: everything an exact resume needs."""
        adam = {}
        for name, p in zip(self.names, self.params):
            st = self.adam.state.get(p)
            if st:
                adam[name] = {k: v.detach().clone() if torch.is_tensor(v)
                              else v for k, v in st.items()}
        return {"adam": adam, "updates": self.updates,
                "mini_step": self.mini_step,
                "acc": None if self.acc is None else dict(zip(
                    self.names, (a.detach().clone() for a in self.acc)))}

    def load_state_dict(self, sd: dict) -> None:
        by_name = dict(zip(self.names, self.params))
        unknown = sorted(set(sd["adam"]) - set(by_name))
        if unknown:
            raise ValueError(f"optimizer state for unknown parameters "
                             f"{unknown[:6]}")
        self.adam.state.clear()
        for name, st in sd["adam"].items():
            p = by_name[name]
            self.adam.state[p] = {
                "step": torch.as_tensor(st["step"],
                                        dtype=torch.float32).clone(),
                "exp_avg": st["exp_avg"].to(p.device, p.dtype).clone(),
                "exp_avg_sq": st["exp_avg_sq"].to(p.device,
                                                  p.dtype).clone()}
        self.updates = int(sd["updates"])
        self.mini_step = int(sd["mini_step"])
        self.acc = (None if sd["acc"] is None else
                    [sd["acc"][n].to(p.device, p.dtype).clone()
                     for n, p in zip(self.names, self.params)])


@dataclasses.dataclass
class TrainState:
    """The model (its BN running statistics are buffers), the criterion
    scalars, the optimizer and the number of train steps taken (micro
    steps, as the JAX `state.step`)."""

    model: RelPoseGNN
    criterion: nn.ParameterDict
    criterion_R: nn.ParameterDict
    optimizer: Optimizer
    step: int = 0

    def state_dict(self) -> dict:
        """Everything `load_state_dict` needs for an exact resume; tensors
        are copies, on their devices."""
        return {"model": {k: v.detach().clone()
                          for k, v in self.model.state_dict().items()},
                "criterion": {k: v.detach().clone()
                              for k, v in self.criterion.items()},
                "criterion_R": {k: v.detach().clone()
                                for k, v in self.criterion_R.items()},
                "optimizer": self.optimizer.state_dict(),
                "step": self.step}

    def load_state_dict(self, sd: dict) -> None:
        """Load a `state_dict()` (or `models/convert.py::
        train_state_from_jax` output).  The model loads with strict=True;
        missing "optimizer" or "step" leave those as they are."""
        self.model.load_state_dict(sd["model"], strict=True)
        with torch.no_grad():
            for name in ("criterion", "criterion_R"):
                own = getattr(self, name)
                if set(sd[name]) != set(own):
                    raise ValueError(f"{name}: keys {sorted(sd[name])} != "
                                     f"{sorted(own)}")
                for k, v in sd[name].items():
                    own[k].copy_(torch.as_tensor(v))
        if "optimizer" in sd:
            self.optimizer.load_state_dict(sd["optimizer"])
        if "step" in sd:
            self.step = int(sd["step"])


def named_param_groups(model: nn.Module, criterion: nn.ParameterDict,
                       criterion_R: nn.ParameterDict) -> list:
    """The reference's three param groups, as (name, parameter) pairs."""
    return [[(f"model.{n}", p) for n, p in model.named_parameters()],
            [(f"criterion.{n}", p) for n, p in criterion.items()],
            [(f"criterion_R.{n}", p) for n, p in criterion_R.items()]]


def make_optimizer(cfg: TrainerConfig, model: nn.Module,
                   criterion: nn.ParameterDict,
                   criterion_R: nn.ParameterDict) -> Optimizer:
    return Optimizer(cfg, named_param_groups(model, criterion, criterion_R))


def create_train_state(model: RelPoseGNN, cfg: TrainerConfig) -> TrainState:
    """A fresh TrainState around `model` (weights as they are): criterion
    scalars from the config, on the model's device, a fresh optimizer."""
    device = next(model.parameters()).device
    criterion = crit.init_criterion_params(cfg.sax, cfg.saq, device=device)
    criterion_R = crit.init_criterion_params(cfg.srx, cfg.srq, device=device)
    return TrainState(model, criterion, criterion_R,
                      make_optimizer(cfg, model, criterion, criterion_R))


def step_generators(seed: int, step: int, device: torch.device
                    ) -> tuple[torch.Generator, torch.Generator]:
    """(dropout, edge dropout) generators of train step `step`, on
    `device`: functions of (seed, step) alone."""
    s = fold_in(seed, step)
    return tuple(torch.Generator(device=device).manual_seed(fold_in(s, k))
                 for k in (0, 1))


def loss_fn(state: TrainState, batch: dict, generator: torch.Generator,
            cfg: TrainerConfig, shard=None) -> tuple[torch.Tensor, dict]:
    """Training forward + homoscedastic relative-pose loss
    (train.py:255-264).  Updates the BN running statistics.  With
    `shard` (a DataShard) the batch is this rank's rows and the loss this
    rank's share (training/criterion.py); the metrics are then the global
    batch's."""
    pred_abs, pred_rel, adj, _ = state.model(batch["images"], batch["adj"],
                                             train=True, generator=generator,
                                             shard=shard)
    target_rel = graph_ops.relative_pose_targets(batch["poses"])
    loss_r, t_loss, q_loss = crit.pose_net_criterion(
        state.criterion_R, pred_rel, target_rel, mask=adj, shard=shard)
    if cfg.use_vo_loss:
        total = loss_r
    else:
        total, t_loss, q_loss = crit.pose_net_criterion(
            state.criterion, pred_abs, batch["poses"])
    if cfg.lambda_ap > 0:
        abs_loss, _, _ = crit.pose_net_criterion(state.criterion, pred_abs,
                                                 batch["poses"])
        total = total + cfg.lambda_ap * abs_loss
    metrics = {"loss": total, "t_loss": t_loss, "q_loss": q_loss,
               "sax_R": state.criterion_R["sax"],
               "saq_R": state.criterion_R["saq"]}
    metrics = {k: v.detach().clone() for k, v in metrics.items()}
    if shard is not None:
        # the ranks' shares average to the global batch's values
        shares = torch.stack([metrics[k] for k in ("loss", "t_loss",
                                                   "q_loss")])
        dist.all_reduce(shares, group=shard.group)
        shares = shares / shard.size
        metrics.update(loss=shares[0], t_loss=shares[1], q_loss=shares[2])
    return total, metrics


class _StepLoss(nn.Module):
    """The train step's forward and loss over every parameter the
    optimizer updates (the model and both criterion sets): the module
    DistributedDataParallel wraps."""

    def __init__(self, state: TrainState, cfg: TrainerConfig):
        super().__init__()
        self.model = state.model
        self.criterion = state.criterion
        self.criterion_R = state.criterion_R
        self.cfg = cfg

    def forward(self, batch: dict, generator: torch.Generator, shard):
        # loss_fn reads .model, .criterion and .criterion_R, which this
        # module holds as a TrainState does
        return loss_fn(self, batch, generator, self.cfg, shard)


def _data_parallel(state: TrainState, cfg: TrainerConfig, mesh):
    """`_StepLoss` under DistributedDataParallel over the mesh's data
    group.  BN buffers are not broadcast each step: every rank folds the
    same global statistics into its own.  The absolute head and its
    criterion get no gradient under the relative-pose loss, so unused
    parameters are looked for."""
    from torch.nn.parallel import DistributedDataParallel
    return DistributedDataParallel(
        _StepLoss(state, cfg), process_group=axis_group(mesh, DATA_AXIS),
        broadcast_buffers=False, find_unused_parameters=True)


def make_train_step(cfg: TrainerConfig, mesh=None):
    """train_step(state, batch, seed) -> metrics (tensors on the device,
    not synchronised): forward, loss, backward, optimizer, step + 1.
    `batch` holds normalised float images [B, N, H, W, 3], poses
    [B, N, 6] and a bool adjacency [B, N, N] on the model's device.

    With `mesh` (parallel/mesh.py) the batch is this rank's rows of the
    global batch, split over the data axis, and the gradients are
    all-reduced by DistributedDataParallel (module docstring); a data
    axis of one rank runs the single-device computation under it.  A
    mesh whose data axis has no process group (a `LocalMesh`: no
    `init_process_group`) runs the single-device step as it is.

    A step is the span `train.step` holding `train.forward`,
    `train.backward` and `train.optimizer` (utils/profiling.py)."""
    shard = data_shard(mesh)
    if mesh is not None and axis_group(mesh, DATA_AXIS) is None:
        mesh = None
    wrapped = {}

    def train_step(state: TrainState, batch: dict, seed: int) -> dict:
        with span("train.step"):
            device = batch["images"].device
            drop_gen, edge_gen = step_generators(seed, state.step, device)
            if cfg.edge_dropout_effective:
                adj = batch["adj"]
                b = adj.shape[0]
                keep = graph_ops.edge_dropout_mask(
                    edge_gen, adj.shape[-1], cfg.edge_keep_factor,
                    batch_shape=(b if shard is None else shard.size * b,)
                    + tuple(adj.shape[1:-2]))
                if shard is not None:   # this rank's rows of the global masks
                    keep = keep[shard.rows(b)]
                batch = dict(batch, adj=adj & graph_ops.ensure_nonempty(keep))
            for p in state.optimizer.params:
                p.grad = None
            with span("train.forward"):
                if mesh is None:
                    total, metrics = loss_fn(state, batch, drop_gen, cfg)
                else:
                    ddp = wrapped.get(id(state))
                    if ddp is None:
                        ddp = wrapped[id(state)] = _data_parallel(state, cfg,
                                                                  mesh)
                    total, metrics = ddp(batch, drop_gen, shard)
            with span("train.backward"):
                total.backward()
            with span("train.optimizer"):
                state.optimizer.step()
            state.step += 1
            return metrics

    return train_step


def fuse_pose_estimates(est: torch.Tensor, mask: torch.Tensor,
                        fuse: str) -> torch.Tensor:
    """Fuse per-source absolute-pose estimates for one query node.

    est [B, N, 6] (the estimate from each potential source node), mask
    [B, N] (True where an edge source -> query exists) -> [B, 6].
    'mean' is the masked mean; 'median' the masked per-dimension median
    (sort with a +inf fill, average the two middle entries).

    PRECONDITION: every row has at least one True in `mask`; a zero-edge
    row fuses to zeros ('mean') or +inf ('median').  The eval step reports
    it as `fuse_ok` and `check_fuse_ok` raises."""
    if fuse == "mean":
        w = mask.to(est.dtype)[..., None]
        return torch.sum(est * w, 1) / torch.clamp_min(torch.sum(w, 1), 1.0)
    if fuse != "median":
        raise ValueError(f"fuse={fuse!r} (want 'mean' or 'median')")
    big = torch.where(mask[..., None], est,
                      torch.full_like(est, float("inf")))
    srt = torch.sort(big, dim=1).values
    cnt = torch.sum(mask, dim=1)
    n = est.shape[1]
    lo = torch.clamp((cnt - 1) // 2, 0, n - 1)
    hi = torch.clamp(cnt // 2, 0, n - 1)

    def take(k):
        idx = k[:, None, None].expand(-1, 1, est.shape[2])
        return torch.gather(srt, 1, idx)[:, 0]

    return 0.5 * (take(lo) + take(hi))


def check_fuse_ok(out: dict, where: str, group=None) -> None:
    """Raise on an eval step's false `fuse_ok` flag (see
    fuse_pose_estimates' precondition); no-op without the flag.  With a
    process `group` (a batch split over its ranks) the flags of every
    rank decide together, so all raise or none does."""
    if "fuse_ok" in out and group is not None:
        bad = (~out["fuse_ok"]).to(torch.int32).reshape(1)
        dist.all_reduce(bad, group=group)
        out = dict(out, fuse_ok=bad[0] == 0)
    if "fuse_ok" in out and not bool(out["fuse_ok"]):
        raise ValueError(
            f"{where}: a query row has ZERO incoming edges in the fuse "
            "mask; fuse='mean'/'median' would silently produce an all-zero "
            "pose or a +inf median for it.  The adjacency feeding this "
            "eval is pathological (or was rebuilt with knn too small)")


def make_eval_step(ref_node: int = 0, fuse: str = "first",
                   static_anchor: int | None = None):
    """eval_step(state, batch) -> {pred [B, 6], target [B, 6], pred_abs
    [B, 6], nbr [B]} (+ `fuse_ok` for 'mean'/'median'), under
    inference_mode, BN on running statistics.

    fuse='first' (reference parity, testing/test.py:227-233): the query's
    pose from ONE relative pose, anchored at `static_anchor` if given (the
    knn=0 protocol) else at the query's nearest neighbour in pre-GNN
    feature space: `poses[nbr] - pred_rel[nbr, ref]`.  'mean' / 'median'
    fuse every incoming estimate `poses[s] - pred_rel[s, ref]` over the
    edges s -> ref of the effective adjacency."""
    if fuse not in ("first", "mean", "median"):
        raise ValueError(f"fuse={fuse!r} (want 'first', 'mean' or "
                         "'median')")

    @torch.inference_mode()
    def eval_step(state: TrainState, batch: dict) -> dict:
        pred_abs, pred_rel, adj, aux = state.model(batch["images"],
                                                   batch["adj"])
        b = pred_rel.shape[0]
        rows = torch.arange(b, device=pred_rel.device)
        if static_anchor is not None:
            nbr = torch.full((b,), static_anchor, dtype=torch.int64,
                             device=pred_rel.device)
        else:
            nbr = graph_ops.nearest_neighbor(aux["node_feats"],
                                             node=ref_node)
        poses = batch["poses"]
        out = {}
        if fuse == "first":
            pred_query = poses[rows, nbr] - pred_rel[rows, nbr, ref_node]
        else:
            est = poses - pred_rel[:, :, ref_node]
            mask = adj[:, :, ref_node]
            pred_query = fuse_pose_estimates(est, mask, fuse)
            out["fuse_ok"] = torch.all(torch.sum(mask, dim=1) >= 1)
        out.update({"pred": pred_query, "target": poses[:, ref_node],
                    "pred_abs": pred_abs[:, ref_node], "nbr": nbr})
        return out

    return eval_step

