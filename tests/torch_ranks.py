"""A pool of gloo ranks on the CPU for the port's multi-rank tests.

`run_ranks(world, fn, cases, tmp)` (or `Ranks(...)`, then `.join()`) spawns `world` processes (the `spawn`
start method: a fresh interpreter each, no forked threads), joins them in
one process group through a `FileStore` under `tmp`
(`parallel/multihost.py::initialize`; no ports, so the suite's parallel
workers cannot collide), runs `fn(cases)` in each with
torch on two intra-op threads, and returns each rank's result, rank 0
first.  A rank that raises fails the call with its traceback; a rank that
does not finish within `timeout` seconds is killed and fails it too, so a
deadlocked collective cannot hang the suite.

`fn` must be importable by the children without JAX: the rank-side work
of each test file lives in this module.
"""

from __future__ import annotations

import functools
import os
import pickle
import queue
import time
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp


def _child(rank: int, world: int, store: str, work: str, out) -> None:
    import torch.distributed as dist
    from relpose_gnn_tpu_torch.parallel.multihost import initialize
    torch.set_num_threads(2)
    try:
        with open(work, "rb") as f:
            fn, cases = pickle.load(f)
        initialize(None, world, rank, device="cpu",
                   store=dist.FileStore(store, world))
        try:
            out.put((rank, "ok", fn(cases)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the parent
        out.put((rank, "error", traceback.format_exc()))


class Ranks:
    """`world` spawned gloo ranks running `fn(cases)`; `join()` waits for
    them and returns each rank's result, rank 0 first.  The caller may
    work in between (the ranks are other processes)."""

    def __init__(self, world: int, fn, cases, tmp, timeout: float = 600.0):
        ctx = mp.get_context("spawn")
        self.world, self.timeout = world, timeout
        self.out = ctx.Queue()
        os.makedirs(str(tmp), exist_ok=True)
        store = os.path.join(str(tmp), "store")
        # the cases go through a file, not the start-up pipe: a payload
        # larger than the pipe holds would make each start wait for its
        # child to boot, one rank after the other
        work = os.path.join(str(tmp), "work.pkl")
        with open(work, "wb") as f:
            pickle.dump((fn, cases), f)
        self.procs = [ctx.Process(target=_child,
                                  args=(r, world, store, work, self.out))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def join(self) -> list:
        results, errors = {}, []
        try:
            for _ in self.procs:   # drain before joining
                rank, status, value = self.out.get(timeout=self.timeout)
                if status == "ok":
                    results[rank] = value
                else:
                    errors.append(f"rank {rank}:\n{value}")
                    break
        except queue.Empty:
            missing = sorted(set(range(self.world)) - set(results))
            errors.append(f"ranks {missing} did not finish within "
                          f"{self.timeout} s")
        finally:
            for p in self.procs:
                p.join(timeout=10 if not errors else 1)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
        if errors:
            raise RuntimeError("\n".join(errors))
        return [results[r] for r in range(self.world)]


def run_ranks(world: int, fn, cases, tmp, timeout: float = 600.0) -> list:
    return Ranks(world, fn, cases, tmp, timeout).join()


# ---------------------------------------------------------------------------
# rank-side work
# ---------------------------------------------------------------------------


def to_numpy(tree):
    """Tensors of a nested dict/list/tuple as numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    if torch.is_tensor(tree):   # bfloat16 widened (exactly) for numpy
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree


def run_cases(cases: list) -> dict:
    """{case name: result} of `cases`, each a (name, function, kwargs)
    triple run in order on every rank."""
    return {name: to_numpy(fn(**kw)) for name, fn, kw in cases}


def np_state(sd: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def torch_state(sd: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


# -- the relocalization service -----------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_service_weights(seq: int, h: int, w: int, rhw: tuple,
                        model_kw: tuple) -> tuple:
    """(model, NetVLAD) variables of the JAX package's tiny service model
    (`model_kw` as sorted items) from keys 0 and 1, inited once a process
    (tests/test_torch_sharding.py and tests/test_torch_sharded_db.py both
    start from them).  Called by the test process only: it imports JAX."""
    import jax
    import jax.numpy as jnp
    from relpose_gnn_tpu.models.netvlad import NetVLADEncoder
    from relpose_gnn_tpu.models.posenet import RelPoseGNN, RelPoseGNNConfig
    jmodel = RelPoseGNN(RelPoseGNNConfig(**dict(model_kw)))
    mvars = jax.device_get(jax.jit(lambda k: jmodel.init(
        k, jnp.ones((1, seq, h, w, 3)), jnp.ones((1, seq, seq), bool),
        train=False))(jax.random.PRNGKey(0)))
    jnet = NetVLADEncoder(num_clusters=4)
    nvars = jax.device_get(jax.jit(lambda k: jnet.init(
        k, jnp.ones((1, *rhw, 3))))(jax.random.PRNGKey(1)))
    return mvars, nvars


def model_norm(x):
    return (x - 0.5) / 0.25


def port_service(weights: dict, model_kw: dict, svc_kw: dict):
    """The port's service on the CPU from numpy state dicts
    {"model": ..., "netvlad": ... or None}."""
    from relpose_gnn_tpu_torch.evaluation.service import (
        RelocalizationService, ServiceConfig)
    from relpose_gnn_tpu_torch.models.netvlad import NetVLADEncoder
    from relpose_gnn_tpu_torch.models.posenet import (RelPoseGNN,
                                                      RelPoseGNNConfig)
    model = RelPoseGNN(RelPoseGNNConfig(**model_kw)).eval()
    model.load_state_dict(torch_state(weights["model"]), strict=True)
    netvlad = None
    if svc_kw.get("retrieval", "netvlad") == "netvlad":
        netvlad = NetVLADEncoder(num_clusters=4).eval()
        netvlad.load_state_dict(torch_state(weights["netvlad"]), strict=True)
    return RelocalizationService(model, netvlad, ServiceConfig(**svc_kw),
                                 device="cpu")


def service_script(weights: dict, model_kw: dict, svc_kw: dict, data: dict,
                   ops: list, n_data: int | None = None) -> list:
    """Run `ops` on a fresh service and return one output per op (None
    where the op returns nothing).  Ops:
      ("build", lo, hi) / ("add", lo, hi): frames db[lo:hi], batch 4
      ("shard",) / ("replicate",): over create_mesh(n_data)
      ("invalidate", rows); ("compact",) -> old_to_new
      ("query", seed[, lo, hi]) -> {neighbors, anchor, pose} of q[lo:hi]
      ("state",) -> the whole tables (gathered), count and local rows
      ("save", path); ("load", path)
      ("await", path): wait for another process to write the file
      ("raises", op) -> the message of the ValueError `op` raises"""
    from relpose_gnn_tpu_torch.parallel.mesh import create_mesh
    from relpose_gnn_tpu_torch.parallel.multihost import host_read
    svc = port_service(weights, model_kw, svc_kw)
    mesh = None if n_data is None else create_mesh(n_data=n_data)

    def run(op):
        kind = op[0]
        if kind == "build":
            return svc.build(data["db"][op[1]:op[2]],
                             data["poses"][op[1]:op[2]], model_norm, batch=4)
        if kind == "add":
            return svc.add_frames(data["db"][op[1]:op[2]],
                                  data["poses"][op[1]:op[2]], model_norm,
                                  batch=4)
        if kind == "shard":
            return svc.shard_database(mesh)
        if kind == "replicate":
            return svc.replicate_over(mesh)
        if kind == "invalidate":
            return svc.invalidate_frames(op[1])
        if kind == "compact":
            return svc.compact_database()
        if kind == "query":
            lo, hi = op[2:4] if len(op) > 2 else (0, len(data["q"]))
            return svc.query(data["q"][lo:hi], model_norm, op[1])
        if kind == "state":
            sharded = svc._db_axis is not None

            def table(x):   # a copy: later ops write the tables in place
                return (host_read(x, svc._mesh, svc._db_axis) if sharded
                        else x.clone())
            return {"desc": table(svc.db_desc), "emb": table(svc.db_emb),
                    "poses": svc.db_poses.clone(),
                    "valid": svc.db_valid.clone(),
                    "count": svc.db_count,
                    "local_rows": svc.db_desc.shape[0]}
        if kind == "save":
            return svc.save_database(op[1])
        if kind == "load":
            return svc.load_database(op[1])
        if kind == "await":
            deadline = time.monotonic() + 300
            while not os.path.exists(op[1]):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{op[1]} was never written")
                time.sleep(0.05)
            return None
        if kind == "raises":
            try:
                run(op[1])
            except ValueError as e:
                return str(e)
            return None
        raise ValueError(f"unknown op {op!r}")

    return [run(op) for op in ops]


# -- training -------------------------------------------------------------------

def _injected_dropout(masks: list):
    """A stand-in for RelPoseGNN._dropout that hands the port's own
    dropout the queued GLOBAL keep masks (x first, then e, a step at a
    time): its uniform draw returns 0 where the mask keeps, 1 where it
    drops, so the row selection, the keep test and the scaling stay the
    port's."""
    from unittest import mock
    from relpose_gnn_tpu_torch.models.posenet import RelPoseGNN
    orig = RelPoseGNN._dropout

    def dropout(module, x, generator, shard=None):
        keep = torch.from_numpy(np.asarray(masks.pop(0)))
        with mock.patch("torch.rand", lambda *a, **k: (~keep).float()):
            return orig(module, x, generator, shard)

    return mock.patch.object(RelPoseGNN, "_dropout", dropout)


def train_case(cfg_kw: dict, masks: list | None = None) -> dict:
    """run_training on the CPU (the mesh comes from cfg_kw's mesh_data);
    returns the epochs' losses rank 0 wrote, the best medians and the
    final train state."""
    import contextlib
    import json
    import os.path as osp
    from relpose_gnn_tpu_torch.training import experiment as exp
    cfg = exp.ExperimentConfig(**cfg_kw)
    with (_injected_dropout(list(masks)) if masks is not None
          else contextlib.nullcontext()):
        out = exp.run_training(cfg, device="cpu")
    path = osp.join(cfg.save_dir, cfg.dataset, cfg.train_scene,
                    cfg.exp_name, "metrics.jsonl")
    losses = {}
    if osp.isfile(path):
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                if "loss" in rec:
                    losses[rec["epoch"]] = rec["loss"]
    state = out["state"]
    return {"losses": losses, "best": out["best"],
            "weights": cfg.weights_filename,
            "ckpt": cfg.ckpt_dir or osp.join(osp.dirname(path), "ckpt"),
            "model": np_state(state.model.state_dict()),
            "criterion": np_state(dict(state.criterion)),
            "criterion_R": np_state(dict(state.criterion_R)),
            "step": state.step}


def placement_case(x: np.ndarray) -> dict:
    """put_like / host_read over create_mesh(n_data=2): this rank's block
    of rows, the whole tensor read back, a replicated tensor, a scalar
    and a 0-d tensor."""
    from relpose_gnn_tpu_torch.parallel.mesh import create_mesh
    from relpose_gnn_tpu_torch.parallel.multihost import host_read, put_like
    mesh = create_mesh(n_data=2)
    mine = put_like(x, mesh, "data", device="cpu")
    whole = put_like(x, mesh, "replicate", device="cpu")
    scalar = put_like(np.float32(3.5), mesh, device="cpu")
    return {"block": mine, "read": host_read(mine, mesh),
            "whole": whole, "read_whole": host_read(whole),
            "scalar": host_read(scalar, mesh),
            "zero_d": host_read(torch.tensor(7, dtype=torch.int64), mesh)}


def step_case(weights: dict, model_kw: dict, batch: dict, seed: int) -> dict:
    """One train-mode forward, loss and backward of this rank's rows of
    `batch` under DistributedDataParallel over create_mesh(n_data=2):
    the global metrics, the all-reduced gradients, the BN running
    statistics after the forward, this rank's rows of the dropout masks
    drawn from `seed`, and the BN all-reduces issued."""
    from relpose_gnn_tpu_torch.models import resnet
    from relpose_gnn_tpu_torch.models.posenet import (RelPoseGNN,
                                                      RelPoseGNNConfig)
    from relpose_gnn_tpu_torch.parallel.mesh import create_mesh
    from relpose_gnn_tpu_torch.parallel.sharding import (data_shard,
                                                         shard_batch)
    from relpose_gnn_tpu_torch.training import trainer
    mesh = create_mesh(n_data=2)
    shard = data_shard(mesh)
    model = RelPoseGNN(RelPoseGNNConfig(**model_kw))
    model.load_state_dict(torch_state(weights), strict=True)
    state = trainer.create_train_state(model, trainer.TrainerConfig())
    local = torch_state(shard_batch(mesh, batch))
    ddp = trainer._data_parallel(state, state.optimizer.cfg, mesh)
    resnet.COUNTS["bn_all_reduce"] = 0
    total, metrics = ddp(local, torch.Generator().manual_seed(seed), shard)
    total.backward()
    ones = torch.ones(local["images"].shape[:2] + (model_kw["node_dim"],))
    mask = model._dropout(ones, torch.Generator().manual_seed(seed),
                          shard) != 0
    return {"metrics": metrics,
            "grads": {n: p.grad for n, p in zip(state.optimizer.names,
                                                state.optimizer.params)
                      if p.grad is not None},
            "buffers": {k: v for k, v in model.state_dict().items()
                        if "running" in k},
            "mask": mask, "bn_all_reduce": resnet.COUNTS["bn_all_reduce"]}


def lookup_case(q_desc, desc, emb, valid, n_data: int, **kw) -> dict:
    """parallel/sharded_db.py::select_and_lookup over create_mesh(n_data)
    on this rank's rows of the tables `desc` and `emb`."""
    from relpose_gnn_tpu_torch.parallel.mesh import (DATA_AXIS, axis_rank,
                                                     create_mesh)
    from relpose_gnn_tpu_torch.parallel.multihost import block
    from relpose_gnn_tpu_torch.parallel.sharded_db import select_and_lookup
    mesh = create_mesh(n_data=n_data)
    rows = block(len(desc), n_data, axis_rank(mesh, DATA_AXIS))
    desc = torch.from_numpy(desc)
    if kw.pop("bf16", False):
        desc = desc.to(torch.bfloat16)
    nbrs, nbr_emb = select_and_lookup(
        torch.from_numpy(q_desc), desc[rows],
        torch.from_numpy(emb)[rows], torch.from_numpy(valid), mesh=mesh,
        axis=DATA_AXIS, **kw)
    return {"nbrs": nbrs, "emb": nbr_emb}


def mesh_case() -> dict:
    """Meshes over a world of two ranks: their shapes, this rank's place,
    and the refusals."""
    from relpose_gnn_tpu_torch.parallel import mesh as pm
    out = {}
    for name, kw in (("default", {}), ("model2", dict(n_model=2)),
                     ("data1", dict(n_data=1)), ("data2", dict(n_data=2))):
        m = pm.create_mesh(**kw)
        out[name] = {"names": tuple(m.mesh_dim_names),
                     "shape": tuple(int(v) for v in m.mesh.shape),
                     "in_mesh": pm.in_mesh(m)}
        if pm.in_mesh(m):
            out[name].update(
                data=(pm.axis_size(m, pm.DATA_AXIS),
                      pm.axis_rank(m, pm.DATA_AXIS)),
                model=(pm.axis_size(m, pm.MODEL_AXIS),
                       pm.axis_rank(m, pm.MODEL_AXIS)))
    single = pm.single_device_mesh()
    out["single"] = {"shape": tuple(int(v) for v in single.mesh.shape)}
    for name, kw in (("too_big", dict(n_data=4)),
                     ("odd_model", dict(n_model=3))):
        try:
            pm.create_mesh(**kw)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def batch_case(batch: dict) -> dict:
    """This rank's rows of a batch split over create_mesh(n_data=2)."""
    from relpose_gnn_tpu_torch.parallel.mesh import create_mesh
    from relpose_gnn_tpu_torch.parallel.sharding import shard_batch
    return shard_batch(create_mesh(n_data=2), batch)


def cached_eval_case(weights: dict, model_kw: dict, root: str,
                     images: np.ndarray, **kw) -> dict:
    """evaluation/serving.py::evaluate_scene_cached over
    create_mesh(n_data=2) on the store at `root`."""
    from relpose_gnn_tpu_torch.data.packed import PackedGraphDataset
    from relpose_gnn_tpu_torch.evaluation.serving import \
        evaluate_scene_cached
    from relpose_gnn_tpu_torch.models.posenet import (RelPoseGNN,
                                                      RelPoseGNNConfig)
    from relpose_gnn_tpu_torch.parallel.mesh import create_mesh
    model = RelPoseGNN(RelPoseGNNConfig(**model_kw)).eval()
    model.load_state_dict(torch_state(weights), strict=True)
    return evaluate_scene_cached(model, PackedGraphDataset(root), images,
                                 device="cpu", mesh=create_mesh(n_data=2),
                                 **kw)


def tp_step_case(weights: dict, model_kw: dict, batch: dict,
                 seed: int) -> dict:
    """One train-mode forward, loss and backward with the GNN MLPs and
    proj_edge split over create_mesh(n_data=1, n_model=2): the loss,
    every parameter's gradient (this rank's block of the split ones) and
    the names of the split parameters with their split dim."""
    from relpose_gnn_tpu_torch.models.posenet import (RelPoseGNN,
                                                      RelPoseGNNConfig)
    from relpose_gnn_tpu_torch.parallel.mesh import create_mesh
    from relpose_gnn_tpu_torch.parallel.sharding import TensorParallel
    from relpose_gnn_tpu_torch.training import trainer
    mesh = create_mesh(n_data=1, n_model=2)
    model = RelPoseGNN(RelPoseGNNConfig(**model_kw))
    model.load_state_dict(torch_state(weights), strict=True)
    state = trainer.create_train_state(model, trainer.TrainerConfig())
    tp = TensorParallel(model, mesh)
    tp.apply(state)
    total, metrics = trainer.loss_fn(state, torch_state(batch),
                                     torch.Generator().manual_seed(seed),
                                     state.optimizer.cfg)
    total.backward()
    return {"metrics": metrics, "dims": tp.dims,
            "grads": {n: p.grad for n, p in zip(state.optimizer.names,
                                                state.optimizer.params)
                      if p.grad is not None}}


def resume_case(cfg_kw: dict) -> dict:
    """run_training for two epochs with a checkpoint after each, then the
    second epoch again resumed from the first's checkpoint: the largest
    difference between the two final train states (every tensor)."""
    import os.path as osp
    import shutil
    import torch.distributed as dist
    from relpose_gnn_tpu_torch.training import experiment as exp
    cfg = exp.ExperimentConfig(**dict(cfg_kw, max_epoch=2, ckpt_every=1))
    first = exp.run_training(cfg, device="cpu")["state"].state_dict()
    ckdir = osp.join(cfg.save_dir, cfg.dataset, cfg.train_scene,
                     cfg.exp_name, "ckpt")
    if dist.get_rank() == 0:
        shutil.rmtree(osp.join(ckdir, "1"))
    dist.barrier()
    again = exp.run_training(exp.ExperimentConfig(**dict(
        vars(cfg), resume=True)), device="cpu")["state"].state_dict()

    def flat(sd, prefix=""):
        out = {}
        for k, v in sd.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}."))
            elif torch.is_tensor(v):
                out[prefix + k] = v
        return out

    a, b = flat(first), flat(again)
    return {"keys": sorted(a) == sorted(b), "n": len(a),
            "max_diff": max(float((a[k].double() - b[k].double()).abs()
                                  .max()) for k in a),
            "steps": (first["step"], again["step"])}


def cli_case(name: str, argv: list) -> dict:
    """The port's entry point `name` (cli/<name>.py) through its `main`,
    on ranks whose process group is already up: its PoseErrors' medians
    and predictions."""
    import importlib
    err = importlib.import_module(f"relpose_gnn_tpu_torch.cli.{name}").main(
        argv)
    return {"median_t": err.median_t, "median_q": err.median_q,
            "pred": err.pred_poses}
