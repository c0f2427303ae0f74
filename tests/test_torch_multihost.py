"""The port's multi-process layer (relpose_gnn_tpu_torch/parallel/
multihost.py, the data-parallel train step and run_training over a mesh)
against the JAX package, on the CPU: the JAX side on the virtual 8-device
mesh of tests/conftest.py, the port's as two gloo ranks spawned by
tests/torch_ranks.py (one pool for the whole module).

Tolerances, with their basis:
  * put_like / host_read: exact (rows are copied, not computed);
  * one train step, two ranks against one process on the global batch,
    same weights and batch: the loss and its parts to 1e-6 relative, the
    BN running statistics (entries 1e-3 to 1) to 1e-6 relative or 1e-6
    absolute, and the gradients to 1e-5 relative of each tensor's largest
    entry (float32 sums split in two and all-reduced: measured up to
    1.3e-7 absolute on a running mean); the dropout masks exactly;
  * run_training over mesh_data=2 against the JAX run_training over its
    mesh_data=2 mesh, droprate 0.5 with the JAX trainer's own dropout
    masks handed to the port (tests/torch_ranks.py::_injected_dropout),
    from one `.pth.tar`, the JAX BatchNorm on the two-pass variance (as
    tests/test_torch_experiment.py): the first step's loss (before any
    update) to 1e-5 relative; after k Adam updates the loss within
    2 lr k (exp(-srx) + exp(-srq)) and every parameter within 2 lr per
    update, plus 1e-5 of its size for rounding (Adam's first update moves
    a weight by exactly +-lr, so a gradient near zero whose sign differs
    puts it 2 lr apart); eval medians as tests/test_torch_experiment.py
    holds them (1e-3 m, 0.1 degree);
  * the two ranks' final states: equal bit for bit.
"""

import json
import os
import os.path as osp
from unittest import mock

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_ranks
from relpose_gnn_tpu.data.packed import PackedGraphWriter as JaxWriter
from relpose_gnn_tpu.models.posenet import RelPoseGNN as JaxRelPoseGNN
from relpose_gnn_tpu.models.posenet import RelPoseGNNConfig as JaxConfig
from relpose_gnn_tpu.parallel.mesh import create_mesh as jax_create_mesh
from relpose_gnn_tpu.parallel.multihost import host_read as jax_host_read
from relpose_gnn_tpu.parallel.multihost import put_like as jax_put_like
from relpose_gnn_tpu.training import checkpoints as jax_ckpt
from relpose_gnn_tpu.training import experiment as jax_exp
from relpose_gnn_tpu_torch.data import synthetic
from relpose_gnn_tpu_torch.models import resnet
from relpose_gnn_tpu_torch.parallel import multihost
from relpose_gnn_tpu_torch.training import checkpoints as ckpt
from relpose_gnn_tpu_torch.training import experiment as exp
from relpose_gnn_tpu_torch.training import trainer

N, H, W = 4, 32, 40
STAGES = (2, 2, 2, 2)
LR = 1e-4
STEPS = 3
MODEL_KW = dict(num_nodes=N, feat_dim=32, edge_dim=32, node_dim=32, knn=0,
                backbone="resnet18", droprate=0.5)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads while this module runs: the suite runs several
    test processes on one host, and torch's default of one thread a core
    in each of them oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_cfg(root, module=exp, **kw):
    base = dict(dataset="7Scenes", experiment=2, train_scene="chess",
                test_scene="chess", train_data_dir=root, test_data_dir=root,
                exp_name="t", model_name="R3", backbone="resnet18",
                feat_dim=32, batch_size=8, seq_len=N, max_epoch=STEPS,
                eval_after_epoch=STEPS - 2, dtype="float32", knn=2,
                droprate=0.5, lr=LR)
    base.update(kw)
    return module.ExperimentConfig(**base)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """`chess_fc4_sp5_{train,test}` (8 / 5 graphs): one step an epoch at
    batch 8, and an eval batch of 5 that pads to 6 over two ranks."""
    root = tmp_path_factory.mktemp("graphs")
    rng = np.random.default_rng(0)
    pool = rng.integers(0, 256, size=(12, H, W, 3), dtype=np.uint8)
    pool_poses = rng.normal(size=(12, 6)).astype(np.float32)
    for split, n in (("train", 8), ("test", 5)):
        w = JaxWriter(str(root / f"chess_fc4_sp5_{split}"), n, N, H, W,
                      mean=[0.45, 0.44, 0.4], std=[0.22, 0.23, 0.21])
        for _ in range(n):
            idx = rng.choice(12, N, replace=False)
            w.add(pool[idx].astype(np.float32) / 255.0, pool_poses[idx],
                  ~np.eye(N, dtype=bool), nbr_idx=idx[1:])
        w.finalize()
    return str(root)


@pytest.fixture(scope="module")
def start_weights(stores, tmp_path_factory):
    """One `.pth.tar` both frameworks start from, BN statistics made
    non-trivial."""
    model = exp.build_model(tiny_cfg(stores), "cpu")
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.2, 0.2, generator=gen)
                m.running_var.uniform_(0.7, 1.3, generator=gen)
                m.weight.uniform_(0.7, 1.3, generator=gen)
    path = str(tmp_path_factory.mktemp("w") / "start.pth.tar")
    return ckpt.save_torch_checkpoint(trainer.create_train_state(
        model, trainer.TrainerConfig()), path, 0)


def jax_keep_masks(seed: int, steps: int, batch: int) -> list:
    """The keep masks (x, then e) the JAX train step draws at steps
    0..steps-1 for a global batch of `batch` 4-node graphs: flax's own
    dropout applied to ones and sown out.  They depend on the key, the
    module and the shape alone, so the part of the model that holds the
    dropout (`from_embeddings`) runs on stand-in embeddings."""
    model = JaxRelPoseGNN(JaxConfig(num_nodes=N, feat_dim=32, edge_dim=32,
                                    node_dim=32, knn=2, backbone="resnet18",
                                    droprate=0.5))
    x = jnp.asarray(np.random.default_rng(0).normal(size=(batch, N, 32)),
                    jnp.float32)
    adj = jnp.ones((batch, N, N), bool)
    variables = jax.jit(lambda k: model.init(
        k, x, adj, method=JaxRelPoseGNN.from_embeddings))(
        jax.random.PRNGKey(0))
    orig = nn.Dropout.__call__

    def ones_dropout(self, inputs, deterministic=None, rng=None):
        out = orig(self, jnp.ones_like(inputs), deterministic=deterministic,
                   rng=rng)
        self.sow("intermediates", "keep", out != 0)
        return inputs

    @jax.jit
    def masks_at(key):
        _, out = model.apply(variables, x, adj, train=True,
                             rngs={"dropout": key}, mutable=["intermediates"],
                             method=JaxRelPoseGNN.from_embeddings)
        return out["intermediates"]["dropout"]["keep"]

    masks = []
    with mock.patch.object(nn.Dropout, "__call__", ones_dropout):
        for step in range(steps):
            masks.extend(np.asarray(m) for m in masks_at(jax.random.split(
                jax.random.fold_in(jax.random.PRNGKey(seed), step))[0]))
    return masks


def step_batch() -> dict:
    """A global batch of 8 graphs on a static graph (knn=0) whose edge
    counts differ between the two ranks' halves: full graphs in rows 0-3,
    only the edges into node 0 in rows 4-7."""
    b = synthetic.synthetic_batch(np.random.default_rng(3), batch_size=8,
                                  num_nodes=N, height=H, width=W)
    adj = np.ones((8, N, N), bool) & ~np.eye(N, dtype=bool)
    adj[4:] = False
    adj[4:, 1:, 0] = True
    return {"images": b["images"].astype(np.float32),
            "poses": b["poses"].astype(np.float32), "adj": adj}


@pytest.fixture(scope="module")
def step_weights():
    model = exp.build_model(tiny_cfg("", knn=0), "cpu")
    return torch_ranks.np_state(model.state_dict())


def _shaped_init(model, cfg, sample: dict):
    """Zeros in the tree the JAX experiment's init would draw: the warm
    start then writes every leaf (`load_torch_weights` checks that it
    covers the params and the BN statistics), so only the shapes matter,
    and nothing is compiled."""
    shapes = jax.eval_shape(lambda k: model.init(
        {"params": k, "dropout": k}, jnp.asarray(sample["images"],
                                                 jnp.float32),
        jnp.asarray(sample["adj"]), train=False),
        jax.random.PRNGKey(cfg.seed))
    return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)


@pytest.fixture(scope="module")
def both(stores, start_weights, step_weights, tmp_path_factory):
    """(every rank-side case of this module, run once on two gloo ranks;
    the JAX run_training over a data=2 mesh, run meanwhile in this
    process, and its per-epoch losses)."""
    x = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
    cfg = tiny_cfg(stores, save_dir=str(tmp_path_factory.mktemp("port")),
                   mesh_data=2, weights_filename=start_weights)
    tp_cfg = tiny_cfg(stores, save_dir=str(tmp_path_factory.mktemp("tp")),
                      mesh_data=1, mesh_model=2, ckpt_every=STEPS,
                      weights_filename=start_weights)
    cases = [
        ("placement", torch_ranks.placement_case, dict(x=x)),
        ("step", torch_ranks.step_case,
         dict(weights=step_weights, model_kw=MODEL_KW, batch=step_batch(),
              seed=5)),
        ("train", torch_ranks.train_case,
         dict(cfg_kw=vars(cfg), masks=jax_keep_masks(0, STEPS, 8))),
        ("tp_step", torch_ranks.tp_step_case,
         dict(weights=step_weights, model_kw=MODEL_KW, batch=step_batch(),
              seed=5)),
        ("tp_train", torch_ranks.train_case, dict(cfg_kw=vars(tp_cfg))),
        ("resume", torch_ranks.resume_case, dict(cfg_kw=vars(tiny_cfg(
            stores, save_dir=str(tmp_path_factory.mktemp("resume")),
            mesh_data=2, eval_after_epoch=99)))),
    ]
    ranks = torch_ranks.Ranks(2, torch_ranks.run_cases, cases,
                              tmp_path_factory.mktemp("ranks"))
    import flax.linen.normalization as flax_norm
    save = str(tmp_path_factory.mktemp("jax"))
    load, stats = jax_ckpt.load_torch_weights, flax_norm._compute_stats
    with pytest.MonkeyPatch.context() as mp:
        # the JAX experiment warm-starts resnet34's stages, and flax's
        # BatchNorm takes the one-pass variance (module docstring)
        mp.setattr(jax_exp.ckpt, "load_torch_weights",
                   lambda state, path: load(state, path, STAGES))
        mp.setattr(flax_norm, "_compute_stats", lambda *a, **k: stats(
            *a, **dict(k, use_fast_variance=False)))
        # its init, which the warm start overwrites, as shapes only: on
        # the CPU it dispatches one op an initializer
        mp.setattr(jax_exp, "_jit_init", _shaped_init)
        ref = jax_exp.run_training(tiny_cfg(
            stores, jax_exp, save_dir=save, mesh_data=2,
            weights_filename=start_weights))
    with open(osp.join(save, "7Scenes", "chess", "t",
                       "metrics.jsonl")) as f:
        losses = {r["epoch"]: r["loss"] for r in map(json.loads, f)
                  if "loss" in r}
    return ranks.join(), (ref, losses)


@pytest.fixture(scope="module")
def ranks(both):
    return both[0]


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def test_put_like_and_host_read_match_jax(ranks):
    """Each rank's block is what the JAX put_like puts on the devices of
    its row of a data=2 mesh; host_read gives the whole back."""
    x = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
    mesh = jax_create_mesh(n_data=2, n_model=1)
    a = jax_put_like(x, NamedSharding(mesh, P("data")))
    blocks = {}
    for shard in a.addressable_shards:
        blocks[shard.index[0].start // 4] = np.asarray(shard.data)
    np.testing.assert_array_equal(jax_host_read(a), x)
    for r, out in enumerate(ranks):
        got = out["placement"]
        np.testing.assert_array_equal(got["block"], blocks[r])
        np.testing.assert_array_equal(got["read"], x)
        np.testing.assert_array_equal(got["whole"], x)
        np.testing.assert_array_equal(got["read_whole"], x)
        assert got["scalar"] == np.float32(3.5) == float(
            jax_put_like(np.float32(3.5), NamedSharding(mesh, P())))
        assert got["zero_d"] == 7 and got["zero_d"].shape == ()


def test_single_process_needs_no_process_group():
    assert multihost.initialize("", 1, 0) is None
    assert multihost.process_count() == 1 and multihost.is_main_process()
    x = np.arange(6.0, dtype=np.float32).reshape(3, 2)
    from relpose_gnn_tpu_torch.parallel.mesh import create_mesh
    mesh = create_mesh()
    np.testing.assert_array_equal(
        multihost.host_read(multihost.put_like(x, mesh, "data", "cpu"),
                            mesh), x)


@pytest.mark.parametrize("kw,match", [
    (dict(local_device_count=2), "launch 2 processes"),
    (dict(num_processes=2), "coordinator"),
    (dict(num_processes=2, coordinator="localhost:1", process_id=2),
     "outside"),
])
def test_initialize_refuses_what_torch_cannot_do(kw, match):
    args = dict(coordinator="", num_processes=1, process_id=0)
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        multihost.initialize(**args, device="cpu")


# ---------------------------------------------------------------------------
# one data-parallel step against one process on the global batch
# ---------------------------------------------------------------------------


def test_two_ranks_step_equals_one_process(ranks, step_weights):
    """Train-mode BatchNorm statistics, dropout masks and the masked L1
    over two ranks are those of one process on the global batch, where
    the ranks' edge counts differ (96 and 24 edge-features a component)."""
    model = exp.build_model(tiny_cfg("", knn=0), "cpu")
    model.load_state_dict(torch_ranks.torch_state(step_weights))
    state = trainer.create_train_state(model, trainer.TrainerConfig())
    batch = torch_ranks.torch_state(step_batch())
    resnet.COUNTS["bn_all_reduce"] = 0
    total, want = trainer.loss_fn(state, batch,
                                  torch.Generator().manual_seed(5),
                                  state.optimizer.cfg)
    total.backward()
    assert resnet.COUNTS["bn_all_reduce"] == 0
    mask = model._dropout(torch.ones(8, N, 32),
                          torch.Generator().manual_seed(5)) != 0
    grads = {n: p.grad for n, p in zip(state.optimizer.names,
                                       state.optimizer.params)
             if p.grad is not None}
    buffers = {k: v for k, v in model.state_dict().items() if "running" in k}

    got = [r["step"] for r in ranks]
    np.testing.assert_array_equal(
        np.concatenate([g["mask"] for g in got]), mask.numpy())
    for g in got:
        # resnet18: 20 BatchNorm layers, two all-reduces each
        assert g["bn_all_reduce"] == 2 * 20
        for k in ("loss", "t_loss", "q_loss"):
            np.testing.assert_allclose(g["metrics"][k], want[k].numpy(),
                                       rtol=1e-6, err_msg=k)
        for k, v in buffers.items():
            np.testing.assert_allclose(g["buffers"][k], v.numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
        assert set(g["grads"]) == set(grads)
        for k, v in grads.items():
            scale = max(float(v.abs().max()), 1e-12)
            err = np.abs(g["grads"][k] - v.numpy()).max() / scale
            assert err <= 1e-5, (k, err)


# ---------------------------------------------------------------------------
# run_training over two ranks against the JAX mesh
# ---------------------------------------------------------------------------


def test_run_training_over_two_ranks_matches_the_jax_mesh(both):
    from relpose_gnn_tpu_torch.models.convert import state_dict_from_jax
    ranks, (ref, want) = both
    got0, got1 = (r["train"] for r in ranks)
    assert got0["step"] == got1["step"] == int(ref["state"].step) == STEPS
    for k, v in got0["model"].items():   # replicated: the same everywhere
        np.testing.assert_array_equal(v, got1["model"][k], err_msg=k)
    assert sorted(got0["losses"]) == sorted(want) == list(range(STEPS))
    np.testing.assert_allclose(got0["losses"][0], want[0], rtol=1e-5)
    for k in range(1, STEPS):
        np.testing.assert_allclose(got0["losses"][k], want[k], rtol=0,
                                   atol=2 * LR * k * (1 + np.exp(2.0)))
    jstate = ref["state"]
    sd = state_dict_from_jax(
        jax.device_get(jstate.params["model"]),
        jax.device_get(jstate.batch_stats), STAGES)
    bound = 2 * LR * STEPS
    for k, v in got0["model"].items():
        if "running" in k or "num_batches" in k:
            continue
        w = sd[k].numpy()
        err = np.abs(v - w) - 1e-5 * np.abs(w)
        assert err.max() <= bound, (k, float(np.abs(v - w).max()))
    best_p, best_j = got0["best"]["chess"], ref["best"]["chess"]
    np.testing.assert_allclose(best_p["median_t"], best_j["median_t"],
                               atol=1e-3)
    np.testing.assert_allclose(best_p["median_q"], best_j["median_q"],
                               atol=0.1)


def test_resume_over_two_ranks_is_bit_for_bit(ranks):
    """Rank 0 writes the checkpoints, both ranks read one to resume, and
    the resumed second epoch ends in the uninterrupted run's state."""
    for r in ranks:
        got = r["resume"]
        assert got["keys"] and got["n"] > 100 and got["steps"] == (2, 2)
        assert got["max_diff"] == 0.0


def test_device_cache_over_a_mesh_is_refused(stores, tmp_path):
    """As in the JAX package: the stores held on the device serve one
    device; a mesh keeps the per-rank host feed."""
    cfg = tiny_cfg(stores, save_dir=str(tmp_path), mesh_data=1,
                   device_cache=True)
    with pytest.raises(ValueError, match="device_cache is single-device"):
        exp.run_training(cfg, device="cpu")


def test_one_process_mesh_trains_as_no_mesh(stores, start_weights,
                                            tmp_path):
    """mesh_data=1 with no process group (the single-card path: a
    LocalMesh) trains, evaluates and checkpoints as mesh_data=0, bit for
    bit: the losses, the eval medians and the final state."""
    runs = [torch_ranks.train_case(vars(tiny_cfg(
        stores, save_dir=str(tmp_path / str(m)), mesh_data=m, max_epoch=2,
        eval_after_epoch=0, ckpt_every=2, weights_filename=start_weights)))
        for m in (0, 1)]
    want, got = runs
    assert got["losses"] == want["losses"] and len(got["losses"]) == 2
    assert got["best"] == want["best"] and got["step"] == want["step"] == 2
    for part in ("model", "criterion", "criterion_R"):
        for k, v in want[part].items():
            np.testing.assert_array_equal(got[part][k], v, err_msg=k)
    assert osp.isfile(osp.join(got["ckpt"], "1", "train_state.pt"))


# ---------------------------------------------------------------------------
# tensor parallelism: the GNN MLPs and proj_edge split over two ranks
# ---------------------------------------------------------------------------


def test_tensor_parallel_step_equals_the_whole_model(ranks, step_weights):
    """mesh_model=2: the loss is the whole model's, each rank's gradient
    of a split parameter is its block of the whole gradient, and the
    other gradients are the whole model's."""
    model = exp.build_model(tiny_cfg("", knn=0), "cpu")
    model.load_state_dict(torch_ranks.torch_state(step_weights))
    state = trainer.create_train_state(model, trainer.TrainerConfig())
    total, want = trainer.loss_fn(state, torch_ranks.torch_state(
        step_batch()), torch.Generator().manual_seed(5), state.optimizer.cfg)
    total.backward()
    grads = {n: p.grad for n, p in zip(state.optimizer.names,
                                       state.optimizer.params)
             if p.grad is not None}
    got = [r["tp_step"] for r in ranks]
    dims = got[0]["dims"]
    # proj_edge's weight; fc1 weight + bias and fc2 weight of three MLPs
    assert len(dims) == 1 + 3 * 3 and got[1]["dims"] == dims
    for rank, g in enumerate(got):
        for k in ("loss", "t_loss", "q_loss"):
            np.testing.assert_allclose(g["metrics"][k], want[k].numpy(),
                                       rtol=1e-6, err_msg=k)
        assert set(g["grads"]) == set(grads)
        for name, v in grads.items():
            v = v.numpy()
            dim = dims.get(name.removeprefix("model."))
            if dim is not None and name.startswith("model."):
                n = v.shape[dim] // 2
                v = np.take(v, range(rank * n, (rank + 1) * n), axis=dim)
            scale = max(float(np.abs(v).max()), 1e-12)
            assert g["grads"][name].shape == v.shape, name
            err = np.abs(g["grads"][name] - v).max() / scale
            assert err <= 1e-5, (name, rank, err)


def test_tensor_parallel_run_training_equals_one_process(ranks, stores,
                                                         tmp_path):
    """run_training over mesh_data=1 x mesh_model=2 against one process,
    from the same `.pth.tar`, droprate 0.5 with the same (port) masks:
    the losses and the checkpoint (gathered whole: the single-device
    layout) by the rules of the module docstring."""
    got0, got1 = (r["tp_train"] for r in ranks)
    cfg = tiny_cfg(stores, save_dir=str(tmp_path), ckpt_every=STEPS,
                   weights_filename=ranks[0]["tp_train"]["weights"])
    want = torch_ranks.train_case(vars(cfg))
    assert got0["losses"] == got1["losses"]
    np.testing.assert_allclose(got0["losses"][0], want["losses"][0],
                               rtol=1e-5)
    for k in range(1, STEPS):
        np.testing.assert_allclose(got0["losses"][k], want["losses"][k],
                                   rtol=0,
                                   atol=2 * LR * k * (1 + np.exp(2.0)))
    ck = torch.load(osp.join(got0["ckpt"], str(STEPS - 1),
                             "train_state.pt"), weights_only=True)
    bound = 2 * LR * STEPS
    for k, w in want["model"].items():
        v = ck["model"][k].numpy()
        assert v.shape == w.shape, k
        if "running" in k or "num_batches" in k:
            continue
        err = np.abs(v - w) - 1e-5 * np.abs(w)
        assert err.max() <= bound, (k, float(np.abs(v - w).max()))
    # the checkpoint loads into a whole model
    model = exp.build_model(tiny_cfg(stores), "cpu")
    model.load_state_dict(ck["model"], strict=True)


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.mark.slow
def test_two_process_cli_train_equals_one_process(stores, start_weights,
                                                  tmp_path):
    """Whole runs of `cli.train` as two OS processes joined over TCP
    (`--coordinator`, `--num-processes`, `--process-id`; gloo with
    `--device cpu`), as the JAX package's slow two-process tests run its
    CLI: the epochs' losses of one process on the global batch, by the
    rules of the module docstring."""
    import subprocess
    import sys
    repo = osp.dirname(osp.dirname(osp.abspath(__file__)))
    argv = ["-m", "relpose_gnn_tpu_torch.cli.train", "--dataset", "7Scenes",
            "--experiment", "2", "--train-scene", "chess", "--test-scene",
            "chess", "--train-data-dir", stores, "--test-data-dir", stores,
            "--exp-name", "t", "--backbone", "resnet18", "--feat-dim", "32",
            "--seq-len", str(N), "--dtype", "float32", "--knn", "2",
            "--batch-size", "8", "--max-epoch", str(STEPS), "--lr", str(LR),
            "--eval-after-epoch", str(STEPS - 2), "--weights-filename",
            start_weights, "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="2")
    port = _free_port()
    two = [subprocess.Popen(
        [sys.executable, *argv, "--save-dir", str(tmp_path / "two"),
         "--mesh-data", "2", "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", "2", "--process-id", str(r)],
        cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for r in (0, 1)]
    try:
        outs = [p.communicate(timeout=600) for p in two]
    finally:
        for p in two:
            p.kill()
    assert [p.returncode for p in two] == [0, 0], outs[0][1][-2000:]
    one = subprocess.run([sys.executable, *argv, "--save-dir",
                          str(tmp_path / "one")], cwd=repo, env=env,
                         capture_output=True, timeout=600)
    assert one.returncode == 0, one.stderr[-2000:]

    def losses(d):
        with open(osp.join(str(tmp_path / d), "7Scenes", "chess", "t",
                           "metrics.jsonl")) as f:
            return {r["epoch"]: r["loss"] for r in map(json.loads, f)
                    if "loss" in r}

    got, want = losses("two"), losses("one")
    assert sorted(got) == sorted(want) == list(range(STEPS))
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for k in range(1, STEPS):
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=2 * LR * k * (1 + np.exp(2.0)))
    # both ranks print the same medians, the one process's to the bounds
    # of the module docstring plus the printed rounding (3 and 2 decimals)
    assert outs[0][0] == outs[1][0]

    def medians(text):
        words = text.decode().split()
        return float(words[4]), float(words[9])   # "... t X m, ... rot Y"

    (t2, q2), (t1, q1) = medians(outs[0][0]), medians(one.stdout)
    assert abs(t2 - t1) <= 1e-3 + 1e-3 and abs(q2 - q1) <= 0.1 + 1e-2
