"""The port's experiment loop (relpose_gnn_tpu_torch/training/experiment.py,
checkpoints.py, utils/logging.py, benchmarks/bench_train.py) against the
JAX package, on the CPU, on tiny packed stores (4-node graphs at 32x40,
resnet18, dims 32), written from numpy seeds.

Tolerances, with their basis:
  * run_training from one `.pth.tar` in both frameworks, droprate 0: the
    first step's loss rtol 1e-5 (as in tests/test_torch_training.py).
    After k Adam updates a weight whose gradient is near zero and of
    opposite sign in the two frameworks sits up to 2 lr k apart; on a
    bias of a relative-pose head that shifts every edge's prediction, so
    the loss by up to 2 lr k (exp(-srx) + exp(-srq)) = 1.7e-3 k (the
    first such update was measured at 1.3e-3); eval medians then within
    1e-3 m and 0.1 degree after two updates;
  * run_eval from one `.pth.tar`: predictions rtol = atol = 1e-4 (the
    pixel path's embeddings agree to 2e-5, tests/test_torch_models.py);
  * the cached-serving eval against the pixel eval of the same store:
    rtol = atol = 1e-5 (the same embeddings; compact against dense edges
    is the same math per edge);
  * checkpoints, resume and the `.pth.tar` round trips: exact.
"""

import json
import os
import os.path as osp

import numpy as np
import jax
import pytest
import torch

from relpose_gnn_tpu.data.packed import PackedGraphWriter as JaxWriter
from relpose_gnn_tpu.models.posenet import RelPoseGNN as JaxRelPoseGNN
from relpose_gnn_tpu.models.posenet import RelPoseGNNConfig as JaxConfig
from relpose_gnn_tpu.training import checkpoints as jax_ckpt
from relpose_gnn_tpu.training import experiment as jax_exp
from relpose_gnn_tpu.training.trainer import TrainerConfig as JaxTrainerCfg
from relpose_gnn_tpu.training.trainer import create_train_state as jax_state
from relpose_gnn_tpu.utils import logging as jax_logging
from relpose_gnn_tpu_torch.benchmarks import bench_train
from relpose_gnn_tpu_torch.models.convert import state_dict_from_jax
from relpose_gnn_tpu_torch.training import checkpoints as ckpt
from relpose_gnn_tpu_torch.training import experiment as exp
from relpose_gnn_tpu_torch.training.trainer import create_train_state
from relpose_gnn_tpu_torch.utils import logging as port_logging

N, H, W = 4, 32, 40
STAGES = (2, 2, 2, 2)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads while this module runs: the suite runs several
    test processes on one host, and torch's default of one thread a core
    in each of them oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """`chess_fc4_sp5_{train,test}` (8 / 5 graphs) over a pool of 12
    frames, whose indices are the graphs' nbr_idx; returns (root, pool)."""
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
    return str(root), pool


def tiny_cfg(root, module=exp, **kw):
    base = dict(dataset="7Scenes", experiment=2, train_scene="chess",
                test_scene="chess", train_data_dir=root, test_data_dir=root,
                exp_name="t", model_name="R3", backbone="resnet18",
                feat_dim=32, batch_size=4, seq_len=N, max_epoch=1,
                eval_after_epoch=99, dtype="float32", knn=2,
                allow_random_init=True)
    base.update(kw)
    return module.ExperimentConfig(**base)


@pytest.fixture
def jax_resnet18_warm_start(monkeypatch):
    """The JAX experiment warm-starts with the resnet34 block layout; give
    its load_torch_weights the tiny model's resnet18 stages."""
    orig = jax_ckpt.load_torch_weights
    monkeypatch.setattr(jax_exp.ckpt, "load_torch_weights",
                        lambda state, path: orig(state, path, STAGES))


@pytest.fixture
def flax_two_pass_variance(monkeypatch):
    """flax's BatchNorm takes the batch variance as E[x^2] - E[x]^2
    (`use_fast_variance`), which cancels where a channel's mean is large
    against its spread: on these stores the JAX gradients of layer3.0 move
    by up to 8% of their size, the layers before it by 1%.  The port takes
    the two-pass variance.  Where a test holds whole training runs to each
    other, flax computes its statistics the two-pass way too."""
    import flax.linen.normalization as flax_norm
    orig = flax_norm._compute_stats
    monkeypatch.setattr(flax_norm, "_compute_stats", lambda *a, **k: orig(
        *a, **dict(k, use_fast_variance=False)))


def _epoch_losses(save_dir):
    path = osp.join(save_dir, "7Scenes", "chess", "t", "metrics.jsonl")
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return {r["epoch"]: r["loss"] for r in recs if "loss" in r}


@pytest.fixture(scope="module")
def start_weights(stores, tmp_path_factory):
    """One `.pth.tar` both frameworks start from: the port's seeded
    weights, BN statistics made non-trivial."""
    root, _ = stores
    cfg = tiny_cfg(root, droprate=0.0)
    model = exp.build_model(cfg, "cpu")
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.2, 0.2, generator=gen)
                m.running_var.uniform_(0.7, 1.3, generator=gen)
                m.weight.uniform_(0.7, 1.3, generator=gen)
    path = str(tmp_path_factory.mktemp("w") / "start.pth.tar")
    return ckpt.save_torch_checkpoint(create_train_state(
        model, exp.TrainerConfig()), path, 0)


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(dataset="7Scenes", experiment=0, test_scene="multi"),
    dict(dataset="7Scenes", experiment=1, test_scene="chess"),
    dict(dataset="7Scenes", experiment=2, train_scene="fire",
         test_scene="fire"),
    dict(dataset="Cambridge", experiment=0, test_scene="multi"),
    dict(dataset="Cambridge", experiment=1, test_scene="ShopFacade"),
])
def test_scene_lists_match_jax(kw):
    assert exp.scene_lists(exp.ExperimentConfig(**kw)) == \
        jax_exp.scene_lists(jax_exp.ExperimentConfig(**kw))


def test_config_fields_roots_and_anchors_match_jax():
    import dataclasses
    got = [f.name for f in dataclasses.fields(exp.ExperimentConfig)]
    want = [f.name for f in dataclasses.fields(jax_exp.ExperimentConfig)]
    assert got == want
    for args in (("/d/", "chess", "7Scenes", "train"),
                 ("/d", "ShopFacade", "Cambridge", "test", 5)):
        assert exp.dataset_root(*args) == jax_exp.dataset_root(*args)
    for knn, n in ((0, 8), (0, 5), (4, 8)):
        kw = dict(knn=knn, seq_len=n)
        assert exp.static_anchor_for(exp.ExperimentConfig(**kw)) == \
            jax_exp.static_anchor_for(jax_exp.ExperimentConfig(**kw))


@pytest.mark.parametrize("kw,what", [
    (dict(mesh_data=2), "multi-GPU"),
])
def test_later_slices_raise_naming_the_roadmap(stores, tmp_path, kw, what):
    root, _ = stores
    cfg = tiny_cfg(root, save_dir=str(tmp_path), **kw)
    for entry in (exp.run_training, exp.run_eval):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            entry(cfg, device="cpu")


def test_entry_points_refuse_to_run_without_a_card(stores, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None means it")
    root, _ = stores
    cfg = tiny_cfg(root, save_dir=str(tmp_path))
    for call in (lambda: exp.run_training(cfg),
                 lambda: exp.run_eval(cfg),
                 lambda: exp.build_model(cfg),
                 lambda: bench_train.main(["--batches", "2"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


# ---------------------------------------------------------------------------
# run_training
# ---------------------------------------------------------------------------


def test_run_training_matches_jax_from_the_same_weights(
        stores, start_weights, tmp_path, jax_resnet18_warm_start,
        flax_two_pass_variance):
    """Batch 8 = one step an epoch: epoch 0's loss is the first step's,
    before any update; epoch 1's follows one Adam update, the eval two."""
    root, _ = stores
    kw = dict(droprate=0.0, max_epoch=2, eval_after_epoch=0, batch_size=8,
              weights_filename=start_weights)
    port = exp.run_training(tiny_cfg(root, save_dir=str(tmp_path / "p"),
                                     **kw), device="cpu")
    ref = jax_exp.run_training(tiny_cfg(root, jax_exp,
                                        save_dir=str(tmp_path / "j"), **kw))
    got, want = (_epoch_losses(str(tmp_path / d)) for d in ("p", "j"))
    assert set(got) == set(want) == {0, 1}
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=0,
                               atol=2 * 1e-4 * (1 + np.exp(2.0)))
    best_p, best_j = port["best"]["chess"], ref["best"]["chess"]
    np.testing.assert_allclose(best_p["median_t"], best_j["median_t"],
                               atol=1e-3)
    np.testing.assert_allclose(best_p["median_q"], best_j["median_q"],
                               atol=0.1)
    assert port["state"].step == int(ref["state"].step) == 2


def test_run_training_writes_metrics_checkpoints_and_best(stores, tmp_path):
    root, _ = stores
    cfg = tiny_cfg(root, save_dir=str(tmp_path), max_epoch=3, ckpt_every=2,
                   ckpt_epochs=(0,), eval_after_epoch=0)
    out = exp.run_training(cfg, device="cpu")
    logdir = tmp_path / "7Scenes" / "chess" / "t"
    assert sorted(os.listdir(logdir / "ckpt")) == ["0", "1"]
    assert ckpt.latest_epoch(str(logdir / "ckpt")) == 1
    with open(logdir / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    evals = [r for r in recs if "median_t" in r]
    assert [r["epoch"] for r in evals] == [1, 2]
    assert out["best"]["chess"]["median_t"] == min(r["median_t"]
                                                   for r in evals)
    assert osp.isfile(logdir / "logger.log")


def test_batch_larger_than_dataset_is_clamped(stores, tmp_path):
    root, _ = stores
    out = exp.run_training(tiny_cfg(root, save_dir=str(tmp_path),
                                    batch_size=64), device="cpu")
    assert out["state"].step == 1


def test_resume_is_bit_for_bit(stores, tmp_path):
    """Epoch 1 of a run resumed from the epoch-0 checkpoint reproduces the
    uninterrupted run: weights, BN statistics, criterion, Adam moments and
    steps, losses; dropout on (its draws depend on seed and step)."""
    root, _ = stores
    kw = dict(max_epoch=2, ckpt_epochs=(0,), droprate=0.5, batch_size=2)
    full = exp.run_training(tiny_cfg(root, save_dir=str(tmp_path / "a"),
                                     **kw), device="cpu")["state"]
    exp.run_training(tiny_cfg(root, save_dir=str(tmp_path / "b"),
                              **dict(kw, max_epoch=1)), device="cpu")
    resumed = exp.run_training(tiny_cfg(root, save_dir=str(tmp_path / "b"),
                                        resume=True, **kw),
                               device="cpu")["state"]
    assert _epoch_losses(str(tmp_path / "a"))[1] == \
        _epoch_losses(str(tmp_path / "b"))[1]
    a, b = full.state_dict(), resumed.state_dict()
    assert a["step"] == b["step"] == 8
    for part in ("model", "criterion", "criterion_R"):
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
    oa, ob = a["optimizer"], b["optimizer"]
    assert oa["updates"] == ob["updates"] == 8
    for name in oa["adam"]:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(oa["adam"][name][k], ob["adam"][name][k])


def test_resume_without_checkpoint_starts_fresh(stores, tmp_path):
    root, _ = stores
    out = exp.run_training(tiny_cfg(root, save_dir=str(tmp_path),
                                    resume=True), device="cpu")
    assert out["state"].step == 2


def test_resume_best_covers_pre_interruption_epochs(stores, tmp_path):
    root, _ = stores
    kw = dict(save_dir=str(tmp_path), eval_after_epoch=-1, ckpt_every=1)
    exp.run_training(tiny_cfg(root, max_epoch=1, **kw), device="cpu")
    out = exp.run_training(tiny_cfg(root, max_epoch=2, resume=True, **kw),
                           device="cpu")
    with open(tmp_path / "7Scenes" / "chess" / "t" / "metrics.jsonl") as f:
        medians = [json.loads(line)["median_t"] for line in f
                   if "median_t" in line]
    assert len(medians) == 2
    assert out["best"]["chess"]["median_t"] == min(medians)


def test_nonfinite_epoch_rolls_back(stores, tmp_path, monkeypatch):
    """A non-finite loss on the epoch's FIRST step rolls the whole epoch
    back (weights, optimizer) though later steps are finite; the step
    count goes on."""
    root, _ = stores
    orig = exp.make_train_step

    def spiked(tcfg):
        step = orig(tcfg)
        calls = {"n": 0}

        def run(state, batch, seed):
            m = step(state, batch, seed)
            calls["n"] += 1
            return dict(m, loss=torch.tensor(float("nan"))) \
                if calls["n"] == 1 else m

        return run

    monkeypatch.setattr(exp, "make_train_step", spiked)
    cfg = tiny_cfg(root, save_dir=str(tmp_path), batch_size=2)
    start = exp.build_model(cfg, "cpu").state_dict()
    out = exp.run_training(cfg, device="cpu")
    state = out["state"]
    assert state.step == 4 and state.optimizer.updates == 0
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, start[k]), k
    # the rolled-back epoch wrote no metrics
    assert not osp.exists(osp.join(str(tmp_path), "7Scenes", "chess", "t",
                                   "metrics.jsonl"))


# ---------------------------------------------------------------------------
# run_eval and checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fuse", ["first", "mean", "median"])
def test_run_eval_matches_jax_from_the_same_weights(
        stores, start_weights, tmp_path, fuse, jax_resnet18_warm_start):
    root, _ = stores
    kw = dict(eval_fuse=fuse, save_dir=str(tmp_path))
    got = exp.run_eval(tiny_cfg(root, **kw), weights=start_weights,
                       device="cpu")["chess"]
    want = jax_exp.run_eval(tiny_cfg(root, jax_exp, **kw),
                            weights=start_weights,
                            save_predictions=False)["chess"]
    np.testing.assert_allclose(got.pred_poses, want.pred_poses, rtol=1e-4,
                               atol=1e-4)
    files = os.listdir(tmp_path / "7Scenes" / "chess" / "t")
    assert any(f.startswith("relpose_gnn_tpu_chess_") and f.endswith(".npz")
               for f in files)


def test_run_eval_weights_contract(stores, tmp_path):
    root, _ = stores
    cfg = tiny_cfg(root, save_dir=str(tmp_path), allow_random_init=False)
    with pytest.raises(FileNotFoundError, match="nope.pth.tar"):
        exp.run_eval(cfg, weights=str(tmp_path / "nope.pth.tar"),
                     device="cpu")
    with pytest.raises(ValueError, match="no weights"):
        exp.run_eval(cfg, device="cpu")
    orbax_like = tmp_path / "orbax" / "3"
    orbax_like.mkdir(parents=True)
    (orbax_like / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="Orbax"):
        exp.run_eval(cfg, weights=str(tmp_path / "orbax"), device="cpu")


def test_save_checkpoint_keeps_the_newest(stores, tmp_path):
    root, _ = stores
    state = create_train_state(exp.build_model(tiny_cfg(root), "cpu"),
                               exp.TrainerConfig())
    for epoch in range(4):
        state.step = epoch
        ckpt.save_checkpoint(str(tmp_path), state, epoch, max_to_keep=2)
    assert sorted(os.listdir(tmp_path)) == ["2", "3"]
    state.step = 99
    ckpt.restore_checkpoint(str(tmp_path), state, 2)
    assert state.step == 2
    ckpt.restore_checkpoint(str(tmp_path), state)
    assert state.step == 3


def test_pth_tar_export_matches_jax_and_loads_there(stores, start_weights,
                                                   tmp_path):
    """The port's `.pth.tar` has the JAX exporter's schema, and the JAX
    package's load_torch_weights takes it: its params then give back the
    port's state dict exactly."""
    root, _ = stores
    port_file = torch.load(start_weights, weights_only=True)
    cfg = tiny_cfg(root)
    model = JaxRelPoseGNN(JaxConfig(num_nodes=N, feat_dim=32, edge_dim=32,
                                    node_dim=32, knn=2, backbone="resnet18"))
    images = np.zeros((1, N, H, W, 3), np.float32)
    adj = ~np.eye(N, dtype=bool)[None]
    jstate = jax_state(jax.random.PRNGKey(0), model, JaxTrainerCfg(), images,
                       adj)
    jstate = jax_ckpt.load_torch_weights(jstate, start_weights,
                                         stage_sizes=STAGES)
    back = state_dict_from_jax(
        jax.device_get(jstate.params["model"]),
        jax.device_get(jstate.batch_stats), STAGES)
    assert set(back) == set(port_file["model_state_dict"])
    for k, v in back.items():
        assert torch.equal(v, port_file["model_state_dict"][k]), k
    jax_file = jax_ckpt.save_torch_checkpoint(jstate, str(tmp_path), 0,
                                              stage_sizes=STAGES)
    want = torch.load(jax_file, weights_only=True)
    assert set(port_file) == set(want)
    assert port_file["epoch"] == want["epoch"]
    assert port_file["optim_state_dict"] == want["optim_state_dict"]
    assert {k: v.item() for k, v in port_file[
        "criterion_state_dict"].items()} == {
        k: v.item() for k, v in want["criterion_state_dict"].items()}
    # and the JAX file loads into the port, strict
    state = create_train_state(exp.build_model(cfg, "cpu"),
                               exp.TrainerConfig())
    ckpt.load_torch_weights(state, jax_file)
    for k, v in want["model_state_dict"].items():
        # the JAX file stores num_batches_tracked with shape [1]
        assert torch.equal(state.model.state_dict()[k].reshape(v.shape),
                           v), k


def test_load_torch_weights_refuses_another_config(stores, start_weights):
    root, _ = stores
    state = create_train_state(
        exp.build_model(tiny_cfg(root, feat_dim=16), "cpu"),
        exp.TrainerConfig())
    with pytest.raises(RuntimeError, match="size mismatch"):
        ckpt.load_torch_weights(state, start_weights)


# ---------------------------------------------------------------------------
# cached-serving eval
# ---------------------------------------------------------------------------


class _PoolDatabase:
    """A raw split standing in for the 7-Scenes loader: the pool's frames
    as float [0, 1], frame 3 unreadable."""

    def __init__(self, pool):
        self.pool = pool

    def __len__(self):
        return len(self.pool)

    def load_image(self, i):
        return None if i == 3 else self.pool[i].astype(np.float32) / 255.0


def test_serving_eval_matches_the_pixel_path(stores, start_weights, tmp_path,
                                             monkeypatch):
    root, pool = stores
    db = _PoolDatabase(pool)
    db.load_image = lambda i: pool[i].astype(np.float32) / 255.0
    monkeypatch.setattr(exp, "_raw_database", lambda *a: db)
    cfg = tiny_cfg(root, save_dir=str(tmp_path))
    pixel = exp.run_eval(cfg, weights=start_weights, device="cpu",
                         save_predictions=False)["chess"]
    served = exp.run_eval(cfg, weights=start_weights, device="cpu",
                          save_predictions=False,
                          serving_data_path="raw")["chess"]
    np.testing.assert_allclose(served.pred_poses, pixel.pred_poses,
                               rtol=1e-5, atol=1e-5)


def test_load_database_images_matches_jax(stores):
    _, pool = stores
    got = exp.load_database_images(_PoolDatabase(pool), H + 2, W - 3)
    want = jax_exp.load_database_images(_PoolDatabase(pool), H + 2, W - 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[3], got[4])


# ---------------------------------------------------------------------------
# logging and the bench
# ---------------------------------------------------------------------------


def test_metrics_writer_and_logger_match_jax(tmp_path):
    recs = []
    for mod in (port_logging, jax_logging):
        path = str(tmp_path / mod.__name__ / "m.jsonl")
        w = mod.MetricsWriter(path)
        w.write(3, {"loss": torch.tensor(1.5) if mod is port_logging
                    else np.float32(1.5), "tag": object()}, epoch=2)
        with open(path) as f:
            rec = json.loads(f.readline())
        rec.pop("time")
        rec["tag"] = rec["tag"].split(" object")[0]
        recs.append(rec)
    assert recs[0] == recs[1] == {"step": 3, "epoch": 2, "loss": 1.5,
                                  "tag": "<object"}
    log = port_logging.get_logger(logfile=str(tmp_path / "l" / "x.log"))
    port_logging.log_hyperparams(log, {"lr": 0.5}, prefix="hp.")
    for h in log.handlers:
        h.flush()
    assert "hp.lr: 0.5" in (tmp_path / "l" / "x.log").read_text()


def test_bench_train_prints_one_json_line(capsys):
    out = bench_train.main([
        "--device", "cpu", "--backbone", "resnet18", "--dims", "32",
        "--seq-len", "4", "--height", "32", "--width", "40", "--dtype",
        "float32", "--iters", "1", "--batches", "2", "--grad-accum", "2",
        "--remat"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == json.loads(json.dumps(out))
    (row,) = out["train"]
    assert row["batch"] == 2 and row["remat"] and row["grad_accum"] == 2
    assert row["loss_finite"] and row["flops_per_step"] > 0
    assert row["mfu"] is None and row["peak_memory_gib"] is None
    assert row["attention_launches_per_step"] == 0  # no card, no kernel
    assert out["platform"] == "cpu"
