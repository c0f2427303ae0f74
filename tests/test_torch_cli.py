"""The port's train and test entry points (relpose_gnn_tpu_torch/cli/)
against the JAX package's `cli/train.py` and `cli/test.py`, on the CPU, on
tiny packed stores (4-node graphs at 32x40, resnet18, dims 32).

  * `parse_args` of the port's train, test, serve, build_graphs and
    parity gives the JAX CLI's namespace for the same argv, apart from the
    port's own `--device`, the multi-process flags included; so does that
    of build_vlad_index, vlad_export and scenes2seq, whose JAX scripts
    parse inside `main` (their namespace is caught at `parse_args`).  The
    JAX CLIs are loaded by file path; they import only argparse, sys and
    numpy at module level.
  * `main` trains (one epoch, a checkpoint after it) and evaluates that
    checkpoint; the test entry's medians equal `run_eval` on the same
    weights exactly (the same float32 CPU computation), and the saved
    weights load into the port's model with strict=True.
  * `--backbone vit` trains, checkpoints and evaluates R3 with the ViT
    node encoder (at a tiny width: see `TinyViT`).
  * Every flag whose work the port does not have yet raises
    NotImplementedError before anything runs, and the multi-process flags
    refuse what cannot run (a process id outside the job, processes
    without a coordinator, a mesh larger than the world) with a
    ValueError before anything runs.
"""

import argparse
import contextlib
import importlib.util
import io
import os
import os.path as osp
from unittest import mock

import numpy as np
import pytest
import torch

from relpose_gnn_tpu_torch.cli import build_graphs as cli_build_graphs
from relpose_gnn_tpu_torch.cli import build_vlad_index as cli_vlad_index
from relpose_gnn_tpu_torch.cli import parity as cli_parity
from relpose_gnn_tpu_torch.cli import refuse_unported
from relpose_gnn_tpu_torch.cli import scenes2seq as cli_scenes2seq
from relpose_gnn_tpu_torch.cli import serve as cli_serve
from relpose_gnn_tpu_torch.cli import test as cli_test
from relpose_gnn_tpu_torch.cli import train as cli_train
from relpose_gnn_tpu_torch.cli import vlad_export as cli_vlad_export
from relpose_gnn_tpu_torch.data.packed import PackedGraphWriter
from relpose_gnn_tpu_torch.models import posenet as posenet_mod
from relpose_gnn_tpu_torch.models import vit as vit_mod
from relpose_gnn_tpu_torch.training import checkpoints as ckpt
from relpose_gnn_tpu_torch.training import experiment as exp

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
N, H, W = 4, 32, 40
TINY = ["--backbone", "resnet18", "--feat-dim", "32", "--seq-len", str(N),
        "--dtype", "float32", "--knn", "2", "--batch-size", "4"]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads while this module runs: the suite runs several
    test processes on one host, and torch's default of one thread a core
    in each of them oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_cli(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_jax_cli_{name}", osp.join(REPO, "cli", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TRAIN_ARGVS = [
    ["--train-data-dir", "a", "--test-data-dir", "b"],
    ["--train-data-dir", "a", "--test-data-dir", "b", "--experiment", "2",
     "--dataset", "7Scenes", "--train-scene", "chess", "--test-scene",
     "chess", "--seed", "3", "--lambda-AP", "0.5", "--ckpt-every", "1",
     "--device-cache", "--resume"],
    ["--train-data-dir", "a", "--test-data-dir", "b", "--experiment", "1",
     "--test-scene", "KingsCollege", "--model-name", "R2", "--dtype",
     "float32", "--backbone", "resnet18", "--feat-dim", "64", "--lr",
     "3e-4", "--knn", "0", "--mesh-model", "2", "--ckpt-dir", "c"],
    ["--train-data-dir", "a", "--test-data-dir", "b", "--exp-name", "mine",
     "--max-epoch", "5", "--batch-size", "2", "--seq-len", "4",
     "--droprate", "0.1", "--srq", "-3", "--saq", "-1", "--gnn-recursion",
     "1", "--eval-after-epoch", "0", "--weights-filename", "w.pth.tar"],
    ["--train-data-dir", "a", "--test-data-dir", "b", "--mesh-data", "4",
     "--mesh-model", "1", "--coordinator", "host0:29500",
     "--num-processes", "4", "--process-id", "3", "--local-device-count",
     "1"],
]
TEST_ARGVS = [
    ["--test-data-dir", "a", "--weights-filename", "w"],
    ["--test-data-dir", "a", "--weights-filename", "w", "--dataset",
     "Cambridge", "--test-scene", "ShopFacade", "--batch-size", "8",
     "--serving-data-path", "raw", "--allow-random-init", "--dense-edges",
     "--fuse", "median", "--pose-stat-path", "s.txt"],
    ["--test-data-dir", "a", "--weights-filename", "w", "--seq-len", "4",
     "--backbone", "resnet18", "--feat-dim", "32", "--dtype", "float32",
     "--knn", "2", "--gnn-recursion", "3", "--seed", "5", "--model-name",
     "R1", "--mesh-model", "2"],
    ["--test-data-dir", "a", "--weights-filename", "w", "--mesh-data", "2"],
]
SERVE_ARGVS = [
    ["--scene", "chess", "--data-path", "raw"],
    ["--scene", "chess", "fire", "--data-path", "raw", "--dataset",
     "7Scenes", "--weights", "w.pth.tar", "--netvlad-checkpoint", "n.tar",
     "--stats-path", "stats", "--backbone", "resnet18", "--feat-dim", "32",
     "--seq-len", "4", "--sampling-period", "3", "--image-size", "32",
     "--batch-size", "4", "--deterministic", "--no-fold-bn", "--dtype",
     "float32", "--out", "o.npz", "--seed", "2", "--retrieval-hw", "24",
     "32", "--retrieval-mode", "shared-trunk", "--rank-dtype", "bfloat16",
     "--pipeline-depth", "3", "--netvlad-clusters", "4", "--capacity", "64",
     "--save-db", "s.npz", "--load-db", "l.npz"],
    ["--scene", "KingsCollege", "--data-path", "raw", "--dataset",
     "Cambridge", "--pose-stat-path", "p.txt", "--mesh-data", "2",
     "--coordinator", "host0:29500", "--num-processes", "2", "--process-id",
     "1", "--local-device-count", "1", "--trace-dir", "t"],
]
BUILD_GRAPHS_ARGVS = [
    ["chess", "train", "--data-path", "raw", "--graph-data-path", "g"],
    ["ShopFacade", "test", "--dataset", "Cambridge", "--data-path", "raw",
     "--graph-data-path", "g", "--stats-path", "s", "--pose-stat-path",
     "p.txt", "--seq-len", "4", "--sp", "3", "--sampling-method", "RAND",
     "--cross-connect", "--netvlad-checkpoint", "n.tar", "--retrieval",
     "netvlad", "--seed", "1"],
    ["KingsCollege", "train", "--dataset", "Cambridge", "--data-path", "raw",
     "--graph-data-path", "g", "--retrieval", "vlad", "--vlad-index",
     "v.pkl"],
]
VLAD_INDEX_ARGVS = [
    ["--image-glob", "raw/*/*.png", "--output", "v.pkl"],
    ["--image-glob", "raw/*/*.png", "--output", "v.pkl", "--clusters", "32",
     "--orb-features", "1000", "--seed", "4"],
]
VLAD_EXPORT_ARGVS = [
    ["--index", "v.pkl", "--output", "d", "--format", "distances"],
    ["--index", "v.pkl", "--output", "p.prj", "--format", "prj",
     "--scale"],
]
SCENES2SEQ_ARGVS = [["raw/chess"], ["raw/chess", "--dst-dir", "out"]]
PARITY_ARGVS = [
    ["--weights", "w.pth.tar", "--graph-data-dir", "g"],
    ["--weights", "w.pth.tar", "--graph-data-dir", "g", "--dataset",
     "Cambridge", "--scenes", "ShopFacade,KingsCollege", "--dataset-dir",
     "raw", "--pose-stat-path", "p.txt", "--backbone", "resnet18",
     "--seq-len", "4", "--knn", "2", "--img-height", "32", "--batch-size",
     "4", "--dtype", "float32", "--save-dir", "out"],
]


@pytest.mark.parametrize("argv", TRAIN_ARGVS)
def test_train_parse_args_equals_jax(argv):
    got = vars(cli_train.parse_args(argv))
    assert got.pop("device") is None
    assert got == vars(_jax_cli("train").parse_args(argv))
    got = vars(cli_train.parse_args(argv + ["--device", "cpu"]))
    assert got["device"] == "cpu"


@pytest.mark.parametrize("argv", TEST_ARGVS)
def test_test_parse_args_equals_jax(argv):
    got = vars(cli_test.parse_args(argv))
    assert got.pop("device") is None
    assert got == vars(_jax_cli("test").parse_args(argv))


@pytest.mark.parametrize("name,module,argv", [
    *(("serve", cli_serve, a) for a in SERVE_ARGVS),
    *(("build_graphs", cli_build_graphs, a) for a in BUILD_GRAPHS_ARGVS),
    *(("parity", cli_parity, a) for a in PARITY_ARGVS),
])
def test_other_entries_parse_args_equal_jax(name, module, argv):
    got = vars(module.parse_args(argv))
    assert got.pop("device") is None
    assert got == vars(_jax_cli(name).parse_args(argv))


class _Parsed(Exception):
    """Carries the namespace out of a JAX script's `main`."""


def _jax_main_namespace(name: str, argv: list) -> dict:
    """The namespace a root JAX script that parses inside `main` builds
    for `argv`; `main` stops there."""
    real = argparse.ArgumentParser.parse_args

    def caught(self, args=None, namespace=None):
        raise _Parsed(real(self, args, namespace))

    with mock.patch.object(argparse.ArgumentParser, "parse_args", caught):
        with pytest.raises(_Parsed) as parsed:
            _jax_cli(name).main(argv)
    return vars(parsed.value.args[0])


@pytest.mark.parametrize("name,module,argv", [
    *(("build_vlad_index", cli_vlad_index, a) for a in VLAD_INDEX_ARGVS),
    *(("vlad_export", cli_vlad_export, a) for a in VLAD_EXPORT_ARGVS),
    *(("scenes2seq", cli_scenes2seq, a) for a in SCENES2SEQ_ARGVS),
])
def test_tool_entries_parse_args_equal_jax(name, module, argv):
    got = vars(module.parse_args(argv))
    assert got.pop("device") is None
    assert got == _jax_main_namespace(name, argv)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """`chess_fc4_sp5_{train,test}` (8 / 5 graphs) written by the port's
    PackedGraphWriter over a pool of 12 frames."""
    root = tmp_path_factory.mktemp("graphs")
    rng = np.random.default_rng(0)
    pool = rng.integers(0, 256, size=(12, H, W, 3), dtype=np.uint8)
    pool_poses = rng.normal(size=(12, 6)).astype(np.float32)
    for split, n in (("train", 8), ("test", 5)):
        w = PackedGraphWriter(str(root / f"chess_fc4_sp5_{split}"), n, N, H,
                              W, mean=[0.45, 0.44, 0.4],
                              std=[0.22, 0.23, 0.21])
        for _ in range(n):
            idx = rng.choice(12, N, replace=False)
            w.add(pool[idx].astype(np.float32) / 255.0, pool_poses[idx],
                  ~np.eye(N, dtype=bool), nbr_idx=idx[1:])
        w.finalize()
    return str(root)


@pytest.fixture(scope="module")
def trained(stores, tmp_path_factory):
    """cli.train for one epoch with a checkpoint after it; returns (out,
    save_dir, printed lines)."""
    save = str(tmp_path_factory.mktemp("out"))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = cli_train.main([
            "--dataset", "7Scenes", "--experiment", "2", "--train-scene",
            "chess", "--test-scene", "chess", "--train-data-dir", stores,
            "--test-data-dir", stores, "--save-dir", save, "--max-epoch",
            "1", "--ckpt-every", "1", "--eval-after-epoch", "-1",
            "--device", "cpu", *TINY])
    return out, save, buf.getvalue().splitlines()


def _ckdir(save):
    return osp.join(save, "7Scenes", "chess",
                    "7Scenes_single_w_chess_w_test_chess_seed_0", "ckpt")


def test_train_entry_trains_and_checkpoints(trained):
    out, save, lines = trained
    assert out["state"].step == 2
    best = out["best"]["chess"]
    assert np.isfinite(best["median_t"]) and np.isfinite(best["median_q"])
    assert lines == [f"chess: best median t {best['median_t']:.3f} m, "
                     f"best median rot {best['median_q']:.2f} deg"]
    ckdir = _ckdir(save)
    assert sorted(os.listdir(ckdir)) == ["0"]
    sd = torch.load(osp.join(ckdir, "0", "train_state.pt"),
                    map_location="cpu", weights_only=True)
    model = exp.build_model(exp.ExperimentConfig(
        backbone="resnet18", feat_dim=32, seq_len=N, knn=2,
        dtype="float32"), "cpu")
    model.load_state_dict(sd["model"], strict=True)
    for k, v in out["state"].model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


def test_test_entry_equals_run_eval(trained, stores, tmp_path, capsys):
    _, save, _ = trained
    ckdir = _ckdir(save)
    got = cli_test.main([
        "--dataset", "7Scenes", "--test-scene", "chess", "--test-data-dir",
        stores, "--save-dir", str(tmp_path), "--weights-filename", ckdir,
        "--device", "cpu", *TINY])
    want = exp.run_eval(exp.ExperimentConfig(
        dataset="7Scenes", test_scene="chess", train_scene="chess",
        experiment=2, train_data_dir=stores, test_data_dir=stores,
        save_dir=str(tmp_path / "ref"), exp_name="eval", backbone="resnet18",
        feat_dim=32, seq_len=N, knn=2, dtype="float32", batch_size=4),
        weights=ckdir, save_predictions=False, device="cpu")
    assert got.keys() == want.keys() == {"chess"}
    g, w = got["chess"], want["chess"]
    assert (g.median_t, g.median_q) == (w.median_t, w.median_q)
    np.testing.assert_array_equal(g.pred_poses, w.pred_poses)
    assert capsys.readouterr().out.splitlines()[-1] == (
        f"chess: median t {w.median_t:.3f} m, median rot "
        f"{w.median_q:.2f} deg")
    exported = os.listdir(osp.join(str(tmp_path), "7Scenes", "chess",
                                   "eval"))
    assert any(f.endswith(".npz") for f in exported), exported


def _orbax_dir(tmp_path):
    d = tmp_path / "orbax"
    (d / "3").mkdir(parents=True)
    (d / "3" / "_CHECKPOINT_METADATA").write_text("{}")
    return str(d)


# the multi-process flags run; what they cannot run is refused with a
# ValueError, and what the port does not have with a NotImplementedError
@pytest.mark.parametrize("extra,error,match", [
    pytest.param(["--coordinator", "localhost:1234", "--num-processes",
                  "2", "--process-id", "2"], ValueError, "outside",
                 id="process-id-outside"),
    pytest.param(["--num-processes", "2"], ValueError, "coordinator",
                 id="no-coordinator"),
    pytest.param(["--mesh-data", "2"], ValueError, "needs 2 ranks",
                 id="mesh-over-world"),
    pytest.param(["--weights-filename", "ORBAX"], NotImplementedError,
                 "save_torch_checkpoint", id="orbax"),
    pytest.param(["--mesh-data", "1", "--mesh-model", "2"], ValueError,
                 "needs 2 ranks", id="tensor-parallel"),
    pytest.param(["--local-device-count", "2"], ValueError,
                 "launch 2 processes", id="local-device-count"),
])
def test_train_entry_refuses_unported_flags(stores, tmp_path, extra, error,
                                            match):
    extra = [_orbax_dir(tmp_path) if a == "ORBAX" else a for a in extra]
    save = tmp_path / "out"
    with pytest.raises(error, match=match):
        cli_train.main(["--train-data-dir", stores, "--test-data-dir",
                        stores, "--save-dir", str(save), "--device", "cpu",
                        *extra])
    assert not save.exists()


@pytest.mark.parametrize("extra,error,match", [
    pytest.param(["--mesh-data", "2"], ValueError, "needs 2 ranks",
                 id="mesh-over-world"),
    pytest.param(["--weights-filename", "ORBAX"], NotImplementedError,
                 "save_torch_checkpoint", id="orbax"),
])
def test_test_entry_refuses_unported_flags(stores, tmp_path, extra, error,
                                           match):
    extra = [_orbax_dir(tmp_path) if a == "ORBAX" else a for a in extra]
    argv = ["--test-data-dir", stores, "--save-dir", str(tmp_path / "out"),
            "--device", "cpu", "--weights-filename", "w.pth.tar", *extra]
    with pytest.raises(error, match=match):
        cli_test.main(argv)
    assert not (tmp_path / "out").exists()


class TinyViT(vit_mod.ViTEncoder):
    """The ViT encoder at a tiny width (patch 16, dim 32, depth 2, heads
    2): `--backbone vit` builds ViT-B/16, whose 86M parameters and their
    Adam moments would make each checkpoint a gigabyte on the CPU."""

    def __init__(self, feat_dim=2048, patch=16, dim=768, depth=12,
                 heads=12, dtype=None, layer_scale=False,
                 image_hw=(256, 341)):
        super().__init__(feat_dim, 16, 32, 2, 2, dtype, layer_scale,
                         image_hw)


@pytest.fixture(scope="module")
def trained_vit(stores, tmp_path_factory):
    """cli.train --backbone vit (the tiny ViT) for one epoch (2 steps) with
    a checkpoint after it and an eval; returns (out, save_dir)."""
    save = str(tmp_path_factory.mktemp("out-vit"))
    mp = pytest.MonkeyPatch()
    mp.setattr(posenet_mod, "ViTEncoder", TinyViT)
    tiny = [a if a != "resnet18" else "vit" for a in TINY]
    with contextlib.redirect_stdout(io.StringIO()):
        out = cli_train.main([
            "--dataset", "7Scenes", "--experiment", "2", "--train-scene",
            "chess", "--test-scene", "chess", "--train-data-dir", stores,
            "--test-data-dir", stores, "--save-dir", save, "--max-epoch",
            "1", "--ckpt-every", "1", "--eval-after-epoch", "-1",
            "--device", "cpu", *tiny])
    yield out, save, tiny
    mp.undo()


def test_train_entry_runs_the_vit_backbone(trained_vit, monkeypatch,
                                           tmp_path):
    """`--backbone vit` trains R3 with the ViT node encoder, sized for the
    stores' 32x40 frames (a 2x2 patch grid), and checkpoints it: the
    saved train state loads with strict=True into the model `cli.test`
    builds; the reference `.pth.tar` has no place for it and refuses."""
    out, save, _ = trained_vit
    monkeypatch.setattr(posenet_mod, "ViTEncoder", TinyViT)
    state = out["state"]
    assert state.step == 2 and state.model.cfg.backbone == "vit"
    assert state.model.cfg.vit_image_hw == (H, W)
    best = out["best"]["chess"]
    assert np.isfinite(best["median_t"]) and np.isfinite(best["median_q"])
    sd = torch.load(osp.join(_ckdir(save), "0", "train_state.pt"),
                    map_location="cpu", weights_only=True)
    assert "encoder.blocks.1.attn.qkv.weight" in sd["model"]
    model = exp.build_model(exp.ExperimentConfig(
        backbone="vit", feat_dim=32, seq_len=N, knn=2, dtype="float32"),
        "cpu", image_hw=(H, W))
    model.load_state_dict(sd["model"], strict=True)
    for k, v in state.model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    with pytest.raises(ValueError, match="ViT"):
        ckpt.save_torch_checkpoint(state, str(tmp_path), 0)


def test_test_entry_runs_the_vit_backbone(trained_vit, stores, tmp_path,
                                          monkeypatch):
    """`cli.test --backbone vit` on the ViT run's checkpoint equals
    `run_eval` on the same weights."""
    _, save, tiny = trained_vit
    monkeypatch.setattr(posenet_mod, "ViTEncoder", TinyViT)
    with contextlib.redirect_stdout(io.StringIO()):
        got = cli_test.main([
            "--dataset", "7Scenes", "--test-scene", "chess",
            "--test-data-dir", stores, "--save-dir", str(tmp_path),
            "--weights-filename", _ckdir(save), "--device", "cpu", *tiny])
    want = exp.run_eval(exp.ExperimentConfig(
        dataset="7Scenes", test_scene="chess", train_scene="chess",
        experiment=2, train_data_dir=stores, test_data_dir=stores,
        save_dir=str(tmp_path / "ref"), exp_name="eval", backbone="vit",
        feat_dim=32, seq_len=N, knn=2, dtype="float32", batch_size=4),
        weights=_ckdir(save), save_predictions=False, device="cpu")
    g, w = got["chess"], want["chess"]
    assert (g.median_t, g.median_q) == (w.median_t, w.median_q)
    np.testing.assert_array_equal(g.pred_poses, w.pred_poses)
    assert np.isfinite(g.pred_poses).all()


def test_orbax_refusal_names_the_pth_tar_exporter(tmp_path):
    """An Orbax directory of the JAX package is refused with the way
    across: the JAX exporter writes a .pth.tar the port loads strictly."""
    args = cli_test.parse_args(["--test-data-dir", str(tmp_path),
                                "--weights-filename", _orbax_dir(tmp_path)])
    with pytest.raises(NotImplementedError) as err:
        refuse_unported(args)
    msg = str(err.value)
    for part in ("Orbax", "tensorstore", "training/checkpoints.py::"
                 "save_torch_checkpoint", ".pth.tar", "strict=True"):
        assert part in msg, part


def test_entries_need_a_card_unless_asked(stores, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_train.main(["--dataset", "7Scenes", "--experiment", "2",
                        "--train-scene", "chess", "--test-scene", "chess",
                        "--train-data-dir", stores, "--test-data-dir",
                        stores, "--save-dir", str(tmp_path), *TINY])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_test.main(["--test-scene", "chess", "--test-data-dir", stores,
                       "--save-dir", str(tmp_path), "--weights-filename",
                       "w.pth.tar", "--allow-random-init", *TINY])
