"""The port's tooling against the JAX package's, on the CPU:
`config.py::FrameworkConfig` (JSON both ways), `utils/seeding.py`,
`utils/profiling.py` (`StepTimer`, `trace`), `utils/visualize.py`,
`data/sequences.py` with `cli.scenes2seq`, and `cli.serve --trace-dir`.

Held exactly: the host generators' states after seeding, `worker_rngs`
draws, the plots' PNG bytes (the same matplotlib calls), and every file
`scenes_to_sequences`, the TUM exports and `scenes2seq` write (pickles,
JSON, text; the TUM quaternions printed to 6 and 9 decimals, which the
port's float32 `mat2quat` gives bit for bit).  The serve run is the
port's alone, at a tiny size (R3 at resnet18, dims 32, 4-node graphs,
32x43 frames, `shared-trunk` retrieval, stochastic selection over a
window of 4 candidates): its trace must parse and hold the serving loop's
operators and the service's spans, and each served-queries line must
count the window's fallbacks.
"""

import functools
import glob
import json
import os
import os.path as osp
import pickle
import random
import sys
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relpose_gnn_tpu import config as jax_config
from relpose_gnn_tpu.data import sequences as jax_seq
from relpose_gnn_tpu.models.posenet import RelPoseGNNConfig as JaxModelCfg
from relpose_gnn_tpu.training.experiment import (
    ExperimentConfig as JaxExperimentCfg)
from relpose_gnn_tpu.training.trainer import TrainerConfig as JaxTrainerCfg
from relpose_gnn_tpu.utils import profiling as jax_profiling
from relpose_gnn_tpu.utils import seeding as jax_seeding
from relpose_gnn_tpu.utils import visualize as jax_visualize
from relpose_gnn_tpu_torch import config
from relpose_gnn_tpu_torch.cli import scenes2seq
from relpose_gnn_tpu_torch.cli import serve as port_serve
from relpose_gnn_tpu_torch.data import sequences
from relpose_gnn_tpu_torch.models.posenet import RelPoseGNNConfig
from relpose_gnn_tpu_torch.training.experiment import ExperimentConfig
from relpose_gnn_tpu_torch.training.trainer import TrainerConfig
from relpose_gnn_tpu_torch.utils import profiling, seeding, visualize
from test_data import write_7scenes_fixture

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# -- config.py ---------------------------------------------------------------

def test_config_written_by_jax_loads_in_the_port(tmp_path):
    path = str(tmp_path / "jax.json")
    jax_config.FrameworkConfig(
        experiment=JaxExperimentCfg(dtype="float32", batch_size=4,
                                    ckpt_epochs=(3, 7)),
        trainer=JaxTrainerCfg(lr=5e-4, filter_nans=True),
        model=JaxModelCfg(num_nodes=16, knn=6, dtype=jnp.bfloat16,
                          remat=True)).save(path)
    with open(path) as f:
        assert json.load(f)["model"]["dtype"] == \
            "<class 'jax.numpy.bfloat16'>"
    cfg = config.FrameworkConfig.load(path)
    assert cfg.model.dtype is torch.bfloat16
    assert (cfg.model.num_nodes, cfg.model.knn, cfg.model.remat) == (
        16, 6, True)
    assert cfg.experiment.dtype == "float32"
    assert cfg.experiment.ckpt_epochs == (3, 7)
    assert (cfg.trainer.lr, cfg.trainer.filter_nans) == (5e-4, True)
    assert cfg.model.vit_image_hw == (256, 341)   # the port's own default


def test_config_written_by_the_port_loads_in_jax(tmp_path):
    path = str(tmp_path / "port.json")
    config.FrameworkConfig(
        experiment=ExperimentConfig(test_scene="fire", max_epoch=3),
        trainer=TrainerConfig(weight_decay=0.0),
        model=RelPoseGNNConfig(feat_dim=64, dtype=torch.bfloat16,
                               vit_image_hw=(224, 224))).save(path)
    cfg = jax_config.FrameworkConfig.load(path)
    assert cfg.model.dtype is jnp.bfloat16 and cfg.model.feat_dim == 64
    assert cfg.experiment.dtype is jnp.bfloat16   # the JAX loader's rule
    assert (cfg.experiment.test_scene, cfg.experiment.max_epoch) == (
        "fire", 3)
    assert cfg.trainer.weight_decay == 0.0
    # and back: the JAX package's second save, through the port
    cfg.save(path)
    back = config.FrameworkConfig.load(path)
    assert back.model.dtype is torch.bfloat16
    assert back.experiment.dtype == "bfloat16"
    assert back.experiment.test_scene == "fire"


def test_config_round_trip_in_the_port(tmp_path):
    path = str(tmp_path / "run.json")
    want = config.FrameworkConfig(
        experiment=ExperimentConfig(dtype="float32", ckpt_epochs=(1, 2)),
        model=RelPoseGNNConfig(num_nodes=4, dtype=None,
                               vit_image_hw=(32, 48)))
    want.save(path)
    assert config.FrameworkConfig.load(path) == want


# -- utils/seeding.py ------------------------------------------------------

def test_seed_everything_matches_jax():
    jax_seeding.seed_everything(7)
    want = (random.random(), np.random.rand(3))
    gen = seeding.seed_everything(7, device="cpu")
    got = (random.random(), np.random.rand(3))
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    assert isinstance(gen, torch.Generator) and gen.device.type == "cpu"
    assert gen.initial_seed() == 7
    torch.testing.assert_close(
        torch.rand(4, generator=gen),
        torch.rand(4, generator=torch.Generator().manual_seed(7)))


def test_worker_rngs_match_jax():
    got = [r.integers(0, 1 << 30, 5) for r in seeding.worker_rngs(3, 4)]
    want = [r.integers(0, 1 << 30, 5) for r in jax_seeding.worker_rngs(3, 4)]
    np.testing.assert_array_equal(got, want)


# -- utils/profiling.py ----------------------------------------------------

def test_step_timer_windows():
    timers = (profiling.StepTimer(window=3), jax_profiling.StepTimer(
        window=3))
    x = torch.ones(2)
    for t in timers:
        t.start()
    with mock.patch.object(torch.cuda, "synchronize") as sync:
        got = [timers[0].step(x) for _ in range(7)]
    want = [timers[1].step(jnp.ones(2)) for _ in range(7)]
    assert [g is None for g in got] == [w is None for w in want] == [
        True, True, False, True, True, False, True]
    assert got[2] > 0 and got[5] > 0 == sync.call_count  # no card, no wait
    assert timers[0].last_steps_per_sec == got[5]


def test_step_timer_waits_for_cuda_tensors_only_at_boundaries():
    timer = profiling.StepTimer(window=2)
    timer.start()
    fake = mock.Mock(spec=torch.Tensor, is_cuda=True, device="cuda:1")
    with mock.patch.object(torch.cuda, "synchronize") as sync:
        timer.step({"pose": fake})
        assert sync.call_count == 0
        timer.step({"pose": fake, "other": [fake]})
    sync.assert_called_once_with("cuda:1")


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with profiling.trace(None):
        torch.ones(2) + 1
    assert not os.listdir(tmp_path)
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir):
        torch.ones(8, 8) @ torch.ones(8, 8)
    files = glob.glob(osp.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names


# -- utils/visualize.py ----------------------------------------------------

@pytest.mark.parametrize("three_d", [True, False])
def test_plot_trajectories_png_equals_jax(tmp_path, three_d):
    pytest.importorskip("matplotlib", reason="matplotlib is not installed "
                        "here: the plots are a host call into it")
    rng = np.random.default_rng(0)
    pred = rng.normal(size=(40, 6)).astype(np.float32)
    targ = pred + rng.normal(scale=0.1, size=pred.shape).astype(np.float32)
    a = jax_visualize.plot_trajectories(pred, targ, str(tmp_path / "a.png"),
                                        three_d=three_d, freq=25)
    b = visualize.plot_trajectories(torch.from_numpy(pred), targ,
                                    str(tmp_path / "b.png"),
                                    three_d=three_d, freq=25)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


# -- data/sequences.py and cli.scenes2seq ----------------------------------

@pytest.fixture(scope="module")
def raw_scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("seq")
    write_7scenes_fixture(str(root), scene="chess", n_seqs=3, n_frames=12,
                          train=True, size=(16, 12))
    write_7scenes_fixture(str(root), scene="chess", n_seqs=1, n_frames=12,
                          train=False, size=(16, 12))
    return str(root / "chess")


def _same_tree(a, b):
    files = sorted(osp.relpath(p, a) for p in glob.glob(
        osp.join(a, "**", "*"), recursive=True) if osp.isfile(p))
    assert files == sorted(osp.relpath(p, b) for p in glob.glob(
        osp.join(b, "**", "*"), recursive=True) if osp.isfile(p))
    for f in files:
        with open(osp.join(a, f), "rb") as fa, \
                open(osp.join(b, f), "rb") as fb:
            assert fa.read() == fb.read(), f
    return files


def test_scenes_to_sequences_byte_equal(raw_scene, tmp_path):
    want = jax_seq.scenes_to_sequences(raw_scene, str(tmp_path / "jax"))
    got = sequences.scenes_to_sequences(raw_scene, str(tmp_path / "port"),
                                        device="cpu")
    assert sorted(got) == sorted(want) == ["test", "train"]
    files = _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert len(files) == 3 * 5 + 2
    frames = sequences.load_frames_bin(got["train"], 2)
    assert len(frames) == 18 and frames[1]["id"] == 2
    with open(want["train"], "rb") as f:
        assert len(pickle.load(f)) == 36


def test_tum_exports_and_readers_byte_equal(raw_scene, tmp_path):
    jseq = jax_seq.scene_to_frame_seq(raw_scene, "seq-02")
    pseq = sequences.scene_to_frame_seq(raw_scene, "seq-02")
    for name, fn in (("rgb.txt", "export_tum_img_info"),
                     ("gt.txt", "export_tum_trajectory"),
                     ("assoc.txt", "export_tum_associate")):
        os.makedirs(tmp_path / "jax" / "tum" / "s", exist_ok=True)
        os.makedirs(tmp_path / "port" / "tum" / "s", exist_ok=True)
        getattr(jax_seq, fn)(jseq, str(tmp_path / "jax" / name))
        getattr(sequences, fn)(pseq, str(tmp_path / "port" / name),
                               *(("cpu",) if fn != "export_tum_img_info"
                                 else ()))
    # TUM ingest of the association file, and the seq.json it dumps
    for mod, who in ((jax_seq, "jax"), (sequences, "port")):
        os.replace(tmp_path / who / "assoc.txt",
                   tmp_path / who / "tum" / "s" / "rdpose_associate.txt")
        seq = mod.tum_seq_to_json(str(tmp_path / who / "tum"), "s",
                                  str(tmp_path / who / "seq.json"))
        assert len(seq) == 12
    _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))


def test_scenes2seq_cli_byte_equal(raw_scene, tmp_path):
    sys.path.insert(0, osp.join(REPO, "cli"))
    try:
        import scenes2seq as jax_cli   # cli/scenes2seq.py
    finally:
        sys.path.remove(osp.join(REPO, "cli"))
    jax_cli.main([raw_scene, "--dst-dir", str(tmp_path / "jax")])
    out = scenes2seq.main([raw_scene, "--dst-dir", str(tmp_path / "port"),
                           "--device", "cpu"])
    assert sorted(out) == ["test", "train"]
    _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))


# -- cli.serve --trace-dir ---------------------------------------------------

@pytest.mark.parametrize("scenes", [("chess",), ("chess", "fire")])
def test_serve_writes_a_trace_on_the_cpu(tmp_path, scenes, monkeypatch,
                                         capsys):
    from test_torch_cli_build_graphs import write_raw_scene
    from test_torch_cli_serve import write_pose_tar

    raw = str(tmp_path / "raw")
    for k, scene in enumerate(scenes):
        write_raw_scene(raw, scene, seed=k)
    pth = str(tmp_path / "r3.pth.tar")
    write_pose_tar(pth)
    trace = str(tmp_path / "trace")
    # a window of 4 of the 12 database frames: 3 selections at period 5
    # need 11 survivors, so every batch's window falls short
    monkeypatch.setattr(port_serve, "ServiceConfig", functools.partial(
        port_serve.ServiceConfig, retrieval_candidates=4))
    out = port_serve.main([
        "--scene", *scenes, "--data-path", raw, "--seq-len", "4",
        "--image-size", "32", "--batch-size", "3", "--backbone", "resnet18",
        "--feat-dim", "32", "--dtype", "float32",
        "--retrieval-mode", "shared-trunk", "--weights", pth,
        "--trace-dir", trace, "--device", "cpu"])
    errs = [out] if len(scenes) == 1 else [out[s] for s in scenes]
    assert all(np.isfinite(e.median_t) for e in errs)
    # 4 queries a scene in batches of 3
    served = [ln for ln in capsys.readouterr().out.splitlines()
              if "served" in ln and "queries in" in ln]
    assert len(served) == len(scenes)
    assert all(ln.endswith(", window fallbacks 2 of 2 batches")
               for ln in served), served
    files = glob.glob(osp.join(trace, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    # the encoder's convolutions and the attention core's plain version
    # (the CPU's) ran inside the traced loop
    assert "aten::conv2d" in names and "aten::softmax" in names
    # and the service's spans, the window's read and its fallback
    assert {"relpose." + n for n in (
        "service.query", "service.upload", "service.descriptor",
        "service.encode", "service.rank", "service.select",
        "service.gather", "service.gnn", "select.window_read",
        "select.full_sort", "stream.fetch")} <= names
