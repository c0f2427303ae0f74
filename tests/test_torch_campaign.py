"""The port's convergence campaign and shared-trunk re-gate
(relpose_gnn_tpu_torch/benchmarks/campaign.py, regate_shared_trunk.py)
against the JAX package's scripts on the CPU.

* `prepare` at a tiny size (7 scenes of 12x16 frames, 4 frames a
  sequence, 3-node graphs) writes the same file tree as the JAX
  `prepare`, name for name.  Files that carry float32 pose6 values are
  held as the earlier parity tests hold them: each package's `process_poses` runs
  in float32 in its own library and may differ in the last bit (ROADMAP.md
  section 3).  The stores' `poses.npy` are held within atol 4e-7, as
  tests/test_torch_cli_build_graphs.py holds them; the scenes' `stats.txt`
  (sums of the float frames, whose colour bars encode pose6, before their
  uint8 rounding) to rtol 1e-7, as tests/test_torch_synthetic_scenes.py
  holds them; the stores' `meta.json` equal as JSON but for the mean and
  std it copies from those stats, to rtol 1e-7.  The PNG files, the pose
  and split files, images, adjacency, neighbour indices and paths are
  byte for byte the JAX files.  The two scripts' `cli/build_graphs` subprocesses run in
  process here (their command lines checked), so that the file stays
  fast; the card's smoke run starts the real subprocess.
* `report` on a hand-written `metrics.jsonl`, whose boundary epoch is
  logged twice as a resumed run logs it, gives the JAX `report`'s
  document exactly, but the `reproduce` lines, which name the port's
  entry points with the JAX command lines' flags.
* The re-gate's per-scene rows and across-scene medians equal the JAX
  script's expressions (its :127-160, with the JAX `compute_pose_errors`)
  on the same arrays, exactly; one tiny scene runs end to end through
  `regate_shared_trunk.main` from a checkpoint `cli.train` wrote, and
  from the same weights exported as a `.pth.tar` (the same rows); an
  Orbax directory is refused.
"""

import importlib.util
import json
import os
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmarks import campaign as jax_campaign
from relpose_gnn_tpu.evaluation.evaluator import \
    compute_pose_errors as jax_pose_errors
from relpose_gnn_tpu_torch.benchmarks import campaign, regate_shared_trunk
from relpose_gnn_tpu_torch.cli import build_graphs as port_build_graphs
from relpose_gnn_tpu_torch.cli import train as cli_train
from relpose_gnn_tpu_torch.data.image_io import decode_png
from relpose_gnn_tpu_torch.training.checkpoints import save_torch_checkpoint

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
POSE_ATOL = 4e-7
MEAN_RTOL, VAR_RTOL, STD_RTOL = 1e-7, 2e-6, 1e-6
TINY = dict(frames_per_seq=4, train_seqs=2, test_seqs=1, height=12,
            width=16, seq_len=3)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads while this module runs: the suite runs several
    test processes on one host, and torch's default of one thread a core
    in each of them oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_build_graphs():
    spec = importlib.util.spec_from_file_location(
        "jax_cli_build_graphs", osp.join(REPO, "cli", "build_graphs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """Both packages' `prepare` at the tiny size; (jax root, port root)."""
    jax_cli = _jax_build_graphs()
    root = tmp_path_factory.mktemp("campaign")
    calls = []
    real_run = subprocess.run
    jax_script = osp.join(REPO, "cli", "build_graphs.py")
    port_module = ["-m", "relpose_gnn_tpu_torch.cli.build_graphs"]

    def run(cmd, check=False, env=None, **kw):
        """The build_graphs subprocess of either script, in process; any
        other command as it is."""
        if not (isinstance(cmd, list) and cmd[0] == sys.executable and (
                cmd[1] == jax_script or cmd[1:3] == port_module)):
            return real_run(cmd, check=check, env=env, **kw)
        assert check and not kw
        calls.append(cmd)
        if cmd[1] == jax_script:
            jax_cli.main(cmd[2:])
        else:
            assert env["PYTHONPATH"].split(os.pathsep)[0] == REPO
            port_build_graphs.main(cmd[3:])
        return subprocess.CompletedProcess(cmd, 0)

    jroot, proot = str(root / "jax"), str(root / "port")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(subprocess, "run", run)
        jax_campaign.prepare(jroot, *TINY.values())
        campaign.prepare(proot, *TINY.values(), device="cpu")
    return jroot, proot, calls


def _tree(root):
    return sorted(osp.relpath(osp.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_prepare_writes_the_jax_tree(prepared):
    jroot, proot, calls = prepared
    # one `multi` build per split in each script; the port's on the CPU
    # because it was asked for
    assert [c[2:4] for c in calls[:2]] == [c[3:5] for c in calls[2:]] == [
        ["multi", "train"], ["multi", "test"]]
    assert [c[-2:] for c in calls[2:]] == [["--device", "cpu"]] * 2
    tree = _tree(jroot)
    assert tree == _tree(proot)
    assert sum(f.endswith("images.npy") for f in tree) == 14
    for rel in tree:
        a, b = osp.join(jroot, rel), osp.join(proot, rel)
        if rel.endswith("poses.npy"):
            x, y = np.load(a), np.load(b)
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_allclose(y, x, atol=POSE_ATOL, rtol=0)
        elif rel.endswith("stats.txt"):
            x, y = np.loadtxt(a), np.loadtxt(b)
            np.testing.assert_allclose(y[0], x[0], rtol=MEAN_RTOL)
            np.testing.assert_allclose(y[1], x[1], rtol=VAR_RTOL)
        elif rel.endswith("meta.json"):
            x, y = (json.loads(open(p).read()) for p in (a, b))
            for key, rtol in (("mean", MEAN_RTOL), ("std", STD_RTOL)):
                np.testing.assert_allclose(y.pop(key), x.pop(key),
                                           rtol=rtol)
            assert x == y
        elif rel.endswith(".png"):
            assert np.array_equal(decode_png(a), decode_png(b)), rel
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), rel


def test_prepare_builds_on_the_card_unless_told(tmp_path, monkeypatch):
    """Without `--device` the build subprocess gets no device flag, and
    `cli.build_graphs` then runs on the card: where there is none it
    raises instead of carrying on on the CPU.  A subset of the scenes is
    built one scene at a time."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    calls = []
    monkeypatch.setattr(subprocess, "run",
                        lambda cmd, **kw: calls.append(cmd))
    campaign.main(["prepare", "--root", str(tmp_path), "--frames-per-seq",
                   "2", "--height", "8", "--width", "12", "--scenes",
                   "fire", "chess"])
    assert [c[3:5] for c in calls] == [["fire", "train"], ["chess", "train"],
                                       ["fire", "test"], ["chess", "test"]]
    assert not any("--device" in c for c in calls)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_build_graphs.main(calls[0][3:])
    with pytest.raises(SystemExit):
        campaign.main(["prepare"])          # --root is required


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------


def _metrics(path):
    """Epochs 0-4 with evals of two scenes from epoch 2; epoch 3 logged
    twice (a run resumed from its checkpoint), the later values win."""
    rng = np.random.default_rng(0)
    lines = []

    def epoch(e):
        lines.append({"step": 10 * (e + 1), "time": 1.0 + e, "epoch": e,
                      "loss": float(rng.normal()), "t_loss": 0.5,
                      "q_loss": 0.25})
        if e >= 2:
            for s in ("chess", "fire"):
                lines.append({"step": 10 * (e + 1), "time": 1.5 + e,
                              "epoch": e, "scene": s,
                              "median_t": float(rng.uniform(0.1, 1)),
                              "median_q": float(rng.uniform(1, 30))})

    for e in (0, 1, 2, 3, 3, 4):
        epoch(e)
    with open(path, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in lines)


def test_report_is_the_jax_document(tmp_path, capsys):
    logdir = tmp_path / "out" / "7Scenes" / "multi" / "acc_r05"
    logdir.mkdir(parents=True)
    _metrics(logdir / "metrics.jsonl")
    eval_dir = tmp_path / "out"
    (eval_dir / "7Scenes" / "chess" / "eval").mkdir(parents=True)
    for name in ("a_1_2.npz", "b_3_4.npz", "notes.txt"):
        (eval_dir / "7Scenes" / "chess" / "eval" / name).write_bytes(b"x")
    kw = dict(eval_dir=str(eval_dir), wall_s=1234.56)
    jax_campaign.report(str(logdir), str(tmp_path / "jax.json"), "G", "O",
                        **kw)
    got = campaign.main(["report", "--logdir", str(logdir), "--graphs", "G",
                         "--out-root", "O", "--eval-dir", str(eval_dir),
                         "--wall-s", "1234.56"])
    want = json.loads((tmp_path / "jax.json").read_text())
    # --out defaults to a file under --logdir, never a file of the repo
    assert json.loads((logdir / "acc_report.json").read_text()) == got
    assert {k: v for k, v in got.items() if k != "reproduce"} == \
        {k: v for k, v in want.items() if k != "reproduce"}
    assert [r["epoch"] for r in got["loss_curve"]] == [0, 1, 2, 3, 4]
    assert len(got["npz_exports"]) == 2
    # the same command lines, naming the port's entry points
    for key, port_head, jax_head in (
            ("train", "python -m relpose_gnn_tpu_torch.cli.train",
             "python cli/train.py"),
            ("test", "python -m relpose_gnn_tpu_torch.cli.test",
             "python cli/test.py")):
        assert got["reproduce"][key].startswith(port_head + " ")
        assert (got["reproduce"][key][len(port_head):]
                == want["reproduce"][key][len(jax_head):])
    assert got["reproduce"]["prepare"] == (
        "python -m relpose_gnn_tpu_torch.benchmarks.campaign prepare "
        "--root <R>")
    assert "final medians" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the re-gate
# ---------------------------------------------------------------------------


def _jax_rows(preds, q_poses, nbr_sets):
    """The JAX script's expressions (regate_shared_trunk.py:127-160)."""
    row = {}
    for mode in ("netvlad", "shared-trunk"):
        pred = np.asarray(preds[mode], np.float64)
        err = jax_pose_errors(pred, q_poses)
        row[mode] = {"median_t": round(err.median_t, 4),
                     "median_q": round(err.median_q, 3),
                     "mean_t": round(err.mean_t, 4),
                     "mean_q": round(err.mean_q, 3)}
    k = nbr_sets["netvlad"].shape[1]
    row["neighbor_overlap"] = round(float(np.mean(
        [len(set(a) & set(b)) / k
         for a, b in zip(nbr_sets["netvlad"],
                         nbr_sets["shared-trunk"])])), 4)
    return row


def _jax_medians(scenes):
    return {m: {"median_t": round(float(np.median(
                    [r[m]["median_t"] for r in scenes.values()])), 4),
                "median_q": round(float(np.median(
                    [r[m]["median_q"] for r in scenes.values()])), 3)}
            for m in ("netvlad", "shared-trunk")}


def test_regate_rows_are_the_jax_expressions():
    rng = np.random.default_rng(1)
    scenes, jax_scenes = {}, {}
    for s in ("chess", "fire", "heads", "office"):
        q_poses = rng.normal(size=(20, 6)).astype(np.float32)
        preds = {m: (q_poses + rng.normal(size=(20, 6)) * 0.1).astype(
            np.float32) for m in regate_shared_trunk.MODES}
        nbrs = {m: rng.integers(0, 12, size=(20, 7))
                for m in regate_shared_trunk.MODES}
        scenes[s] = regate_shared_trunk.scene_row(preds, q_poses, nbrs)
        jax_scenes[s] = _jax_rows(preds, q_poses, nbrs)
        assert scenes[s] == jax_scenes[s]
        assert 0 < scenes[s]["neighbor_overlap"] < 1
    assert regate_shared_trunk.across_scenes(scenes) == \
        _jax_medians(jax_scenes)


def test_regate_end_to_end_from_a_cli_train_checkpoint(prepared, tmp_path,
                                                       capsys):
    _, proot, _ = prepared
    graphs, raw, stats = (osp.join(proot, d) for d in ("graphs", "raw",
                                                       "stats"))
    model = ["--backbone", "resnet18", "--feat-dim", "32", "--seq-len", "3",
             "--knn", "1", "--dtype", "float32"]
    trained = cli_train.main([
        "--dataset", "7Scenes", "--experiment", "2", "--train-scene",
        "chess", "--test-scene", "chess", "--train-data-dir", graphs,
        "--test-data-dir", graphs, "--save-dir", str(tmp_path / "out"),
        "--exp-name", "t", "--batch-size", "4", "--max-epoch", "1",
        "--ckpt-every", "1", "--device", "cpu", *model])
    ckpt = str(tmp_path / "out" / "7Scenes" / "chess" / "t" / "ckpt")
    out = tmp_path / "regate.json"
    argv = ["--ckpt", ckpt, "--data-root", raw, "--stats-root", stats,
            "--scenes", "chess", "--out", str(out), "--image-size", "24",
            "--retrieval-hw", "24", "32", "--netvlad-clusters", "4",
            "--device", "cpu", *model]
    res = regate_shared_trunk.main(argv)
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    # 2 train sequences x 4 frames of chess: 8 graphs, batch 4, one epoch
    assert res["step"] == 2 and list(res["scenes"]) == ["chess"]
    row = res["scenes"]["chess"]
    for mode in regate_shared_trunk.MODES:
        assert set(row[mode]) == {"median_t", "median_q", "mean_t",
                                  "mean_q"}
        assert all(np.isfinite(v) for v in row[mode].values())
    assert 0 <= row["neighbor_overlap"] <= 1
    assert res["across_scenes"] == regate_shared_trunk.across_scenes(
        res["scenes"])
    assert "restored step 2" in capsys.readouterr().out

    # the same weights as a reference-layout .pth.tar: the same rows
    pth = str(tmp_path / "w.pth.tar")
    save_torch_checkpoint(trained["state"], pth, epoch=0)
    res2 = regate_shared_trunk.main(["--ckpt", pth, *argv[2:]])
    assert res2["step"] is None and res2["scenes"] == res["scenes"]

    orbax = tmp_path / "orbax"
    (orbax / "199").mkdir(parents=True)
    with pytest.raises(ValueError, match="Orbax"):
        regate_shared_trunk.main(["--ckpt", str(orbax), *argv[2:]])
