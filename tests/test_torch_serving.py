"""The port's cached serving slice against the JAX serving path, with the
same weights and inputs (float32), plus the guards that keep the port free
of jax and keep `chip_smoke.py` from passing without a card.

Tolerances: anchors (`nbr`) exactly equal; predictions atol 1e-4 (a
ResNet18 embedding, two GNN passes and the heads, each summed in another
order than XLA's; measured differences are ~2e-7); pose errors (float64
numpy on both sides) rtol 1e-12; the normaliser and fusion (the same
float32 expressions) rtol = atol = 1e-6.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from relpose_gnn_tpu.data.pipeline import make_normalizer as jax_normalizer
from relpose_gnn_tpu.evaluation import evaluator as jax_evaluator
from relpose_gnn_tpu.evaluation import serving as jax_serving
from relpose_gnn_tpu.models.posenet import RelPoseGNN as JaxRelPoseGNN
from relpose_gnn_tpu.models.posenet import RelPoseGNNConfig as JaxConfig
from relpose_gnn_tpu.training import trainer as jax_trainer
from relpose_gnn_tpu_torch.data.packed import (PackedGraphDataset,
                                               PackedGraphWriter)
from relpose_gnn_tpu_torch.data.pipeline import make_normalizer
from relpose_gnn_tpu_torch.evaluation import serving
from relpose_gnn_tpu_torch.evaluation.evaluator import compute_pose_errors
from relpose_gnn_tpu_torch.models.convert import state_dict_from_jax
from relpose_gnn_tpu_torch.models.posenet import RelPoseGNN, RelPoseGNNConfig
from relpose_gnn_tpu_torch.training.trainer import (check_fuse_ok,
                                                    fuse_pose_estimates)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = (2, 2, 2, 2)
B, N, D, H, W = 3, 4, 32, 32, 40
PRED_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads while this module runs: the suite runs several
    test processes on one host, and torch's default of one thread a core
    in each of them oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg_kwargs(**kw):
    base = dict(num_nodes=N, feat_dim=D, edge_dim=D, node_dim=D, knn=2,
                backbone="resnet18", droprate=0.0, compact_edges=True)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def weights():
    """JAX variables of a small RelPoseGNN (numpy) and the inputs of one
    cached eval batch."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    nbr_emb = rng.normal(size=(B, N - 1, D)).astype(np.float32)
    nbr_poses = rng.normal(size=(B, N - 1, 6)).astype(np.float32)
    adj = np.broadcast_to(~np.eye(N, dtype=bool), (B, N, N)).copy()
    model = JaxRelPoseGNN(JaxConfig(**_cfg_kwargs()))
    variables = jax.jit(lambda k: model.init(
        k, q[:, None].repeat(N, 1), adj))(jax.random.PRNGKey(0))
    variables = jax.device_get(variables)
    return variables, (q, nbr_emb, nbr_poses, adj)


def _models(variables, **kw):
    jmodel = JaxRelPoseGNN(JaxConfig(**_cfg_kwargs(**kw)))
    tmodel = RelPoseGNN(RelPoseGNNConfig(**_cfg_kwargs(**kw))).eval()
    tmodel.load_state_dict(state_dict_from_jax(
        variables["params"], variables["batch_stats"], STAGES), strict=True)
    return jmodel, tmodel


@pytest.mark.parametrize("fuse,kw", [
    ("first", {}), ("mean", {}), ("median", {}),
    ("first", dict(compact_edges=False)),
    ("first", dict(knn=0, static_anchor=1)),
    ("mean", dict(knn=0, static_anchor=1)),
])
def test_cached_eval_step_matches_jax(weights, fuse, kw):
    variables, inputs = weights
    kw = dict(kw)
    static_anchor = kw.pop("static_anchor", None)
    jmodel, tmodel = _models(variables, **kw)
    want = jax_serving.make_cached_eval_step(
        jmodel, static_anchor=static_anchor, fuse=fuse)(variables, *inputs)
    got = serving.make_cached_eval_step(
        tmodel, static_anchor=static_anchor, fuse=fuse)(
        *map(torch.from_numpy, inputs))
    np.testing.assert_array_equal(got["nbr"].numpy(), np.asarray(want["nbr"]))
    if static_anchor is not None:
        np.testing.assert_array_equal(got["nbr"].numpy(), static_anchor)
    np.testing.assert_allclose(got["pred"].numpy(), np.asarray(want["pred"]),
                               atol=PRED_ATOL)
    assert ("fuse_ok" in got) == (fuse != "first")


def test_cached_eval_step_refuses_ref_node(weights):
    _, tmodel = _models(weights[0])
    with pytest.raises(ValueError, match="ref_node == 0"):
        serving.make_cached_eval_step(tmodel, ref_node=1)


def _write_store(root, rng, n_graphs, n_db):
    db = rng.integers(0, 256, size=(n_db, H, W, 3)).astype(np.uint8)
    db_poses = rng.normal(size=(n_db, 6)).astype(np.float32)
    writer = PackedGraphWriter(root, n_graphs, N, H, W,
                               mean=[0.4, 0.45, 0.5], std=[0.2, 0.25, 0.3])
    for _ in range(n_graphs):
        nbr = rng.choice(n_db, N - 1, replace=False)
        query = rng.integers(0, 256, size=(1, H, W, 3)) / 255.0
        imgs = np.concatenate([query, db[nbr] / 255.0])
        poses = np.concatenate([rng.normal(size=(1, 6)), db_poses[nbr]])
        writer.add(imgs.astype(np.float32), poses.astype(np.float32),
                   ~np.eye(N, dtype=bool), nbr_idx=nbr)
    writer.finalize()
    return db


@pytest.mark.parametrize("fuse", ["first", "median"])
def test_evaluate_scene_cached_matches_jax(weights, tmp_path, fuse):
    variables, _ = weights
    rng = np.random.default_rng(1)
    db = _write_store(str(tmp_path / "store"), rng, n_graphs=7, n_db=10)
    ds = PackedGraphDataset(str(tmp_path / "store"))
    jmodel, tmodel = _models(variables)
    want = jax_serving.evaluate_scene_cached(
        jmodel, variables, ds, db, batch_size=3, embed_batch=4, fuse=fuse)
    got = serving.evaluate_scene_cached(
        tmodel, ds, db, batch_size=3, embed_batch=4, fuse=fuse,
        device="cpu")
    assert got["pred"].shape == (7, 6)
    np.testing.assert_allclose(got["pred"], want["pred"], atol=PRED_ATOL)
    np.testing.assert_array_equal(got["target"], want["target"])


def test_embed_database_matches_jax(weights):
    variables, (q, *_) = weights
    jmodel, tmodel = _models(variables)
    imgs = np.concatenate([q, q[::-1]])
    want = jax_serving.embed_database(jmodel, variables, imgs, batch_size=4)
    got = serving.embed_database(tmodel, imgs, batch_size=4, device="cpu")
    assert got.shape == (2 * B, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=PRED_ATOL)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_make_normalizer_matches_jax(dtype):
    rng = np.random.default_rng(2)
    imgs = (rng.integers(0, 256, size=(2, 5, 6, 3)).astype(dtype)
            if dtype == np.uint8 else rng.random((2, 5, 6, 3), np.float32))
    mean, std = np.array([0.4, 0.5, 0.6]), np.array([0.2, 0.3, 0.25])
    got = make_normalizer(mean, std, "cpu")(torch.from_numpy(imgs))
    want = jax_normalizer(mean, std)(jnp.asarray(imgs))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("fuse", ["mean", "median"])
def test_fuse_pose_estimates_matches_jax(fuse):
    rng = np.random.default_rng(3)
    est = rng.normal(size=(6, 5, 6)).astype(np.float32)
    mask = rng.random((6, 5)) < 0.5
    mask[np.arange(6), np.arange(6) % 5] = True   # 1..5 sources per row
    mask[0] = [True, False, False, False, False]  # exactly one source
    got = fuse_pose_estimates(torch.from_numpy(est), torch.from_numpy(mask),
                              fuse)
    want = jax_trainer.fuse_pose_estimates(jnp.asarray(est),
                                           jnp.asarray(mask), fuse)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_check_fuse_ok_raises_on_zero_edge_rows():
    check_fuse_ok({"fuse_ok": torch.tensor(True)}, "here")
    check_fuse_ok({"pred": torch.zeros(1)}, "here")
    with pytest.raises(ValueError, match="ZERO incoming edges"):
        check_fuse_ok({"fuse_ok": torch.tensor(False)}, "here")


def test_compute_pose_errors_matches_jax():
    rng = np.random.default_rng(4)
    pred, targ = rng.normal(size=(2, 20, 6)).astype(np.float32)
    mean, std = rng.normal(size=3), rng.uniform(0.5, 2, size=3)
    for kw in ({}, dict(pose_mean=mean, pose_std=std)):
        got = compute_pose_errors(pred, targ, **kw)
        want = jax_evaluator.compute_pose_errors(pred, targ, **kw)
        for f in ("median_t", "mean_t", "median_q", "mean_q", "t_errors",
                  "q_errors", "pred_poses", "targ_poses"):
            np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                       rtol=1e-12, err_msg=f)
        assert str(got) == str(want)


def _run(code_or_args, env=None, timeout=120):
    env = {**os.environ, **(env or {})}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, *code_or_args], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_port_and_chip_smoke_never_import_jax():
    """After importing every module of the port and `chip_smoke`, no
    module of jax, flax, optax, orbax, the JAX package or the repo's
    top-level `benchmarks` package is loaded (the `_torch` package's own name
    starts like the JAX package's and is excepted), and no module of PIL:
    the loaders import it only where they decode, so that the card's
    machine, which has none, imports them."""
    proc = _run(["-c", (
        "import importlib, pkgutil, sys\n"
        "import relpose_gnn_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    pkg.__path__, pkg.__name__ + '.')]\n"
        "assert len(names) >= 55, names\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "def foreign(m):\n"
        "    top = m.split('.')[0]\n"
        "    return top in ('jax', 'jaxlib', 'flax', 'optax', 'orbax',\n"
        "                   'relpose_gnn_tpu', 'benchmarks', 'bench', 'PIL')\n"
        "bad = sorted(m for m in sys.modules if foreign(m))\n"
        "assert not bad, bad\n"
        "for tail in ('evaluation.service', 'evaluation.multiscene',\n"
        "             'ops.att_variants', 'benchmarks._util',\n"
        "             'benchmarks._synthetic', 'benchmarks.bench_att_core',\n"
        "             'benchmarks.bench_att_variants',\n"
        "             'benchmarks.bench_att_variants2',\n"
        "             'benchmarks.bench_att_exp2',\n"
        "             'benchmarks.bench_service',\n"
        "             'benchmarks.bench_service_bisect',\n"
        "             'benchmarks.bench_retrieval_stages',\n"
        "             'benchmarks.bench_eval', 'benchmarks.bench_train',\n"
        "             'ops.pose', 'training.criterion',\n"
        "             'training.checkpoints', 'training.experiment',\n"
        "             'utils.logging', 'ops.camera', 'data.transforms',\n"
        "             'data.seven_scenes', 'data.cambridge',\n"
        "             'data.graph_builder', 'data.device_cache',\n"
        "             'data.native_io', 'benchmarks.bench_feed'):\n"
        "    assert 'relpose_gnn_tpu_torch.' + tail in sys.modules, tail\n"
        "print('clean')\n")])
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def test_entry_points_refuse_to_run_without_a_card(weights, tmp_path):
    """`device=None` means the CUDA card: where there is none the entry
    points raise instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    _, tmodel = _models(weights[0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serving.embed_database(tmodel, np.zeros((1, H, W, 3), np.float32))
    _write_store(str(tmp_path / "s"), np.random.default_rng(0), 2, 4)
    ds = PackedGraphDataset(str(tmp_path / "s"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serving.evaluate_scene_cached(
            tmodel, ds, np.zeros((4, H, W, 3), np.uint8))


def test_chip_smoke_fails_without_cuda():
    proc = _run(["chip_smoke.py"], env={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    lines = proc.stdout.strip().splitlines()
    assert not lines or '"ok": true' not in lines[-1]
