"""The port's training feeds and dataset eval against the JAX package's,
on the CPU, on tiny packed stores (4-node graphs, 8x10 and 32x40 frames,
resnet18, dims 32) written from numpy seeds:

  * the native graphio runtime (`data/native_io.py`, `csrc/graphio.cc`):
    `NativeArray`, `NativeConcatDataset` (two stores, rows grouped by
    store; mixed dtypes refused) and `native_data_iterator` equal the JAX
    package's byte for byte;
  * `DeviceCachedFeed(device="cpu")` equals the port's host feed
    (`data_iterator` -> `device_prefetch`) bit for bit, and JAX's cached
    feed within atol 1e-6 (the normalisation is float32 in both, in
    different libraries);
  * `run_training(device_cache=True)` equals the host-feed run (which
    takes the native feed) bit for bit;
  * `evaluate_dataset` with the port's eval step equals JAX's on weights
    carried over by `train_state_from_jax`, predictions within rtol =
    atol = 1e-4 (the tolerance tests/test_torch_experiment.py holds
    `run_eval` to);
  * `run_eval(serving_data_path=...)` on a raw 7-Scenes tree: database
    images equal JAX's `load_database_images` byte for byte, predictions
    and medians equal those of the JAX serving eval's body within that
    tolerance.
"""

import os.path as osp

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from relpose_gnn_tpu.data import native_io as jax_native
from relpose_gnn_tpu.data import pipeline as jax_pipeline
from relpose_gnn_tpu.data.device_cache import DeviceCachedFeed as JaxCached
from relpose_gnn_tpu.data.packed import PackedGraphDataset as JaxPacked
from relpose_gnn_tpu.data.seven_scenes import SevenScenes as JaxSevenScenes
from relpose_gnn_tpu.evaluation import evaluator as jax_evaluator
from relpose_gnn_tpu.models.posenet import RelPoseGNN as JaxRelPoseGNN
from relpose_gnn_tpu.models.posenet import RelPoseGNNConfig as JaxConfig
from relpose_gnn_tpu.training import experiment as jax_exp
from relpose_gnn_tpu.training import trainer as jax_trainer
from relpose_gnn_tpu_torch.data import native_io, pipeline
from relpose_gnn_tpu_torch.data.device_cache import DeviceCachedFeed
from relpose_gnn_tpu_torch.data.graph_builder import (GraphBuilderConfig,
                                                      build_graphs)
from relpose_gnn_tpu_torch.data.packed import (ConcatPackedDataset,
                                               PackedGraphDataset,
                                               PackedGraphWriter)
from relpose_gnn_tpu_torch.data.seven_scenes import SevenScenes
from relpose_gnn_tpu_torch.evaluation.evaluator import evaluate_dataset
from relpose_gnn_tpu_torch.models.convert import train_state_from_jax
from relpose_gnn_tpu_torch.models.posenet import RelPoseGNN, RelPoseGNNConfig
from relpose_gnn_tpu_torch.training import checkpoints as ckpt
from relpose_gnn_tpu_torch.training import experiment as exp
from relpose_gnn_tpu_torch.training import trainer
from test_data import write_7scenes_fixture

N, H, W, D = 4, 32, 40, 32
PRED_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads while this module runs: the suite runs several
    test processes on one host, and torch's default of one thread a core
    in each of them oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _write(root, n, mean, std, rng, h=8, w=10, dtype="uint8", rows=None):
    """A store of n graphs, `rows` of them written (the rest are the
    preallocated tail a store with skipped frames keeps)."""
    wtr = PackedGraphWriter(root, n, N, h, w, mean=mean, std=std,
                            dtype=dtype)
    for _ in range(n if rows is None else rows):
        wtr.add(rng.random((N, h, w, 3)),
                rng.normal(size=(N, 6)).astype(np.float32),
                rng.random((N, N)) < 0.5, nbr_idx=rng.integers(0, 9, N - 1))
    wtr.finalize()
    return root


@pytest.fixture(scope="module")
def small_stores(tmp_path_factory):
    """Two uint8 stores (9 graphs; 7 of 8 written) and a float16 one."""
    root = tmp_path_factory.mktemp("feed")
    rng = np.random.default_rng(0)
    a = _write(str(root / "a"), 9, [0.4, 0.45, 0.5], [0.2, 0.25, 0.3], rng)
    b = _write(str(root / "b"), 8, [0.6] * 3, [0.3] * 3, rng, rows=7)
    f16 = _write(str(root / "f16"), 3, [0.5] * 3, [0.2] * 3, rng,
                 dtype="float16")
    return a, b, f16


def _equal_batches(got, want, exact=True):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in a:
            x = a[k].numpy() if torch.is_tensor(a[k]) else np.asarray(a[k])
            y = b[k].numpy() if torch.is_tensor(b[k]) else np.asarray(b[k])
            if exact or k != "images":
                assert x.dtype == y.dtype, k
                np.testing.assert_array_equal(x, y, err_msg=k)
            else:
                np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the native runtime
# ---------------------------------------------------------------------------


def test_native_runtime_builds_into_the_ports_build_dir():
    assert native_io.available()
    path = native_io.library_path()
    assert path.is_file() and path.parent.name == "_build"
    assert path.parent.parent.name == "relpose_gnn_tpu_torch"


@pytest.mark.parametrize("threads", [1, 4])
def test_native_array_matches_jax(small_stores, threads):
    for key in ("images", "poses", "adj", "nbr_idx"):
        path = osp.join(small_stores[0], f"{key}.npy")
        idx = np.array([8, 0, 3, 3, 5, 1, 7])
        got = native_io.NativeArray(path).gather(idx, threads=threads)
        want = jax_native.NativeArray(path).gather(idx, threads=threads)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.load(path)[idx])
    arr = native_io.NativeArray(osp.join(small_stores[0], "poses.npy"))
    with pytest.raises(IndexError):
        arr.gather(np.array([0, 9]))
    with pytest.raises(ValueError, match="C-contiguous"):
        arr.gather(np.array([0, 1]), out=np.empty((2, N, 6), np.float64))


def test_native_concat_matches_jax_and_the_grouped_concat(small_stores):
    roots = list(small_stores[:2])
    got_ds = native_io.NativeConcatDataset(roots, threads=2)
    want_ds = jax_native.NativeConcatDataset(roots, threads=2)
    concat = ConcatPackedDataset([PackedGraphDataset(r) for r in roots])
    assert len(got_ds) == len(want_ds) == len(concat) == 16
    np.testing.assert_array_equal(got_ds.mean, want_ds.mean)
    rng = np.random.default_rng(1)
    for idx in (rng.permutation(16), np.array([15, 2, 9, 9, 0, 12]),
                np.array([3]), np.arange(16)[::-1]):
        got, want = got_ds.batch(idx), want_ds.batch(idx)
        _equal_batches([got], [want])
        # the concat feed's rows, grouped by store by a stable sort
        order = np.argsort(idx >= 9, kind="stable")
        ref = concat.batch(idx)
        _equal_batches([got], [{k: v[order] for k, v in ref.items()}])
    with pytest.raises(IndexError):
        got_ds.batch(np.array([16]))
    got_ds.close()


def test_native_concat_refuses_mixed_dtypes_like_jax(small_stores):
    roots = [small_stores[0], small_stores[2]]
    for mod in (native_io, jax_native):
        with pytest.raises(ValueError, match="mixed images dtypes"):
            mod.NativeConcatDataset(roots)


@pytest.mark.parametrize("kw", [
    dict(batch_size=2, seed=3, epochs=2),
    dict(batch_size=4, shuffle=False, drop_remainder=False),
    dict(batch_size=3, seed=5, drop_remainder=False, threads=1),
])
def test_native_data_iterator_matches_jax(small_stores, kw):
    for root in small_stores[:2]:
        got = pipeline.native_data_iterator(root, **kw)
        _equal_batches(got, jax_pipeline.native_data_iterator(root, **kw))
        kw_np = {k: v for k, v in kw.items() if k != "threads"}
        _equal_batches(pipeline.native_data_iterator(root, **kw),
                       pipeline.data_iterator(PackedGraphDataset(root),
                                              **kw_np))


def test_native_loader_stops_cleanly_mid_epoch(small_stores):
    loader = native_io.NativeBatchLoader(small_stores[1], threads=2)
    assert len(loader) == 7
    it = loader.epoch(np.random.default_rng(0), 2)
    first = next(it)
    it.close()
    assert first["images"].shape == (2, N, 8, 10, 3)
    loader.close()


# ---------------------------------------------------------------------------
# the store held on the device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["single", "concat"])
def test_device_cache_equals_the_host_feed(small_stores, which):
    roots = small_stores[:1] if which == "single" else small_stores[:2]
    ds = (PackedGraphDataset(roots[0]) if which == "single" else
          ConcatPackedDataset([PackedGraphDataset(r) for r in roots]))
    feed = DeviceCachedFeed(ds, "cpu")
    assert feed.nbytes == sum(v.nbytes for v in
                              ds.batch(np.arange(len(ds))).values())
    for seed in (0, 7):
        host = pipeline.device_prefetch(
            pipeline.data_iterator(ds, 4, seed=seed, epochs=1), ds.mean,
            ds.std, device="cpu")
        _equal_batches(feed.epoch(seed=seed, batch_size=4), host)
    host = pipeline.device_prefetch(
        pipeline.data_iterator(ds, 4, shuffle=False, epochs=1,
                               drop_remainder=False), ds.mean, ds.std,
        device="cpu")
    cached = list(feed.eval_batches(4))
    assert [n for _, n in cached] == [4] * (len(ds) // 4) + (
        [len(ds) % 4] if len(ds) % 4 else [])
    _equal_batches([b for b, _ in cached], host)


def test_device_cache_matches_jax(small_stores):
    got = DeviceCachedFeed(PackedGraphDataset(small_stores[0]), "cpu")
    want = JaxCached(JaxPacked(small_stores[0]))
    assert got.nbytes == want.nbytes
    _equal_batches(got.epoch(seed=2, batch_size=3),
                   want.epoch(seed=2, batch_size=3), exact=False)
    _equal_batches([b for b, _ in got.eval_batches(4)],
                   [b for b, _ in want.eval_batches(4)], exact=False)


# ---------------------------------------------------------------------------
# run_training, evaluate_dataset, run_eval
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def graph_stores(tmp_path_factory):
    """`chess_fc4_sp5_{train,test}` (10 / 5 graphs at 32x40)."""
    root = tmp_path_factory.mktemp("graphs")
    rng = np.random.default_rng(2)
    for split, n in (("train", 10), ("test", 5)):
        _write(str(root / f"chess_fc4_sp5_{split}"), n,
               [0.45, 0.44, 0.4], [0.22, 0.23, 0.21], rng, h=H, w=W)
    return str(root)


def _cfg(root, module=exp, **kw):
    base = dict(dataset="7Scenes", experiment=2, train_scene="chess",
                test_scene="chess", train_data_dir=root, test_data_dir=root,
                exp_name="t", model_name="R3", backbone="resnet18",
                feat_dim=D, batch_size=4, seq_len=N, max_epoch=2,
                eval_after_epoch=-1, dtype="float32", knn=2,
                allow_random_init=True)
    base.update(kw)
    return module.ExperimentConfig(**base)


def test_run_training_from_the_device_cache_equals_the_host_feed(
        graph_stores, tmp_path):
    runs = {}
    for cache in (True, False):
        save = str(tmp_path / str(cache))
        runs[cache] = exp.run_training(
            _cfg(graph_stores, save_dir=save, device_cache=cache),
            device="cpu")
        with open(osp.join(save, "7Scenes", "chess", "t", "logger.log")) as f:
            log = f.read()
        assert ("training feed: device cache" in log) == cache
        assert ("training feed: native C++ graphio" in log) == (not cache)
    got = runs[True]["state"].state_dict()
    want = runs[False]["state"].state_dict()
    flat_got, flat_want = _flat(got), _flat(want)
    assert flat_got.keys() == flat_want.keys()
    for k in flat_got:
        assert torch.equal(flat_got[k], flat_want[k]), k
    assert runs[True]["best"] == runs[False]["best"]
    assert runs[True]["best"]["chess"]["median_t"] < 1e6


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        elif torch.is_tensor(v):
            out[prefix + str(k)] = v
    return out


@pytest.fixture(scope="module")
def jax_state(graph_stores):
    model = JaxRelPoseGNN(JaxConfig(num_nodes=N, feat_dim=D, edge_dim=D,
                                    node_dim=D, knn=2, backbone="resnet18"))
    images = jnp.zeros((2, N, H, W, 3), jnp.float32)
    adj = jnp.asarray(np.broadcast_to(~np.eye(N, dtype=bool), (2, N, N)))
    variables = jax.jit(lambda k: model.init(k, images, adj))(
        jax.random.PRNGKey(3))
    return jax_trainer.create_train_state(
        jax.random.PRNGKey(3), model, jax_trainer.TrainerConfig(), images,
        adj, variables=variables)


@pytest.mark.parametrize("fuse", ["first", "median"])
def test_evaluate_dataset_matches_jax(graph_stores, jax_state, fuse):
    root = osp.join(graph_stores, "chess_fc4_sp5_test")
    model = RelPoseGNN(RelPoseGNNConfig(num_nodes=N, feat_dim=D, edge_dim=D,
                                        node_dim=D, knn=2,
                                        backbone="resnet18"))
    state = trainer.create_train_state(model, trainer.TrainerConfig())
    state.load_state_dict(train_state_from_jax(
        jax.tree.map(np.asarray, jax_state.params),
        jax.tree.map(np.asarray, jax_state.batch_stats)))
    ds = PackedGraphDataset(root)
    mean_t, std_t = np.array([0.1, 0.2, 0.3]), np.array([2.0, 1.0, 0.5])
    step = trainer.make_eval_step(fuse=fuse)
    got = evaluate_dataset(step, state, pipeline.device_prefetch(
        pipeline.data_iterator(ds, 3, shuffle=False, drop_remainder=False),
        ds.mean, ds.std, device="cpu"), mean_t, std_t)
    jds = JaxPacked(root)
    want = jax_evaluator.evaluate_dataset(
        jax_trainer.make_eval_step(fuse=fuse), jax_state,
        jax_pipeline.device_prefetch(jax_pipeline.data_iterator(
            jds, 3, shuffle=False, drop_remainder=False), jds.mean, jds.std),
        mean_t, std_t)
    assert got.pred_poses.shape == (5, 7)
    np.testing.assert_allclose(got.pred_poses, want.pred_poses, **PRED_TOL)
    np.testing.assert_array_equal(got.targ_poses, want.targ_poses)
    # the store held on the device gives the host feed's errors exactly
    cached = evaluate_dataset(step, state, (b for b, _ in DeviceCachedFeed(
        ds, "cpu").eval_batches(3)), mean_t, std_t)
    np.testing.assert_array_equal(cached.pred_poses, got.pred_poses)
    assert (cached.median_t, cached.median_q) == (got.median_t,
                                                  got.median_q)


@pytest.fixture(scope="module")
def raw_tree(tmp_path_factory):
    """A raw 7-Scenes tree (2 sequences x 4 frames at 40x32; the test
    split is seq-01) and
    `chess_fc4_sp5_test`, built by the port from it (RAND neighbours from
    the train split, whose indices nbr_idx holds)."""
    base = tmp_path_factory.mktemp("raw7")
    raw, graphs = str(base / "raw"), str(base / "graphs")
    write_7scenes_fixture(raw, n_seqs=2, n_frames=4, size=(W, H))
    write_7scenes_fixture(raw, n_seqs=1, n_frames=4, train=False,
                          size=(W, H))
    query = SevenScenes("chess", raw, train=False, image_size=H)
    database = SevenScenes("chess", raw, train=True, image_size=H)
    n = build_graphs(query, database,
                     osp.join(graphs, "chess_fc4_sp5_test"),
                     GraphBuilderConfig(seq_len=N, retrieval_mode="RAND",
                                        database_is_query_set=False),
                     mean=[0.45, 0.44, 0.4], std=[0.22, 0.23, 0.21],
                     height=H, width=W)
    assert n == len(query) == 4
    return raw, graphs


def test_serving_eval_from_raw_frames_matches_jax(raw_tree, jax_state,
                                                  tmp_path):
    """`run_eval(serving_data_path=...)` reads the database with the
    port's SevenScenes; the JAX side is the body of its own serving eval
    (`load_database_images` over its SevenScenes, then
    `evaluate_scene_cached` on the compact-edge model) from the same
    weights."""
    from relpose_gnn_tpu.evaluation.serving import evaluate_scene_cached

    raw, graphs = raw_tree
    got_db = exp.load_database_images(
        exp._raw_database(_cfg(graphs), "chess", raw, H), H, W)
    want_db = jax_exp.load_database_images(
        JaxSevenScenes("chess", raw, train=True, image_size=H), H, W)
    assert got_db.dtype == want_db.dtype == np.uint8
    np.testing.assert_array_equal(got_db, want_db)

    state = trainer.create_train_state(
        exp.build_model(_cfg(graphs), "cpu"), trainer.TrainerConfig())
    state.load_state_dict(train_state_from_jax(
        jax.tree.map(np.asarray, jax_state.params),
        jax.tree.map(np.asarray, jax_state.batch_stats)))
    weights = ckpt.save_torch_checkpoint(state, str(tmp_path / "w.pth.tar"),
                                         0)
    got = exp.run_eval(_cfg(graphs, save_dir=str(tmp_path)),
                       weights=weights, device="cpu", save_predictions=False,
                       serving_data_path=raw)["chess"]
    compact = JaxRelPoseGNN(JaxConfig(num_nodes=N, feat_dim=D, edge_dim=D,
                                      node_dim=D, knn=2, backbone="resnet18",
                                      compact_edges=True))
    out = evaluate_scene_cached(
        compact, {"params": jax_state.params["model"],
                  "batch_stats": jax_state.batch_stats},
        JaxPacked(osp.join(graphs, "chess_fc4_sp5_test")), want_db,
        batch_size=4)
    want = jax_evaluator.compute_pose_errors(out["pred"], out["target"],
                                             np.zeros(3), np.ones(3))
    assert got.pred_poses.shape == (4, 7)
    np.testing.assert_allclose(got.pred_poses, want.pred_poses, **PRED_TOL)
    np.testing.assert_allclose([got.median_t, got.median_q],
                               [want.median_t, want.median_q], **PRED_TOL)
