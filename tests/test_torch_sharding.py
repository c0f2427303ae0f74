"""The port's mesh, batch splitting and tensor-parallel layout
(relpose_gnn_tpu_torch/parallel/mesh.py, sharding.py), the service's
replicated form over a mesh (`RelocalizationService.replicate_over`) and
`evaluate_scene_cached` with a mesh, against the JAX package, on the CPU:
the JAX side on the virtual 8-device mesh of tests/conftest.py, the
port's as two gloo ranks spawned by tests/torch_ranks.py (one pool for the
whole module); the cases of tests/test_sharding.py.

Tolerances, with their basis:
  * meshes, splits and layouts: exact;
  * replicate_over: each rank encodes its half of the query batch, which
    changes the last bits of a CPU convolution against the whole batch in
    one process (tests/test_torch_service.py), so neighbours and anchors
    are held exactly (the scene's similarity gaps are wide, and the
    stochastic draws are keyed by the global query row) and poses to
    rtol = atol = 1e-5;
  * evaluate_scene_cached over two ranks: predictions to 1e-5 against one
    process (the same batch-split effect) and to 1e-4 against the JAX
    function over its data=2 mesh (tests/test_torch_serving.py's bound);
    targets exact;
  * `cli.serve --mesh-data 2` over two ranks against the same command in
    one process (tests/test_torch_cli_serve.py's raw scene, `.pth.tar`
    and NetVLAD `.tar`): predictions to 1e-5 (the batch split again),
    medians to 1e-4 m and 1e-2 degrees (that file's bound).
"""

import numpy as np
import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P
from scipy.ndimage import gaussian_filter

import torch_ranks
from relpose_gnn_tpu.evaluation import serving as jax_serving
from relpose_gnn_tpu.models.posenet import RelPoseGNN as JaxRelPoseGNN
from relpose_gnn_tpu.models.posenet import RelPoseGNNConfig as JaxConfig
from relpose_gnn_tpu.parallel import sharding as jax_sharding
from relpose_gnn_tpu.parallel.mesh import create_mesh as jax_create_mesh
from relpose_gnn_tpu_torch.data.packed import (PackedGraphDataset,
                                               PackedGraphWriter)
from relpose_gnn_tpu_torch.evaluation import serving
from relpose_gnn_tpu_torch.models.convert import (netvlad_state_dict_from_jax,
                                                  state_dict_from_jax)
from relpose_gnn_tpu_torch.models.posenet import RelPoseGNN, RelPoseGNNConfig
from relpose_gnn_tpu_torch.parallel import mesh as port_mesh
from relpose_gnn_tpu_torch.parallel import sharding

SEQ, H, W, RHW = 4, 32, 40, (48, 64)
STAGES = (2, 2, 2, 2)
MODEL_KW = dict(num_nodes=SEQ, feat_dim=32, edge_dim=32, node_dim=32, knn=2,
                backbone="resnet18", droprate=0.0)
SVC = dict(seq_len=SEQ, sampling_period=2, retrieval_hw=RHW)
FORMS = {
    "netvlad_det": dict(SVC, deterministic=True),
    "netvlad_stoch": dict(SVC, retrieval_candidates=8),
    "shared_stoch": dict(SVC, retrieval="shared-trunk"),
}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads while this module runs: the suite runs several
    test processes on one host, and torch's default of one thread a core
    in each of them oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_scene(n, seed=0, n_fields=3):
    """n frames [n, H, W, 3] in [0, 1]: sliding crops of `n_fields`
    smooth random fields (neighbouring crops overlap, fields differ)."""
    rng = np.random.default_rng(seed)
    fields = []
    for _ in range(n_fields):
        f = gaussian_filter(rng.normal(size=(90, 140, 3)), sigma=(5, 5, 0))
        fields.append((f - f.min()) / (f.max() - f.min()))
    per = -(-n // n_fields)
    frames = [fields[i // per][4 * (i % per):4 * (i % per) + H,
                               7 * (i % per):7 * (i % per) + W]
              for i in range(n)]
    return (np.stack(frames).astype(np.float32),
            rng.normal(size=(n, 6)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_weights():
    return torch_ranks.jax_service_weights(SEQ, H, W, RHW,
                                           tuple(sorted(MODEL_KW.items())))


@pytest.fixture(scope="module")
def weights(jax_weights):
    mvars, nvars = jax_weights
    return {"model": torch_ranks.np_state(state_dict_from_jax(
                mvars["params"], mvars["batch_stats"], STAGES)),
            "netvlad": torch_ranks.np_state(netvlad_state_dict_from_jax(
                nvars["params"]))}


@pytest.fixture(scope="module")
def data():
    db, poses = make_scene(16)
    q = np.clip(db[[1, 4, 6, 9, 10, 12, 14, 15]] * 0.98 + 0.01, 0, 1)
    return {"db": db, "poses": poses, "q": q.astype(np.float32)}


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """A packed store of 5 graphs with nbr_idx over a 10-frame uint8
    database: batch 4 leaves a ragged batch of 1, which pads over two
    ranks."""
    root = str(tmp_path_factory.mktemp("store") / "s")
    rng = np.random.default_rng(1)
    db = rng.integers(0, 256, size=(10, H, W, 3)).astype(np.uint8)
    db_poses = rng.normal(size=(10, 6)).astype(np.float32)
    writer = PackedGraphWriter(root, 5, SEQ, H, W, mean=[0.4, 0.45, 0.5],
                               std=[0.2, 0.25, 0.3])
    for _ in range(5):
        nbr = rng.choice(10, SEQ - 1, replace=False)
        query = rng.integers(0, 256, size=(1, H, W, 3)) / 255.0
        imgs = np.concatenate([query, db[nbr] / 255.0])
        poses = np.concatenate([rng.normal(size=(1, 6)), db_poses[nbr]])
        writer.add(imgs.astype(np.float32), poses.astype(np.float32),
                   ~np.eye(SEQ, dtype=bool), nbr_idx=nbr)
    writer.finalize()
    return root, db


BATCH = {"images": np.arange(8 * 2 * 3, dtype=np.float32).reshape(8, 2, 3),
         "adj": np.arange(8 * 4).reshape(8, 4) % 3 == 0}
CACHED = dict(batch_size=4, embed_batch=3)


@pytest.fixture(scope="module")
def serve_argv(tmp_path_factory):
    """`cli.serve` on the raw chess scene of tests/test_torch_cli_serve.py,
    deterministic, batch 4 over its 4 queries."""
    from test_torch_cli_build_graphs import write_raw_scene
    from test_torch_cli_serve import RHW as SERVE_RHW
    from test_torch_cli_serve import write_netvlad_tar, write_pose_tar
    tmp = tmp_path_factory.mktemp("serve")
    raw = str(tmp / "raw")
    frames = write_raw_scene(raw, "chess", seed=0)
    pth, nv = str(tmp / "r3.pth.tar"), str(tmp / "netvlad.tar")
    write_pose_tar(pth)
    write_netvlad_tar(nv, frames)
    return ["--scene", "chess", "--dataset", "7Scenes", "--data-path", raw,
            "--seq-len", "4", "--image-size", "32", "--batch-size", "4",
            "--backbone", "resnet18", "--feat-dim", "32", "--dtype",
            "float32", "--retrieval-hw", *map(str, SERVE_RHW),
            "--netvlad-clusters", "4", "--deterministic", "--weights", pth,
            "--netvlad-checkpoint", nv, "--device", "cpu"]


@pytest.fixture(scope="module")
def both(weights, jax_weights, data, store, serve_argv, tmp_path_factory):
    """(every rank-side case of this module, run once on two gloo ranks;
    the one-process and JAX results they are held against, computed
    meanwhile in this process)."""
    root, db = store
    cases = [("mesh", torch_ranks.mesh_case, {}),
             ("batch", torch_ranks.batch_case, dict(batch=BATCH)),
             ("cached", torch_ranks.cached_eval_case,
              dict(weights=weights["model"],
                   model_kw=dict(MODEL_KW, compact_edges=True), root=root,
                   images=db, **CACHED))]
    for name, cfg in FORMS.items():
        cases.append((name, torch_ranks.service_script,
                      dict(weights=weights, model_kw=MODEL_KW, svc_kw=cfg,
                           data=data, n_data=2,
                           ops=[("build", 0, 16), ("replicate",),
                                ("query", 3), ("query", 4),
                                ("raises", ("query", 0, 0, 7))])))
    cases.append(("cli_serve", torch_ranks.cli_case,
                  dict(name="serve", argv=serve_argv + ["--mesh-data", "2"])))
    cases.append(("replicate_sharded", torch_ranks.service_script,
                  dict(weights=weights, model_kw=MODEL_KW,
                       svc_kw=FORMS["netvlad_det"], data=data, n_data=2,
                       ops=[("build", 0, 8), ("shard",),
                            ("raises", ("replicate",))])))
    pool = torch_ranks.Ranks(2, torch_ranks.run_cases, cases,
                             tmp_path_factory.mktemp("ranks"))
    refs = {name: torch_ranks.to_numpy(torch_ranks.service_script(
                weights, MODEL_KW, cfg, data,
                [("build", 0, 16), ("query", 3), ("query", 4)]))
            for name, cfg in FORMS.items()}
    mvars, _ = jax_weights
    ds = PackedGraphDataset(root)
    model = RelPoseGNN(RelPoseGNNConfig(**dict(MODEL_KW,
                                               compact_edges=True))).eval()
    model.load_state_dict(torch_ranks.torch_state(weights["model"]),
                          strict=True)
    refs["cached"] = serving.evaluate_scene_cached(model, ds, db,
                                                   device="cpu", **CACHED)
    refs["cached_jax"] = jax_serving.evaluate_scene_cached(
        JaxRelPoseGNN(JaxConfig(**dict(MODEL_KW, compact_edges=True))),
        mvars, ds, db, mesh=jax_create_mesh(n_data=2, n_model=1), **CACHED)
    from relpose_gnn_tpu_torch.cli import serve as cli_serve
    refs["cli_serve"] = cli_serve.main(serve_argv)
    return pool.join(), refs


@pytest.fixture(scope="module")
def ranks(both):
    return both[0]


@pytest.fixture(scope="module")
def refs(both):
    return both[1]


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------


def test_create_mesh_shapes(ranks):
    """As the JAX create_mesh over its devices: ("data", "model") axes,
    the data axis absorbing what the model axis leaves, a smaller mesh
    allowed (the ranks past it idle), a larger one refused."""
    jmesh = jax_create_mesh(n_model=2)
    assert jmesh.axis_names == ("data", "model")
    assert jmesh.devices.shape == (4, 2)
    for rank, out in enumerate(ranks):
        m = out["mesh"]
        assert m["default"]["names"] == ("data", "model")
        assert m["default"]["shape"] == (2, 1)
        assert m["default"]["data"] == (2, rank)
        assert m["default"]["model"] == (1, 0)
        assert m["model2"]["shape"] == (1, 2)
        assert m["model2"]["model"] == (2, rank)
        assert m["data2"]["shape"] == (2, 1)
        assert m["data1"]["shape"] == (1, 1)
        assert m["data1"]["in_mesh"] == (rank == 0)
        assert m["single"]["shape"] == (1, 1)
        assert "needs 4 ranks" in m["too_big"]
        assert "do not divide" in m["odd_model"]


def test_one_process_mesh_needs_no_process_group():
    mesh = port_mesh.create_mesh()
    assert isinstance(mesh, port_mesh.LocalMesh)
    assert port_mesh.axis_size(mesh, "data") == 1
    assert port_mesh.axis_group(mesh, "data") is None
    assert sharding.data_shard(mesh) is None
    assert port_mesh.in_mesh(port_mesh.single_device_mesh())
    with pytest.raises(ValueError, match="needs 2 ranks"):
        port_mesh.create_mesh(n_data=2)


def test_shard_batch_matches_the_jax_batch_sharding(ranks):
    """Each rank's rows are what the JAX batch sharding puts on the
    devices of its row of a data=2 mesh."""
    mesh = jax_create_mesh(n_data=2, n_model=1)
    for k, v in BATCH.items():
        arr = jax.device_put(v, jax_sharding.batch_sharding(mesh, v.ndim))
        blocks = {s.index[0].start // 4: np.asarray(s.data)
                  for s in arr.addressable_shards}
        for rank, out in enumerate(ranks):
            np.testing.assert_array_equal(out["batch"][k], blocks[rank])
    assert sharding.batch_rows(port_mesh.create_mesh(), 3) == slice(0, 3)
    assert sharding.batch_rows(_Mesh2(), 4) == slice(0, 2)
    with pytest.raises(ValueError, match="divisible by the data axis"):
        sharding.batch_rows(_Mesh2(), 3)


class _Mesh2(port_mesh.LocalMesh):
    """A stand-in data=2 mesh for the host-side split rules."""

    def size(self, mesh_dim=None):
        return 2 if mesh_dim == 0 else 1


def test_param_sharding_matches_the_jax_specs(jax_weights):
    """Which parameters split, and along which dim, is the JAX
    `_gnn_kernel_spec`'s choice, read through the converter's name map:
    each JAX leaf is marked with its spec, converted, and read back."""
    from torch.distributed.tensor import Replicate, Shard
    mvars, _ = jax_weights
    specs = jax_sharding.param_sharding(jax_create_mesh(n_data=4,
                                                        n_model=2),
                                        mvars["params"])
    code = {P(): 0.0, P(None, "model"): 1.0, P("model", None): 2.0,
            P("model"): 1.0}
    marked = jax.tree.map(lambda leaf, s: np.full(leaf.shape,
                                                  code[s.spec], np.float32),
                          mvars["params"], specs)
    want = state_dict_from_jax(marked, mvars["batch_stats"], STAGES)
    model = RelPoseGNN(RelPoseGNNConfig(**MODEL_KW))
    got = sharding.param_sharding(model)
    split = 0
    for name, placement in got.items():
        assert placement[0] == Replicate(), name
        mark = float(want[name].flatten()[0])
        expect = {0.0: Replicate(), 1.0: Shard(0), 2.0: Shard(1)}[mark]
        assert placement[1] == expect, (name, placement, mark)
        split += mark != 0.0
    # proj_edge's weight; fc1 weight + bias and fc2 weight of three MLPs
    assert split == 1 + 3 * 3
    assert all(p == (Replicate(), Replicate()) for p in
               sharding.param_sharding(model, tensor_parallel=False).values())
    with pytest.raises(ValueError, match="does not split"):
        sharding.param_sharding(model, _Model3())


class _Model3(port_mesh.LocalMesh):
    def size(self, mesh_dim=None):
        return 3 if mesh_dim == 1 else 1


# ---------------------------------------------------------------------------
# the replicated service over two ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(FORMS))
def test_replicate_over_splits_queries_and_equals_one_process(ranks, refs,
                                                              name):
    want = refs[name]
    for out in ranks:
        got = out[name]
        for g, w in zip(got[2:4], want[1:3]):
            np.testing.assert_array_equal(g["neighbors"], w["neighbors"])
            np.testing.assert_array_equal(g["anchor"], w["anchor"])
            np.testing.assert_allclose(g["pose"], w["pose"], rtol=1e-5,
                                       atol=1e-5)
        assert "data axis" in got[4]           # 7 queries over 2 ranks
        assert "is sharded" in out["replicate_sharded"][2]


# ---------------------------------------------------------------------------
# evaluate_scene_cached with a mesh
# ---------------------------------------------------------------------------


def test_evaluate_scene_cached_over_two_ranks(ranks, refs):
    one, want = refs["cached"], refs["cached_jax"]
    for out in ranks:
        got = out["cached"]
        assert got["pred"].shape == (5, 6)
        np.testing.assert_allclose(got["pred"], one["pred"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got["pred"], want["pred"], atol=1e-4)
        np.testing.assert_array_equal(got["target"], want["target"])


def test_cli_serve_over_two_ranks_equals_one_process(ranks, refs):
    """`--mesh-data 2` on ranks whose process group is up: the database
    whole on each, the query batch split, every rank reporting the whole
    scene as one process does."""
    want = refs["cli_serve"]
    for out in ranks:
        got = out["cli_serve"]
        assert got["pred"].shape == want.pred_poses.shape == (4, 7)
        np.testing.assert_allclose(got["pred"], want.pred_poses, rtol=1e-5,
                                   atol=1e-5)
        assert abs(got["median_t"] - want.median_t) < 1e-4
        assert abs(got["median_q"] - want.median_q) < 1e-2
