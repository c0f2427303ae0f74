"""The port's `cli.serve` against the JAX package's `cli/serve.py`: both in
float32 with `--deterministic`, on raw 7-Scenes fixtures (60x80 PNGs,
served at 32x43) with one `.pth.tar` (R3 at resnet18, feat_dim 32, 4-node
graphs) and one NetVLAD `.tar` (VGG16 + 4 clusters, retrieval at 24x32),
batch 3 over 4 queries, so the ragged tail pads and trims.  One scene
through `RelocalizationService`, and two through `MultiSceneService`.

The fixture has wide similarity gaps (the frames of
tests/test_torch_cli_build_graphs.py, NetVLAD centroids drawn from their
own VGG features).  Every query batch's neighbours and anchors are
recorded from each service's `query_stream` and held exact; poses to atol
1e-4, as tests/test_torch_service.py holds the services; the median errors
to 1e-4 m and 1e-2 degrees.  The JAX CLI's `.pth.tar` loader assumes
resnet34's stage sizes and its state init runs eagerly: the test passes
resnet18's stages and a jitted init (the same values).
"""

import functools
import os.path as osp
import sys

import jax
import numpy as np
import pytest
import torch

from relpose_gnn_tpu.evaluation import multiscene as jax_multiscene
from relpose_gnn_tpu.evaluation import service as jax_service
from relpose_gnn_tpu.training import checkpoints as jax_ckpt
from relpose_gnn_tpu.training import trainer as jax_trainer
from relpose_gnn_tpu_torch.cli import serve as port_cli
from relpose_gnn_tpu_torch.data.image_io import decode_png
from relpose_gnn_tpu_torch.evaluation import multiscene as port_multiscene
from relpose_gnn_tpu_torch.evaluation import service as port_service
from relpose_gnn_tpu_torch.models.posenet import (RelPoseGNN,
                                                  RelPoseGNNConfig,
                                                  init_weights)
from relpose_gnn_tpu_torch.retrieval import netvlad_index as port_index
from test_torch_cli_build_graphs import write_raw_scene

sys.path.insert(0, osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                            "cli"))
import serve as jax_cli  # noqa: E402  (cli/serve.py)

RHW = (24, 32)
POSE_ATOL = 1e-4
SCENES = ("chess", "fire")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def write_pose_tar(path):
    """R3 at resnet18 / feat_dim 32 / 4 nodes, seeded weights and random
    BatchNorm statistics, in the reference `.pth.tar` layout."""
    model = RelPoseGNN(RelPoseGNNConfig.preset(
        "R3", num_nodes=4, knn=2, droprate=0.0, backbone="resnet18",
        feat_dim=32, edge_dim=32, node_dim=32))
    gen = torch.Generator().manual_seed(3)
    init_weights(model, gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1, generator=gen)
                m.running_var.uniform_(0.8, 1.2, generator=gen)
    torch.save({"epoch": 0, "model_state_dict": model.state_dict()}, path)


def write_netvlad_tar(path, frame_paths):
    """VGG16 + 4 clusters whose centroids and assignment weights are the
    frames' own VGG features at the retrieval size."""
    enc = port_index.seeded_encoder(4, 512, None, seed=5)
    with torch.no_grad():
        x = torch.as_tensor(np.stack([
            port_index.netvlad_preprocess_7scenes(_frame01(p), out_hw=RHW)
            for p in frame_paths]))
        feat = enc.encoder(x).reshape(-1, 512)
        feat = feat / feat.norm(dim=1, keepdim=True).clamp_min(1e-12)
        cent = feat[torch.randperm(
            len(feat), generator=torch.Generator().manual_seed(9))[:4]]
        enc.pool.centroids.copy_(cent)
        enc.pool.conv.weight.copy_(30.0 * cent[:, :, None, None])
    torch.save({"state_dict": enc.state_dict()}, path)


def _frame01(path):
    return decode_png(path).astype(np.float32) / 255.0


def _recording(method, sink):
    """`query_stream` that also appends each batch's result, as numpy, to
    the list `sink[0]`."""
    @functools.wraps(method)
    def wrapped(self, *args, **kwargs):
        for out in method(self, *args, **kwargs):
            sink[0].append({k: np.asarray(v) for k, v in out.items()})
            yield out
    return wrapped


def _jitted_state(create):
    """The JAX create_train_state with its model init jitted."""
    def fast(rng, model, cfg, images, adj, variables=None):
        if variables is None:
            variables = jax.jit(lambda k: model.init(
                {"params": k, "dropout": k}, images, adj,
                train=False))(rng)
        return create(rng, model, cfg, images, adj, variables)
    return fast


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Both CLIs, one scene and two; returns {(which, cli): (result,
    recorded batches, npz paths)}."""
    tmp = tmp_path_factory.mktemp("serve")
    raw = str(tmp / "raw")
    frames = []
    for k, scene in enumerate(SCENES):
        frames += write_raw_scene(raw, scene, seed=k)
    pth, nv = str(tmp / "r3.pth.tar"), str(tmp / "netvlad.tar")
    write_pose_tar(pth)
    write_netvlad_tar(nv, frames)
    common = ["--dataset", "7Scenes", "--data-path", raw, "--seq-len", "4",
              "--image-size", "32", "--batch-size", "3", "--backbone",
              "resnet18", "--feat-dim", "32", "--dtype", "float32",
              "--retrieval-hw", *map(str, RHW), "--netvlad-clusters", "4",
              "--deterministic", "--weights", pth,
              "--netvlad-checkpoint", nv]
    runs = {}
    sink = [None]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_ckpt, "load_torch_weights", functools.partial(
            jax_ckpt.load_torch_weights, stage_sizes=(2, 2, 2, 2)))
        mp.setattr(jax_trainer, "create_train_state",
                   _jitted_state(jax_trainer.create_train_state))
        for cls in (jax_service.RelocalizationService,
                    jax_multiscene.MultiSceneService,
                    port_service.RelocalizationService,
                    port_multiscene.MultiSceneService):
            mp.setattr(cls, "query_stream",
                       _recording(cls.query_stream, sink))
        for which, scenes in (("one", SCENES[:1]), ("two", SCENES)):
            for name, mod, extra in (("jax", jax_cli, []),
                                     ("port", port_cli,
                                      ["--device", "cpu"])):
                sink[0] = []
                out = str(tmp / f"{which}_{name}.npz")
                result = mod.main(["--scene", *scenes, *common, "--out",
                                   out, *extra])
                npz = ([out] if which == "one" else
                       [out.replace(".npz", f"_{s}.npz") for s in scenes])
                runs[(which, name)] = (result, sink[0], npz)
    return runs


@pytest.mark.parametrize("which", ["one", "two"])
def test_neighbours_anchors_and_poses_match_jax(served, which):
    _, want, _ = served[(which, "jax")]
    _, got, _ = served[(which, "port")]
    # 4 queries in batches of 3: two batches a scene
    assert len(got) == len(want) == 2 * (1 if which == "one" else 2)
    for g, w in zip(got, want):
        assert g["pose"].shape == (3, 6) and g["neighbors"].shape == (3, 3)
        np.testing.assert_array_equal(g["neighbors"], w["neighbors"])
        np.testing.assert_array_equal(g["anchor"], w["anchor"])
        np.testing.assert_allclose(g["pose"], w["pose"], atol=POSE_ATOL)


@pytest.mark.parametrize("which", ["one", "two"])
def test_exports_trim_to_the_real_query_count(served, which):
    for jz, pz in zip(served[(which, "jax")][2], served[(which, "port")][2]):
        want, got = np.load(jz), np.load(pz)
        assert sorted(got.files) == sorted(want.files)
        assert got["pose6"].shape == want["pose6"].shape == (4, 6)
        for k in want.files:
            np.testing.assert_allclose(got[k], want[k], atol=POSE_ATOL)
        np.testing.assert_allclose(np.linalg.norm(got["abs_q"], axis=1),
                                   1.0, atol=1e-5)


@pytest.mark.parametrize("which", ["one", "two"])
def test_medians_match_jax(served, which):
    want = served[(which, "jax")][0]
    got = served[(which, "port")][0]
    if which == "one":
        want, got = {"chess": want}, {"chess": got}
    assert sorted(got) == sorted(want)
    for s in want:
        assert np.isfinite(got[s].median_t) and np.isfinite(got[s].median_q)
        assert abs(got[s].median_t - want[s].median_t) < 1e-4
        assert abs(got[s].median_q - want[s].median_q) < 1e-2


# the multi-process flags run; what they cannot run is refused with a
# ValueError (or SystemExit) before anything runs
@pytest.mark.parametrize("flag,error,match", [
    pytest.param(["--mesh-data", "2"], ValueError, "needs 2 ranks",
                 id="mesh-over-world"),
    pytest.param(["--coordinator", "localhost:1234", "--num-processes",
                  "2", "--process-id", "5"], ValueError, "outside",
                 id="process-id-outside"),
    pytest.param(["--num-processes", "2"], ValueError, "coordinator",
                 id="no-coordinator"),
    pytest.param(["--local-device-count", "2"], ValueError,
                 "launch 2 processes", id="local-device-count"),
    pytest.param(["--mesh-data", "2", "--batch-size", "3"], ValueError,
                 "must divide", id="batch-over-mesh"),
    pytest.param(["--mesh-data", "1", "--scene", "chess", "fire"], SystemExit,
                 "ONE scene", id="mesh-several-scenes"),
])
def test_unported_flags_are_refused(tmp_path, flag, error, match):
    with pytest.raises(error, match=match):
        port_cli.main(["--scene", "chess", "--data-path", str(tmp_path),
                       "--device", "cpu", *flag])
