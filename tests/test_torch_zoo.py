"""The port's model zoo (relpose_gnn_tpu_torch/models/zoo.py, atloc.py,
legacy.py, pair_encoder.py) against the JAX zoo: every name of
`MODEL_NAMES` built by both `build_model`s at a tiny size, the same
weights carried across by `zoo_state_dict_from_jax`, the same numpy
inputs, eval mode, float32 on the CPU.  Also the RelPoseGNN ablations
(`use_gnn=False`, `use_ap=False`), R3-32's compact-edge GNN on 32-node
graphs, the LSTM's seeded initial carry and the space-to-depth stem.

The JAX variables are built as shapes (`jax.eval_shape` of the init) and
filled from a numpy seed: flax's own init of the LSTM's orthogonal
kernels alone takes ~10 s to compile.  The JAX R3-vit builds ViT-B's
widths with no override; both packages' ViTEncoder are swapped for
subclasses at a tiny width (patch 16, dim 32, depth 2, heads 2) there.

Tolerances, with their basis:
  * model outputs: rtol = atol = 5e-5 -- a ResNet18/34 trunk (up to 36
    convolutions with BatchNorm at non-trivial statistics) then GNN
    layers or an LSTM, summed in other orders by XLA and oneDNN; the
    ResNet18 embeddings alone differ by up to 2e-5
    (tests/test_torch_models.py);
  * the space-to-depth stem against the 7x7 stem: rtol = atol = 1e-5, the
    JAX package's bound for the same identity (tests/test_fold_bn.py);
  * weights, state-dict keys, adjacency and the kernel transform: exact.
"""

import functools

import numpy as np
import jax
import pytest
import torch

from relpose_gnn_tpu.models import fold_bn as jax_fold
from relpose_gnn_tpu.models import vit as jax_vit
from relpose_gnn_tpu.models import zoo as jax_zoo
from relpose_gnn_tpu.models.posenet import RelPoseGNN as JaxRelPoseGNN
from relpose_gnn_tpu.models.posenet import RelPoseGNNConfig as JaxConfig
from relpose_gnn_tpu.ops import graph as jax_graph
from relpose_gnn_tpu_torch.evaluation.service import (RelocalizationService,
                                                      ServiceConfig)
from relpose_gnn_tpu_torch.models import posenet as port_posenet
from relpose_gnn_tpu_torch.models import zoo
from relpose_gnn_tpu_torch.models.atloc import FourDirectionalLSTM
from relpose_gnn_tpu_torch.models.convert import (state_dict_from_jax,
                                                  zoo_state_dict_from_jax)
from relpose_gnn_tpu_torch.models.fold_bn import (fold_relpose_backbone,
                                                  space_to_depth_conv1)
from relpose_gnn_tpu_torch.models.posenet import (RelPoseGNN,
                                                  RelPoseGNNConfig,
                                                  init_weights)
from relpose_gnn_tpu_torch.models.vit import ViTEncoder

TOL = dict(rtol=5e-5, atol=5e-5)
S2D_TOL = dict(rtol=1e-5, atol=1e-5)
N, H, W, FEAT = 4, 36, 52, 32
GRAPH = ("R1", "light_knn", "R2", "R3", "R3-vit", "R3-32")
SEQUENCE = ("mapnet", "atloc+")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads while this module runs: the suite runs several
    test processes on one host, and torch's default of one thread a core
    in each of them oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class TinyJaxViT(jax_vit.ViTEncoder):
    dim: int = 32
    depth: int = 2
    heads: int = 2


class TinyPortViT(ViTEncoder):
    def __init__(self, feat_dim=FEAT, patch=16, dim=32, depth=2, heads=2,
                 dtype=None, layer_scale=False, image_hw=(H, W)):
        super().__init__(feat_dim, 16, 32, 2, 2, dtype, layer_scale,
                         image_hw)


@pytest.fixture(autouse=True)
def tiny_vits(monkeypatch):
    monkeypatch.setattr(jax_vit, "ViTEncoder", TinyJaxViT)
    monkeypatch.setattr(port_posenet, "ViTEncoder", TinyPortViT)


def _fill(tree, rng, path=()):
    """Seeded values in the shapes of a flax variables tree: kernels at
    variance 1/fan_in, biases and embeddings small, BN/LayerNorm scales
    and LayerScale gammas near 1, running means near 0, variances near
    1."""
    if hasattr(tree, "items"):
        return {k: _fill(v, rng, path + (k,)) for k, v in tree.items()}
    shape, name = tree.shape, path[-1]
    if name == "kernel":
        fan_in = int(np.prod(shape[:-1]))
        a = rng.normal(size=shape) / np.sqrt(fan_in)
    elif name in ("scale", "var", "ls1", "ls2"):
        a = rng.uniform(0.7, 1.3, shape)
    elif name == "mean":
        a = rng.uniform(-0.3, 0.3, shape)
    else:                                     # biases, cls, pos_embed
        a = 0.1 * rng.normal(size=shape)
    return a.astype(np.float32)


def _kwargs(name: str) -> tuple[dict, dict]:
    """(JAX overrides, the port's) of the tiny size of `name`."""
    if name in GRAPH:
        kw = dict(feat_dim=FEAT, edge_dim=FEAT, node_dim=FEAT, num_nodes=N,
                  knn=2)
        if name == "R3-vit":
            return kw, dict(kw, vit_image_hw=(H, W))
        kw["backbone"] = "resnet18"
        return kw, kw
    if name.startswith("posenetx"):
        kw = dict(stage_sizes=(1, 1, 1, 1), feat_dim=FEAT)
        if name not in ("posenetx", "posenetx2"):
            kw["edge_dim"] = FEAT
        return kw, kw
    return dict(feat_dim=FEAT), dict(feat_dim=FEAT)


def _inputs(name: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    if name in GRAPH or name.startswith("posenetx"):
        n = 32 if name == "R3-32" else N
        images = rng.normal(size=(1, n, H, W, 3)).astype(np.float32)
        adj = rng.random((1, n, n)) < 0.7
        adj[:, np.arange(n), np.arange(n)] = False
        return images, adj
    if name in SEQUENCE:
        return (rng.normal(size=(1, 2, H, W, 3)).astype(np.float32),)
    return (rng.normal(size=(2, H, W, 3)).astype(np.float32),)


@functools.lru_cache(maxsize=None)
def _jax(name: str):
    """The JAX zoo model `name` at the tiny size, its seeded variables
    and its output on `_inputs(name)`."""
    jkw, _ = _kwargs(name)
    model = jax_zoo.build_model(name, **jkw)
    args = _inputs(name)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)
    variables = _fill(shapes, np.random.default_rng(1))
    out = jax.jit(model.apply)(variables, *args)
    return variables, jax.device_get(out)


def _port(name: str):
    _, pkw = _kwargs(name)
    variables, _ = _jax(name)
    model = zoo.build_model(name, device="cpu", **pkw)
    sd = zoo_state_dict_from_jax(name, variables["params"],
                                 variables.get("batch_stats", {}))
    return model, sd


def _close(got, want, tol=TOL):
    if isinstance(want, dict):
        for k in want:
            _close(got[k], want[k], tol)
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, tol)
    elif want is None:
        assert got is None
    else:
        got = got.numpy()
        assert got.shape == np.shape(want)
        if got.dtype == bool:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, np.asarray(want), **tol)


@pytest.mark.parametrize("name", zoo.MODEL_NAMES)
def test_zoo_model_matches_jax(name):
    model, sd = _port(name)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    args = _inputs(name)
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in args))
    _, want = _jax(name)
    if name in GRAPH:    # aux: the pre- and post-GNN node states
        _close(got, want)
    elif isinstance(want, tuple) and len(want) == 4:
        _close(got[:3], want[:3])
        _close(got[3]["node_feats"], want[3]["node_feats"])
    else:
        _close(got, want)


def test_zoo_names_equal_jax_and_unknown_names_raise():
    assert zoo.MODEL_NAMES == jax_zoo.MODEL_NAMES
    for build in (jax_zoo.build_model,
                  functools.partial(zoo.build_model, device="cpu")):
        with pytest.raises(ValueError, match="nope"):
            build("nope")


@pytest.mark.parametrize("ablation", [dict(use_gnn=False),
                                      dict(use_ap=False),
                                      dict(use_gnn=False, use_ap=False),
                                      dict(use_gnn=False,
                                           compact_edges=True)])
def test_relpose_gnn_ablations_match_jax(ablation):
    """use_gnn=False: an MLP on the projected edges (`mlp`); use_ap=False:
    the absolute heads on pair features, pred_abs [B, N, N, 6]."""
    kw = dict(num_nodes=N, feat_dim=FEAT, edge_dim=FEAT, node_dim=FEAT,
              knn=2, backbone="resnet18", droprate=0.0, **ablation)
    images, adj = _inputs("R3", 2)
    jmodel = JaxRelPoseGNN(JaxConfig(**kw))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), images, adj)
    v = _fill(shapes, np.random.default_rng(3))
    want = jax.jit(jmodel.apply)(v, images, adj)
    model = RelPoseGNN(RelPoseGNNConfig(**kw)).eval()
    model.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"],
                                              (2, 2, 2, 2)), strict=True)
    assert ("mlp.0.weight" in model.state_dict()) == (not model.cfg.use_gnn)
    with torch.no_grad():
        got = model(torch.from_numpy(images), torch.from_numpy(adj))
    _close(got[:3], want[:3])
    shape = (1, N, N, 6) if not model.cfg.use_ap else (1, N, 6)
    assert got[0].shape == shape


def test_r3_32_compact_from_embeddings_matches_jax():
    """R3-32's GNN at N = 32 on the compact kNN-4 edge list (E = 128 a
    graph: the attention core's rows)."""
    kw = dict(feat_dim=FEAT, edge_dim=FEAT, node_dim=FEAT,
              compact_edges=True, droprate=0.0)
    jmodel = JaxRelPoseGNN(JaxConfig.preset("R3-32", backbone="resnet18",
                                            **kw))
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 32, FEAT)).astype(np.float32)
    adj = np.ones((2, 32, 32), bool)
    embed = functools.partial(jmodel.apply,
                              method=JaxRelPoseGNN.from_embeddings)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            np.zeros((1, 32, H, W, 3), np.float32), adj[:1])
    v = _fill(shapes, rng)
    want = jax.jit(embed)(v, x, adj)
    model = RelPoseGNN(RelPoseGNNConfig.preset(
        "R3-32", backbone="resnet18", **kw)).eval()
    assert model.cfg.num_nodes == 32 and model.cfg.knn == 4
    model.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"],
                                              (2, 2, 2, 2)), strict=True)
    with torch.no_grad():
        got = model.from_embeddings(torch.from_numpy(x), torch.from_numpy(adj))
    _close(got[:3], want[:3])
    assert int(got[2].sum()) == 2 * 32 * 4


def test_lstm_random_carry_is_seeded():
    """random_init draws the carry from the generator the caller passes:
    the same seed gives the same output, another seed another; without a
    generator it raises.  The zero carry (the JAX default, held by
    `atloc-lstm` above) needs none."""
    lstm = FourDirectionalLSTM(seq_size=4, origin_feat_size=16,
                               hidden_size=8, random_init=True)
    init_weights(lstm, torch.Generator().manual_seed(0))
    x = torch.randn(3, 16, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a, b, c = (lstm(x, torch.Generator().manual_seed(s))
                   for s in (7, 7, 8))
    assert a.shape == (3, 32)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="Generator"):
        lstm(x)


def test_space_to_depth_kernel_matches_jax():
    w = np.random.default_rng(5).normal(size=(64, 3, 7, 7)).astype(
        np.float32)
    want = jax_fold.space_to_depth_conv1(
        {"kernel": w.transpose(2, 3, 1, 0)})["kernel"]
    got = space_to_depth_conv1(torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).transpose(3, 2, 0, 1))


@pytest.mark.parametrize("hw", [(36, 52), (35, 51)])
def test_s2d_stem_equals_the_7x7_stem(hw):
    """The folded trunk with the space-to-depth stem against the 7x7 one
    (even and odd extents), and the service's `s2d_stem` knob."""
    cfg = RelPoseGNNConfig(num_nodes=N, feat_dim=FEAT, edge_dim=FEAT,
                           node_dim=FEAT, knn=2, backbone="resnet18",
                           droprate=0.0)
    model = RelPoseGNN(cfg).eval()
    gen = torch.Generator().manual_seed(6)
    init_weights(model, gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.3, 0.3, generator=gen)
                m.running_var.uniform_(0.7, 1.3, generator=gen)
    _, plain = fold_relpose_backbone(model)
    _, s2d = fold_relpose_backbone(model, s2d_stem=True)
    assert s2d.cfg.s2d_stem and tuple(
        s2d.feature_extractor.conv1.weight.shape) == (64, 12, 4, 4)
    images = torch.rand(2, N, *hw, 3, generator=gen)
    with torch.no_grad():
        want = plain.encode_nodes(images)
        got = s2d.encode_nodes(images)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **S2D_TOL)
    svc = RelocalizationService(model, None,
                                ServiceConfig(seq_len=N,
                                              retrieval="shared-trunk"),
                                s2d_stem=True, device="cpu")
    assert svc.model.cfg.s2d_stem and svc.model.cfg.bn_folded
    with torch.no_grad():
        np.testing.assert_allclose(svc.model.encode_nodes(images).numpy(),
                                   want.numpy(), **S2D_TOL)


def test_graph_contract_of_the_jax_zoo():
    """PoseNetXOX's "absolute" output is its relative one at the first N
    construction-order edges, in both packages."""
    model, sd = _port("posenetxox")
    model.load_state_dict(sd, strict=True)
    images, adj = _inputs("posenetxox")
    with torch.no_grad():
        pa, pr, _, _ = model(torch.from_numpy(images), torch.from_numpy(adj))
    ei = jax_graph.fc_edge_index(N)[:, :N]
    assert torch.equal(pa[0], pr[0, ei[0], ei[1]])
