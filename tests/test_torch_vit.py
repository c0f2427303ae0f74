"""The port's ViT node encoder (relpose_gnn_tpu_torch/models/vit.py), its
weight conversion and warm start, and the R3-vit model, against the JAX
package: the same weights (carried across by `vit_state_dict_from_jax` /
`state_dict_from_jax`), the same numpy inputs, float32 on the CPU.

Tolerances, with their basis:
  * ViTEncoder and R3-vit outputs: rtol = atol = 1e-5 -- two blocks of
    float32 matmuls, softmax and LayerNorm summed in other orders by XLA
    and oneDNN; the JAX LayerNorm takes its variance as E[x^2] - E[x]^2,
    so the tests make it take the two-pass one, as the port does;
  * `interpolate_pos_embed`: rtol = atol = 1e-6 -- the same float32
    weights, contracted in float64 and rounded once by the port, in one
    float32 einsum by jax (measured up to 2.5e-7 of the largest value);
  * converted weights, state-dict keys and the warm start: exact.

The tiny ViT (patch 16, dim 32, depth 2, heads 2) takes 37x53 inputs, so
the remainder crop runs (a 2x3 patch grid).  Both packages' RelPoseGNN
build their encoder with ViT-B's widths and no way to override them; the
R3-vit tests swap in subclasses of the two ViTEncoders with the tiny
widths.
"""

import functools

import numpy as np
import jax
import pytest
import torch

from relpose_gnn_tpu.models import convert as jax_convert
from relpose_gnn_tpu.models import vit as jax_vit
from relpose_gnn_tpu.models.posenet import RelPoseGNN as JaxRelPoseGNN
from relpose_gnn_tpu.models.posenet import RelPoseGNNConfig as JaxConfig
from relpose_gnn_tpu.training import checkpoints as jax_ckpt
from relpose_gnn_tpu_torch.models import posenet as port_posenet
from relpose_gnn_tpu_torch.models.convert import (convert_vit,
                                                  interpolate_pos_embed,
                                                  state_dict_from_jax,
                                                  vit_state_dict_from_jax)
from relpose_gnn_tpu_torch.models.posenet import (RelPoseGNN,
                                                  RelPoseGNNConfig,
                                                  init_weights)
from relpose_gnn_tpu_torch.models.vit import ViTEncoder
from relpose_gnn_tpu_torch.training import checkpoints as ckpt
from relpose_gnn_tpu_torch.training.trainer import (TrainerConfig,
                                                    create_train_state)

TOL = dict(rtol=1e-5, atol=1e-5)
POS_TOL = dict(rtol=1e-6, atol=1e-6)
PATCH, DIM, DEPTH, HEADS, FEAT = 16, 32, 2, 2, 16
H, W = 37, 53                      # cropped to a 2x3 grid of 16x16 patches
GRID = (H // PATCH, W // PATCH)
N = 4


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads while this module runs: the suite runs several
    test processes on one host, and torch's default of one thread a core
    in each of them oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def flax_two_pass_variance(monkeypatch):
    """flax's LayerNorm takes the variance as E[x^2] - E[x]^2; the port
    (torch) the two-pass one.  Here flax takes it the two-pass way too."""
    import flax.linen.normalization as flax_norm
    orig = flax_norm._compute_stats
    monkeypatch.setattr(flax_norm, "_compute_stats", lambda *a, **k: orig(
        *a, **dict(k, use_fast_variance=False)))


def _np_tree(tree):
    if hasattr(tree, "items"):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.array(tree)


def _perturb(tree, rng, scale=0.05):
    """Non-trivial values everywhere (flax's init leaves the CLS token at
    zero and the LayerScale gammas at one: those legs of a parity would be
    vacuous)."""
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, scale) for k, v in tree.items()}
    return (tree + scale * rng.normal(size=tree.shape)).astype(np.float32)


class TinyJaxViT(jax_vit.ViTEncoder):
    """The JAX ViTEncoder at the tiny widths (R3-vit has no override)."""

    dim: int = DIM
    depth: int = DEPTH
    heads: int = HEADS


class TinyPortViT(ViTEncoder):
    """The port's ViTEncoder at the tiny widths, for the RelPoseGNN that
    builds it with ViT-B's (`models/posenet.py::make_backbone`)."""

    def __init__(self, feat_dim=FEAT, patch=PATCH, dim=DIM, depth=DEPTH,
                 heads=HEADS, dtype=None, layer_scale=False,
                 image_hw=(H, W)):
        super().__init__(feat_dim, PATCH, DIM, DEPTH, HEADS, dtype,
                         layer_scale, image_hw)


@pytest.fixture
def tiny_vits(monkeypatch):
    """Both packages' RelPoseGNN build the tiny ViT."""
    monkeypatch.setattr(jax_vit, "ViTEncoder", TinyJaxViT)
    monkeypatch.setattr(port_posenet, "ViTEncoder", TinyPortViT)


def _tiny_port_vit(layer_scale=False):
    return TinyPortViT(layer_scale=layer_scale)


@functools.lru_cache(maxsize=None)
def _jax_vit(layer_scale, seed=0):
    """The JAX tiny ViTEncoder, its jitted apply and perturbed params."""
    m = jax_vit.ViTEncoder(feat_dim=FEAT, patch=PATCH, dim=DIM, depth=DEPTH,
                           heads=HEADS, layer_scale=layer_scale)
    x = np.zeros((1, H, W, 3), np.float32)
    params = jax.jit(m.init)(jax.random.PRNGKey(seed), x)["params"]
    return (jax.jit(m.apply),
            _perturb(_np_tree(params), np.random.default_rng(seed)))


def _jax_vit_params(layer_scale):
    return _jax_vit(layer_scale)[1]


@pytest.mark.parametrize("layer_scale", [False, True])
def test_vit_encoder_matches_jax(layer_scale):
    apply, params = _jax_vit(layer_scale)
    x = np.random.default_rng(1).normal(size=(3, H, W, 3)).astype(np.float32)
    want = np.asarray(apply({"params": params}, x))
    port = _tiny_port_vit(layer_scale)
    port.load_state_dict(vit_state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (3, FEAT)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_vit_encoder_refuses_another_grid():
    port = _tiny_port_vit()
    with pytest.raises(ValueError, match="image_hw"):
        port(torch.zeros(1, 64, 48, 3))


@pytest.mark.parametrize("old_hw,new_hw", [((14, 14), (16, 21)),
                                           ((16, 21), (8, 10)),
                                           ((3, 3), (3, 5))])
def test_interpolate_pos_embed_matches_jax(old_hw, new_hw):
    rng = np.random.default_rng(2)
    pos = rng.normal(size=(1, old_hw[0] * old_hw[1] + 1, 24)).astype(
        np.float32)
    kw = {} if old_hw[0] == old_hw[1] else dict(old_hw=old_hw)
    want = jax_convert.interpolate_pos_embed(pos, new_hw, **kw)
    got = interpolate_pos_embed(pos, new_hw, **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **POS_TOL)
    np.testing.assert_array_equal(got[:, 0].numpy(), pos[:, 0])


def test_interpolate_pos_embed_same_size_and_refusals():
    pos = np.random.default_rng(3).normal(size=(1, 10, 8)).astype(np.float32)
    np.testing.assert_array_equal(interpolate_pos_embed(pos, (3, 3)).numpy(),
                                  pos)
    rect = pos[:, :7]                       # 6 patch slots: not square
    for fn in (jax_convert.interpolate_pos_embed, interpolate_pos_embed):
        with pytest.raises(ValueError, match="not square"):
            fn(rect, (2, 3))


def _timm_state_dict(layer_scale=False, grid=(2, 2), seed=4):
    """A seeded timm/DINOv2-layout ViT state dict (numpy), at `grid`."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return (0.1 * rng.normal(size=shape)).astype(np.float32)

    sd = {"cls_token": r(1, 1, DIM),
          "pos_embed": r(1, grid[0] * grid[1] + 1, DIM),
          "patch_embed.proj.weight": r(DIM, 3, PATCH, PATCH),
          "patch_embed.proj.bias": r(DIM),
          "norm.weight": 1 + r(DIM), "norm.bias": r(DIM)}
    for i in range(DEPTH):
        p = f"blocks.{i}"
        sd.update({f"{p}.norm1.weight": 1 + r(DIM), f"{p}.norm1.bias": r(DIM),
                   f"{p}.attn.qkv.weight": r(3 * DIM, DIM),
                   f"{p}.attn.qkv.bias": r(3 * DIM),
                   f"{p}.attn.proj.weight": r(DIM, DIM),
                   f"{p}.attn.proj.bias": r(DIM),
                   f"{p}.norm2.weight": 1 + r(DIM), f"{p}.norm2.bias": r(DIM),
                   f"{p}.mlp.fc1.weight": r(4 * DIM, DIM),
                   f"{p}.mlp.fc1.bias": r(4 * DIM),
                   f"{p}.mlp.fc2.weight": r(DIM, 4 * DIM),
                   f"{p}.mlp.fc2.bias": r(DIM)})
        if layer_scale:
            sd[f"{p}.ls1.gamma"] = 1 + r(DIM)
            sd[f"{p}.ls2.gamma"] = 1 + r(DIM)
    return sd


@pytest.mark.parametrize("layer_scale", [False, True])
def test_convert_vit_matches_jax_converter(layer_scale):
    """The port's converter gives the numbers the JAX converter gives,
    in the port's layout (fc aside: neither produces it)."""
    sd = _timm_state_dict(layer_scale)
    jparams, jls = jax_convert.convert_vit(sd, heads=HEADS, grid_hw=GRID)
    got, ls = convert_vit(sd, heads=HEADS, grid_hw=GRID)
    assert ls == jls == layer_scale
    zero_fc = {"kernel": np.zeros((DIM, FEAT), np.float32),
               "bias": np.zeros(FEAT, np.float32)}
    want = vit_state_dict_from_jax(dict(jparams, fc=zero_fc))
    assert sorted(got) == sorted(k for k in want if not k.startswith("fc."))
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                   err_msg=k, **POS_TOL)
        if k != "pos_embed":      # everything but the resize is a copy
            np.testing.assert_array_equal(v.numpy(), want[k].numpy(),
                                          err_msg=k)


def test_convert_vit_refuses_unconsumed_keys_like_jax():
    sd = _timm_state_dict()
    sd["blocks.0.attn.q_norm.weight"] = np.ones(DIM, np.float32)
    for fn in (jax_convert.convert_vit, convert_vit):
        with pytest.raises(ValueError, match="unconsumed"):
            fn(sd, heads=HEADS)


class _JaxState:
    """What the JAX load_vit_weights reads of a train state."""

    def __init__(self, params):
        self.params = params

    def replace(self, params):
        return _JaxState(params)


def _port_state(layer_scale=False):
    cfg = RelPoseGNNConfig(num_nodes=N, feat_dim=FEAT, edge_dim=FEAT,
                           node_dim=FEAT, knn=2, backbone="vit",
                           droprate=0.0, vit_layer_scale=layer_scale,
                           vit_image_hw=(H, W))
    model = RelPoseGNN(cfg)
    init_weights(model, torch.Generator().manual_seed(0))
    return create_train_state(model, TrainerConfig())


def _save(tmp_path, sd, name="vit.pth"):
    path = str(tmp_path / name)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return path


@pytest.mark.parametrize("layer_scale", [False, True])
def test_load_vit_weights_matches_jax(tmp_path, layer_scale, tiny_vits):
    """A 2x2-grid (square, "pretraining") table loads at the model's 2x3
    grid: every encoder tensor but `fc` takes the checkpoint's values, the
    ones the JAX warm start gives; `fc` stays as it was."""
    sd = _timm_state_dict(layer_scale)
    path = _save(tmp_path, sd)
    state = _port_state(layer_scale)
    before = {k: v.clone() for k, v in state.model.encoder.state_dict()
              .items()}
    ckpt.load_vit_weights(state, path, heads=HEADS, grid_hw=GRID)
    after = state.model.encoder.state_dict()

    jparams = _jax_vit_params(layer_scale)
    jstate = jax_ckpt.load_vit_weights(
        _JaxState({"model": {"encoder": jparams}}), path, heads=HEADS,
        grid_hw=GRID)
    want = vit_state_dict_from_jax(jstate.params["model"]["encoder"])
    assert sorted(after) == sorted(want)
    for k, v in after.items():
        if k.startswith("fc."):
            assert torch.equal(v, before[k]), k
        else:
            assert not torch.equal(v, before[k]), k
            np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                       err_msg=k, **POS_TOL)


def test_load_vit_weights_raises_where_jax_raises(tmp_path, tiny_vits):
    jplain = _jax_vit_params(False)
    jls = _jax_vit_params(True)
    cases = [
        # LayerScale gammas in the file, a model built without them
        (_timm_state_dict(layer_scale=True), False, jplain, GRID,
         "LayerScale"),
        # a model with LayerScale, a file without: gammas left uncovered
        (_timm_state_dict(), True, jls, GRID, "does not cover"),
        # a square table at the model's 2x3 grid without grid_hw
        (_timm_state_dict(), False, jplain, None, "grid_hw"),
    ]
    for i, (sd, model_ls, jparams, grid, match) in enumerate(cases):
        path = _save(tmp_path, sd, f"case{i}.pth")
        with pytest.raises(ValueError, match=match):
            jax_ckpt.load_vit_weights(
                _JaxState({"model": {"encoder": jparams}}), path,
                heads=HEADS, grid_hw=grid)
        with pytest.raises(ValueError, match=match):
            ckpt.load_vit_weights(_port_state(model_ls), path, heads=HEADS,
                                  grid_hw=grid)


@pytest.fixture(scope="module")
def r3_vit():
    """A tiny JAX R3-vit (knn 2 over 4-node graphs), its jitted apply and
    numpy params; the same weights in the port's model."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_vit, "ViTEncoder", TinyJaxViT)
    mp.setattr(port_posenet, "ViTEncoder", TinyPortViT)
    rng = np.random.default_rng(5)
    images = rng.normal(size=(2, N, H, W, 3)).astype(np.float32)
    adj = np.broadcast_to(~np.eye(N, dtype=bool), (2, N, N))
    cfg = JaxConfig.preset("R3-vit", num_nodes=N, feat_dim=FEAT,
                           edge_dim=FEAT, node_dim=FEAT, knn=2, droprate=0.0)
    jmodel = JaxRelPoseGNN(cfg)
    variables = jax.jit(lambda k: jmodel.init(k, images, adj))(
        jax.random.PRNGKey(0))
    params = _perturb(_np_tree(variables["params"]), rng, 0.02)
    model = RelPoseGNN(RelPoseGNNConfig.preset(
        "R3-vit", num_nodes=N, feat_dim=FEAT, edge_dim=FEAT, node_dim=FEAT,
        knn=2, droprate=0.0, vit_image_hw=(H, W))).eval()
    model.load_state_dict(state_dict_from_jax(params, {}, ()), strict=True)
    apply = jax.jit(jmodel.apply)
    embed = jax.jit(functools.partial(
        jmodel.apply, method=JaxRelPoseGNN.from_embeddings))
    yield apply, embed, params, model, images, adj
    mp.undo()


def test_r3_vit_keys_are_timm_names_under_encoder(r3_vit):
    _, _, params, model, _, _ = r3_vit
    keys = set(state_dict_from_jax(params, {}, ()))
    assert keys == set(model.state_dict())
    assert "encoder.blocks.1.attn.qkv.weight" in keys
    assert not any(k.startswith("feature_extractor.") for k in keys)


def test_r3_vit_forward_matches_jax(r3_vit):
    apply, _, params, model, images, adj = r3_vit
    want = apply({"params": params}, images, adj)
    with torch.no_grad():
        got = model(torch.from_numpy(images), torch.from_numpy(adj.copy()))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    np.testing.assert_allclose(got[3]["node_feats"].numpy(),
                               np.asarray(want[3]["node_feats"]), **TOL)


def test_r3_vit_from_embeddings_matches_jax(r3_vit):
    _, embed, params, model, _, adj = r3_vit
    x = np.random.default_rng(6).normal(size=(2, N, FEAT)).astype(np.float32)
    want = embed({"params": params}, x, adj)
    with torch.no_grad():
        got = model.from_embeddings(torch.from_numpy(x),
                                    torch.from_numpy(adj.copy()))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
