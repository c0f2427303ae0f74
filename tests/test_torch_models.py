"""Port models (relpose_gnn_tpu_torch/models) against the JAX models, with
the same weights (carried over by `state_dict_from_jax`) and the same numpy
inputs, in float32.

Tolerances, with their basis:
  * weights and state-dict keys: exact;
  * ResNet18 embeddings (unfolded and BN-folded): rtol = atol = 2e-5 --
    twenty convolutions summed in other orders by XLA and oneDNN; the
    measured difference is 1.5e-6 on embeddings of magnitude up to 1.5;
  * PairMLP2 / DenseEdgeGNN / from_embeddings: rtol = atol = 1e-5 -- a
    few float32 matmuls; kNN adjacency and edge lists exactly equal.
"""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from relpose_gnn_tpu.models import convert as jax_convert
from relpose_gnn_tpu.models import fold_bn as jax_fold
from relpose_gnn_tpu.models.gnn import DenseEdgeGNN as JaxDenseEdgeGNN
from relpose_gnn_tpu.models.gnn import PairMLP2 as JaxPairMLP2
from relpose_gnn_tpu.models.posenet import RelPoseGNN as JaxRelPoseGNN
from relpose_gnn_tpu.models.posenet import RelPoseGNNConfig as JaxConfig
from relpose_gnn_tpu.ops import graph as jg
from relpose_gnn_tpu_torch.models.convert import state_dict_from_jax
from relpose_gnn_tpu_torch.models.fold_bn import fold_relpose_backbone
from relpose_gnn_tpu_torch.models.gnn import PairMLP2
from relpose_gnn_tpu_torch.models.posenet import (RelPoseGNN, RelPoseGNNConfig,
                                                  init_weights)

STAGES = (2, 2, 2, 2)
N, D, H, W = 4, 32, 32, 40
RESNET_TOL = dict(rtol=2e-5, atol=2e-5)
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfg_kwargs(**kw):
    base = dict(num_nodes=N, feat_dim=D, edge_dim=D, node_dim=D, knn=2,
                backbone="resnet18", droprate=0.0)
    base.update(kw)
    return base


def _to_numpy_tree(tree):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _to_numpy_tree(v) for k, v in tree.items()}
    return np.array(tree)


def _randomize_bn(params, stats, rng):
    """Non-trivial BN (as tests/test_full_model_parity.py does), so an
    unfolded/folded mix-up cannot pass."""
    for k, v in params.items():
        if isinstance(v, dict) and "scale" in v:
            v["scale"] = rng.uniform(0.5, 1.5, v["scale"].shape).astype(
                np.float32)
            v["bias"] = rng.normal(0, 0.1, v["bias"].shape).astype(
                np.float32)
            stats[k]["mean"] = rng.uniform(-0.3, 0.3, stats[k]["mean"].shape
                                           ).astype(np.float32)
            stats[k]["var"] = rng.uniform(0.7, 1.3, stats[k]["var"].shape
                                          ).astype(np.float32)
        elif isinstance(v, dict):
            _randomize_bn(v, stats.get(k, {}), rng)


@pytest.fixture(scope="module")
def jax_variables():
    """A small JAX RelPoseGNN: numpy (params, batch_stats) + images."""
    rng = np.random.default_rng(0)
    images = rng.random((2, N, H, W, 3)).astype(np.float32)
    adj = np.broadcast_to(~np.eye(N, dtype=bool), (2, N, N))
    model = JaxRelPoseGNN(JaxConfig(**_cfg_kwargs()))
    variables = jax.jit(lambda k: model.init(k, images, adj))(
        jax.random.PRNGKey(0))
    variables = _to_numpy_tree(jax.device_get(variables))
    params, stats = variables["params"], variables["batch_stats"]
    _randomize_bn(params["encoder"], stats["encoder"], rng)
    return params, stats, images


def _port_model(params, stats, **kw):
    model = RelPoseGNN(RelPoseGNNConfig(**_cfg_kwargs(**kw))).eval()
    model.load_state_dict(state_dict_from_jax(params, stats, STAGES),
                          strict=True)
    return model


def test_state_dict_from_jax_matches_exporter_key_for_key(jax_variables):
    params, stats, _ = jax_variables
    want = jax_convert.export_relpose_gnn(params, stats, STAGES)
    got = state_dict_from_jax(params, stats, STAGES)
    assert list(got) == list(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    # and the port takes it whole
    model = RelPoseGNN(RelPoseGNNConfig(**_cfg_kwargs()))
    model.load_state_dict(got, strict=True)


def test_state_dict_from_jax_refuses_unknown_subtrees(jax_variables):
    params, stats, _ = jax_variables
    with pytest.raises(ValueError, match="vit_encoder"):
        state_dict_from_jax({**params, "vit_encoder": {}}, stats, STAGES)


@pytest.mark.parametrize("folded", [False, True])
def test_resnet18_embeddings(jax_variables, folded):
    params, stats, images = jax_variables
    cfg = JaxConfig(**_cfg_kwargs())
    variables = {"params": params, "batch_stats": stats}
    model = _port_model(params, stats)
    if folded:
        cfg, variables = jax_fold.fold_relpose_backbone(cfg, variables)
        _, model = fold_relpose_backbone(model)
        assert not any("bn" in k for k in model.state_dict())
    want = JaxRelPoseGNN(cfg).apply(variables, images, train=False,
                                    method=JaxRelPoseGNN.encode_nodes)
    with torch.no_grad():
        got = model.encode_nodes(torch.from_numpy(images))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RESNET_TOL)


@pytest.mark.parametrize("compact", [False, True])
def test_pair_mlp2(compact):
    rng = np.random.default_rng(1)
    b, n, d, de, hid = 2, 5, 6, 3, 7
    x = rng.normal(size=(b, n, d)).astype(np.float32)
    if compact:
        _, src, tgt = jg.knn_edge_list(x, 2)
        src, tgt = np.array(src), np.array(tgt)
        e = rng.normal(size=(b, src.shape[-1], de)).astype(np.float32)
    else:
        src = tgt = None
        e = rng.normal(size=(b, n, n, de)).astype(np.float32)
    jmlp = JaxPairMLP2((d, d, de), hid, 4)
    ops = [(x, "s"), (x, "t"), (e, "e")]
    v = jmlp.init(jax.random.PRNGKey(1), ops, src, tgt)
    want = jmlp.apply(v, ops, src, tgt)

    mlp = PairMLP2((d, d, de), hid, 4)
    p = v["params"]
    with torch.no_grad():
        for i, fc in ((0, "fc1"), (2, "fc2")):
            mlp[i].weight.copy_(torch.from_numpy(
                np.asarray(p[fc]["kernel"]).T.copy()))
            mlp[i].bias.copy_(torch.from_numpy(np.array(p[fc]["bias"])))
        t = torch.from_numpy
        got = mlp([(t(x), "s"), (t(x), "t"), (t(e), "e")],
                  None if src is None else t(src).long(),
                  None if tgt is None else t(tgt).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("compact", [False, True])
def test_dense_edge_gnn(jax_variables, compact):
    """The model's gnn1 (weights from the JAX tree) against the flax layer
    on the same x, e and graph."""
    params, stats, _ = jax_variables
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, N, D)).astype(np.float32)
    adj, src, tgt = (np.array(a) for a in jg.knn_edge_list(x, 2))
    emask = np.ones(src.shape, bool)
    e_shape = src.shape if compact else (2, N, N)
    e = rng.normal(size=e_shape + (D,)).astype(np.float32)
    edges = (src, tgt, emask) if compact else None
    want_x, want_e = JaxDenseEdgeGNN(D, D, D).apply(
        {"params": params["gnn1"]}, x, e, adj, edges=edges)

    layer = _port_model(params, stats).gnn1
    t = torch.from_numpy
    with torch.no_grad():
        got_x, got_e = layer(
            t(x), t(e), t(adj),
            edges=(t(src).long(), t(tgt).long(), t(emask)) if compact
            else None)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), **TOL)
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), **TOL)


@pytest.mark.parametrize("cfg_kw", [
    dict(compact_edges=True),                 # the serving path
    dict(compact_edges=False),                # dense N x N grid
    dict(knn=0, compact_edges=True),          # static graph, adj_edge_list
    dict(knn=0, compact_edges=False),
    dict(compact_edges=True, use_attention=True, gnn_recursion=3),
], ids=["compact", "dense", "static-compact", "static-dense", "node-att"])
def test_from_embeddings(jax_variables, cfg_kw):
    params, stats, _ = jax_variables
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, N, D)).astype(np.float32)
    adj = rng.random((3, N, N)) < 0.6
    adj &= ~np.eye(N, dtype=bool)
    adj[:, 1, 0] = True                       # every query has an edge
    jcfg = JaxConfig(**_cfg_kwargs(**cfg_kw))
    jparams = params
    if cfg_kw.get("use_attention"):
        # the model-level block has its own weights: init them in JAX
        full = JaxRelPoseGNN(jcfg).init(
            jax.random.PRNGKey(4), x, adj,
            method=JaxRelPoseGNN.from_embeddings)
        jparams = {**params, "att": _to_numpy_tree(full["params"]["att"])}
    want = JaxRelPoseGNN(jcfg).apply({"params": jparams}, x, adj,
                                     method=JaxRelPoseGNN.from_embeddings)

    model = _port_model(jparams, stats, **cfg_kw)
    with torch.no_grad():
        got = model.from_embeddings(torch.from_numpy(x),
                                    torch.from_numpy(adj))
    for name, g, w in zip(("pred_abs", "pred_rel"), got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for k in ("node_feats", "node_feats_post"):
        np.testing.assert_allclose(got[3][k].numpy(), np.asarray(want[3][k]),
                                   **TOL, err_msg=k)


@pytest.mark.parametrize("kw,what", [
    (dict(eval_dropout=True), "eval_dropout"),
    (dict(backbone="vit"), "backbone"),
    (dict(use_gnn=False), "use_gnn"),
])
def test_unported_options_raise_naming_the_roadmap(kw, what):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        RelPoseGNN(RelPoseGNNConfig(**_cfg_kwargs(**kw)))


def test_presets_mirror_jax():
    for name in ("R1", "R2", "R3"):
        got = dataclasses.asdict(RelPoseGNNConfig.preset(name))
        want = dataclasses.asdict(JaxConfig.preset(name))
        assert {k: v for k, v in got.items() if k != "dtype"} == \
            {k: want[k] for k in got if k != "dtype"}


def test_init_weights_is_seeded_and_lecun_scaled():
    def build(seed):
        model = RelPoseGNN(RelPoseGNNConfig(**_cfg_kwargs()))
        init_weights(model, torch.Generator().manual_seed(seed))
        return model.state_dict()

    a, b, c = build(0), build(0), build(1)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert not torch.equal(a["proj_edge.weight"], c["proj_edge.weight"])
    w = a["gnn1.mlp.0.weight"]                 # fan_in 2 * D
    assert abs(w.std().item() * (2 * D) ** 0.5 - 1.0) < 0.1
    assert torch.all(a["gnn1.mlp.0.bias"] == 0)
    assert torch.all(a["feature_extractor.bn1.running_var"] == 1)
