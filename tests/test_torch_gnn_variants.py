"""The ablation GNN layers of the port (relpose_gnn_tpu_torch/models/gnn.py:
EdgeModelAtt, DenseEdgeGNNSplit, DenseEdgeGNNGated, DenseEdgeGNNNoUpdate,
EdgeConvRotDense, cosine_gate, ConvMapGNN, DenseConv) against the JAX
layers: the same weights (carried across by `tree_state_dict_from_jax`),
the same numpy inputs and graph, float32 on the CPU.

Tolerances, with their basis:
  * the MLP layers (and their attention blocks): rtol = atol = 1e-5 -- a
    few float32 matmuls, summed in other orders by XLA and oneDNN;
  * ConvMapGNN: rtol = atol = 2e-5 -- six 3x3 convolutions with
    BatchNorm, as the ResNet parity of tests/test_torch_models.py; in
    train mode flax takes the batch variance the two-pass way here, as the
    port does (flax's default E[x^2] - E[x]^2 differs where a channel's
    mean is large against its spread); the running statistics it updates
    to the same tolerance;
  * cosine_gate: rtol = atol = 1e-6 -- a few reductions.
"""

import functools

import numpy as np
import jax
import pytest
import torch

from relpose_gnn_tpu.models import gnn as jg
from relpose_gnn_tpu_torch.models import gnn as tg
from relpose_gnn_tpu_torch.models.convert import tree_state_dict_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)
CONV_TOL = dict(rtol=2e-5, atol=2e-5)
B, N, D, DE, OUT = 2, 5, 16, 12, 16


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads while this module runs: the suite runs several
    test processes on one host, and torch's default of one thread a core
    in each of them oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    if hasattr(tree, "items"):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.array(tree)


def _inputs(seed=0, d=D, de=DE):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, N, d)).astype(np.float32)
    e = rng.normal(size=(B, N, N, de)).astype(np.float32)
    adj = rng.random((B, N, N)) < 0.6
    adj[:, 1] = False                 # an isolated target, and a source
    return x, e, adj


def _carry(jmod, port, *args):
    """Init the JAX layer on `args`, carry its weights into `port`, return
    (JAX output, port output)."""
    v = jax.jit(lambda k: jmod.init(k, *args))(jax.random.PRNGKey(1))
    v = _np_tree(v)
    port.load_state_dict(tree_state_dict_from_jax(
        v["params"], v.get("batch_stats", {})), strict=True)
    want = jax.jit(jmod.apply)(v, *args)
    with torch.no_grad():
        got = port(*(torch.from_numpy(np.array(a)) for a in args))
    return want, got


def _close(got, want, tol=TOL):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, tol)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("layer", ["split", "gated", "noupdate",
                                   "noupdate-noatt"])
def test_edge_gnn_layers_match_jax(layer):
    x, e, adj = _inputs()
    jmod, port = {
        "split": (jg.DenseEdgeGNNSplit(D, DE, OUT),
                  tg.DenseEdgeGNNSplit(D, DE, OUT)),
        "gated": (jg.DenseEdgeGNNGated(D, DE, OUT),
                  tg.DenseEdgeGNNGated(D, DE, OUT)),
        "noupdate": (jg.DenseEdgeGNNNoUpdate(D, DE, OUT),
                     tg.DenseEdgeGNNNoUpdate(D, DE, OUT)),
        "noupdate-noatt": (
            jg.DenseEdgeGNNNoUpdate(D, DE, OUT, use_attention=False),
            tg.DenseEdgeGNNNoUpdate(D, DE, OUT, use_attention=False)),
    }[layer]
    want, got = _carry(jmod, port, x, e, adj)
    _close(got, want)
    if layer == "split":
        assert got[0].shape == (B, N, 2 * OUT)


def test_edge_gnn_layer_in_edge_width():
    """A first layer whose incoming edges are narrower than its own."""
    x, e, adj = _inputs(1, de=6)
    want, got = _carry(jg.DenseEdgeGNNGated(D, DE, OUT),
                       tg.DenseEdgeGNNGated(D, DE, OUT, in_edge_dim=6),
                       x, e, adj)
    _close(got, want)


def test_edge_model_att_matches_jax():
    x, e, _ = _inputs(2)
    want, got = _carry(jg.EdgeModelAtt(D, DE, OUT),
                       tg.EdgeModelAtt(D, DE, OUT), x, e)
    _close(got, want)


@pytest.mark.parametrize("node_dim", [D, 3])
def test_edge_conv_rot_matches_jax(node_dim):
    """Aggregated at the source; `mlp0` on the edges alone for nodes at
    most 5 wide."""
    x, e, adj = _inputs(3, d=node_dim)
    port = tg.EdgeConvRotDense(node_dim, DE, OUT)
    assert hasattr(port, "mlp0") == (node_dim <= 5)
    want, got = _carry(jg.EdgeConvRotDense(node_dim, DE, OUT), port,
                       x, e, adj)
    _close(got, want)


def test_dense_conv_matches_jax():
    x, _, adj = _inputs(4)
    want, got = _carry(jg.DenseConv(OUT), tg.DenseConv(D, OUT), x, adj)
    _close(got, want)


def test_cosine_gate_matches_jax():
    rng = np.random.default_rng(5)
    a, b = (rng.normal(size=(B, N, 6, 7)).astype(np.float32)
            for _ in range(2))
    b[0, 0, 0] = 0.0                          # a zero vector: clamped den
    want = jg.cosine_gate(a, b)
    got = tg.cosine_gate(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.fixture
def flax_two_pass_variance(monkeypatch):
    import flax.linen.normalization as flax_norm
    orig = flax_norm._compute_stats
    monkeypatch.setattr(flax_norm, "_compute_stats", lambda *a, **k: orig(
        *a, **dict(k, use_fast_variance=False)))


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("use_attention", [False, True])
def test_conv_map_gnn_matches_jax(flax_two_pass_variance, train,
                                  use_attention):
    c, ce, hw = 8, 5, 4
    rng = np.random.default_rng(6)
    x = rng.normal(size=(B, 3, hw, hw, c)).astype(np.float32)
    e = rng.normal(size=(B, 3, 3, hw, hw, ce)).astype(np.float32)
    adj = rng.random((B, 3, 3)) < 0.7
    jmod = jg.ConvMapGNN(c, use_attention=use_attention)
    v = _np_tree(jax.jit(lambda k: jmod.init(k, x, e, adj))(
        jax.random.PRNGKey(2)))
    stats = v["batch_stats"]
    for k in stats:                    # non-trivial running statistics
        stats[k]["mean"] = rng.uniform(-0.3, 0.3, stats[k]["mean"].shape
                                       ).astype(np.float32)
        stats[k]["var"] = rng.uniform(0.7, 1.3, stats[k]["var"].shape
                                      ).astype(np.float32)
    port = tg.ConvMapGNN(c, edge_channels=ce, use_attention=use_attention)
    port.load_state_dict(tree_state_dict_from_jax(v["params"], stats),
                         strict=True)
    t = torch.from_numpy
    if train:
        want, new = jax.jit(functools.partial(
            jmod.apply, train=True, mutable=["batch_stats"]))(v, x, e, adj)
    else:
        want = jax.jit(jmod.apply)(v, x, e, adj)
    with torch.no_grad():
        got = port(t(x), t(e), t(adj), train=train)
    _close(got, want, CONV_TOL)
    if train:
        sd = port.state_dict()
        for name, s in new["batch_stats"].items():
            np.testing.assert_allclose(sd[f"{name}.running_mean"].numpy(),
                                       np.asarray(s["mean"]), **CONV_TOL)
            np.testing.assert_allclose(sd[f"{name}.running_var"].numpy(),
                                       np.asarray(s["var"]), **CONV_TOL)
