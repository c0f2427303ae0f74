"""PyTorch graph ops (relpose_gnn_tpu_torch/ops/graph.py) against the JAX
ops they port, on the same numpy inputs.

Tolerances: index outputs (kNN order, edge lists, anchors) must be EXACTLY
equal, ties included.  Ops that only move values are exact too.  Float
arithmetic is held to rtol = atol = 1e-6: the two sides sum in other
orders, which costs a few float32 ulps (distances of ~30 have an ulp of
~4e-6, hence the relative term).  Squared distances get atol 1e-5: on the
diagonal ||a||^2 - 2 a.a + ||a||^2 cancels terms of ~60 (ulp 7.6e-6) and
leaves a rounding residue that differs between the two sides.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from relpose_gnn_tpu.ops import graph as jg
from relpose_gnn_tpu_torch.ops import graph as tg

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads while this module runs: the suite runs several
    test processes on one host, and torch's default of one thread a core
    in each of them oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _feats(seed, b=3, n=8, d=16, ties=False):
    rng = np.random.default_rng(seed)
    if ties:
        # small integers: every distance is exact in float32, so ties are
        # real ties on both sides; duplicated rows add more, including a
        # tie for the query's nearest neighbour (rows 1 and 2)
        x = rng.integers(0, 3, size=(b, n, d)).astype(np.float32)
        x[:, 2] = x[:, 1]
        x[:, 5] = x[:, 3]
        return x
    return rng.normal(size=(b, n, d)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("ties", [False, True])
def test_pairwise_sq_dists(ties):
    x = _feats(0, ties=ties)
    np.testing.assert_allclose(tg.pairwise_sq_dists(_t(x)).numpy(),
                               np.asarray(jg.pairwise_sq_dists(x)),
                               rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("k", [2, 4])
def test_knn_adjacency_and_edge_list(ties, k):
    x = _feats(1, ties=ties)
    np.testing.assert_array_equal(tg.knn_adjacency(_t(x), k).numpy(),
                                  np.asarray(jg.knn_adjacency(x, k)))
    adj, src, tgt = tg.knn_edge_list(_t(x), k)
    jadj, jsrc, jtgt = jg.knn_edge_list(x, k)
    np.testing.assert_array_equal(adj.numpy(), np.asarray(jadj))
    np.testing.assert_array_equal(src.numpy(), np.asarray(jsrc))
    np.testing.assert_array_equal(tgt.numpy(), np.asarray(jtgt))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("node", [0, 3])
def test_nearest_neighbor(ties, node):
    x = _feats(2, b=16, ties=ties)
    got = tg.nearest_neighbor(_t(x), node=node).numpy()
    np.testing.assert_array_equal(got,
                                  np.asarray(jg.nearest_neighbor(x, node)))
    if ties and node == 0:
        # rows 1 and 2 are equal: wherever they are the nearest, the lower
        # index wins, as with lax.argmin
        assert not np.any(got == 2)


@pytest.mark.parametrize("e_max", [None, 7])
def test_adj_edge_list(e_max):
    rng = np.random.default_rng(3)
    adj = rng.random((4, 5, 5)) < 0.4
    adj[0] = False                     # a graph with no edge at all
    adj &= ~np.eye(5, dtype=bool)
    got = tg.adj_edge_list(_t(adj), e_max)
    want = jg.adj_edge_list(jnp.asarray(adj), e_max)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_edge_pair_features_dense_and_compact():
    x = _feats(4, n=6)
    np.testing.assert_array_equal(tg.edge_pair_features(_t(x)).numpy(),
                                  np.asarray(jg.edge_pair_features(x)))
    _, src, tgt = jg.knn_edge_list(x, 3)
    src, tgt = np.asarray(src), np.asarray(tgt)
    got = tg.edge_pair_features_compact(_t(x), _t(src).long(),
                                        _t(tgt).long())
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jg.edge_pair_features_compact(x, src, tgt)))


def test_compact_mean_aggregate_and_scatter():
    rng = np.random.default_rng(5)
    b, n, e, d = 3, 5, 9, 7
    msg = rng.normal(size=(b, e, d)).astype(np.float32)
    src = rng.integers(0, n, size=(b, e))
    tgt = rng.integers(0, n, size=(b, e))
    emask = rng.random((b, e)) < 0.7
    np.testing.assert_allclose(
        tg.compact_mean_aggregate(_t(msg), _t(tgt), _t(emask), n).numpy(),
        np.asarray(jg.compact_mean_aggregate(msg, tgt, emask, n)), **TOL)
    np.testing.assert_allclose(
        tg.scatter_edge_values(_t(msg), _t(src), _t(tgt), _t(emask),
                               n).numpy(),
        np.asarray(jg.scatter_edge_values(msg, src, tgt, emask, n)), **TOL)


def test_masked_mean_aggregate_isolated_nodes_get_zero():
    rng = np.random.default_rng(6)
    msg = rng.normal(size=(2, 5, 5, 4)).astype(np.float32)
    adj = rng.random((2, 5, 5)) < 0.5
    adj[:, :, 2] = False               # node 2 has no incoming edge
    got = tg.masked_mean_aggregate(_t(msg), _t(adj)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jg.masked_mean_aggregate(msg, adj)), **TOL)
    np.testing.assert_array_equal(got[:, 2], 0.0)


def test_relative_pose_targets():
    p = _feats(7, d=6)
    np.testing.assert_array_equal(tg.relative_pose_targets(_t(p)).numpy(),
                                  np.asarray(jg.relative_pose_targets(p)))


@pytest.mark.parametrize("n", [2, 5, 8])
def test_numpy_edge_tables(n):
    np.testing.assert_array_equal(tg.fc_edge_index(n), jg.fc_edge_index(n))
    np.testing.assert_array_equal(tg.fc_edge_index(n, False),
                                  jg.fc_edge_index(n, False))
    np.testing.assert_array_equal(tg.fc_adjacency(n), jg.fc_adjacency(n))
