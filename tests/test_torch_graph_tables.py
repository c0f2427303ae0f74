"""The port's static edge tables (relpose_gnn_tpu_torch/ops/graph.py)
against the JAX package's: every table, `build_edge_index`,
`edge_index_to_adj` and `first_edge_anchor`, for n in {2, 3, 5, 8}, and
`fc_rand_edge_index` for every seed tried.  Host numpy on both sides, so
equality is exact."""

import numpy as np
import pytest

from relpose_gnn_tpu.ops import graph as jax_graph
from relpose_gnn_tpu_torch.ops import graph

NS = (2, 3, 5, 8)
TABLES = ("rnn_edge_index", "circ_edge_index", "dilated_edge_index",
          "ho_edge_index", "fc_edge_index")
STRUCTURES = ("ind", "rnn", "circ", "dilated", "ho", "fc")


def _anchors(mod, e):
    """Every ordinal's anchor, then the out-of-range error's message."""
    into = int(np.sum(e[1] == 0))
    got = [mod.first_edge_anchor(e, r) for r in range(into)]
    with pytest.raises(ValueError) as info:
        mod.first_edge_anchor(e, into)
    return got, str(info.value)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("name", TABLES)
def test_table_matches_jax(name, n):
    got = getattr(graph, name)(n)
    want = getattr(jax_graph, name)(n)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    if name == "fc_edge_index":
        np.testing.assert_array_equal(graph.fc_edge_index(n, False),
                                      jax_graph.fc_edge_index(n, False))
    if got.shape[1] and np.any(got[1] == 0):
        assert _anchors(graph, got) == _anchors(jax_graph, want)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("structure", STRUCTURES)
def test_build_edge_index_and_adj_match_jax(structure, n):
    got = graph.build_edge_index(structure, n)
    want = jax_graph.build_edge_index(structure, n)
    if structure == "ind":
        assert got is None and want is None
        return
    np.testing.assert_array_equal(got, want)
    adj = graph.edge_index_to_adj(got, n)
    np.testing.assert_array_equal(adj, jax_graph.edge_index_to_adj(want, n))
    assert adj.dtype == bool
    assert _anchors(graph, got) == _anchors(jax_graph, want)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("seed", range(5))
def test_fc_rand_matches_jax_under_one_seed(seed, n):
    for hoc, factor in ((2, 0.2), (1, 0.7)):
        got = graph.fc_rand_edge_index(n, hoc, factor,
                                       np.random.default_rng(seed))
        want = jax_graph.fc_rand_edge_index(n, hoc, factor,
                                            np.random.default_rng(seed))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(graph.edge_index_to_adj(got, n),
                                      jax_graph.edge_index_to_adj(want, n))
        if np.any(got[1] == 0):
            assert _anchors(graph, got) == _anchors(jax_graph, want)


def test_static_anchor_is_the_first_fc_edge_into_the_query():
    """The experiment's static anchor (knn=0) is `first_edge_anchor` of
    the fc table: node 1 for every graph size."""
    from relpose_gnn_tpu_torch.training import experiment as exp
    for n in NS:
        cfg = exp.ExperimentConfig(knn=0, seq_len=n)
        assert exp.static_anchor_for(cfg) == 1 == \
            jax_graph.first_edge_anchor(jax_graph.fc_edge_index(n))
