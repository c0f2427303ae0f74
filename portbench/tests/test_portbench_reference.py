"""The benchmark's plain reference against the program, on the CPU at a
tiny size with seeded weights (the program in float32, so that the two
agree to rounding)."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from portbench import scenes
from portbench.reference import nets, params, selection
from portbench.reference import train as rtrain

FP32 = nets.Precision("float32")
TINY = {"backbone": "resnet18", "feat_dim": 32, "edge_dim": 32,
        "node_dim": 32, "num_nodes": 8, "knn": 4, "gnn_recursion": 2,
        "droprate": 0.5, "image_hw": [64, 86], "dtype": "float32",
        "preset": "R3"}


def _weights(spec, seed=3):
    return params.make_weights(spec, scenes.generator(seed, "w", "cpu"))


def _port_model(m, w):
    from portbench import program
    return program.pose_model(m, w, "cpu")


def _images(n, hw=(64, 86), seed=4):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, *hw, 3), generator=g)


@pytest.mark.parametrize("train", [False, True])
def test_resnet_encoder_matches_the_program(train):
    w = _weights(params.relpose_spec(TINY))
    model = _port_model(TINY, w)
    x = _images(4)
    got = model.encode_nodes(x[:, None], train=train)[:, 0]
    want = nets.encode(w, TINY, x, FP32, train=train)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_served_fold_matches_the_unfolded_reference():
    """The service folds BatchNorm into the convolutions; the reference
    keeps it: the same function (BN statistics away from identity)."""
    from relpose_gnn_tpu_torch.models.fold_bn import fold_relpose_backbone
    w = _weights(params.relpose_spec(TINY))
    _, folded = fold_relpose_backbone(_port_model(TINY, w))
    x = _images(3)
    torch.testing.assert_close(folded.encode_nodes(x[:, None])[:, 0],
                               nets.encode(w, TINY, x, FP32),
                               rtol=1e-4, atol=1e-4)


def test_vit_encoder_matches_the_program():
    m = dict(TINY, backbone="vit", preset="R3-vit", vit={
        "patch": 16, "dim": 768, "depth": 12, "heads": 12, "mlp_ratio": 4})
    w = _weights(params.relpose_spec(m))
    model = _port_model(m, w)
    x = _images(2)
    torch.testing.assert_close(model.encode_nodes(x[:, None])[:, 0],
                               nets.encode(w, m, x, FP32),
                               rtol=1e-4, atol=1e-4)


def test_netvlad_matches_the_program():
    from portbench import program
    r = {"num_clusters": 8, "encoder_dim": 512, "retrieval_hw": [48, 64],
         "dtype": "float32"}
    w = _weights(params.netvlad_spec(r))
    enc = program.netvlad_model(r, w, "cpu", "float32")
    x = nets.netvlad_input(_images(2), r["retrieval_hw"])
    torch.testing.assert_close(enc(x), nets.netvlad(w, r, x, FP32),
                               rtol=1e-4, atol=1e-5)


def test_gnn_on_the_knn_edge_list_matches_the_program():
    """The program's compact GNN (the service's form) against the
    reference: the relative pose of every kNN edge and the anchor."""
    from relpose_gnn_tpu_torch.models.posenet import RelPoseGNN
    w = _weights(params.relpose_spec(TINY))
    dense = _port_model(TINY, w)
    compact = RelPoseGNN(dataclasses.replace(dense.cfg, compact_edges=True))
    compact.load_state_dict(dense.state_dict())
    g = torch.Generator().manual_seed(5)
    x = torch.randn(3, 8, 32, generator=g)
    adj = ~torch.eye(8, dtype=torch.bool).expand(3, 8, 8)
    with torch.no_grad():
        _, pred_rel, _, _ = compact.from_embeddings(x, adj)
        ref, src, tgt, _ = nets.relpose_edges(w, TINY, x, FP32)
    rows = torch.arange(3)[:, None]
    torch.testing.assert_close(pred_rel[rows, src, tgt], ref, rtol=1e-4,
                               atol=1e-5)
    from relpose_gnn_tpu_torch.ops.graph import nearest_neighbor
    assert torch.equal(nearest_neighbor(x), nets.nearest(x)[0])


@pytest.mark.parametrize("deterministic", [False, True])
def test_selection_rule_matches_the_program(deterministic):
    from relpose_gnn_tpu_torch.retrieval.subsample import (
        subsample_neighbors_batch)
    g = torch.Generator().manual_seed(6)
    sim = torch.rand(16, 300, generator=g)
    valid = torch.arange(300) < 280
    seed = 2 ** 31 + 77
    want = selection.select(sim, valid, 7, 5, seed, deterministic)
    if deterministic:
        # the service's strided top-k: ranks 0, 5, ..., 30
        order = torch.sort(torch.where(valid, 1 - sim, float("inf")),
                           dim=1, stable=True).indices
        assert torch.equal(want, order[:, ::5][:, :7])
        return
    for candidates in (None, 64):
        got = subsample_neighbors_batch(seed, sim, ~valid, 7, 5,
                                        candidates=candidates)
        assert torch.equal(got, want)


def test_fold_in_is_the_programs():
    from relpose_gnn_tpu_torch.retrieval.subsample import fold_in
    for s, i in ((0, 0), (2 ** 31 + 5, 17), (3 * 2 ** 40 + 1, 123456)):
        assert selection.fold_in(s, i) == fold_in(s, i)


def test_train_step_matches_the_program():
    """One train step of the program (float32, dropout on) against the
    reference's, on the same rows, masks and graph: loss, gradient and
    update."""
    from relpose_gnn_tpu_torch.training.trainer import (TrainerConfig,
                                                        create_train_state,
                                                        make_train_step)
    w = _weights(params.relpose_spec(TINY))
    cfg = TrainerConfig(lr=1e-4, weight_decay=5e-4)
    state = create_train_state(_port_model(TINY, w), cfg)
    g = torch.Generator().manual_seed(8)
    images = torch.rand(2, 8, 64, 86, 3, generator=g)
    poses = torch.randn(2, 8, 6, generator=g)
    batch = {"images": images, "poses": poses,
             "adj": ~torch.eye(8, dtype=torch.bool).expand(2, 8, 8)}
    before = {n: p.detach().clone() for n, p in
              zip(state.optimizer.names, state.optimizer.params)}
    metrics = make_train_step(cfg)(state, batch, 99)

    leaves = {f"model.{k}": v.clone().requires_grad_() for k, v in w.items()
              if v.is_floating_point() and "running" not in k}
    crit = {"srx": torch.tensor(0.0, requires_grad=True),
            "srq": torch.tensor(-2.0, requires_grad=True)}
    sd = {k[6:]: v for k, v in leaves.items()}
    drop = rtrain.dropout_fn(99, 0, TINY["droprate"], "cpu")
    loss, _, _, _ = rtrain.loss(sd, crit, TINY, images, poses, FP32, drop)
    assert float(metrics["loss"]) == pytest.approx(float(loss.detach()),
                                                   rel=1e-5)
    params_ = dict(leaves, **{"criterion_R.sax": crit["srx"],
                              "criterion_R.saq": crit["srq"]})
    grads = dict(zip(params_, torch.autograd.grad(loss, list(
        params_.values()), allow_unused=True)))
    opt = rtrain.Adam({k: v.detach().clone() for k, v in params_.items()},
                      1e-4, 5e-4)
    opt.step({k: torch.zeros_like(v) if grads[k] is None else grads[k]
              for k, v in params_.items()})
    for name, p in zip(state.optimizer.names, state.optimizer.params):
        if name in opt.p:
            step = (p.detach() - before[name]).norm()
            want = (opt.p[name] - params_[name].detach()).norm()
            assert float(step) == pytest.approx(float(want), rel=1e-3,
                                                abs=1e-9), name
