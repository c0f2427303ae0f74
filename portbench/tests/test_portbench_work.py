"""The benchmark's own count of work: from the configuration, never from
the program's call."""

from __future__ import annotations

import dataclasses
import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import work
from portbench.tests.conftest import ROOT

SERVE = {"batch": 128, "retrieval": "netvlad", "db_live": 7000}


def _config(name):
    with open(os.path.join(ROOT, "portbench", "configs", name + ".json")) as f:
        return json.load(f)


def _port_flops(s2d_stem: bool, compact: bool) -> float:
    """What FlopCounterMode sees of the program's own encode and GNN, at
    a small size, in one of its forms."""
    from relpose_gnn_tpu_torch.models.fold_bn import fold_relpose_backbone
    from relpose_gnn_tpu_torch.models.posenet import (RelPoseGNN,
                                                      RelPoseGNNConfig)
    cfg = RelPoseGNNConfig.preset("R3", feat_dim=32, edge_dim=32,
                                  node_dim=32, backbone="resnet18")
    _, model = fold_relpose_backbone(RelPoseGNN(cfg), s2d_stem=s2d_stem)
    model = RelPoseGNN(dataclasses.replace(model.cfg, compact_edges=compact))
    x = torch.zeros(2, 8, 64, 86, 3)
    adj = ~torch.eye(8, dtype=torch.bool).expand(2, 8, 8)
    with FlopCounterMode(display=False) as c, torch.no_grad():
        model(x, adj)
    return c.get_total_flops()


def test_count_is_the_same_whatever_form_the_program_runs():
    """The program's own count moves with its s2d stem (zero taps) and
    its dense edge grid (64 pair rows a graph, not 32); the benchmark's
    count reads the configuration alone, so it is one number."""
    forms = {(s2d, compact): _port_flops(s2d, compact)
             for s2d in (False, True) for compact in (False, True)}
    assert forms[(True, True)] > forms[(False, True)]
    assert forms[(False, False)] > forms[(False, True)]
    cfg = _config("r3")
    counts = {work.serve_flops_per_query(cfg, SERVE) for _ in forms}
    assert len(counts) == 1


def test_serve_count_holds_its_parts():
    """The ranking product over the live frames and kernel #1 at
    3 E C^2 a call are in the count, the stem at its published 7x7."""
    cfg = _config("r3")
    m = cfg["model"]
    base = work.serve_flops_per_query(cfg, SERVE)
    more = work.serve_flops_per_query(cfg, dict(SERVE, db_live=8000))
    dv = cfg["retrieval"]["num_clusters"] * cfg["retrieval"]["encoder_dim"]
    assert more - base == pytest.approx(2 * dv * 1000)
    # the stem: 64 x 3 x 7 x 7 multiply-adds at each of 128 x 171 outputs
    stem = 2 * 64 * 3 * 49 * 128 * 171
    assert base > stem
    e = m["num_nodes"] * m["knn"]                # kNN edges of one graph
    c = m["node_dim"] // 8
    core = 3 * e * c * c * m["gnn_recursion"]
    trunk = work.serve_flops_per_query(cfg, dict(SERVE,
                                                 retrieval="shared-trunk"))
    assert base > trunk > core


def test_train_count_is_forward_and_backward():
    """ResNet34 is 3.6 GMAC at 224x224 (torchvision), so 12.5 GFLOP an
    image at 256x341; a trained graph is 8 of them, forward and backward
    (about three forwards), and the GNN."""
    cfg = _config("r3")
    encode = 2 * 3.6e9 * 256 * 341 / (224 * 224)
    trunk = work.serve_flops_per_query(cfg, dict(SERVE,
                                                 retrieval="shared-trunk",
                                                 db_live=0))
    assert encode < trunk < 1.6 * encode
    train = work.train_flops_per_graph(cfg, {"batch": 32})
    assert 2.8 * 8 * encode < train < 3.4 * 8 * encode


def test_att_core_bound_lets_the_exponentials_use_every_pipe():
    """The bound counts the special-function unit and the fp32 pipes
    together (2 instructions an exponential there), so no way of
    computing the exponentials beats it."""
    e, c = 4096, 256
    sfu_only = e * c * c / (work.SFU_PER_SM_CLOCK * work.SMS
                            * work.SM_CLOCK_HZ)
    bound = work.att_core_bound_s(e, c, 2)
    assert bound < sfu_only
    assert bound == pytest.approx(e * c * c / work.EXP_PER_S)
    assert work.EXP_PER_S == pytest.approx(80 * 132 * 1.98e9)
    # bytes bound: three bf16 inputs in, float32 out
    assert bound > (3 * e * c * 2 + 4 * e * c) / work.HBM_BYTES_S
