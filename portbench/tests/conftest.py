"""Tiny cells for the CPU tests: a root holding BENCHMARK.json and the
data files of cells at a size a test run holds, the drivers and readers
of this package."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_MODEL = {"backbone": "resnet18", "feat_dim": 32, "edge_dim": 32,
              "node_dim": 32, "num_nodes": 8, "knn": 4, "gnn_recursion": 2,
              "droprate": 0.5, "image_hw": [64, 86], "dtype": "float32"}
TINY_SERVE = {
    "driver": "serve_stream", "batch": 4, "db_live": 60, "db_capacity": 64,
    "retrieval": "netvlad", "deterministic": False, "sampling_period": 5,
    "retrieval_candidates": 16, "rank_dtype": "float32", "depth": 2,
    "pool_batches": 3, "warm_batches": 1, "build_batch": 16,
    "strip_columns": 600,
    "pixel_stats": {"mean": [0.5, 0.5, 0.5], "std": [0.27, 0.27, 0.27]},
    "check_batches": 2, "trace": {"wait": 1, "active": 2,
                                  "launches_per_step": 734}}
TINY_TRAIN = {
    "driver": "train_loop", "batch": 2, "graphs": 8, "node_stride": 12,
    "strip_columns": 600,
    "pixel_stats": {"mean": [0.5, 0.5, 0.5], "std": [0.27, 0.27, 0.27]},
    "lr": 1e-4, "weight_decay": 5e-4, "sax": 0.0, "saq": -2.0, "srx": 0.0,
    "srq": -2.0, "check_steps": 3,
    "trace": {"wait": 1, "active": 2, "launches_per_step": 1500}}
# the program runs in float32 here and agrees with the reference to
# rounding, so no near-tie needs leaving out: every answer is compared
SERVE_LIMITS = {"max": {"retrieval_gap": 0.01, "anchor_gap": 0.01,
                        "pose_gap": 0.01},
                "tie_margin": 0.0}
TRAIN_LIMITS = {"max": {"loss_gap": 0.01, "grad_gap": 0.01,
                        "update_gap": 0.01}}


def _dump(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def write_root(root: str, cells: dict) -> dict:
    """A benchmark root with the repository's BENCHMARK.json metrics and
    readers and the given tiny cells: {cell: (config dict, traffic dict,
    limits dict)}."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    drivers = {}
    for w in bench["workloads"]:
        with open(os.path.join(ROOT, "portbench", "traffic",
                               w["traffic"] + ".json")) as f:
            drivers[w["name"]] = json.load(f)["driver"]
    shutil.copytree(os.path.join(ROOT, "portbench", "metrics"),
                    os.path.join(root, "portbench", "metrics"))
    bench["configs"], bench["workloads"] = [], []
    for name, (cfg, traffic, limits) in cells.items():
        bench["configs"].append({"name": "cfg-" + name, "source": "test",
                                 "file": f"portbench/configs/{name}.json",
                                 "reduced": [], "why": "test"})
        bench["workloads"].append({"name": name, "config": "cfg-" + name,
                                   "traffic": "mix-" + name, "chips": 1,
                                   "why": "test"})
        _dump(os.path.join(root, "portbench", "configs", name + ".json"),
              cfg)
        _dump(os.path.join(root, "portbench", "traffic",
                           "mix-" + name + ".json"), traffic)
        _dump(os.path.join(root, "portbench", "limits", name + ".json"),
              limits)
    # each metric goes to the tiny cells of the drivers it is read in
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            kinds = {drivers[w] for w in m["workloads"]}
            m["workloads"] = [n for n, (_, t, _) in cells.items()
                              if t["driver"] in kinds]
    _dump(os.path.join(root, "BENCHMARK.json"), bench)
    return bench


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
