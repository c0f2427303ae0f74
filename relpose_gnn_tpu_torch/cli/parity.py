"""Accuracy-parity entry point against the reference's released artifacts:
`python -m relpose_gnn_tpu_torch.cli.parity --weights <.pth.tar>
--graph-data-dir <root>`.

Port of the JAX package's `cli/parity.py`.  Reads the released checkpoint
(e.g. `relpose_gnn__multi_39.pth.tar`) into the port's model with
strict=True, then each scene's test graphs, either packed stores or the
reference's torch-geometric `processed/data_*.pt` files (read without
torch-geometric through `data/pyg_import.py`), evaluates them with the
reference protocol (testing/test.py:180-286: kNN-4 dynamic graph, the
anchor on the first kNN edge into node 0, or with `--knn 0` the static fc
graph's construction-order first edge; float64 medians) and prints
per-scene medians with the difference to the published table.  The same
flags as the JAX script, plus `--device`.

    python -m relpose_gnn_tpu_torch.cli.parity \\
        --weights /data/relpose_gnn__multi_39.pth.tar \\
        --graph-data-dir /data/7Scenes_graphs/ --dataset-dir /data/7Scenes/
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

from relpose_gnn_tpu_torch import resolve_device
from relpose_gnn_tpu_torch.cli import add_device_arg, pin_full_fp32
from relpose_gnn_tpu_torch.data.cambridge import CAMBRIDGE_SCENES
from relpose_gnn_tpu_torch.data.packed import PackedGraphDataset
from relpose_gnn_tpu_torch.data.pipeline import (data_iterator,
                                                 device_prefetch)
from relpose_gnn_tpu_torch.data.pyg_import import iter_pyg_dir
from relpose_gnn_tpu_torch.data.seven_scenes import test_split_rgb_paths
from relpose_gnn_tpu_torch.evaluation.evaluator import (evaluate_dataset,
                                                        save_poses)
from relpose_gnn_tpu_torch.models.posenet import (RelPoseGNN,
                                                  RelPoseGNNConfig)
from relpose_gnn_tpu_torch.ops import graph as graph_ops
from relpose_gnn_tpu_torch.training.checkpoints import read_state_dict
from relpose_gnn_tpu_torch.training.trainer import (TrainerConfig,
                                                    create_train_state,
                                                    make_eval_step)

# published 7-Scenes multi-scene results (README.md:47-121, the filenames
# of the released prediction npz files, = paper Table 1)
PUBLISHED_7SCENES = {
    "chess": (0.09, 2.9),
    "fire": (0.23, 7.4),
    "heads": (0.13, 8.5),
    "office": (0.15, 4.1),
    "pumpkin": (0.17, 3.3),
    "redkitchen": (0.20, 3.6),
    "stairs": (0.23, 6.4),
}


def parse_args(argv):
    p = argparse.ArgumentParser("relpose_gnn_tpu parity")
    p.add_argument("--weights", required=True,
                   help="released .pth.tar checkpoint")
    p.add_argument("--graph-data-dir", required=True,
                   help="root containing <scene>_fc8_sp5_test dirs "
                        "(reference processed/*.pt or packed stores)")
    p.add_argument("--dataset", default="7Scenes",
                   choices=("7Scenes", "Cambridge"))
    p.add_argument("--scenes", default=None,
                   help="comma list; default = all scenes with published "
                        "numbers")
    p.add_argument("--dataset-dir", default=None,
                   help="raw dataset root; enables the TestSplit.txt "
                        "filename-count assertion (testing/test.py:115-121)")
    p.add_argument("--pose-stat-path", default="",
                   help="Cambridge translation stats file")
    p.add_argument("--model-name", default="R3")
    p.add_argument("--backbone", default="resnet34")
    p.add_argument("--seq-len", type=int, default=8)
    p.add_argument("--knn", type=int, default=4)
    p.add_argument("--img-height", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--dtype", default="bfloat16",
                   choices=("bfloat16", "float32"))
    p.add_argument("--save-dir", default=None,
                   help="export npz predictions here (reference convention)")
    add_device_arg(p)
    return p.parse_args(argv)


def _scene_graph_dir(root: Path, scene: str, dataset: str,
                     seq_len: int, single_scene: bool = False) -> Path:
    """A scene's graph store.  The bare `root` (pointing --graph-data-dir
    at one store) is taken only for a single scene: with several it would
    evaluate the same store for every row of the table."""
    sp = 3 if dataset == "Cambridge" else 5
    cands = [root / f"{scene}_fc{seq_len}_sp{sp}_test", root / scene]
    if single_scene:
        cands.append(root)
    for cand in cands:
        if cand.is_dir() and (
                (cand / "meta.json").is_file()
                or (cand / "processed").is_dir()
                or list(cand.glob("data_*.pt"))):
            return cand
    raise FileNotFoundError(
        f"no graph store for {scene} under {root} (expected "
        f"{cands[0].name}/ or {scene}/"
        + (" or the root itself" if single_scene else "") + ")")


def _pyg_batches(gdir: Path, img_height: int, batch_size: int,
                 device: torch.device, count: list):
    """Device batches of a reference `processed/` directory (its images
    are stored normalised); `count[0]` counts the graphs read."""
    buf = []

    def batch():
        return {k: torch.as_tensor(np.stack([g[k] for g in buf]),
                                   device=device)
                for k in ("images", "poses", "adj")}

    for _, g in iter_pyg_dir(gdir, img_height):
        buf.append(g)
        count[0] += 1
        if len(buf) == batch_size:
            yield batch()
            buf.clear()
    if buf:
        yield batch()


def build_parity_model(args, sd: dict, device: torch.device) -> RelPoseGNN:
    """The preset named by --model-name (else R3) at the checkpoint's
    width, with its weights (strict=True)."""
    feat_dim = sd["proj_edge.weight"].shape[1] // 2  # from the checkpoint
    cfg = RelPoseGNNConfig.preset(
        args.model_name if args.model_name in ("R1", "R2", "R3") else "R3",
        num_nodes=args.seq_len, knn=args.knn, droprate=0.0,
        backbone=args.backbone, feat_dim=feat_dim, edge_dim=feat_dim,
        node_dim=feat_dim,
        dtype=torch.bfloat16 if args.dtype == "bfloat16" else None)
    model = RelPoseGNN(cfg)
    model.load_state_dict(sd, strict=True)
    return model.to(device).eval()


def main(argv=None) -> list:
    """Evaluate; returns [(scene, PoseErrors, published (t, rot) or
    None)]."""
    args = parse_args(argv if argv is not None else sys.argv[1:])
    pin_full_fp32()
    device = resolve_device(args.device)
    if args.scenes:
        scenes = args.scenes.split(",")
    elif args.dataset == "7Scenes":
        scenes = list(PUBLISHED_7SCENES)
    else:
        # Cambridge publishes no in-repo table: every scene, rather than
        # silently none
        scenes = list(CAMBRIDGE_SCENES)
    published = PUBLISHED_7SCENES if args.dataset == "7Scenes" else {}

    model = build_parity_model(args, read_state_dict(args.weights), device)
    state = create_train_state(model, TrainerConfig())
    static_anchor = (None if args.knn > 0 else graph_ops.first_edge_anchor(
        graph_ops.fc_edge_index(args.seq_len)))
    eval_step = make_eval_step(ref_node=0, static_anchor=static_anchor)

    mean_t, std_t = np.zeros(3), np.ones(3)
    if args.dataset == "Cambridge" and args.pose_stat_path:
        mean_t, std_t = np.loadtxt(args.pose_stat_path)

    root = Path(args.graph_data_dir)
    rows = []
    for scene in scenes:
        gdir = _scene_graph_dir(root, scene, args.dataset, args.seq_len,
                                single_scene=len(scenes) == 1)
        if (gdir / "meta.json").is_file():  # packed store
            ds = PackedGraphDataset(str(gdir))
            it = data_iterator(ds, batch_size=args.batch_size,
                               shuffle=False, epochs=1,
                               drop_remainder=False)
            err = evaluate_dataset(eval_step, state,
                                   device_prefetch(it, ds.mean, ds.std,
                                                   device),
                                   pose_mean=mean_t, pose_std=std_t)
            count = len(ds)
        else:  # reference torch-geometric pickles
            counted = [0]
            err = evaluate_dataset(
                eval_step, state, _pyg_batches(gdir, args.img_height,
                                               args.batch_size, device,
                                               counted),
                pose_mean=mean_t, pose_std=std_t)
            count = counted[0]

        if args.dataset_dir and args.dataset == "7Scenes":
            test_split_rgb_paths(args.dataset_dir, scene,
                                 expected_count=count)
        rows.append((scene, err, published.get(scene)))
        if args.save_dir:
            save_poses(args.save_dir, scene, err)

    print(f"{'scene':<12} {'med t':>7} {'med rot':>8}"
          f" {'pub t':>7} {'pub rot':>8} {'d t':>7} {'d rot':>7}")
    for scene, err, pub in rows:
        if pub:
            print(f"{scene:<12} {err.median_t:7.3f} {err.median_q:8.2f}"
                  f" {pub[0]:7.2f} {pub[1]:8.1f}"
                  f" {err.median_t - pub[0]:+7.3f}"
                  f" {err.median_q - pub[1]:+7.2f}")
        else:
            print(f"{scene:<12} {err.median_t:7.3f} {err.median_q:8.2f}"
                  f" {'-':>7} {'-':>8} {'-':>7} {'-':>7}")
    return rows


if __name__ == "__main__":
    main()
