"""Re-gate the shared-trunk retrieval mode with trained weights.

    python -m relpose_gnn_tpu_torch.benchmarks.regate_shared_trunk \
        --ckpt R/out/7Scenes/multi/acc_r05/ckpt --data-root R/raw \
        --stats-root R/stats --out regate.json

Counterpart of the JAX package's `benchmarks/regate_shared_trunk.py`.
With the weights the convergence campaign trained (`campaign.py`), per
scene the database is the scene's train frames (raw 7-Scenes-layout
images and their pose6) and the queries are its test frames, through the
serving path users call, `RelocalizationService.query` (deterministic
strided retrieval), once per retrieval mode:

    netvlad       VGG16 + NetVLAD descriptors, the reference protocol
    shared-trunk  rank on the trained backbone's embeddings, which the
                  query step computes anyway (ServiceConfig.retrieval)

It reports the end-task pose errors against the ground truth
(`evaluation/evaluator.py::compute_pose_errors`, the math of `cli.test`:
medians and means of the translation in m and the rotation in degrees),
the share of neighbours the two modes have in common, and the medians of
each mode across the scenes.

The campaign's data is synthetic, so the NetVLAD side runs untrained
weights drawn from the port's own seeded generator (`--seed`): the JAX
script's `jax.random` draws cannot be reproduced in torch, so its
NetVLAD weights, and its neighbour sets, are not these.  What compares is
the end task: both modes feed the same trained GNN; only the neighbour
selection differs.

Weights: `--ckpt` is a checkpoint directory of `cli.train` (the latest
epoch wins) or a `.pth.tar` of the reference layout (`strict=True`).  An
Orbax directory of the JAX package is refused.  The model flags must be
those the checkpoint was trained with (the defaults are `cli.train`'s:
R3, 8-node graphs, kNN 4, bf16).  Frames load at `--image-size` (the
short side, 256 as the graph builder stores them).  Runs on the CUDA card
unless `--device cpu` asks otherwise.
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import sys

import numpy as np
import torch

from relpose_gnn_tpu_torch import resolve_device
from relpose_gnn_tpu_torch.cli import netvlad_encoder, pin_full_fp32
from relpose_gnn_tpu_torch.data.seven_scenes import (SevenScenes,
                                                     load_scene_stats)
from relpose_gnn_tpu_torch.evaluation.evaluator import compute_pose_errors
from relpose_gnn_tpu_torch.evaluation.service import (RelocalizationService,
                                                      ServiceConfig)
from relpose_gnn_tpu_torch.training import checkpoints as ckpt_lib
from relpose_gnn_tpu_torch.training.experiment import (ExperimentConfig,
                                                       build_model)
from relpose_gnn_tpu_torch.training.trainer import (TrainerConfig,
                                                    create_train_state)

SCENES = ("chess", "fire", "heads", "office", "pumpkin", "redkitchen",
          "stairs")
MODES = ("netvlad", "shared-trunk")


def load_frames(data_root: str, scene: str, train: bool,
                image_size: int = 256) -> tuple[np.ndarray, np.ndarray]:
    """A split's frames in [0, 1] (not normalised: the service applies
    the scene's normalisation on the device) and their pose6 rows, through
    the loader and resize the graph builder uses."""
    ds = SevenScenes(scene=scene, data_path=data_root, train=train,
                     image_size=image_size)
    imgs, poses = [], []
    for i in range(len(ds)):
        img, pose, _ = ds[i]
        imgs.append(img)
        poses.append(pose)
    return (np.stack(imgs).astype(np.float32),
            np.stack(poses).astype(np.float32))


def scene_row(preds: dict, q_poses: np.ndarray, nbrs: dict) -> dict:
    """One scene's row: per mode the pose errors of its predictions
    (float64) against `q_poses`, and the neighbour overlap of the modes."""
    row = {}
    for mode in MODES:
        err = compute_pose_errors(np.asarray(preds[mode], np.float64),
                                  q_poses)
        row[mode] = {"median_t": round(err.median_t, 4),
                     "median_q": round(err.median_q, 3),
                     "mean_t": round(err.mean_t, 4),
                     "mean_q": round(err.mean_q, 3)}
    k = nbrs["netvlad"].shape[1]
    row["neighbor_overlap"] = round(float(np.mean(
        [len(set(a) & set(b)) / k
         for a, b in zip(nbrs["netvlad"], nbrs["shared-trunk"])])), 4)
    return row


def across_scenes(scenes: dict) -> dict:
    """Each mode's median over the scenes of their median errors."""
    return {m: {"median_t": round(float(np.median(
                    [r[m]["median_t"] for r in scenes.values()])), 4),
                "median_q": round(float(np.median(
                    [r[m]["median_q"] for r in scenes.values()])), 3)}
            for m in MODES}


def load_model(args, device: torch.device):
    """The trained pose model and its step count (None for a file)."""
    ecfg = ExperimentConfig(model_name=args.model_name,
                            backbone=args.backbone, feat_dim=args.feat_dim,
                            seq_len=args.seq_len, knn=args.knn,
                            dtype=args.dtype)
    state = create_train_state(build_model(ecfg, device), TrainerConfig())
    if osp.isdir(args.ckpt):
        ckpt_lib.restore_checkpoint(args.ckpt, state)
        return state.model.eval(), int(state.step)
    ckpt_lib.load_torch_weights(state, args.ckpt)
    return state.model.eval(), None


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True,
                    help="cli.train checkpoint directory (latest epoch) "
                         "or a .pth.tar")
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--stats-root", required=True)
    ap.add_argument("--scenes", default=",".join(SCENES))
    ap.add_argument("--out", required=True)
    ap.add_argument("--db-batch", type=int, default=16)
    ap.add_argument("--model-name", default="R3")
    ap.add_argument("--backbone", default="resnet34")
    ap.add_argument("--feat-dim", type=int, default=0,
                    help="0 = the preset's")
    ap.add_argument("--seq-len", type=int, default=8)
    ap.add_argument("--knn", type=int, default=4)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--image-size", type=int, default=256)
    ap.add_argument("--retrieval-hw", type=int, nargs=2, default=(192, 256))
    ap.add_argument("--netvlad-clusters", type=int, default=64)
    ap.add_argument("--netvlad-checkpoint", default="",
                    help="netvlad_vgg16.tar; empty = seeded weights")
    ap.add_argument("--seed", type=int, default=1,
                    help="the seeded NetVLAD's seed")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' must be asked for")
    args = ap.parse_args(argv)
    pin_full_fp32()
    device = resolve_device(args.device)
    model, step = load_model(args, device)
    print(f"restored step {step} from {args.ckpt}", flush=True)
    netvlad = netvlad_encoder(
        args.netvlad_checkpoint, args.netvlad_clusters,
        torch.bfloat16 if args.dtype == "bfloat16" else None, args.seed)

    results = {"ckpt": args.ckpt, "step": step, "scenes": {},
               "protocol": "serving-path A/B: DB=train frames, "
                           "queries=test frames, deterministic strided "
                           "retrieval, trained R3 GNN on both sides; "
                           "netvlad trunk weights are UNTRAINED (seeded) "
                           "- compare END-TASK medians"}
    for scene in args.scenes.split(","):
        mean, std = (torch.as_tensor(a, device=device)
                     for a in load_scene_stats(args.stats_root, scene))

        def model_norm(x, mean=mean, std=std):
            return (x - mean) / std

        db_imgs, db_poses = load_frames(args.data_root, scene, True,
                                        args.image_size)
        q_imgs, q_poses = load_frames(args.data_root, scene, False,
                                      args.image_size)
        preds, nbrs = {}, {}
        for mode in MODES:
            svc = RelocalizationService(
                model, netvlad if mode == "netvlad" else None,
                ServiceConfig(seq_len=args.seq_len,
                              retrieval_hw=tuple(args.retrieval_hw),
                              retrieval=mode, deterministic=True),
                device=device)
            svc.build(db_imgs, db_poses, model_norm, batch=args.db_batch)
            out = svc.query(q_imgs, model_norm, 0)
            preds[mode] = out["pose"].float().cpu().numpy()
            nbrs[mode] = out["neighbors"].cpu().numpy()
        row = scene_row(preds, q_poses, nbrs)
        for mode in MODES:
            print(f"[{scene}] {mode}: median_t {row[mode]['median_t']:.3f} "
                  f"m  median_q {row[mode]['median_q']:.2f} deg", flush=True)
        print(f"[{scene}] neighbor overlap: {row['neighbor_overlap']}",
              flush=True)
        results["scenes"][scene] = row

    results["across_scenes"] = across_scenes(results["scenes"])
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {args.out}: {json.dumps(results['across_scenes'])}",
          flush=True)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
