"""Evaluation entry point: `python -m relpose_gnn_tpu_torch.cli.test`.

Port of the JAX package's `cli/test.py` (the reference's
testing/test.py:289-317 argparse surface): load a checkpoint, evaluate per
scene, export npz predictions with the median errors in the filename.  The
same flags, defaults and choices, plus `--device`.  `--weights-filename`
takes a reference `.pth.tar` or a checkpoint directory of `cli.train`
(its latest epoch); the JAX package's Orbax directories are refused.
`--mesh-data N` splits every eval batch over N processes, one per device,
started by `torchrun --nproc-per-node N` (cli/__init__.py).
"""

from __future__ import annotations

import argparse
import sys

from relpose_gnn_tpu_torch.cli import (add_device_arg, end_processes,
                                       pin_full_fp32, refuse_unported,
                                       start_processes)
from relpose_gnn_tpu_torch.training.experiment import (ExperimentConfig,
                                                       run_eval)


def parse_args(argv):
    p = argparse.ArgumentParser("relpose_gnn_tpu test")
    p.add_argument("--dataset", type=str, default="7Scenes",
                   choices=("7Scenes", "Cambridge"))
    p.add_argument("--test-scene", type=str, default="multi")
    p.add_argument("--test-data-dir", type=str, required=True)
    p.add_argument("--save-dir", type=str, default="outputs")
    p.add_argument("--weights-filename", type=str, required=True,
                   help=".pth.tar or a checkpoint directory of cli.train")
    p.add_argument("--pose-stat-path", type=str, default="")
    p.add_argument("--model-name", type=str, default="R3")
    p.add_argument("--batch-size", type=int, default=64,
                   help="eval batch (the reference is fixed at 1)")
    p.add_argument("--serving-data-path", type=str, default=None,
                   help="raw dataset root; enables the cached-embedding "
                        "serving path when graph stores carry nbr_idx")
    p.add_argument("--allow-random-init", action="store_true",
                   help="evaluate RANDOM-INIT weights when the weights "
                        "path is missing (smoke mode); without this a bad "
                        "path is a hard error")
    p.add_argument("--dense-edges", action="store_true",
                   help="serving path only: use the dense N x N GNN grid "
                        "instead of the (exact, faster) compact edge list")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--knn", default=4, type=int)
    p.add_argument("--dtype", default="bfloat16",
                   choices=("bfloat16", "float32"))
    p.add_argument("--seq-len", type=int, default=8,
                   help="graph size; selects the <scene>_fc{N}_... stores")
    p.add_argument("--backbone", default="resnet34",
                   choices=("resnet34", "resnet18", "vit"))
    p.add_argument("--feat-dim", type=int, default=0,
                   help="override feat/edge/node dims (0 = preset default)")
    p.add_argument("--gnn-recursion", type=int, default=2)
    p.add_argument("--fuse", type=str, default="first",
                   choices=("first", "mean", "median"),
                   help="absolute-pose recovery: 'first' = reference "
                        "protocol (one relative pose from the anchor "
                        "neighbor); 'mean'/'median' fuse ALL incoming "
                        "edge estimates")
    p.add_argument("--mesh-data", type=int, default=0,
                   help=">0: split each eval batch over this many ranks "
                        "(one process per device)")
    p.add_argument("--mesh-model", type=int, default=1,
                   help="tensor-parallel axis: the GNN MLPs split over "
                        "this many ranks")
    add_device_arg(p)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Evaluate; returns run_eval's {scene: PoseErrors}."""
    args = parse_args(argv if argv is not None else sys.argv[1:])
    pin_full_fp32()
    refuse_unported(args)
    started = start_processes(args)
    try:
        results = _run(args)
    finally:
        end_processes(started)
    for scene, err in results.items():
        print(f"{scene}: median t {err.median_t:.3f} m, "
              f"median rot {err.median_q:.2f} deg")
    return results


def _run(args) -> dict:
    cfg = ExperimentConfig(
        dataset=args.dataset, test_scene=args.test_scene,
        train_data_dir=args.test_data_dir,
        test_data_dir=args.test_data_dir, save_dir=args.save_dir,
        exp_name="eval", model_name=args.model_name,
        batch_size=args.batch_size, seed=args.seed, knn=args.knn,
        weights_filename=args.weights_filename,
        allow_random_init=args.allow_random_init,
        pose_stats_file=args.pose_stat_path, dtype=args.dtype,
        seq_len=args.seq_len, backbone=args.backbone,
        feat_dim=args.feat_dim, gnn_recursion=args.gnn_recursion,
        serving_compact_edges=not args.dense_edges,
        eval_fuse=args.fuse,
        mesh_data=args.mesh_data, mesh_model=args.mesh_model,
        experiment=2, train_scene=args.test_scene)
    return run_eval(cfg, serving_data_path=args.serving_data_path,
                    device=args.device)


if __name__ == "__main__":
    main()
