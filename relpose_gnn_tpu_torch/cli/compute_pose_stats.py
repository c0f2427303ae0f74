"""Cambridge translation statistics: `python -m
relpose_gnn_tpu_torch.cli.compute_pose_stats --data-path <root> --output
<file>`.

Port of the JAX package's `cli/compute_pose_stats.py` (the reference's
datasets/cambridge_landmark.py:196-230): the training poses of the stats
scenes concatenated through the port's Cambridge loader, the mean and
standard deviation of their translations saved in the two-row format of
the bundled `data/stats/Cambridge/Cambridge_pose_stats.txt`.  Host only.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from relpose_gnn_tpu_torch.data.cambridge import CambridgeLandmark


def main(argv=None) -> tuple[np.ndarray, np.ndarray]:
    p = argparse.ArgumentParser("relpose_gnn_tpu compute_pose_stats")
    p.add_argument("--data-path", type=str, required=True)
    p.add_argument("--output", type=str, required=True)
    p.add_argument("--scenes", nargs="+",
                   default=["ShopFacade", "StMarysChurch", "KingsCollege",
                            "OldHospital"],
                   help="scenes whose train poses define the stats "
                        "(the reference uses these four)")
    args = p.parse_args(argv if argv is not None else sys.argv[1:])

    poses = []
    for scene in args.scenes:
        ds = CambridgeLandmark(scene, args.data_path, train=True,
                               normalize_translation=False)
        poses.append(ds.poses)
        print(f"{scene}: {len(ds)} poses")
    cat = np.concatenate(poses)
    mean_t = cat[:, :3].mean(axis=0)
    std_t = cat[:, :3].std(axis=0)
    np.savetxt(args.output, np.vstack([mean_t, std_t]), fmt="%8.7f")
    print(f"saved {args.output}: mean={mean_t}, std={std_t}")
    return mean_t, std_t


if __name__ == "__main__":
    main()
