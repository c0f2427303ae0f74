"""Synthetic multi-scene raw dataset in the exact 7-Scenes on-disk layout.

    python -m relpose_gnn_tpu_torch.data.synthetic_scenes --root raw \\
        --stats-root stats --scenes chess fire --height 480 --width 640

The port's copy of `relpose_gnn_tpu/data/synthetic_scenes.py`: from the
same seed it writes the same layout, pose files, stats files and pixel
arrays, with PNGs written by the port's own encoder
(`data/image_io.py::encode_png`) where the JAX module uses PIL.  The full
raw-frame path consumes it unchanged: `cli.build_graphs` -> `cli.train`
-> `cli.test`, `cli.serve`, `cli.parity`.  Each frame encodes its own
pose6 as six full-height vertical stripes (the learnable signal of
`data/synthetic.py`).

Layout written per scene (the 7-Scenes loader's parse contract):

    <root>/<scene>/TrainSplit.txt / TestSplit.txt   ("sequenceN" lines)
    <root>/<scene>/seq-NN/frame-%06d.pose.txt       (4x4 camera-to-world)
    <root>/<scene>/seq-NN/frame-%06d.color.png

plus `<stats_root>/<scene>/stats.txt` (mean row, variance row) in the
reference's published-stats format.

Camera trajectories are per-sequence smooth random walks (bounded box,
bounded rotation steps), so kNN graph structure is non-degenerate; poses
stay inside the stripe encoder's dynamic range by construction.
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np

from relpose_gnn_tpu_torch.data.image_io import encode_png
from relpose_gnn_tpu_torch.ops.pose import process_poses

# stripe gains: component value v -> pixel 0.5 + GAIN * v, kept well inside
# [0, 1] for |t| <= 1.6 m and |logq| <= 0.55 rad (trajectory bounds below)
_GAINS = np.array([0.25, 0.25, 0.25, 0.6, 0.6, 0.6])
_NOISE_STD = 0.02  # texture so images aren't piecewise-constant


def _random_walk_poses(rng: np.random.Generator, n: int
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Smooth trajectory: returns (R [n,3,3], t [n,3])."""
    from scipy.spatial.transform import Rotation

    t = np.empty((n, 3))
    t[0] = rng.uniform(-1.0, 1.0, 3)
    R = [Rotation.from_rotvec(rng.uniform(-0.4, 0.4, 3))]
    for i in range(1, n):
        step = rng.normal(scale=0.08, size=3)
        t[i] = np.clip(t[i - 1] + step, -1.5, 1.5)
        dR = Rotation.from_rotvec(rng.normal(scale=0.05, size=3))
        R.append(dR * R[i - 1])
        # keep the total rotation inside the logq encoding range
        if np.linalg.norm(R[i].as_rotvec()) > 1.0:  # logq = rotvec/2
            R[i] = R[i - 1]
    return np.stack([r.as_matrix() for r in R]), t


def _encode_image(pose6: np.ndarray, h: int, w: int,
                  rng: np.random.Generator) -> np.ndarray:
    img = 0.5 + rng.normal(scale=_NOISE_STD, size=(h, w, 3))
    w6 = w // 6
    for c in range(6):
        img[:, c * w6:(c + 1) * w6, :] = 0.5 + _GAINS[c] * pose6[c]
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def generate_scene(root: str, scene: str, *, n_train_seqs: int = 2,
                   n_test_seqs: int = 1, frames_per_seq: int = 32,
                   height: int = 256, width: int = 341,
                   seed: int = 0, stats_root: str | None = None) -> dict:
    """Write one scene; returns {'mean': .., 'var': ..} of the images."""
    rng = np.random.default_rng(seed)
    base = osp.join(root, scene)
    os.makedirs(base, exist_ok=True)
    n_seqs = n_train_seqs + n_test_seqs
    with open(osp.join(base, "TrainSplit.txt"), "w") as f:
        f.writelines(f"sequence{s}\n" for s in range(1, n_train_seqs + 1))
    with open(osp.join(base, "TestSplit.txt"), "w") as f:
        f.writelines(f"sequence{s}\n"
                     for s in range(n_train_seqs + 1, n_seqs + 1))

    px_sum = np.zeros(3)
    px_sq = np.zeros(3)
    n_px = 0
    for s in range(1, n_seqs + 1):
        seq_dir = osp.join(base, f"seq-{s:02d}")
        os.makedirs(seq_dir, exist_ok=True)
        R, t = _random_walk_poses(rng, frames_per_seq)
        raw = np.concatenate([R, t[:, :, None]],
                             axis=2).reshape(frames_per_seq, 12)
        # the SAME pose6 the loader will derive (ops/pose.py) is what the
        # image encodes: no convention skew between pixels and targets
        pose6 = process_poses(raw, np.zeros(3), np.ones(3), np.eye(3),
                              np.zeros(3), 1.0)
        for i in range(frames_per_seq):
            P = np.eye(4)
            P[:3, :3] = R[i]
            P[:3, 3] = t[i]
            np.savetxt(osp.join(seq_dir, f"frame-{i:06d}.pose.txt"), P)
            img = _encode_image(pose6[i], height, width, rng)
            encode_png(osp.join(seq_dir, f"frame-{i:06d}.color.png"),
                       (img * 255 + 0.5).astype(np.uint8))
            px_sum += img.reshape(-1, 3).sum(0)
            px_sq += (img.reshape(-1, 3) ** 2).sum(0)
            n_px += img.shape[0] * img.shape[1]

    mean = px_sum / n_px
    var = px_sq / n_px - mean ** 2
    if stats_root is not None:
        sdir = osp.join(stats_root, scene)
        os.makedirs(sdir, exist_ok=True)
        np.savetxt(osp.join(sdir, "stats.txt"), np.stack([mean, var]))
    return {"mean": mean, "var": var}


def generate_dataset(root: str, scenes, stats_root: str, *,
                     n_train_seqs: int = 2, n_test_seqs: int = 1,
                     frames_per_seq: int = 32, height: int = 256,
                     width: int = 341, seed: int = 0) -> None:
    for k, scene in enumerate(scenes):
        generate_scene(root, scene, n_train_seqs=n_train_seqs,
                       n_test_seqs=n_test_seqs,
                       frames_per_seq=frames_per_seq, height=height,
                       width=width, seed=seed * 1000 + k,
                       stats_root=stats_root)


def main(argv=None):
    import argparse

    from relpose_gnn_tpu_torch.data.seven_scenes import SEVEN_SCENES

    p = argparse.ArgumentParser("synthetic 7-Scenes-layout generator")
    p.add_argument("--root", required=True)
    p.add_argument("--stats-root", required=True)
    p.add_argument("--scenes", nargs="*", default=list(SEVEN_SCENES))
    p.add_argument("--train-seqs", type=int, default=2)
    p.add_argument("--test-seqs", type=int, default=1)
    p.add_argument("--frames-per-seq", type=int, default=32)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=341)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    generate_dataset(args.root, args.scenes, args.stats_root,
                     n_train_seqs=args.train_seqs,
                     n_test_seqs=args.test_seqs,
                     frames_per_seq=args.frames_per_seq,
                     height=args.height, width=args.width, seed=args.seed)
    print(f"wrote {len(args.scenes)} scenes under {args.root}")


if __name__ == "__main__":
    main()
