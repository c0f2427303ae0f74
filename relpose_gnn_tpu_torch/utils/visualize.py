"""Trajectory plots (matplotlib, Agg backend).

Port of `relpose_gnn_tpu/utils/visualize.py` (the reference's `visulize`
helper, datasets/seven_scenes.py:177-202): predicted against target
camera positions, 3-D for 7-Scenes and 2-D for Cambridge, with connecting
segments, saved to a file.  A host call into matplotlib, imported when
called (the card's machine has none: there it raises ImportError).
"""

from __future__ import annotations

import numpy as np
import torch


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def plot_trajectories(pred_poses, targ_poses, out_path: str,
                      three_d: bool = True, freq: int = 1000) -> str:
    """pred / targ [L, >=3] pose arrays or tensors (translations in the
    first 3 columns); at most about `freq` of them drawn.  Returns
    out_path."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pred_poses, targ_poses = _host(pred_poses), _host(targ_poses)
    stride = max(1, len(pred_poses) // freq)
    p = pred_poses[::stride, :3]
    t = targ_poses[::stride, :3]

    fig = plt.figure(figsize=(8, 8))
    if three_d:
        ax = fig.add_subplot(111, projection="3d")
        for a, b in zip(p, t):
            ax.plot([a[0], b[0]], [a[1], b[1]], zs=[a[2], b[2]], c="b",
                    linewidth=0.5)
        ax.scatter(p[:, 0], p[:, 1], zs=p[:, 2], c="r", s=4,
                   label="predicted")
        ax.scatter(t[:, 0], t[:, 1], zs=t[:, 2], c="g", s=4, label="target")
        ax.view_init(azim=119, elev=13)
    else:
        ax = fig.add_subplot(111)
        ax.scatter(p[:, 0], p[:, 1], c="r", s=4, label="predicted")
        ax.scatter(t[:, 0], t[:, 1], c="g", s=4, label="target")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
