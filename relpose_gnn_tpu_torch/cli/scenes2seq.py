"""7-Scenes sequence metadata: `python -m relpose_gnn_tpu_torch.cli.scenes2seq
<scene dir> [--dst-dir <dir>]`.

Port of the JAX package's `cli/scenes2seq.py` (the reference's
scenes2seq.py:109-216, its README's preprocessing step): for one scene
directory, each sequence's `seq.json`, `K.txt` and TUM `rgb.txt`,
`depth.txt` and `groundtruth.txt`, then the split-concatenated
`train_frames.bin` / `test_frames.bin` pickles
(`data/sequences.py::scenes_to_sequences`).  The same arguments as the
JAX script, plus `--device` (default: the CUDA card; `cpu` must be asked
for), where the trajectories' quaternions are taken; the same files byte
for byte.
"""

from __future__ import annotations

import argparse
import sys

from relpose_gnn_tpu_torch.cli import add_device_arg, pin_full_fp32
from relpose_gnn_tpu_torch.data.sequences import scenes_to_sequences


def parse_args(argv):
    p = argparse.ArgumentParser("relpose_gnn_tpu scenes2seq")
    p.add_argument("seq_dir", help="scene directory (contains seq-NN/, "
                                   "TrainSplit.txt, TestSplit.txt)")
    p.add_argument("--dst-dir", default=None,
                   help="output directory (default: in place)")
    add_device_arg(p)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Write the metadata; returns {split: frames.bin path}."""
    args = parse_args(argv if argv is not None else sys.argv[1:])
    pin_full_fp32()
    out = scenes_to_sequences(args.seq_dir, args.dst_dir, args.device)
    for split, path in out.items():
        print(f"{split}: {path}")
    return out


if __name__ == "__main__":
    main()
