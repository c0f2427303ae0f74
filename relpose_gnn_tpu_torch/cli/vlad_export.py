"""VLAD index analysis and export: `python -m
relpose_gnn_tpu_torch.cli.vlad_export --index <index.pkl> --output <file>
--format distances|csv|prj`.

Port of the JAX package's `cli/vlad_export.py` (the reference's
pairwiseDistace.py, VLADtoCSV.py and VLADtoPRJ.py in one command):

  * `--format distances`: the pairwise Euclidean distance matrix of the
    index's descriptors, comma-delimited, in `<output>.txt` (the name the
    reference writes); computed on the device (`--device`, default the
    card) in float32 as |a|^2 + |b|^2 - 2ab from one Gram product at full
    precision (TF32 refused, `require_full_fp32`);
  * `--format csv`: one `imageID,f0,f1,...` row a descriptor;
  * `--format prj`: the DY layout (`DY`, count, dim, `0;1;...;d`, then
    `name.txt;f0;...;fd;0.0` rows), `--scale` min-max scaling each
    feature to [0, 1].

Image IDs come from the index's `<index>.paths.txt` sidecar, else row
numbers.  The same flags as the JAX script, plus `--device`.
"""

from __future__ import annotations

import argparse
import os.path as osp
import sys

import numpy as np
import torch

from relpose_gnn_tpu_torch import require_full_fp32, resolve_device
from relpose_gnn_tpu_torch.cli import add_device_arg, pin_full_fp32
from relpose_gnn_tpu_torch.retrieval.vlad import VLADIndex


def pairwise_euclidean(V: np.ndarray, device=None) -> np.ndarray:
    """All-pairs Euclidean distances [M, M] of the rows of V, float32 on
    `device` (None: the card)."""
    v = torch.as_tensor(np.asarray(V, np.float32), device=resolve_device(
        device))
    require_full_fp32(v)
    g = v @ v.T
    sq = torch.diagonal(g)   # the Gram's own diagonal: d(i, i) is exactly 0
    d2 = torch.clamp_min(sq[:, None] + sq[None, :] - 2.0 * g, 0.0)
    return torch.sqrt(d2).cpu().numpy()


def parse_args(argv):
    p = argparse.ArgumentParser("relpose_gnn_tpu vlad_export")
    p.add_argument("--index", type=str, required=True,
                   help="index pickle from cli/build_vlad_index.py")
    p.add_argument("--output", type=str, required=True)
    p.add_argument("--format", type=str, required=True,
                   choices=("distances", "csv", "prj"))
    p.add_argument("--scale", action="store_true",
                   help="prj only: min-max scale features to [0,1] "
                        "(VLADtoPRJ.py:44-47)")
    add_device_arg(p)
    return p.parse_args(argv)


def main(argv=None) -> str:
    """Write the export; returns its path."""
    args = parse_args(argv if argv is not None else sys.argv[1:])
    pin_full_fp32()
    index = VLADIndex.load(args.index, device="cpu")
    if index.descriptors is None:
        raise ValueError(f"{args.index}: the index has no descriptors")
    V = np.asarray(index.descriptors, np.float64)
    m, d = V.shape
    paths_file = args.index + ".paths.txt"
    if osp.exists(paths_file):
        with open(paths_file) as f:
            ids = [line.strip() for line in f if line.strip()]
        if len(ids) != m:
            raise ValueError(f"{paths_file}: {len(ids)} paths for {m} "
                             "index rows")
    else:
        ids = [str(i) for i in range(m)]

    if args.format == "distances":
        out = (args.output if args.output.endswith(".txt")
               else args.output + ".txt")
        np.savetxt(out, pairwise_euclidean(V, args.device), delimiter=",")
    elif args.format == "csv":
        out = args.output
        with open(out, "w") as f:
            for i in range(m):
                f.write("%s,%s\n" % (ids[i],
                                     ",".join(str(x) for x in V[i])))
    else:  # prj
        out = args.output
        if args.scale:
            lo, hi = V.min(axis=0), V.max(axis=0)
            V = (V - lo) / np.where(hi > lo, hi - lo, 1.0)
        with open(out, "w") as f:
            f.write("DY\n%d\n%d\n" % (m, d))
            f.write(";".join(str(i) for i in range(d + 1)) + "\n")
            for i in range(m):
                f.write("%s;%s;0.0\n" % (
                    str(ids[i]) + ".txt",
                    ";".join(str(x) for x in V[i])))
    print(f"wrote {args.format} export: {out} ({m} x {d})")
    return out


if __name__ == "__main__":
    main()
