"""Classical VLAD index (the Cambridge retrieval): `python -m
relpose_gnn_tpu_torch.cli.build_vlad_index --image-glob '<glob>' --output
<index.pkl>`.

Port of the JAX package's `cli/build_vlad_index.py` (the reference's
describe.py, visualDictionary.py, vladDescriptors.py and indexBallTree.py
in one command): ORB descriptors of every image matched by the glob
(sorted; frames decoded by the port's PNG library, `data/transforms.py::
load_rgb`), the KMeans visual dictionary, every image's VLAD vector
aggregated on the device (`--device`, default the card), and the index
pickle with its `<output>.paths.txt` sidecar (one path a row, the
images ORB found no keypoint in left out), which `cli.build_graphs
--retrieval vlad` joins to the dataset's order.  The same flags as the
JAX script, plus `--device`.  ORB needs OpenCV and the dictionary
scikit-learn, on the host.
"""

from __future__ import annotations

import argparse
import glob
import sys

import numpy as np

from relpose_gnn_tpu_torch.cli import add_device_arg, pin_full_fp32
from relpose_gnn_tpu_torch.data.transforms import load_rgb
from relpose_gnn_tpu_torch.retrieval.vlad import (VLADIndex,
                                                  fit_visual_dictionary,
                                                  orb_descriptors)


def parse_args(argv):
    p = argparse.ArgumentParser("relpose_gnn_tpu build_vlad_index")
    p.add_argument("--image-glob", type=str, required=True,
                   help="e.g. '/data/Cambridge/ShopFacade/seq*/*.png'")
    p.add_argument("--output", type=str, required=True,
                   help="output index pickle path")
    p.add_argument("--clusters", type=int, default=16,
                   help="visual dictionary size (reference default: 16)")
    p.add_argument("--orb-features", type=int, default=500)
    p.add_argument("--seed", type=int, default=0)
    add_device_arg(p)
    return p.parse_args(argv)


def main(argv=None) -> VLADIndex:
    """Build and save the index; returns it."""
    args = parse_args(argv if argv is not None else sys.argv[1:])
    pin_full_fp32()
    paths = sorted(glob.glob(args.image_glob))
    if not paths:
        raise FileNotFoundError(f"no images match {args.image_glob}")
    per_image, kept_paths = [], []
    for path in paths:
        img = load_rgb(path)
        if img is None:
            raise ValueError(f"{path}: not a readable PNG")
        desc = orb_descriptors(img, args.orb_features)
        if desc is None or len(desc) == 0:
            print(f"no ORB features: {path} (skipped)")
            continue
        per_image.append(np.asarray(desc, np.float32))
        kept_paths.append(path)

    all_desc = np.concatenate(per_image)
    print(f"{len(kept_paths)} images, {len(all_desc)} descriptors; "
          f"fitting {args.clusters}-word dictionary...")
    centers = fit_visual_dictionary(all_desc, args.clusters, args.seed)
    index = VLADIndex(centers, device=args.device)
    index.build(per_image)
    index.save(args.output)
    with open(args.output + ".paths.txt", "w") as f:
        f.write("\n".join(kept_paths))
    print(f"index saved: {args.output} ({len(kept_paths)} entries)")
    return index


if __name__ == "__main__":
    main()
