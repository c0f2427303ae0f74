"""Graph-construction entry point:
`python -m relpose_gnn_tpu_torch.cli.build_graphs <scene> <train|test>`.

Port of the JAX package's `cli/build_graphs.py` (the reference's
`dataset_7Scenes_multi.py` / `dataset_Cambridge_multi.py` mains): the same
flags, positional `scene mode` arguments, store names
(`<scene>_fc<seq>_sp<sp>_<mode>`) and widths (341 for 7-Scenes' 640x480,
455 for Cambridge's 1920x1080), plus `--device`.  Frames decode and resize
on the host with the port's own PNG library (`data/image_io.py`).

IR retrieval takes one of two descriptor engines, as the JAX script does:
  * NetVLAD (`--retrieval netvlad`, and `auto` on 7-Scenes): every frame
    embedded with the port's `NetVLADIndex` on the card (VGG16 + NetVLAD,
    `--netvlad-checkpoint` in the released `netvlad_vgg16.tar` layout,
    else seeded random weights) after the reference's NetVLAD geometry on
    the host (`crop_by_intrinsic` from the RGB to the depth intrinsics,
    then 192x256), the database ranked by cosine similarity there in
    float32;
  * classical ORB-VLAD (`--retrieval vlad`, and `auto` on Cambridge): the
    `--vlad-index` pickle of `cli.build_vlad_index` (either package's),
    its rows joined to the database's order by path through the
    `.paths.txt` sidecar (frames without a row are never retrieved), each
    query's ORB descriptors (OpenCV, on the host) aggregated and ranked
    against the table on the device in float32.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from relpose_gnn_tpu_torch import resolve_device
from relpose_gnn_tpu_torch.cli import (add_device_arg, netvlad_encoder,
                                       pin_full_fp32)
from relpose_gnn_tpu_torch.data.cambridge import (CAMBRIDGE_SCENES,
                                                  CambridgeLandmark)
from relpose_gnn_tpu_torch.data.graph_builder import (GraphBuilderConfig,
                                                      build_graphs,
                                                      self_exclusion_mask)
from relpose_gnn_tpu_torch.data.image_io import decode_png
from relpose_gnn_tpu_torch.data.seven_scenes import (SEVEN_SCENES,
                                                     SevenScenes,
                                                     load_scene_stats)
from relpose_gnn_tpu_torch.data.transforms import load_rgb
from relpose_gnn_tpu_torch.retrieval.netvlad_index import (
    NetVLADIndex, netvlad_preprocess_7scenes)
from relpose_gnn_tpu_torch.retrieval.vlad import VLADIndex, orb_descriptors

EMBED_CHUNK = 256   # frames preprocessed at a time (a multiple of 16)
PREP_THREADS = max(1, min(8, os.cpu_count() or 1))


def parse_args(argv):
    p = argparse.ArgumentParser("relpose_gnn_tpu build_graphs")
    p.add_argument("scene_name", type=str)
    p.add_argument("mode", type=str, choices=("train", "test"))
    p.add_argument("--dataset", type=str, default="7Scenes",
                   choices=("7Scenes", "Cambridge"))
    p.add_argument("--data-path", type=str, required=True,
                   help="raw dataset root")
    p.add_argument("--graph-data-path", type=str, required=True,
                   help="output root for packed graph stores")
    p.add_argument("--stats-path", type=str, default="",
                   help="7-Scenes per-scene stats dir (data/7scenes)")
    p.add_argument("--pose-stat-path", type=str, default="",
                   help="Cambridge translation stats file")
    p.add_argument("--seq-len", type=int, default=8)
    p.add_argument("--sampling-period", "--sp", dest="sampling_period",
                   type=int, default=None)
    p.add_argument("--sampling-method", type=str, default="IR",
                   choices=("IR", "RAND"))
    p.add_argument("--cross-connect", action="store_true")
    p.add_argument("--netvlad-checkpoint", type=str, default="")
    p.add_argument("--retrieval", type=str, default="auto",
                   choices=("auto", "netvlad", "vlad"),
                   help="descriptor engine: auto = NetVLAD for 7-Scenes, "
                        "classical ORB-VLAD for Cambridge (reference "
                        "behavior); 'netvlad' unifies both datasets on the "
                        "NetVLAD path (SURVEY.md §7 parity knob)")
    p.add_argument("--vlad-index", type=str, default="")
    p.add_argument("--seed", type=int, default=0)
    add_device_arg(p)
    return p.parse_args(argv)


def use_netvlad_for(retrieval: str, dataset: str) -> bool:
    """Reference behaviour: NetVLAD for 7-Scenes, classical ORB-VLAD for
    Cambridge; 'netvlad' overrides."""
    return retrieval == "netvlad" or (retrieval == "auto"
                                      and dataset == "7Scenes")


def main(argv=None) -> int:
    """Build the stores; returns how many graphs were written."""
    args = parse_args(argv if argv is not None else sys.argv[1:])
    pin_full_fp32()
    if args.sampling_period is None:
        args.sampling_period = 3 if args.dataset == "Cambridge" else 5
    device = resolve_device(args.device)

    if args.scene_name == "multi":
        scenes = (SEVEN_SCENES if args.dataset == "7Scenes"
                  else CAMBRIDGE_SCENES)
    else:
        scenes = (args.scene_name,)

    train = args.mode == "train"
    encoder = None
    total = 0
    for scene in scenes:
        # the builder's datasets load raw [0, 1] pixels; the scene's
        # normalisation statistics go into the store's header and apply
        # on the device
        if args.dataset == "7Scenes":
            mean, std = load_scene_stats(args.stats_path or None, scene)
            query = SevenScenes(scene, args.data_path, train=train)
            database = (query if train else
                        SevenScenes(scene, args.data_path, train=True))
            width = 341  # 640x480 -> Resize(256)
        else:
            query = CambridgeLandmark(
                scene, args.data_path, train=train,
                pose_stats_file=args.pose_stat_path, color_jitter=train,
                normalize_images=False)
            database = (query if train else CambridgeLandmark(
                scene, args.data_path, train=True,
                pose_stats_file=args.pose_stat_path, color_jitter=train,
                normalize_images=False))
            mean, std = query.mean, query.std  # Normalize(0.5, 0.25)
            width = 455  # 1920x1080 -> Resize(256)

        sim_fn = invalid_fn = None
        if args.sampling_method == "IR" and not use_netvlad_for(
                args.retrieval, args.dataset):
            sim_fn, invalid_fn = _vlad_retrieval_fns(args, scene, device,
                                                     query, database)
        elif args.sampling_method == "IR":
            if encoder is None:
                encoder = netvlad_encoder(args.netvlad_checkpoint)
            sim_fn, invalid_fn = _retrieval_fns(args, scene, encoder, device,
                                                query, database)

        out = osp.join(
            args.graph_data_path,
            f"{scene}_fc{args.seq_len}_sp{args.sampling_period}_"
            f"{args.mode}")
        cfg = GraphBuilderConfig(
            seq_len=args.seq_len, sampling_period=args.sampling_period,
            retrieval_mode=args.sampling_method,
            cross_connect=args.cross_connect,
            database_is_query_set=train, seed=args.seed)
        n = build_graphs(query, database, out, cfg, similarity_fn=sim_fn,
                         invalid_fn=invalid_fn, mean=mean, std=std,
                         width=width)
        print(f"{scene}: wrote {n} graphs -> {out}")
        total += n
    print(f"total graphs: {total}")
    return total


def _read_frame01(path: str) -> np.ndarray:
    """A raw colour frame as float32 [H, W, 3] in [0, 1]; a missing file
    raises (the retrieval pass skips nothing)."""
    img = decode_png(path)
    if img is None:
        raise FileNotFoundError(path)
    return img.astype(np.float32) / 255.0


def _netvlad_input(path: str) -> np.ndarray:
    return netvlad_preprocess_7scenes(_read_frame01(path))


def preprocessed_chunks(paths: list):
    """Raw frames in the reference's NetVLAD geometry
    (`netvlad_preprocess_7scenes`), EMBED_CHUNK at a time, prepared on
    PREP_THREADS threads (inflate and the resize run outside the
    interpreter lock)."""
    with ThreadPoolExecutor(PREP_THREADS) as pool:
        for i in range(0, len(paths), EMBED_CHUNK):
            yield np.stack(list(pool.map(_netvlad_input,
                                         paths[i:i + EMBED_CHUNK])))


def _retrieval_fns(args, scene, encoder, device, query_ds, database_ds):
    """(similarity_fn, invalid_fn) for IR mode: the database embedded
    into a `NetVLADIndex` on the device, every query's similarities in
    one float32 product there."""
    db_is_q = args.mode == "train"
    index = NetVLADIndex(encoder, device=device)
    for chunk in preprocessed_chunks(database_ds.c_imgs):
        index.add(chunk)
    q_desc = (index.descriptors.cpu().numpy() if db_is_q
              else np.concatenate([index.embed(chunk) for chunk in
                                   preprocessed_chunks(query_ds.c_imgs)]))
    sim = index.similarities(q_desc)
    return (lambda qi: sim[qi]), _invalid_fn(args, scene, query_ds,
                                             database_ds)


def _invalid_fn(args, scene, query_ds, database_ds, extra_invalid=None):
    """The IR exclusion mask of a query: itself where the database is the
    query set, under cross-connect its whole source sequence (by the
    datasets' per-frame seq_id; the reference skips the exclusion for
    'heads', whose single training sequence would leave no candidates,
    dataset_7Scenes_multi.py:247), and `extra_invalid` (database frames
    without a VLAD index row)."""
    n_db = len(database_ds)
    db_is_q = args.mode == "train"
    cross = args.cross_connect and db_is_q and scene != "heads"

    def invalid_fn(qi):
        mask = self_exclusion_mask(
            n_db, qi, db_is_q, cross_connect=cross,
            seq_ids=database_ds.seq_id if cross else None,
            query_seq=int(query_ds.seq_id[qi]) if cross else None)
        if extra_invalid is not None:
            mask |= extra_invalid
        return mask

    return invalid_fn


def _align_vlad_index(index: VLADIndex, index_path: str, database_ds):
    """The VLAD table's rows in the database's frame order, joined on
    '<seqdir>/<filename>' path suffixes through `<index>.paths.txt` (the
    index comes from sorted(glob) less ORB failures, the dataset from its
    split file less outlier poses: the two orders differ on real data).
    Returns (descriptors [n_db, K*D] float32, missing [n_db] bool: frames
    without a row, masked invalid).  An index without the sidecar must
    have the dataset's length and order."""
    n_db = len(database_ds)
    desc = index.descriptors
    missing = np.zeros(n_db, bool)
    paths_file = index_path + ".paths.txt"

    def key(p):
        parts = p.replace("\\", "/").rstrip("/").split("/")
        return "/".join(parts[-2:])

    if osp.isfile(paths_file):
        with open(paths_file) as f:
            idx_paths = [ln.strip() for ln in f if ln.strip()]
        if len(idx_paths) != len(desc):
            raise ValueError(
                f"{paths_file}: {len(idx_paths)} paths vs "
                f"{len(desc)} index rows — stale index?")
        row_by_key = {key(p): r for r, p in enumerate(idx_paths)}
        aligned = np.zeros((n_db, desc.shape[1]), desc.dtype)
        for i in range(n_db):
            r = row_by_key.get(key(database_ds.c_imgs[i]))
            if r is None:
                missing[i] = True
            else:
                aligned[i] = desc[r]
        if missing.any():
            print(f"WARNING: {int(missing.sum())}/{n_db} database frames "
                  f"have no VLAD index row (no ORB features at build "
                  f"time?); they will never be retrieved")
        return aligned, missing
    if len(desc) != n_db:
        raise ValueError(
            f"VLAD index has {len(desc)} rows but the database split has "
            f"{n_db} frames and {paths_file} is missing — rebuild the "
            f"index with cli/build_vlad_index.py (writes the path list "
            f"used to align the two orders)")
    print(f"WARNING: {paths_file} missing; assuming index row order == "
          f"dataset_train.txt order")
    return desc, missing


def _vlad_retrieval_fns(args, scene, device, query_ds, database_ds):
    """(similarity_fn, invalid_fn) for IR mode on classical ORB-VLAD: the
    index's table joined to the database's order and put on the device,
    every
    query's ORB descriptors aggregated there, EMBED_CHUNK at a time, and
    ranked in float32; a query without ORB features ranks the database
    by similarity 0 everywhere, as the JAX script's does."""
    index = VLADIndex.load(args.vlad_index, device="cpu")
    aligned, missing = _align_vlad_index(index, args.vlad_index, database_ds)
    table = VLADIndex(index.centers, aligned, device=device)
    descs = []
    for path in query_ds.c_imgs:
        img = load_rgb(path)
        if img is None:
            raise ValueError(f"{path}: not a readable PNG")
        descs.append(orb_descriptors(img))
    found = [i for i, d in enumerate(descs) if d is not None]
    sim = np.zeros((len(descs), len(aligned)), np.float32)
    for i in range(0, len(found), EMBED_CHUNK):
        rows = found[i:i + EMBED_CHUNK]
        q = table.describe_batch([np.asarray(descs[r], np.float32)
                                  for r in rows])
        sim[rows] = table.similarities(q).cpu().numpy()
    return (lambda qi: sim[qi]), _invalid_fn(
        args, scene, query_ds, database_ds,
        missing if missing.any() else None)


if __name__ == "__main__":
    main()
