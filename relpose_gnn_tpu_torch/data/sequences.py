"""Sequence metadata: frame lists with poses and intrinsics, and the
7-Scenes sequence preparation.

The port's own copy of `relpose_gnn_tpu/data/sequences.py` (the
reference's vendored sequence tooling, SURVEY.md section 2.2 E3):
  * `FrameSeq`, the JSON frame-list container (`FrameSeqData`): each
    frame a dict with `id`, `file_name`, `extrinsic_Tcw` (3x4
    world->camera), `camera_intrinsic` (fx, fy, cx, cy, k1, k2),
    `frame_dim` (h, w), `timestamp`, optional `depth_file_name`;
  * `scenes_to_sequences`, the `scenes2seq.py` pipeline: walk a raw
    7-Scenes scene's `seq-NN` directories, invert the camera-to-world
    pose files to Tcw, write each sequence's `seq.json`, `K.txt` and TUM
    `rgb.txt` / `depth.txt` / `groundtruth.txt`, and dump the
    split-concatenated `train_frames.bin` / `test_frames.bin` pickles;
  * the TUM exports and readers, and `load_frames_bin`.

Host code (numpy, json, pickle) but for the quaternions of the TUM
exports: every frame's camera-to-world rotation goes through one call of
the port's `ops/pose.py::mat2quat` in float32 on `device` (None: the
card), as the JAX module takes them from its own in float32 on its
default device.  `mat2quat` is elementwise IEEE arithmetic (its square
roots and its norm's fused multiply-adds rounded exactly), so the card
and the CPU give the same bits, and every file is the JAX module's byte
for byte.  Kinect defaults as scenes2seq.py:69: depth
intrinsics (585, 585, 320, 240), frame dim (480, 640).
"""

from __future__ import annotations

import glob
import json
import os
import os.path as osp
import pickle

import numpy as np
import torch

from relpose_gnn_tpu_torch import resolve_device
from relpose_gnn_tpu_torch.ops import pose as pose_ops

SEVEN_SCENES_INTRINSIC = (585.0, 585.0, 320.0, 240.0, 0.0, 0.0)
SEVEN_SCENES_DIM = (480, 640)


def K_from_frame(frame: dict) -> np.ndarray:
    fx, fy, cx, cy = frame["camera_intrinsic"][:4]
    return np.asarray([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)


class FrameSeq:
    """Ordered frame-metadata collection with JSON round-trip."""

    def __init__(self, json_path: str | None = None):
        self.frames: list[dict] = []
        if json_path is not None:
            self.load_json(json_path)

    def __len__(self) -> int:
        return len(self.frames)

    def append_frame(self, frame_idx: int, img_file_name: str,
                     Tcw: np.ndarray, camera_intrinsic, frame_dim,
                     timestamp: float = 0.0,
                     depth_file_name: str | None = None) -> None:
        self.frames.append({
            "id": int(frame_idx),
            "file_name": img_file_name,
            "extrinsic_Tcw": np.asarray(Tcw, np.float32)[:3, :4],
            "camera_intrinsic": np.asarray(camera_intrinsic, np.float32),
            "frame_dim": tuple(frame_dim),
            "timestamp": float(timestamp),
            "depth_file_name": depth_file_name,
        })

    def sort_by_frame_idx(self) -> None:
        self.frames.sort(key=lambda f: f["id"])

    def dump_json(self, path: str) -> None:
        ser = []
        for f in self.frames:
            g = dict(f)
            g["extrinsic_Tcw"] = np.asarray(f["extrinsic_Tcw"]).tolist()
            g["camera_intrinsic"] = np.asarray(
                f["camera_intrinsic"]).tolist()
            ser.append(g)
        with open(path, "w") as fh:
            json.dump(ser, fh)

    def load_json(self, path: str) -> None:
        with open(path) as fh:
            ser = json.load(fh)
        self.frames = []
        for g in ser:
            g = dict(g)
            g["extrinsic_Tcw"] = np.asarray(g["extrinsic_Tcw"], np.float32)
            g["camera_intrinsic"] = np.asarray(g["camera_intrinsic"],
                                               np.float32)
            g["frame_dim"] = tuple(g["frame_dim"])
            self.frames.append(g)


def scene_to_frame_seq(scene_root: str, seq_name: str,
                       rel_root: str | None = None) -> FrameSeq:
    """One `seq-NN` directory -> FrameSeq with inverted (Tcw) poses
    (scenes2ares, scenes2seq.py:49-106).  Pose files are camera-to-world;
    Tcw = [R^T | -R^T t]."""
    seq_dir = osp.join(scene_root, seq_name)
    rgb_dir = seq_dir if osp.isfile(
        osp.join(seq_dir, "frame-000000.color.png")) else osp.join(seq_dir,
                                                                   "rgb")
    pose_dir = seq_dir if rgb_dir == seq_dir else osp.join(seq_dir, "poses")
    depth_dir = seq_dir if rgb_dir == seq_dir else osp.join(seq_dir, "depth")
    rel_root = rel_root or osp.dirname(scene_root.rstrip("/"))

    seq = FrameSeq()
    frames = sorted(glob.glob(osp.join(rgb_dir, "*.color.png")),
                    key=lambda p: int(
                        osp.basename(p).split(".")[0].split("-")[1]))
    for idx, rgb_path in enumerate(frames):
        name = osp.basename(rgb_path).split(".")[0]
        Twc = np.loadtxt(osp.join(pose_dir, f"{name}.pose.txt")) \
            .astype(np.float32).reshape(4, 4)
        R, t = Twc[:3, :3], Twc[:3, 3]
        Tcw = np.concatenate([R.T, (-R.T @ t)[:, None]], axis=1)
        seq.append_frame(
            frame_idx=idx,
            img_file_name=osp.relpath(rgb_path, rel_root),
            Tcw=Tcw,
            camera_intrinsic=SEVEN_SCENES_INTRINSIC,
            frame_dim=SEVEN_SCENES_DIM,
            timestamp=float(name.split("-")[1]),
            depth_file_name=osp.relpath(
                osp.join(depth_dir, f"{name}.depth.png"), rel_root))
    return seq


def scenes_to_sequences(scene_root: str, dst_dir: str | None = None,
                        device=None) -> dict:
    """Full scenes2seq pipeline for one scene directory: per-seq `seq.json`
    + `K.txt`, then split-concatenated `train_frames.bin` /
    `test_frames.bin` pickles (scenes2seq.py:109-216).  The trajectories'
    quaternions are taken on `device` (None: the card)."""
    dst_dir = dst_dir or scene_root
    os.makedirs(dst_dir, exist_ok=True)

    seq_dirs = sorted(d for d in glob.glob(osp.join(scene_root, "seq*"))
                      if osp.isdir(d))
    per_seq: dict[str, FrameSeq] = {}
    for seq_dir in seq_dirs:
        seq_name = osp.basename(seq_dir)
        seq = scene_to_frame_seq(scene_root, seq_name)
        if not len(seq):
            continue
        out = osp.join(dst_dir, seq_name)
        os.makedirs(out, exist_ok=True)
        seq.dump_json(osp.join(out, "seq.json"))
        np.savetxt(osp.join(out, "K.txt"), K_from_frame(seq.frames[0]))
        export_tum_img_info(seq, osp.join(out, "rgb.txt"),
                            osp.join(out, "depth.txt"))
        export_tum_trajectory(seq, osp.join(out, "groundtruth.txt"),
                              device)
        per_seq[seq_name] = seq

    def split_ids(split_file):
        path = osp.join(scene_root, split_file)
        if not osp.isfile(path):  # tolerate missing split (ref. crashes)
            return []
        with open(path) as f:
            return [int(line.split("sequence")[1].strip()) for line in f
                    if not line.startswith("#")]

    out_paths = {}
    for split, split_file in (("train", "TrainSplit.txt"),
                              ("test", "TestSplit.txt")):
        frames = []
        for sid in split_ids(split_file):
            key = f"seq-{sid:02d}"
            if key in per_seq:
                frames.extend(per_seq[key].frames)
        path = osp.join(dst_dir, f"{split}_frames.bin")
        with open(path, "wb") as f:
            pickle.dump(frames, f)
        out_paths[split] = path
    return out_paths


def _camera_to_world(seq: FrameSeq, device) -> tuple:
    """Every frame's camera-to-world translation [N, 3] (numpy, as the
    JAX module forms it) and unit quaternion (w, x, y, z) [N, 4], the
    latter by one float32 `mat2quat` on `device` (None: the card)."""
    Rwc, twc = [], []
    for fr in seq.frames:
        Tcw = np.asarray(fr["extrinsic_Tcw"])
        R, t = Tcw[:3, :3], Tcw[:3, 3]
        Rwc.append(R.T)
        twc.append(-R.T @ t)
    q = pose_ops.mat2quat(torch.as_tensor(
        np.asarray(Rwc, np.float32), device=resolve_device(device)))
    return twc, q.cpu().numpy()


def export_tum_img_info(seq: FrameSeq, rgb_txt: str,
                        depth_txt: str | None = None) -> None:
    """TUM-format image lists: `timestamp path` per line
    (tum_seq2ares.py::export_tum_img_info equivalent, written by
    scenes2seq.py:155-162)."""
    with open(rgb_txt, "w") as f:
        f.write("# color images\n# timestamp filename\n")
        for fr in seq.frames:
            f.write(f"{fr['timestamp']:.6f} {fr['file_name']}\n")
    if depth_txt:
        with open(depth_txt, "w") as f:
            f.write("# depth images\n# timestamp filename\n")
            for fr in seq.frames:
                if fr.get("depth_file_name"):
                    f.write(f"{fr['timestamp']:.6f} "
                            f"{fr['depth_file_name']}\n")


def export_tum_trajectory(seq: FrameSeq, path: str, device=None) -> None:
    """TUM groundtruth format: `timestamp tx ty tz qx qy qz qw` of the
    camera-to-world pose (tum_seq2ares.py::export_to_tum_format equivalent,
    scenes2seq.py:166-170); quaternions on `device` (None: the card)."""
    twc, q = _camera_to_world(seq, device) if seq.frames else ((), ())
    with open(path, "w") as f:
        f.write("# trajectory\n# timestamp tx ty tz qx qy qz qw\n")
        for fr, t, qi in zip(seq.frames, twc, q):
            f.write(f"{fr['timestamp']:.6f} "
                    f"{t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                    f"{qi[1]:.6f} {qi[2]:.6f} {qi[3]:.6f} {qi[0]:.6f}\n")


TUM_INTRINSIC = (525.0, 525.0, 319.5, 239.5, 0.0, 0.0)  # tum_seq2ares.py:88-92
TUM_DIM = (480, 640)


def export_tum_associate(seq: FrameSeq, path: str, device=None) -> None:
    """TUM rgb/depth/pose ASSOCIATION file: one line per frame,
    `ts rgb_path ts depth_path ts tx ty tz qx qy qz qw` — the
    `rdpose_associate.txt` layout `read_tum_sequence` ingests (the format
    `export_to_tum_format(write_img_info=True)` emits,
    tum_seq2ares.py:63-75).  Poses are camera-to-world, TUM quaternion
    order (qw LAST); quaternions on `device` (None: the card)."""
    twc, q = _camera_to_world(seq, device) if seq.frames else ((), ())
    with open(path, "w") as f:
        for fr, t, qi in zip(seq.frames, twc, q):
            ts = f"{fr['timestamp']:.6f}"
            f.write(f"{ts} {fr['file_name']} {ts} "
                    f"{fr.get('depth_file_name') or 'none'} {ts} "
                    f"{t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
                    f"{qi[1]:.9f} {qi[2]:.9f} {qi[3]:.9f} {qi[0]:.9f}\n")


def read_tum_sequence(tum_base_dir: str, seq_name: str) -> FrameSeq:
    """TUM-RGBD ingest (tum_seq2ares.py:78-133): read a sequence's
    `rdpose_associate.txt` (rgb + depth + groundtruth pose rows) — or
    `rd_associate.txt` (no poses; identity Tcw, :119-121) — into a
    FrameSeq with the TUM Freiburg intrinsics/dims.  Pose rows are
    camera-to-world `[tx ty tz qx qy qz qw]`; stored extrinsics are the
    inverted world-to-camera 3x4 like every other loader here."""
    seq_dir = osp.join(tum_base_dir, seq_name)
    path = osp.join(seq_dir, "rdpose_associate.txt")
    with_pose = osp.isfile(path)
    if not with_pose:
        path = osp.join(seq_dir, "rd_associate.txt")
        if not osp.isfile(path):
            raise FileNotFoundError(
                f"no rdpose_associate.txt / rd_associate.txt under "
                f"{seq_dir} (run TUM's associate.py first)")
    from scipy.spatial.transform import Rotation

    seq = FrameSeq()
    with open(path) as f:
        for frame_idx, line in enumerate(ln for ln in f
                                         if ln.strip()
                                         and not ln.startswith("#")):
            tok = line.split()
            if with_pose:
                ts, img, _, depth = tok[0], tok[1], tok[2], tok[3]
                tx, ty, tz, qx, qy, qz, qw = map(float, tok[5:12])
                Rwc = Rotation.from_quat([qx, qy, qz, qw]).as_matrix()
                twc = np.array([tx, ty, tz])
                # invert camera-to-world -> Tcw (tum_seq2ares.py:116-118)
                Tcw = np.concatenate([Rwc.T, (-Rwc.T @ twc)[:, None]], 1)
            else:
                ts, img, _, depth = tok[0], tok[1], tok[2], tok[3]
                Tcw = np.eye(4)[:3, :]
            seq.append_frame(frame_idx=frame_idx,
                             img_file_name=osp.join(seq_name, img),
                             Tcw=Tcw,
                             camera_intrinsic=TUM_INTRINSIC,
                             frame_dim=TUM_DIM,
                             timestamp=float(ts),
                             depth_file_name=osp.join(seq_name, depth))
    return seq


def tum_seq_to_json(tum_base_dir: str, seq_name: str,
                    out_json_path: str) -> FrameSeq:
    """The `tum_rgbd_seq2ares` CLI tail (tum_seq2ares.py:136-143):
    ingest + dump the uniform seq.json."""
    seq = read_tum_sequence(tum_base_dir, seq_name)
    seq.dump_json(out_json_path)
    return seq


def load_frames_bin(path: str, sampling_period: int = 1) -> list[dict]:
    """Read a frames.bin with strided subsampling
    (dataset_7Scenes_multi.py:157-159)."""
    with open(path, "rb") as f:
        frames = pickle.load(f, encoding="latin1")
    return frames[::sampling_period]
