"""The port's loaders and their helpers against the JAX package's, on the
same on-disk fixtures (the writers of tests/test_data.py, 40x32 and 64x48
PNGs) and the same seeded inputs:

  * `ops/pose.py`: `mat2quat`, `quat2mat`, `process_poses*`, atol 1e-6
    (both compute the quaternion and its log in float32 and widen; the
    last bits of arccos and sqrt may differ between the libraries);
  * `ops/camera.py::crop_by_intrinsic` and `netvlad_preprocess_7scenes`
    on a raw 640x480 frame: equal (the same PIL resize of the same
    uint8 pixels and the same float32 arithmetic);
  * `data/transforms.py`: equal, `color_jitter` under the same Generator;
  * `SevenScenes` (flat and `rgb/ poses/` layouts, gt, VO and depth
    modes, a corrupt frame) and `CambridgeLandmark`: paths, `seq_id`,
    `gt_idx` and decoded images equal, poses within atol 1e-6;
  * split paths, leave-one-out masks, scene statistics, and the bundled
    statistics files byte for byte.
"""

import filecmp
import os
import os.path as osp
import shutil

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image
from scipy.spatial.transform import Rotation

from relpose_gnn_tpu.data import cambridge as jax_cambridge
from relpose_gnn_tpu.data import seven_scenes as jax_7s
from relpose_gnn_tpu.data import transforms as jax_T
from relpose_gnn_tpu.ops import camera as jax_camera
from relpose_gnn_tpu.ops import pose as jax_pose
from relpose_gnn_tpu.retrieval import netvlad_index as jax_index
from relpose_gnn_tpu_torch.data import cambridge, seven_scenes
from relpose_gnn_tpu_torch.data import transforms as T
from relpose_gnn_tpu_torch.ops import camera, pose
from relpose_gnn_tpu_torch.retrieval import netvlad_index
from test_data import (write_7scenes_fixture, write_7scenes_vo_fixture,
                       write_cambridge_fixture)

POSE_ATOL = 1e-6
SIZE = (40, 32)


def _rotations(n, seed):
    R = Rotation.random(n, rng=np.random.default_rng(seed)).as_matrix()
    # pivots of every kind: identity, 180-degree turns (w == 0) about
    # each axis, and a near-identity rotation
    extra = [np.eye(3), np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1, -1]),
             np.diag([-1.0, -1, 1]),
             Rotation.from_rotvec([1e-7, 0, 0]).as_matrix()]
    return np.concatenate([R, np.stack(extra)])


# ---------------------------------------------------------------------------
# pose conversions
# ---------------------------------------------------------------------------


def test_mat2quat_and_quat2mat_match_jax():
    R = _rotations(64, 0).astype(np.float32)
    got = pose.mat2quat(torch.from_numpy(R)).numpy()
    want = np.asarray(jax_pose.mat2quat(jnp.asarray(R)))
    np.testing.assert_allclose(got, want, atol=POSE_ATOL)
    got_R = pose.quat2mat(torch.from_numpy(got)).numpy()
    np.testing.assert_allclose(
        got_R, np.asarray(jax_pose.quat2mat(jnp.asarray(want))),
        atol=POSE_ATOL)
    np.testing.assert_allclose(got_R, R, atol=1e-5)


@pytest.mark.parametrize("quirk", [False, True])
def test_process_poses_matches_jax(quirk):
    rng = np.random.default_rng(1)
    R = _rotations(32, 1)
    t = rng.normal(size=(len(R), 3))
    raw = np.concatenate([R, t[:, :, None]], axis=2).reshape(len(R), 12)
    align_R = Rotation.random(rng=rng).as_matrix()
    args = (raw, rng.normal(size=3), rng.uniform(0.5, 2, 3), align_R,
            rng.normal(size=3), 1.3)
    got = pose.process_poses(*args, sign_zero_quirk=quirk)
    want = jax_pose.process_poses(*args, sign_zero_quirk=quirk)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_allclose(got, want, atol=POSE_ATOL)


def test_process_poses_cambridge_match_jax():
    rng = np.random.default_rng(2)
    for R in _rotations(8, 2):
        T4 = np.eye(4)
        T4[:3, :3] = R
        T4[:3, 3] = rng.normal(size=3)
        np.testing.assert_allclose(pose.process_poses_cambridge(T4),
                                   jax_pose.process_poses_cambridge(T4),
                                   atol=POSE_ATOL)
        q = rng.normal(size=4)
        p7 = np.concatenate([rng.normal(size=3), q / np.linalg.norm(q)])
        np.testing.assert_allclose(
            pose.process_poses_cambridge_norod(p7),
            jax_pose.process_poses_cambridge_norod(p7), atol=POSE_ATOL)


# ---------------------------------------------------------------------------
# transforms, crop, NetVLAD preprocessing
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def raw_frame():
    return np.random.default_rng(3).random((480, 640, 3)).astype(np.float32)


def test_crop_by_intrinsic_matches_jax(raw_frame):
    K_rgb, K_depth = netvlad_index.K_7SCENES_RGB, netvlad_index.K_7SCENES_DEPTH
    np.testing.assert_array_equal(K_rgb, jax_index.K_7SCENES_RGB)
    np.testing.assert_array_equal(K_depth, jax_index.K_7SCENES_DEPTH)
    u8 = (raw_frame * 255).astype(np.uint8)
    for img in (raw_frame, u8):
        got = camera.crop_by_intrinsic(img, K_rgb, K_depth)
        want = jax_camera.crop_by_intrinsic(img, K_rgb, K_depth)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="FOV"):
        camera.crop_by_intrinsic(raw_frame, K_depth, K_rgb)


def test_netvlad_preprocess_of_a_raw_frame_matches_jax(raw_frame):
    got = netvlad_index.netvlad_preprocess_7scenes(raw_frame)
    want = jax_index.netvlad_preprocess_7scenes(raw_frame)
    assert got.shape == (192, 256, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_transforms_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    for size in ((64, 48), (48, 64), (37, 37)):
        img = Image.fromarray(
            (rng.random((size[1], size[0], 3)) * 255).astype(np.uint8))
        for side in (16, 256):
            np.testing.assert_array_equal(
                np.asarray(T.resize_short_side(img, side)),
                np.asarray(jax_T.resize_short_side(img, side)))
        path = str(tmp_path / f"{size}.png")
        img.save(path)
        mean, std = [0.4, 0.5, 0.6], [0.2, 0.25, 0.3]
        for kw in ({}, dict(mean=mean, std=std)):
            np.testing.assert_array_equal(
                T.load_and_preprocess(path, 20, **kw),
                jax_T.load_and_preprocess(path, 20, **kw))
        np.testing.assert_array_equal(
            T.to_float_chw_free(img), jax_T.to_float_chw_free(img))
    (tmp_path / "bad.png").write_bytes(b"not a png")
    assert T.load_rgb(str(tmp_path / "bad.png")) is None
    assert T.load_rgb(str(tmp_path / "missing.png")) is None
    x = rng.random((6, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(T.normalize(x, mean, std),
                                  jax_T.normalize(x, mean, std))


JITTERS = [dict(brightness=0.0), dict(brightness=0.0, hue=0.0),
           dict(contrast=0.0, saturation=0.0, hue=0.0),
           dict(brightness=0.3, contrast=0.0, saturation=0.0, hue=0.0)]


@pytest.mark.parametrize("seed", range(4))
def test_color_jitter_matches_jax_under_one_generator(seed):
    """The same draws from one Generator, and the same result wherever
    the JAX function applies the factors it drew.  With brightness and a
    later factor both on, the JAX function's brightness closure reads the
    LAST factor drawn (a late-bound loop variable: with hue on, a factor
    in [-0.2, 0.2] that clips the frame to black); the port multiplies by
    the brightness draw, as torchvision's ColorJitter does, so there it
    is held to its own draws instead (ROADMAP.md, queue 3)."""
    x = np.random.default_rng(10 + seed).random((9, 7, 3)).astype(np.float32)
    for kw in JITTERS:
        g1, g2 = np.random.default_rng(seed), np.random.default_rng(seed)
        np.testing.assert_array_equal(T.color_jitter(g1, x, **kw),
                                      jax_T.color_jitter(g2, x, **kw))
        assert g1.random() == g2.random()  # the same number of draws
    g1, g2 = np.random.default_rng(seed), np.random.default_rng(seed)
    got = T.color_jitter(g1, x)
    jax_T.color_jitter(g2, x)
    assert g1.random() == g2.random()
    # the brightness op alone, with the factor the port drew first
    g = np.random.default_rng(seed)
    fb = g.uniform(0.5, 1.5)
    rest = [g.uniform(0.5, 1.5), g.uniform(0.5, 1.5), g.uniform(-0.2, 0.2)]
    order = g.permutation(4)
    y = x
    for j in order:
        if j == 0:
            y = np.clip(y * fb, 0, 1)
        else:
            kw = dict(brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0)
            kw[("contrast", "saturation", "hue")[j - 1]] = 1.0
            y = T.color_jitter(_Fixed(rest[j - 1]), y, **kw)
    np.testing.assert_array_equal(got, y)


class _Fixed:
    """A Generator stand-in that draws one fixed factor."""

    def __init__(self, f):
        self.f = f

    def uniform(self, lo, hi):
        return self.f

    def permutation(self, n):
        return np.arange(n)


def test_pil_is_named_where_it_is_missing(monkeypatch):
    import builtins
    real_import = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError, match="PIL"):
        T.load_rgb("x.png")
    with pytest.raises(ImportError, match="PIL"):
        netvlad_index.netvlad_preprocess_7scenes(np.zeros((4, 4, 3)))


# ---------------------------------------------------------------------------
# 7-Scenes and Cambridge
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def seven_root(tmp_path_factory):
    """Flat layout (train: 2 seqs x 4 frames with seq-01 frame 2
    corrupt; test: 1 seq x 3), a VO tree (orbslam) and an `rgb/ depth/
    poses/` copy of the flat train split."""
    root = tmp_path_factory.mktemp("7s")
    flat, vo, sub = (str(root / d) for d in ("flat", "vo", "sub"))
    write_7scenes_fixture(flat, n_seqs=2, n_frames=4, size=SIZE)
    write_7scenes_fixture(flat, n_seqs=1, n_frames=3, train=False,
                          size=SIZE)
    write_7scenes_vo_fixture(vo, n_seqs=2, n_frames=4, size=SIZE)
    write_7scenes_vo_fixture(vo, scene="fire", vo_lib="libviso2",
                             n_seqs=1, n_frames=4, size=SIZE)
    shutil.copytree(flat, sub)
    for s in (1, 2):
        seq = osp.join(sub, "chess", f"seq-{s:02d}")
        for kind, d in (("color", "rgb"), ("depth", "depth"),
                        ("pose", "poses")):
            os.makedirs(osp.join(seq, d))
            for f in os.listdir(seq):
                if f".{kind}." in f:
                    os.replace(osp.join(seq, f), osp.join(seq, d, f))
    bad = osp.join(flat, "chess", "seq-01", "frame-000002.color.png")
    with open(bad, "r+b") as f:
        f.truncate(40)
    return flat, vo, sub


def _same_dataset(got, want, loads=True):
    assert got.c_imgs == want.c_imgs and got.d_imgs == want.d_imgs
    np.testing.assert_array_equal(got.seq_id, want.seq_id)
    np.testing.assert_array_equal(got.gt_idx, want.gt_idx)
    assert got.seq_id.dtype == want.seq_id.dtype
    assert got.poses.dtype == want.poses.dtype == np.float32
    np.testing.assert_allclose(got.poses, want.poses, atol=POSE_ATOL)
    assert len(got) == len(want)
    if loads:
        for i in range(len(got)):
            a, b = got.load_image(i), want.load_image(i)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
            assert got.rel_path(i) == want.rel_path(i)


@pytest.mark.parametrize("layout", ["flat", "sub"])
@pytest.mark.parametrize("train", [True, False])
def test_seven_scenes_matches_jax(seven_root, layout, train):
    root = seven_root[0 if layout == "flat" else 2]
    mean, std = seven_scenes.load_scene_stats(None, "chess")
    kw = dict(train=train, image_size=24, mean=mean, std=std)
    got = seven_scenes.SevenScenes("chess", root, **kw)
    want = jax_7s.SevenScenes("chess", root, **kw)
    _same_dataset(got, want)
    if layout == "flat" and train:
        assert got.load_image(2) is None  # the corrupt frame
        g_img, g_pose, g_rel = got[2]   # skips forward to frame 3
        w_img, w_pose, w_rel = want[2]
        np.testing.assert_array_equal(g_img, w_img)
        np.testing.assert_array_equal(g_pose, w_pose)
        assert g_rel == w_rel == osp.join("chess", "seq-01",
                                          "frame-000003.color.png")


@pytest.mark.parametrize("mode", [1, 2])
def test_seven_scenes_depth_modes_match_jax(seven_root, mode):
    got = seven_scenes.SevenScenes("chess", seven_root[2], True, 24,
                                   mode=mode)
    want = jax_7s.SevenScenes("chess", seven_root[2], True, 24, mode=mode)
    for i in (0, 5):
        g, w = got[i], want[i]
        for a, b in zip(g[0] if mode == 2 else (g[0],),
                        w[0] if mode == 2 else (w[0],)):
            np.testing.assert_array_equal(a, b)
        assert g[2] == w[2]


@pytest.mark.parametrize("scene,vo_lib", [("chess", "orbslam"),
                                          ("fire", "libviso2")])
def test_seven_scenes_vo_mode_matches_jax(seven_root, scene, vo_lib):
    kw = dict(train=True, image_size=24, real=True, vo_lib=vo_lib)
    got = seven_scenes.SevenScenes(scene, seven_root[1], **kw)
    want = jax_7s.SevenScenes(scene, seven_root[1], **kw)
    _same_dataset(got, want, loads=False)
    np.testing.assert_array_equal(got.load_image(0), want.load_image(0))


def test_seven_scenes_split_helpers_match_jax(seven_root):
    flat = seven_root[0]
    assert seven_scenes.test_split_rgb_paths(flat, "chess", 4) == \
        jax_7s.test_split_rgb_paths(flat, "chess", 4)
    assert seven_scenes.test_split_rgb_paths(seven_root[2], "chess") == \
        jax_7s.test_split_rgb_paths(seven_root[2], "chess")
    with pytest.raises(IOError, match="Not the same number"):
        seven_scenes.test_split_rgb_paths(flat, "chess", 3)
    assert seven_scenes.SCENE_FILE_INDEX_RANGES == \
        jax_7s.SCENE_FILE_INDEX_RANGES
    idx = np.arange(-5, 26_100, 37)
    for excluded in (None, "chess", ("heads", "stairs"), "fire"):
        np.testing.assert_array_equal(
            seven_scenes.leave_one_out_file_mask(idx, excluded),
            jax_7s.leave_one_out_file_mask(idx, excluded))


@pytest.mark.parametrize("scene", seven_scenes.SEVEN_SCENES)
def test_scene_stats_match_jax(scene, tmp_path):
    for a, b in zip(seven_scenes.load_scene_stats(None, scene),
                    jax_7s.load_scene_stats(None, scene)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    d = tmp_path / scene
    d.mkdir()
    np.savetxt(d / "stats.txt", [[0.1, 0.2, 0.3], [0.04, 0.09, 0.16]])
    for a, b in zip(seven_scenes.load_scene_stats(str(tmp_path), scene),
                    jax_7s.load_scene_stats(str(tmp_path), scene)):
        np.testing.assert_array_equal(a, b)


def test_bundled_stats_are_the_jax_packages_byte_for_byte():
    ours = osp.dirname(seven_scenes.BUNDLED_STATS_DIR)
    theirs = osp.dirname(jax_7s.BUNDLED_STATS_DIR)
    assert ours != theirs and "relpose_gnn_tpu_torch" in ours
    names = []
    for dirpath, _, files in os.walk(theirs):
        names += [osp.relpath(osp.join(dirpath, f), theirs) for f in files]
    assert len(names) == 8
    for n in names:
        assert filecmp.cmp(osp.join(ours, n), osp.join(theirs, n),
                           shallow=False), n
    assert filecmp.cmp(seven_scenes.BUNDLED_CAMBRIDGE_POSE_STATS,
                       jax_7s.BUNDLED_CAMBRIDGE_POSE_STATS, shallow=False)
    np.testing.assert_array_equal(
        cambridge.load_pose_stats(seven_scenes.BUNDLED_CAMBRIDGE_POSE_STATS),
        jax_cambridge.load_pose_stats(jax_7s.BUNDLED_CAMBRIDGE_POSE_STATS))


@pytest.fixture(scope="module")
def cambridge_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cam"))
    _, stats = write_cambridge_fixture(
        root, n=6, size=SIZE,
        subdirs=["seq1", "seq1", "seq2", "seqA", "seqA", "seqB"])
    write_cambridge_fixture(root, n=3, train=False, size=SIZE)
    np.savetxt(stats, [[0.1, -0.2, 0.3], [1.5, 0.5, 2.0]])
    return root, stats


@pytest.mark.parametrize("kw", [
    dict(train=True),
    dict(train=False),
    dict(train=True, normalize_images=False, normalize_translation=False),
])
def test_cambridge_matches_jax(cambridge_root, kw):
    root, stats = cambridge_root
    kw = dict(image_size=24, pose_stats_file=stats, **kw)
    assert cambridge.CAMBRIDGE_SCENES == jax_cambridge.CAMBRIDGE_SCENES
    got = cambridge.CambridgeLandmark("ShopFacade", root, **kw)
    want = jax_cambridge.CambridgeLandmark("ShopFacade", root, **kw)
    assert got.c_imgs == want.c_imgs
    np.testing.assert_array_equal(got.seq_id, want.seq_id)
    np.testing.assert_allclose(got.poses, want.poses, atol=POSE_ATOL)
    for i in range(len(got)):
        np.testing.assert_array_equal(got.load_image(i), want.load_image(i))
    g, w = got[0], want[0]
    np.testing.assert_array_equal(g[0], w[0])
    assert g[2] == w[2]


def test_cambridge_jitter_draws_from_its_seed(cambridge_root):
    """With `color_jitter`, each decoded frame is jittered by draws from
    `default_rng(seed)` in turn, then normalised (the JAX loader's draws;
    its results differ through its brightness closure, see
    test_color_jitter_matches_jax_under_one_generator)."""
    root, stats = cambridge_root
    ds = cambridge.CambridgeLandmark("ShopFacade", root, True, 24,
                                     pose_stats_file=stats,
                                     color_jitter=True, seed=3)
    rng = np.random.default_rng(3)
    for i in range(3):
        x = T.color_jitter(rng, T.load_and_preprocess(ds.c_imgs[i], 24))
        np.testing.assert_array_equal(ds.load_image(i),
                                      T.normalize(x, ds.mean, ds.std))
