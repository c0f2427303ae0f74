"""The port's synthetic 7-Scenes writer (`data/synthetic_scenes.py`)
against the JAX package's, from the same seed at 32x40 and 48x64: the same
files, the split and pose files byte for byte, the PNG pixels equal, each
package's decoder reading its own files and the other's; the stats files
to rtol 1e-7 (each package's `process_poses` runs in float32 in its own
library and may differ in the last bit, ROADMAP.md section 3, and the
stats sum the float frames before their uint8 rounding); and both
packages' loaders equal over the port's files.
"""

import filecmp
import os
import os.path as osp

import numpy as np
import pytest
from PIL import Image

from relpose_gnn_tpu.data import seven_scenes as jax_7s
from relpose_gnn_tpu.data import synthetic_scenes as jax_syn
from relpose_gnn_tpu_torch.data import seven_scenes, synthetic_scenes
from relpose_gnn_tpu_torch.data.image_io import decode_png

SCENES = ("chess", "fire")
KW = dict(n_train_seqs=2, n_test_seqs=1, frames_per_seq=4, seed=3)


def _pil(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


@pytest.fixture(scope="module", params=[(32, 40), (48, 64)],
                ids=["32x40", "48x64"])
def both(request, tmp_path_factory):
    h, w = request.param
    tmp = tmp_path_factory.mktemp(f"syn{h}")
    out = {}
    for name, mod in (("jax", jax_syn), ("port", synthetic_scenes)):
        root, stats = str(tmp / name / "raw"), str(tmp / name / "stats")
        mod.generate_dataset(root, SCENES, stats, height=h, width=w, **KW)
        out[name] = (root, stats)
    return out


def _files(root):
    return sorted(osp.relpath(osp.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_same_files_split_and_pose_files_byte_equal(both):
    (jroot, jstats), (proot, pstats) = both["jax"], both["port"]
    names = _files(jroot)
    assert names == _files(proot)
    assert len([n for n in names if n.endswith(".color.png")]) == 2 * 3 * 4
    for n in names:
        if not n.endswith(".png"):
            assert filecmp.cmp(osp.join(jroot, n), osp.join(proot, n),
                               shallow=False), n
    assert _files(jstats) == _files(pstats) == [
        osp.join(s, "stats.txt") for s in SCENES]
    for s in SCENES:
        np.testing.assert_allclose(
            np.loadtxt(osp.join(pstats, s, "stats.txt")),
            np.loadtxt(osp.join(jstats, s, "stats.txt")), rtol=1e-7)


def test_pixels_equal_each_decoder_on_each_packages_files(both):
    jroot, proot = both["jax"][0], both["port"][0]
    for n in _files(jroot):
        if not n.endswith(".png"):
            continue
        j, p = osp.join(jroot, n), osp.join(proot, n)
        want = _pil(j)
        assert want.dtype == np.uint8
        np.testing.assert_array_equal(decode_png(p), want)
        np.testing.assert_array_equal(decode_png(j), want)
        np.testing.assert_array_equal(_pil(p), want)


@pytest.mark.parametrize("train", [True, False])
def test_loaders_read_the_ports_scenes_as_the_jax_loader(both, train):
    proot = both["port"][0]
    for s in SCENES:
        got = seven_scenes.SevenScenes(s, proot, train=train, image_size=24)
        want = jax_7s.SevenScenes(s, proot, train=train, image_size=24)
        assert got.c_imgs == want.c_imgs and len(got) == 4 * (2 if train
                                                              else 1)
        np.testing.assert_allclose(got.poses, want.poses, atol=1e-6)
        for i in range(len(got)):
            np.testing.assert_array_equal(got.load_image(i),
                                          want.load_image(i))


def test_main_writes_the_layout(tmp_path, capsys):
    root, stats = str(tmp_path / "raw"), str(tmp_path / "stats")
    synthetic_scenes.main(["--root", root, "--stats-root", stats,
                           "--scenes", "heads", "--frames-per-seq", "2",
                           "--height", "16", "--width", "24"])
    assert "wrote 1 scenes" in capsys.readouterr().out
    ds = seven_scenes.SevenScenes("heads", root, train=True, image_size=16)
    assert len(ds) == 4 and ds.load_image(0).shape == (16, 24, 3)
