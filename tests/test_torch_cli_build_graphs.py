"""The port's `cli.build_graphs` against the JAX package's `cli/build_graphs.py`
on one raw 7-Scenes fixture (60x80 PNGs, 2 train sequences of 6 frames and
a test sequence of 4) with one NetVLAD `.tar`, in IR mode with
cross-connect (train and test stores) and in RAND mode.

The fixture has wide similarity gaps, since near-ties are the hazard
(ROADMAP.md section 3): the frames are sliding crops of three smooth
random fields, and the NetVLAD centroids and assignment weights are drawn
from the fixture's own VGG features, so descriptors spread (cosine 0.35 to
1, the closest two of a query's candidates 1.7e-4 apart, the two packages'
similarities 3.5e-5 apart).  Two settings of the test keep the run small
and exact, the same for both packages: the NetVLAD input is 48x64 (192x256
in the CLIs), and both embed in float32 (the CLIs' bfloat16 VGG16 gives
similarities 1.3e-2 apart between the packages).  The JAX CLI's IR mode
names `self_exclusion_mask` outside the function that imports it (a
NameError in the reference package, which does not change); the test
binds the name in its module.

Held: the store files byte for byte (images, adjacency, nbr_idx, rel
paths, header) but `poses.npy`, within atol 4e-7 (each package's loader
computes pose6 in float32 in its own library, ROADMAP.md section 3).
"""

import functools
import os
import os.path as osp
import sys

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter
from scipy.spatial.transform import Rotation

from relpose_gnn_tpu.data import graph_builder as jax_gb
from relpose_gnn_tpu.retrieval import netvlad_index as jax_index
from relpose_gnn_tpu_torch import cli
from relpose_gnn_tpu_torch.cli import build_graphs as port_cli
from relpose_gnn_tpu_torch.data.image_io import encode_png
from relpose_gnn_tpu_torch.retrieval import netvlad_index as port_index

sys.path.insert(0, osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                            "cli"))
import build_graphs as jax_cli  # noqa: E402  (cli/build_graphs.py)

H, W = 60, 80
NV_HW = (48, 64)
POSE_ATOL = 4e-7
SEQS = {1: 6, 2: 6, 3: 4}   # sequences 1-2 train, 3 test


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def write_raw_scene(root, scene="chess", seed=0):
    """Sliding crops of three smooth fields in the 7-Scenes layout;
    returns the colour frame paths in split order."""
    rng = np.random.default_rng(seed)
    fields = []
    for _ in range(3):
        f = gaussian_filter(rng.normal(size=(160, 220, 3)), sigma=(6, 6, 0))
        fields.append((f - f.min()) / (f.max() - f.min()))
    base = osp.join(root, scene)
    os.makedirs(base)
    with open(osp.join(base, "TrainSplit.txt"), "w") as f:
        f.write("sequence1\nsequence2\n")
    with open(osp.join(base, "TestSplit.txt"), "w") as f:
        f.write("sequence3\n")
    k, paths = 0, []
    for s, n in SEQS.items():
        d = osp.join(base, f"seq-{s:02d}")
        os.makedirs(d)
        for i in range(n):
            o = k // 3
            img = fields[k % 3][7 * o:7 * o + H, 9 * o:9 * o + W]
            paths.append(osp.join(d, f"frame-{i:06d}.color.png"))
            encode_png(paths[-1], (img * 255 + 0.5).astype(np.uint8))
            P = np.eye(4)
            P[:3, :3] = Rotation.random(rng=rng).as_matrix()
            P[:3, 3] = rng.normal(size=3)
            np.savetxt(osp.join(d, f"frame-{i:06d}.pose.txt"), P)
            k += 1
    return paths


def write_netvlad_tar(path, frame_paths, seed=5):
    """A full-width NetVLAD (VGG16, 64 x 512) in the released layout whose
    centroids and assignment weights are 64 of the frames' own VGG
    features: descriptors that tell the frames apart."""
    enc = port_index.seeded_encoder(64, 512, None, seed)
    with torch.no_grad():
        x = torch.as_tensor(np.stack([
            port_index.netvlad_preprocess_7scenes(
                port_cli._read_frame01(p), out_hw=NV_HW)
            for p in frame_paths]))
        feat = enc.encoder(x).reshape(-1, 512)
        feat = feat / feat.norm(dim=1, keepdim=True).clamp_min(1e-12)
        pick = torch.randperm(len(feat),
                              generator=torch.Generator().manual_seed(9))
        cent = feat[pick[:64]]
        enc.pool.centroids.copy_(cent)
        enc.pool.conv.weight.copy_(30.0 * cent[:, :, None, None])
    torch.save({"state_dict": enc.state_dict()}, path)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """Both CLIs over the fixture: IR with cross-connect (train and test)
    and RAND (train); returns (root of the JAX stores, root of the
    port's, raw root, the graphs each port run wrote)."""
    tmp = tmp_path_factory.mktemp("bg")
    raw = str(tmp / "raw")
    frames = write_raw_scene(raw)
    nv = str(tmp / "netvlad.tar")
    write_netvlad_tar(nv, frames[:12])
    out = {"jax": str(tmp / "jax"), "port": str(tmp / "port")}
    counts = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_cli, "self_exclusion_mask",
                   jax_gb.self_exclusion_mask, raising=False)
        for mod, name in ((jax_index, "netvlad_preprocess_7scenes"),
                          (port_cli, "netvlad_preprocess_7scenes")):
            mp.setattr(mod, name, functools.partial(getattr(mod, name),
                                                    out_hw=NV_HW))
        mp.setattr(jax_index, "NetVLADIndex",
                   functools.partial(jax_index.NetVLADIndex, dtype=None))
        mp.setattr(port_cli, "netvlad_encoder",
                   functools.partial(cli.netvlad_encoder, dtype=None))
        for mode, extra in (("train", ["--cross-connect"]),
                            ("test", ["--cross-connect"]),
                            ("train", ["--sampling-method", "RAND",
                                       "--seq-len", "3"])):
            argv = ["chess", mode, "--data-path", raw, "--seq-len", "4",
                    "--netvlad-checkpoint", nv, *extra]
            jax_cli.main([*argv, "--graph-data-path", out["jax"]])
            counts[(mode, extra[0])] = port_cli.main(
                [*argv, "--graph-data-path", out["port"], "--device", "cpu"])
    return out["jax"], out["port"], raw, counts


STORES = ["chess_fc4_sp5_train", "chess_fc4_sp5_test", "chess_fc3_sp5_train"]


@pytest.mark.parametrize("store", STORES)
def test_stores_equal_the_jax_clis(built, store):
    jroot, proot, _, _ = built
    j, p = osp.join(jroot, store), osp.join(proot, store)
    assert sorted(os.listdir(j)) == sorted(os.listdir(p))
    for f in sorted(os.listdir(j)):
        if f == "poses.npy":
            a, b = np.load(osp.join(j, f)), np.load(osp.join(p, f))
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_allclose(b, a, atol=POSE_ATOL, rtol=0)
        else:
            with open(osp.join(j, f), "rb") as fa, \
                    open(osp.join(p, f), "rb") as fb:
                assert fa.read() == fb.read(), f


def test_counts_widths_and_cross_connect(built):
    _, proot, _, counts = built
    assert tuple(counts.values()) == (12, 4, 12)
    nbr = np.load(osp.join(proot, STORES[0], "nbr_idx.npy"))
    seq = np.repeat([1, 2], 6)
    assert nbr.shape == (12, 3)
    assert not (seq[nbr] == seq[:, None]).any()   # cross-connect held
    images = np.load(osp.join(proot, STORES[1], "images.npy"), mmap_mode="r")
    assert images.shape == (4, 4, 256, 341, 3) and images.dtype == np.uint8


def test_vlad_retrieval_is_refused(built, tmp_path):
    """Classical ORB-VLAD retrieval runs (tests/test_torch_vlad.py holds
    its stores against the JAX CLI's); without its index pickle it is
    refused, as the JAX CLI's is, before any store is written."""
    _, _, raw, _ = built
    missing = str(tmp_path / "none.pkl")
    with pytest.raises(FileNotFoundError, match="none.pkl"):
        port_cli.main(["chess", "train", "--data-path", raw,
                       "--graph-data-path", str(tmp_path / "g"),
                       "--retrieval", "vlad", "--vlad-index", missing,
                       "--device", "cpu"])
    assert not (tmp_path / "g").exists()


def test_compute_pose_stats_matches_jax(tmp_path, capsys):
    """`cli.compute_pose_stats` over the Cambridge loader: the same file
    as the JAX script's, to the 7 decimals it writes."""
    from relpose_gnn_tpu_torch.cli import compute_pose_stats
    from test_data import write_cambridge_fixture

    import compute_pose_stats as jax_stats  # cli/compute_pose_stats.py

    for k, scene in enumerate(("ShopFacade", "KingsCollege")):
        write_cambridge_fixture(str(tmp_path), scene=scene, n=4 + k,
                                size=(16, 12))
    argv = ["--data-path", str(tmp_path), "--scenes", "ShopFacade",
            "KingsCollege"]
    jax_stats.main([*argv, "--output", str(tmp_path / "jax.txt")])
    mean_t, std_t = compute_pose_stats.main(
        [*argv, "--output", str(tmp_path / "port.txt")])
    assert "KingsCollege: 5 poses" in capsys.readouterr().out
    assert (tmp_path / "port.txt").read_text() == \
        (tmp_path / "jax.txt").read_text()
    assert mean_t.shape == std_t.shape == (3,)
