"""The port's classical ORB-VLAD retrieval (`retrieval/vlad.py`,
`cli.build_vlad_index`, `cli.vlad_export`, `cli.build_graphs --retrieval
vlad`) against the JAX package's module and root CLIs, on the CPU.

Tolerances, stated once:
  * VLAD vectors: atol 1e-6 (VLAD_ATOL; measured 2.2e-8 against eager
    JAX, where the two libraries' L2 norms round apart in the last bit,
    and up to 5e-7 against the jitted function the CLI runs use, see
    `jitted_jax_vlad`), assignments exact
    (on well-separated descriptors a wrong one would move a block by
    O(1)); against a float64 per-cluster loop, atol 1e-6 as well;
  * `vlad_export --format distances`: atol 1e-5 parsed (DIST_ATOL) off
    the diagonal; on it the port's 0 against the JAX script's cancellation
    residue (below 1e-3);
  * everything else exact: pickles' centers, `.paths.txt`, the csv and
    prj text, ORB descriptors and KMeans centers (the same OpenCV and
    scikit-learn calls), top-k orders, and the `build_graphs` stores.

The retrieval fixture has texture: ORB finds no keypoint in a smooth or
striped frame, so the frames are seeded rectangles painted on a gradient
(110-185 keypoints at 320x240), written through the port's
`image_io.encode_png`; one database frame and one query are left flat,
so the index skips the first (its row missing, masked invalid) and the
second ranks the database by similarity 0.  The stores are held byte for
byte but `poses.npy`, within atol 4e-7 (each package's loader computes
pose6 in float32 through its own arccos), as
tests/test_torch_cli_build_graphs.py holds them; the JAX CLI's IR mode
names `self_exclusion_mask` outside the function that imports it (a
NameError of the reference package), which the test binds in its module.
Host-library tests skip with a reason where cv2 or sklearn is absent.
"""

import importlib.util
import os
import os.path as osp
import pickle

import jax
import jax.numpy as jnp
import types

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from relpose_gnn_tpu.data import graph_builder as jax_gb
from relpose_gnn_tpu.retrieval import vlad as jax_vlad
from relpose_gnn_tpu_torch import require_full_fp32
from relpose_gnn_tpu_torch.cli import build_graphs as port_build_graphs
from relpose_gnn_tpu_torch.cli import build_vlad_index as port_index_cli
from relpose_gnn_tpu_torch.cli import vlad_export as port_export_cli
from relpose_gnn_tpu_torch.data.image_io import encode_png
from relpose_gnn_tpu_torch.retrieval import vlad

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
VLAD_ATOL = 1e-6
DIST_ATOL = 1e-5
POSE_ATOL = 4e-7


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_cli(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_jax_vlad_cli_{name}", osp.join(REPO, "cli", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _needs_host_libraries():
    pytest.importorskip("cv2", reason="OpenCV is not installed here: ORB "
                        "is a host call into it in both packages")
    pytest.importorskip("sklearn", reason="scikit-learn is not installed "
                        "here: the dictionary is a host call into it")


# -- vlad_aggregate and VLADIndex --------------------------------------------

def _separated(rng, k=6, d=8, per=(30, 7)):
    """Byte-valued images of descriptors near well-separated centers (as
    ORB's are bytes): the nearest center of every descriptor is far
    nearer than the next, and the residual sums are exact in float32."""
    centers = rng.integers(40, 216, (k, d)).astype(np.float32)
    imgs = []
    for n in per:
        pick = rng.integers(0, k, n)
        imgs.append(centers[pick] + rng.integers(-6, 7, (n, d)).astype(
            np.float32))
    return centers, imgs


def _vlad_oracle(x, centers):
    """The reference's per-cluster loop in float64."""
    x, c = x.astype(np.float64), centers.astype(np.float64)
    assign = np.argmin(((x[:, None] - c[None]) ** 2).sum(-1), axis=1)
    v = np.zeros_like(c)
    for j in range(len(c)):
        v[j] = (x[assign == j] - c[j]).sum(0)
    v = v.reshape(-1)
    v = np.sign(v) * np.sqrt(np.abs(v))
    return v / max(np.linalg.norm(v), 1e-12)


def test_vlad_aggregate_matches_jax_and_the_loop():
    rng = np.random.default_rng(0)
    centers, imgs = _separated(rng)
    batch = vlad.VLADIndex(centers, device="cpu").describe_batch(imgs)
    for i, x in enumerate(imgs):
        got = vlad.vlad_aggregate(torch.from_numpy(x),
                                  torch.from_numpy(centers)).numpy()
        want = np.asarray(jax_vlad.vlad_aggregate(jnp.asarray(x),
                                                  jnp.asarray(centers)))
        np.testing.assert_allclose(got, want, rtol=0, atol=VLAD_ATOL)
        np.testing.assert_allclose(got, _vlad_oracle(x, centers), rtol=0,
                                   atol=VLAD_ATOL)
        # the padded batch gives each image its own vector
        np.testing.assert_allclose(batch[i].numpy(), got, rtol=0,
                                   atol=VLAD_ATOL)


def test_vlad_aggregate_ties_go_to_the_lower_center():
    """jnp.argmin's rule, as the loop oracle's np.argmin."""
    centers = np.array([[0.0, 0.0], [2.0, 0.0], [9.0, 9.0]], np.float32)
    x = np.array([[1.0, 0.0]], np.float32)       # equidistant to 0 and 1
    got = vlad.vlad_aggregate(torch.from_numpy(x), torch.from_numpy(centers))
    np.testing.assert_array_equal(got.numpy(), _vlad_oracle(x, centers))
    assert got[0] > 0 and got[2] == 0            # center 0 took it


def _random_index_inputs(seed=1, m=40, k=8, d=16, p=40):
    """Byte-valued descriptors, `p` an image (one shape: eager JAX
    compiles each op once a shape), centers drawn from them."""
    rng = np.random.default_rng(seed)
    imgs = [rng.integers(0, 256, (p, d)).astype(np.float32)
            for _ in range(m)]
    centers = np.concatenate(imgs)[rng.choice(m * p, k, replace=False)]
    return centers, imgs


def test_index_topk_order_equals_jax():
    centers, imgs = _random_index_inputs()
    j = jax_vlad.VLADIndex(centers=centers)
    j.build(imgs)
    p = vlad.VLADIndex(centers, device="cpu")
    p.build(imgs)
    np.testing.assert_allclose(p.descriptors, j.descriptors, rtol=0,
                               atol=VLAD_ATOL)
    for q in imgs[:10]:
        gs, gi = p.query(q, 7)
        ws, wi = j.query(q, 7)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gs, ws, rtol=0, atol=VLAD_ATOL)


def test_index_ties_go_to_the_lower_row():
    """Equal scores rank the lower row first.  The table's entries and the
    query's VLAD vector are exact in binary (one descriptor a unit from
    its center gives e_0), so any GEMM scores rows 3-5 exactly as rows
    0-2; repeated frames need not (the CPU's GEMV may score two equal
    rows an ulp apart, in the JAX package as here)."""
    centers = np.array([[0.0, 0.0], [100.0, 100.0]], np.float32)
    table = np.zeros((6, 4), np.float32)
    table[:, 0] = [0.25, 0.75, 0.5, 0.25, 0.75, 0.5]
    p = vlad.VLADIndex(centers, table, device="cpu")
    scores, idx = p.query(np.array([[1.0, 0.0]], np.float32), 6)
    assert list(idx) == [1, 4, 2, 5, 0, 3]
    assert list(scores) == [0.75, 0.75, 0.5, 0.5, 0.25, 0.25]


@pytest.mark.parametrize("dtype,is_cuda,refused", [
    (torch.float32, True, True), (torch.bfloat16, True, False),
    (torch.float32, False, False)])
def test_ranking_products_refuse_tf32(monkeypatch, dtype, is_cuda, refused):
    """Under TF32, a float32 product on the card that decides a ranking
    raises rather than run (`require_full_fp32`); a bfloat16 one or one on
    the CPU takes no TF32 and runs."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    x = types.SimpleNamespace(is_cuda=is_cuda, dtype=dtype)
    if refused:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            require_full_fp32(x)
    else:
        require_full_fp32(x)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    require_full_fp32(x)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_index_pickle_loads_across_packages(tmp_path, writer):
    centers, imgs = _random_index_inputs(3, m=12)
    path = str(tmp_path / "index.pkl")
    if writer == "jax":
        src = jax_vlad.VLADIndex(centers=centers)
        src.build(imgs)
        src.save(path)
        dst = vlad.VLADIndex.load(path, device="cpu")
    else:
        src = vlad.VLADIndex(centers, device="cpu")
        src.build(imgs)
        src.save(path)
        dst = jax_vlad.VLADIndex.load(path)
    with open(path, "rb") as f:
        raw = pickle.load(f)
    assert sorted(raw) == ["centers", "descriptors"]
    assert raw["descriptors"].dtype == np.float32
    np.testing.assert_array_equal(dst.centers, src.centers)
    np.testing.assert_array_equal(dst.descriptors, src.descriptors)
    np.testing.assert_array_equal(dst.query(imgs[4], 5)[1],
                                  src.query(imgs[4], 5)[1])


# -- the host calls: ORB and the KMeans dictionary --------------------------

def textured_frame(rng, h=480, w=640, n=60):
    """A gradient with `n` seeded rectangles painted on it."""
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 // w, y * 255 // h, np.full_like(x, 128)],
                   -1).astype(np.uint8)
    for _ in range(n):
        y0, x0 = rng.integers(0, h - 20), rng.integers(0, w - 20)
        img[y0:y0 + rng.integers(10, 120), x0:x0 + rng.integers(10, 160)] \
            = rng.integers(0, 256, 3)
    return img


def test_orb_and_dictionary_equal_jax():
    _needs_host_libraries()
    rng = np.random.default_rng(4)
    descs = []
    for _ in range(3):
        img = textured_frame(rng, 240, 320, n=80)
        got, want = vlad.orb_descriptors(img), jax_vlad.orb_descriptors(img)
        np.testing.assert_array_equal(got, want)
        assert got.shape[1] == 32 and len(got) > 100
        descs.append(got)
    flat = np.full((64, 64, 3), 90, np.uint8)
    assert vlad.orb_descriptors(flat) is None
    all_desc = np.concatenate(descs).astype(np.float32)
    np.testing.assert_array_equal(
        vlad.fit_visual_dictionary(all_desc, 8, seed=1),
        jax_vlad.fit_visual_dictionary(all_desc, 8, seed=1))


# -- the CLIs on a textured raw fixture -------------------------------------

SEQS = {1: 6, 2: 6, 3: 4}     # 7-Scenes: sequences 1-2 train, 3 test


def write_textured_7scenes(root, scene="chess", seed=0):
    rng = np.random.default_rng(seed)
    base = osp.join(root, scene)
    os.makedirs(base)
    with open(osp.join(base, "TrainSplit.txt"), "w") as f:
        f.write("sequence1\nsequence2\n")
    with open(osp.join(base, "TestSplit.txt"), "w") as f:
        f.write("sequence3\n")
    for s, n in SEQS.items():
        d = osp.join(base, f"seq-{s:02d}")
        os.makedirs(d)
        for i in range(n):
            flat = (s, i) in ((2, 3), (3, 1))   # no ORB keypoint
            img = (np.full((240, 320, 3), 120, np.uint8) if flat
                   else textured_frame(rng, 240, 320, n=80))
            encode_png(osp.join(d, f"frame-{i:06d}.color.png"), img)
            P = np.eye(4)
            P[:3, :3] = Rotation.random(rng=rng).as_matrix()
            P[:3, 3] = rng.normal(size=3)
            np.savetxt(osp.join(d, f"frame-{i:06d}.pose.txt"), P)


def write_textured_cambridge(root, scene="ShopFacade", seed=1):
    """Train split in seq1, test split in seq2, 320x180 textured frames."""
    from test_data import write_cambridge_fixture
    rng = np.random.default_rng(seed)
    _, stats = write_cambridge_fixture(root, scene, n=8, train=True,
                                       subdirs=["seq1"] * 8)
    write_cambridge_fixture(root, scene, n=4, train=False,
                            subdirs=["seq2"] * 4)
    for sub in ("seq1", "seq2"):
        for name in sorted(os.listdir(osp.join(root, scene, sub))):
            encode_png(osp.join(root, scene, sub, name),
                       textured_frame(rng, 180, 320, n=80))
    return stats


@pytest.fixture(scope="module")
def jitted_jax_vlad():
    """The JAX `vlad_aggregate` under `jax.jit` while the CLIs run: eager
    JAX compiles each of its ops anew for every descriptor count (0.9 s
    an image); jitted, one program a count, the same arithmetic fused
    (its vectors move by up to 5e-7)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_vlad, "vlad_aggregate",
                   jax.jit(jax_vlad.vlad_aggregate))
        yield


@pytest.fixture(scope="module")
def indexed(tmp_path_factory, jitted_jax_vlad):
    """Both index CLIs over the 7-Scenes fixture, the port's over the
    Cambridge one; returns (tmp root, raw roots, index paths)."""
    _needs_host_libraries()
    tmp = tmp_path_factory.mktemp("vlad")
    seven, camb = str(tmp / "7scenes"), str(tmp / "cambridge")
    write_textured_7scenes(seven)
    stats = write_textured_cambridge(camb)
    glob7 = osp.join(seven, "chess", "seq-*", "*.color.png")
    paths = {"jax": str(tmp / "jax.pkl"), "port": str(tmp / "port.pkl"),
             "cambridge": str(tmp / "camb.pkl")}
    _jax_cli("build_vlad_index").main(["--image-glob", glob7, "--output",
                                       paths["jax"], "--clusters", "8"])
    port_index_cli.main(["--image-glob", glob7, "--output", paths["port"],
                         "--clusters", "8", "--device", "cpu"])
    port_index_cli.main(["--image-glob", osp.join(camb, "ShopFacade",
                                                  "seq*", "*.png"),
                         "--output", paths["cambridge"], "--clusters", "8",
                         "--device", "cpu"])
    return tmp, {"7Scenes": seven, "Cambridge": camb, "stats": stats}, paths


def test_index_clis_write_the_same_index(indexed):
    _, _, paths = indexed
    with open(paths["jax"], "rb") as f:
        want = pickle.load(f)
    with open(paths["port"], "rb") as f:
        got = pickle.load(f)
    assert sorted(got) == sorted(want) == ["centers", "descriptors"]
    np.testing.assert_array_equal(got["centers"], want["centers"])
    assert got["descriptors"].shape == want["descriptors"].shape == (14, 256)
    np.testing.assert_allclose(got["descriptors"], want["descriptors"],
                               rtol=0, atol=VLAD_ATOL)
    with open(paths["jax"] + ".paths.txt") as a, \
            open(paths["port"] + ".paths.txt") as b:
        text = b.read()
        assert text == a.read()
    assert "seq-02/frame-000003" not in text      # the flat frame, skipped


def test_entry_points_pin_full_fp32(indexed, monkeypatch):
    """An entry point turns a caller's TF32 off for its process
    (`cli.pin_full_fp32`), the port's one precision policy."""
    tmp, _, paths = indexed
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    port_export_cli.main(["--index", paths["port"], "--output",
                          str(tmp / "export_pinned"), "--format", "csv",
                          "--device", "cpu"])
    assert torch.backends.cuda.matmul.allow_tf32 is False


@pytest.mark.parametrize("fmt", ["csv", "prj", "prj --scale", "distances"])
def test_vlad_export_equals_jax(indexed, fmt):
    tmp, _, paths = indexed
    fmt, *extra = fmt.split()
    outs = {}
    for name, main in (("jax", _jax_cli("vlad_export").main),
                       ("port", port_export_cli.main)):
        out = str(tmp / f"export_{name}_{fmt}{'_'.join(extra)}")
        argv = ["--index", paths["port"], "--output", out, "--format", fmt,
                *extra]
        main(argv + (["--device", "cpu"] if name == "port" else []))
        outs[name] = out + (".txt" if fmt == "distances" else "")
    if fmt == "distances":
        got = np.loadtxt(outs["port"], delimiter=",")
        want = np.loadtxt(outs["jax"], delimiter=",")
        assert got.shape == (14, 14)
        off = ~np.eye(14, dtype=bool)
        np.testing.assert_allclose(got[off], want[off], rtol=0,
                                   atol=DIST_ATOL)
        # d(i, i): the port takes |a|^2 from the Gram's own diagonal, so
        # 0 exactly; the JAX script's separate sum of squares leaves up to
        # sqrt(an ulp of |a|^2) ~ 5e-4 there
        assert (np.diag(got) == 0).all() and np.diag(want).max() < 1e-3
    else:
        with open(outs["port"]) as a, open(outs["jax"]) as b:
            assert a.read() == b.read()


GRAPH_RUNS = [
    ("7Scenes", "train", ["--retrieval", "vlad", "--cross-connect"],
     "chess_fc4_sp5_train"),
    ("7Scenes", "test", ["--retrieval", "vlad"], "chess_fc4_sp5_test"),
    ("Cambridge", "test", [], "ShopFacade_fc4_sp3_test"),    # auto: VLAD
]


@pytest.fixture(scope="module")
def vlad_stores(indexed):
    """The JAX CLI and the port's over the same index files."""
    tmp, raw, paths = indexed
    jax_cli = _jax_cli("build_graphs")
    counts = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_cli, "self_exclusion_mask",
                   jax_gb.self_exclusion_mask, raising=False)
        for dataset, mode, extra, store in GRAPH_RUNS:
            scene = "chess" if dataset == "7Scenes" else "ShopFacade"
            index = paths["port" if dataset == "7Scenes" else "cambridge"]
            argv = [scene, mode, "--dataset", dataset, "--data-path",
                    raw[dataset], "--seq-len", "4", "--vlad-index", index,
                    *extra]
            if dataset == "Cambridge":
                argv += ["--pose-stat-path", raw["stats"]]
            jax_cli.main([*argv, "--graph-data-path", str(tmp / "jax")])
            counts[store] = port_build_graphs.main(
                [*argv, "--graph-data-path", str(tmp / "port"), "--device",
                 "cpu"])
    return str(tmp / "jax"), str(tmp / "port"), counts


@pytest.mark.parametrize("store", [r[3] for r in GRAPH_RUNS])
def test_vlad_stores_equal_the_jax_cli(vlad_stores, store):
    jroot, proot, counts = vlad_stores
    assert counts[store] == {"chess_fc4_sp5_train": 12,
                             "chess_fc4_sp5_test": 4,
                             "ShopFacade_fc4_sp3_test": 4}[store]
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


def test_vlad_stores_hold_cross_connect_and_the_missing_row(vlad_stores):
    _, proot, _ = vlad_stores
    nbr = np.load(osp.join(proot, "chess_fc4_sp5_train", "nbr_idx.npy"))
    seq = np.repeat([1, 2], 6)
    assert nbr.shape == (12, 3)
    assert not (seq[nbr] == seq[:, None]).any()
    assert not (nbr == 9).any()      # seq-02 frame 3: no index row
