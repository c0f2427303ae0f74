"""The port's graph builder (relpose_gnn_tpu_torch/data/graph_builder.py)
against the JAX package's: the same datasets, similarities, masks and
seed through both, and the two stores compared file by file, byte for
byte (images.npy, poses.npy, adj.npy, nbr_idx.npy, meta.json,
rel_paths.json).  RAND and IR retrieval, cross-connect, short-ranking
padding, the all-excluded skip and corrupt frames, on the toy datasets
of tests/test_data.py and on a 7-Scenes fixture read by each package's
own loader (there the poses, which each loader computes itself, agree
within atol 1e-6); `self_exclusion_mask` over the JAX test's cases."""

import filecmp
import os
import warnings

import numpy as np
import pytest

from relpose_gnn_tpu.data import graph_builder as jax_gb
from relpose_gnn_tpu.data.seven_scenes import SevenScenes as JaxSevenScenes
from relpose_gnn_tpu_torch.data import graph_builder as gb
from relpose_gnn_tpu_torch.data.packed import PackedGraphDataset
from relpose_gnn_tpu_torch.data.seven_scenes import SevenScenes
from test_data import _ToyDataset, write_7scenes_fixture

FILES = ("images.npy", "poses.npy", "adj.npy", "nbr_idx.npy", "meta.json",
         "rel_paths.json")


class _PathToy(_ToyDataset):
    """A toy dataset whose frames have paths, and some frames unreadable."""

    def __init__(self, n, bad=(), seed=0, seq_len=5):
        super().__init__(n, seed=seed)
        self.bad = set(bad)
        self.seq_id = (np.arange(n) // seq_len).astype(np.int32)

    def load_image(self, i):
        return None if i in self.bad else super().load_image(i)

    def rel_path(self, i):
        return f"scene/seq-{self.seq_id[i]:02d}/frame-{i:06d}.color.png"


def _build_both(tmp_path, query, database, cfg_kw, **kw):
    """Build with each package (warnings recorded); compare the stores
    byte for byte; return (count, warnings, port store root)."""
    out = {}
    for name, mod in (("port", gb), ("jax", jax_gb)):
        root = str(tmp_path / name)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            n = mod.build_graphs(query, database, root,
                                 mod.GraphBuilderConfig(**cfg_kw), **kw)
        out[name] = (n, [str(w.message) for w in caught], root)
    assert out["port"][:2] == out["jax"][:2]
    for f in FILES:
        a = os.path.join(out["port"][2], f)
        b = os.path.join(out["jax"][2], f)
        assert os.path.exists(a) == os.path.exists(b), f
        if os.path.exists(a):
            assert filecmp.cmp(a, b, shallow=False), f
    return out["port"]


@pytest.mark.parametrize("seed", [0, 3])
def test_rand_mode_store_equals_jax(tmp_path, seed):
    ds = _PathToy(10)
    n, _, root = _build_both(tmp_path, ds, ds,
                             dict(seq_len=4, retrieval_mode="RAND",
                                  seed=seed), height=8, width=10)
    assert n == 10
    store = PackedGraphDataset(root)
    assert store.rel_paths == [ds.rel_path(i) for i in range(10)]
    np.testing.assert_array_equal(store.poses[:, 0], ds.poses)


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("structure", ["fc", "ho", "rnn"])
def test_ir_mode_store_equals_jax(tmp_path, cross, structure):
    n = 30
    ds = _PathToy(n)
    desc = np.random.default_rng(3).normal(size=(n, 8))
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)

    def invalid(qi):
        return gb.self_exclusion_mask(n, qi, True, cross_connect=cross,
                                      seq_ids=ds.seq_id,
                                      query_seq=ds.seq_id[qi])

    written, _, root = _build_both(
        tmp_path, ds, ds,
        dict(seq_len=4, sampling_period=2, seed=1, cross_connect=cross,
             graph_structure=structure),
        similarity_fn=lambda qi: desc @ desc[qi], invalid_fn=invalid,
        mean=[0.4, 0.5, 0.6], std=[0.2, 0.2, 0.3], height=6, width=12)
    assert written == n
    store = PackedGraphDataset(root)
    for qi in range(n):
        assert not invalid(qi)[store.nbr_idx[qi]].any()


def test_short_ranking_is_padded_like_jax(tmp_path):
    ds = _PathToy(3)
    sim = np.eye(3)
    n, _, root = _build_both(
        tmp_path, ds, ds, dict(seq_len=8, retrieval_mode="IR", seed=0),
        similarity_fn=lambda qi: sim[qi],
        invalid_fn=lambda qi: gb.self_exclusion_mask(3, qi, True),
        height=8, width=10)
    assert n == 3
    nbr = PackedGraphDataset(root).nbr_idx
    assert nbr.shape == (3, 7) and (nbr >= 0).all() and (nbr < 3).all()


def test_all_excluded_queries_are_skipped_like_jax(tmp_path):
    ds = _PathToy(6)
    n, msgs, _ = _build_both(
        tmp_path, ds, ds, dict(seq_len=4, retrieval_mode="IR", seed=0),
        similarity_fn=lambda qi: np.ones(6),
        invalid_fn=lambda qi: np.ones(6, bool), height=8, width=10)
    assert n == 0 and len(msgs) == 6 and "excluded" in msgs[0]


@pytest.mark.parametrize("mode", ["RAND", "IR"])
def test_corrupt_frames_are_skipped_like_jax(tmp_path, mode):
    ds = _PathToy(12, bad={3, 7})
    desc = np.random.default_rng(4).normal(size=(12, 5))
    n, _, root = _build_both(
        tmp_path, ds, ds, dict(seq_len=4, retrieval_mode=mode, seed=2,
                               sampling_period=1),
        similarity_fn=lambda qi: desc @ desc[qi],
        invalid_fn=lambda qi: gb.self_exclusion_mask(12, qi, True),
        height=8, width=10)
    assert 0 < n < 10
    assert len(PackedGraphDataset(root)) == n


def test_store_from_seven_scenes_loaders_equals_jax(tmp_path):
    """Each package's SevenScenes over one raw tree, IR retrieval over
    seeded descriptors with cross-connect by `seq_id`: the same store."""
    raw = str(tmp_path / "raw")
    write_7scenes_fixture(raw, n_seqs=3, n_frames=4, size=(40, 32))
    port_ds = SevenScenes("chess", raw, train=True, image_size=24)
    jax_ds = JaxSevenScenes("chess", raw, train=True, image_size=24)
    m = len(port_ds)
    desc = np.random.default_rng(5).normal(size=(m, 16))

    def invalid(qi):
        return gb.self_exclusion_mask(m, qi, True, True,
                                      seq_ids=port_ds.seq_id,
                                      query_seq=port_ds.seq_id[qi])

    out = {}
    for name, mod, ds in (("port", gb, port_ds), ("jax", jax_gb, jax_ds)):
        root = str(tmp_path / name)
        out[name] = mod.build_graphs(
            ds, ds, root, mod.GraphBuilderConfig(seq_len=4, seed=0,
                                                 cross_connect=True),
            similarity_fn=lambda qi: desc @ desc[qi], invalid_fn=invalid,
            height=24, width=32)
    assert out["port"] == out["jax"] == m
    for f in FILES:
        if f != "poses.npy":
            assert filecmp.cmp(str(tmp_path / "port" / f),
                               str(tmp_path / "jax" / f), shallow=False), f
    # the loaders' poses agree to float32 rounding of arccos and sqrt
    # (tests/test_torch_loaders.py), and the store holds them as read
    np.testing.assert_allclose(np.load(tmp_path / "port" / "poses.npy"),
                               np.load(tmp_path / "jax" / "poses.npy"),
                               atol=1e-6)


def test_fit_matches_jax():
    rng = np.random.default_rng(6)
    for shape in ((5, 7, 3), (12, 3, 3), (8, 10, 3)):
        img = rng.random(shape).astype(np.float32)
        for h, w in ((8, 10), (4, 4), (16, 2)):
            np.testing.assert_array_equal(gb._fit(img, h, w),
                                          jax_gb._fit(img, h, w))


@pytest.mark.parametrize("args,kw", [
    ((10, 3, True), {}),
    ((10, 3, True), dict(cross_connect=True, group_len=5)),
    ((10, 3, False), {}),
    ((10, 12, True), {}),
    ((9, 4, True), dict(cross_connect=True, query_seq=2,
                        seq_ids=np.array([1, 1, 1, 2, 2, 3, 3, 3, 3]))),
    ((9, 0, True), dict(cross_connect=True, query_seq=2,
                        seq_ids=np.array([1, 1, 1, 2, 2, 3, 3, 3, 3]))),
    ((9, 0, True), dict(cross_connect=False, query_seq=2,
                        seq_ids=np.array([1, 1, 1, 2, 2, 3, 3, 3, 3]))),
])
def test_self_exclusion_mask_matches_jax(args, kw):
    got = gb.self_exclusion_mask(*args, **kw)
    np.testing.assert_array_equal(got, jax_gb.self_exclusion_mask(*args,
                                                                  **kw))
    assert got.dtype == bool
