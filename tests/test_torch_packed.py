"""The port's packed graph store (relpose_gnn_tpu_torch/data/packed.py)
against the JAX package's: the same records written by either package's
writer give byte-identical files, and either reader reads the other's
store to the same arrays."""

import filecmp
import os

import numpy as np
import pytest

from relpose_gnn_tpu.data import packed as jax_packed
from relpose_gnn_tpu_torch.data import packed as port_packed

FILES = ("meta.json", "images.npy", "poses.npy", "adj.npy", "nbr_idx.npy",
         "rel_paths.json")


def _write(mod, root, dtype, n_written=3):
    rng = np.random.default_rng(0)
    n, h, w = 4, 6, 8
    writer = mod.PackedGraphWriter(root, 5, n, h, w, mean=[0.4, 0.45, 0.5],
                                   std=[0.2, 0.25, 0.3], dtype=dtype)
    for i in range(n_written):     # fewer than preallocated: header slices
        writer.add(rng.random((n, h, w, 3)).astype(np.float32),
                   rng.normal(size=(n, 6)).astype(np.float32),
                   ~np.eye(n, dtype=bool),
                   nbr_idx=rng.integers(0, 9, n - 1) if i % 2 == 0 else None,
                   rel_path=f"seq-01/frame-{i:06d}.color.png")
    writer.finalize()


@pytest.mark.parametrize("dtype", ["uint8", "float16"])
def test_writers_produce_identical_files(tmp_path, dtype):
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    _write(jax_packed, a, dtype)
    _write(port_packed, b, dtype)
    for name in FILES:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name),
                           shallow=False), name


@pytest.mark.parametrize("writer,reader", [(jax_packed, port_packed),
                                           (port_packed, jax_packed)])
def test_cross_package_round_trip(tmp_path, writer, reader):
    root, ref = str(tmp_path / "store"), str(tmp_path / "ref")
    _write(writer, root, "uint8")
    _write(reader, ref, "uint8")
    got = reader.PackedGraphDataset(root)
    want = writer.PackedGraphDataset(ref)
    assert len(got) == len(want) == 3
    assert got.meta == want.meta and got.rel_paths == want.rel_paths
    for name in ("images", "poses", "adj", "nbr_idx", "mean", "std"):
        x, y = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), name
    gb = got.batch(np.array([2, 0]), with_nbr_idx=True)
    wb = want.batch(np.array([2, 0]), with_nbr_idx=True)
    assert sorted(gb) == sorted(wb) == ["adj", "images", "nbr_idx", "poses"]
    for k in gb:
        np.testing.assert_array_equal(gb[k], wb[k])


def test_port_packed_has_no_jax_package_import():
    import ast
    import inspect
    tree = ast.parse(inspect.getsource(port_packed))
    mods = [n.module if isinstance(n, ast.ImportFrom) else a.name
            for n in ast.walk(tree)
            if isinstance(n, (ast.Import, ast.ImportFrom))
            for a in (n.names if isinstance(n, ast.Import) else [n])]
    assert not [m for m in mods if m and (m.split(".")[0] in (
        "jax", "flax", "relpose_gnn_tpu"))], mods
