"""The port's `data/pyg_import.py` and `cli.parity` against the JAX
package's, on the stand-ins tests/test_parity_cli.py writes: a reference
`.pth.tar` (the torch reference model at resnet18, dims 32, 4 nodes) and
torch-geometric `processed/data_*.pt` pickles written through the stub
classes, in the nested (PyG 2.x `_store._mapping`) and flat (PyG 1.x)
layouts; and a packed store of the same graphs.

`pyg_import` is held exact (the same tensors); both parity CLIs, float32,
kNN-4 dynamic graph and the `--knn 0` static anchor, to the same
per-scene medians within 1e-4 (translation in metres, rotation in
degrees) and the same table header.  The
port reads the pickles through its own stub classes: the JAX module's,
registered first by the writers, are taken out of `sys.modules` around
each port read.
"""

import os.path as osp
import sys

import numpy as np
import pytest
import torch

from relpose_gnn_tpu.data import pyg_import as jax_pyg
from relpose_gnn_tpu.ops import graph as graph_ops
from relpose_gnn_tpu_torch.cli import parity as port_cli
from relpose_gnn_tpu_torch.data import pyg_import
from relpose_gnn_tpu_torch.data.packed import PackedGraphWriter
from test_parity_cli import _write_ckpt, _write_pyg_dir

sys.path.insert(0, osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                            "cli"))
import parity as jax_cli  # noqa: E402  (cli/parity.py)

MEDIAN_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def drop_stubs(monkeypatch):
    """Take the torch_geometric stub modules out of `sys.modules` (until
    the test ends), so the port registers and unpickles with its own."""
    for name in [m for m in sys.modules if m.startswith("torch_geometric")]:
        monkeypatch.delitem(sys.modules, name)


def _write_flat_pt(path, n=4, h=8, w=8, seed=0):
    """A PyG 1.x style pickle: the tensors directly on the Data object."""
    jax_pyg.install_pyg_stubs()
    data = sys.modules["torch_geometric.data.data"].Data()
    rng = np.random.default_rng(seed)
    data.x = torch.from_numpy(rng.normal(size=(n, 3 * h * w)).astype(
        np.float32))
    data.edge_index = torch.from_numpy(graph_ops.fc_edge_index(n).copy())
    data.y = torch.from_numpy(rng.normal(size=(n, 6)).astype(np.float32))
    torch.save(data, path)


def _same_graph(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])


def test_nested_layout_reads_as_the_jax_module(tmp_path, monkeypatch):
    gdir = str(tmp_path / "chess_fc4_sp5_test")
    _write_pyg_dir(gdir, n_graphs=3, n=4, h=32, w=36)
    want = list(jax_pyg.iter_pyg_dir(gdir, img_height=32))
    drop_stubs(monkeypatch)
    got = list(pyg_import.iter_pyg_dir(gdir, img_height=32))
    assert issubclass(sys.modules["torch_geometric.data.data"].Data,
                      pyg_import._Stub)
    assert [i for i, _ in got] == [i for i, _ in want] == [0, 1, 2]
    for (_, g), (_, w) in zip(got, want):
        _same_graph(g, w)


def test_flat_layout_reads_as_the_jax_module(tmp_path, monkeypatch):
    path = tmp_path / "data_000000.pt"
    _write_flat_pt(path)
    want = jax_pyg.load_pyg_graph(path)
    drop_stubs(monkeypatch)
    got = pyg_import.load_pyg_graph(path)
    _same_graph(got, want)
    assert got["x"].shape == (4, 192) and "edge_attr" not in got


def test_search_handles_pyg2_storage_objects():
    """Objects whose classes claim a torch_geometric module (a real PyG
    install, stubs not registered): tensors found through `_store`."""
    x, ei, y = torch.ones(2, 3), torch.tensor([[0], [1]]), torch.zeros(2, 6)
    storage = type("BaseStorage", (), {})()
    storage.__class__.__module__ = "torch_geometric.data.storage"
    storage._mapping = {"x": x, "edge_index": ei, "y": y}
    data = type("Data", (), {})()
    data.__class__.__module__ = "torch_geometric.data.data"
    data._store = storage
    found = {}
    pyg_import._search(data, found)
    assert set(found) >= {"x", "edge_index", "y"} and found["x"] is x


def test_missing_tensors_and_empty_dirs_raise(tmp_path, monkeypatch):
    drop_stubs(monkeypatch)
    pyg_import.install_pyg_stubs()
    data = sys.modules["torch_geometric.data.data"].Data()
    data.x = torch.ones(2, 3)
    torch.save(data, tmp_path / "data_000000.pt")
    with pytest.raises(ValueError, match="missing"):
        pyg_import.load_pyg_graph(tmp_path / "data_000000.pt")
    with pytest.raises(FileNotFoundError, match="data_"):
        next(pyg_import.iter_pyg_dir(tmp_path / "empty"))


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """The `.pth.tar`, a pyg directory of 5 graphs and a packed store of
    the same graphs (pixels quantised to uint8 for the store)."""
    tmp = tmp_path_factory.mktemp("parity")
    ckpt = str(tmp / "relpose_gnn__multi_39.pth.tar")
    _write_ckpt(ckpt)
    pyg_root = tmp / "pyg"
    graphs = _write_pyg_dir(str(pyg_root / "chess_fc4_sp5_test"),
                            n_graphs=5, n=4, h=32, w=36)
    packed_root = tmp / "packed"
    writer = PackedGraphWriter(str(packed_root / "chess_fc4_sp5_test"),
                               num_graphs=5, num_nodes=4, height=32,
                               width=36, mean=np.full(3, 0.5),
                               std=np.full(3, 0.25))
    adj = graph_ops.edge_index_to_adj(graph_ops.fc_edge_index(4), 4)
    for images, y in graphs:
        x01 = np.clip(images.transpose(0, 2, 3, 1) * 0.1 + 0.5, 0, 1)
        writer.add(x01.astype(np.float32), y, adj)
    writer.finalize()
    return ckpt, str(pyg_root), str(packed_root)


def _both(artifacts, capsys, monkeypatch, root, knn):
    ckpt = artifacts[0]
    argv = ["--weights", ckpt, "--graph-data-dir", root, "--scenes",
            "chess", "--seq-len", "4", "--knn", str(knn), "--backbone",
            "resnet18", "--img-height", "32", "--batch-size", "2",
            "--dtype", "float32"]
    want = jax_cli.main(argv)
    want_out = capsys.readouterr().out
    drop_stubs(monkeypatch)
    got = port_cli.main([*argv, "--device", "cpu"])
    got_out = capsys.readouterr().out
    return got, want, got_out, want_out


@pytest.mark.parametrize("knn", [4, 0])
@pytest.mark.parametrize("layout", ["pyg", "packed"])
def test_parity_cli_matches_jax(artifacts, capsys, monkeypatch, layout,
                                knn):
    root = artifacts[1] if layout == "pyg" else artifacts[2]
    got, want, got_out, want_out = _both(artifacts, capsys, monkeypatch,
                                         root, knn)
    assert [r[0] for r in got] == [r[0] for r in want] == ["chess"]
    (_, g, gpub), (_, w, wpub) = got[0], want[0]
    assert gpub == wpub == (0.09, 2.9)
    assert len(g.t_errors) == len(w.t_errors) == 5
    assert abs(g.median_t - w.median_t) < MEDIAN_TOL
    assert abs(g.median_q - w.median_q) < MEDIAN_TOL
    np.testing.assert_allclose(g.t_errors, w.t_errors, atol=MEDIAN_TOL)
    assert got_out.splitlines()[0] == want_out.splitlines()[0]
    assert "chess" in got_out.splitlines()[1]


def test_dataset_dir_count_check_and_exports(artifacts, tmp_path, capsys):
    raw = tmp_path / "raw" / "chess"
    (raw / "seq-03").mkdir(parents=True)
    (raw / "TestSplit.txt").write_text("sequence3\n")
    for i in range(4):   # one fewer than the 5 graphs
        (raw / "seq-03" / f"frame-{i:06d}.color.png").write_bytes(b"")
    argv = ["--weights", artifacts[0], "--graph-data-dir", artifacts[2],
            "--scenes", "chess", "--seq-len", "4", "--backbone", "resnet18",
            "--img-height", "32", "--dtype", "float32", "--device", "cpu"]
    with pytest.raises(IOError, match="4 filenames != 5 graphs"):
        port_cli.main([*argv, "--dataset-dir", str(tmp_path / "raw")])
    port_cli.main([*argv, "--save-dir", str(tmp_path / "preds")])
    assert list((tmp_path / "preds").glob("*.npz"))
    with pytest.raises(FileNotFoundError, match="no graph store"):
        port_cli.main([*argv[:2], "--graph-data-dir", str(tmp_path),
                       *argv[4:]])
