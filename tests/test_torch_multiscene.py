"""The port's MultiSceneService against the JAX one, on the small model of
tests/test_torch_service.py (resnet18, feat_dim 32, 4 NetVLAD clusters,
32x40 frames, float32) with the same weights through the converters, and
the port's own contracts: multi-scene equals single-scene with `norm_ms`,
scenes do not leak, per-scene add / invalidate / compact / save / load,
and every fail-loud check.

Tolerances.  Deterministic queries on the SAME tables (the JAX
snapshot's, carried across): neighbours and anchors exact, poses atol
1e-4.  Tables embedded by both frameworks: descriptors atol 2e-6,
embeddings atol 1e-4 (a ResNet18 summed in another order).  Everything the
port compares with itself is exact.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from relpose_gnn_tpu.evaluation import multiscene as jax_multiscene
from relpose_gnn_tpu.evaluation import service as jax_service
from relpose_gnn_tpu.models.netvlad import NetVLADEncoder as JaxEncoder
from relpose_gnn_tpu.models.posenet import RelPoseGNN as JaxRelPoseGNN
from relpose_gnn_tpu.models.posenet import RelPoseGNNConfig as JaxConfig
from relpose_gnn_tpu_torch.evaluation.multiscene import (MultiSceneService,
                                                         SceneDatabase)
from relpose_gnn_tpu_torch.evaluation.service import (RelocalizationService,
                                                      ServiceConfig)
from relpose_gnn_tpu_torch.models.convert import (netvlad_state_dict_from_jax,
                                                  state_dict_from_jax)
from relpose_gnn_tpu_torch.models.netvlad import NetVLADEncoder
from relpose_gnn_tpu_torch.models.posenet import RelPoseGNN, RelPoseGNNConfig
from test_torch_service import (FINGERPRINT_KEYS, H, MODEL_KW, MODES, RHW,
                                SEQ, STAGES, W, make_scene,
                                weights)  # noqa: F401  (a fixture)

CAP = 16
# not powers of two: 1/std is inexact, so (x - mean) * (1/std) and
# (x - mean) / std differ and the identities below are not vacuous
STATS = {"a": (np.float32([0.45, 0.43, 0.41]),
               np.float32([0.293, 0.277, 0.301])),
         "b": (np.float32([0.52, 0.50, 0.48]),
               np.float32([0.311, 0.286, 0.297]))}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads while this module runs: the suite runs several
    test processes on one host, and torch's default of one thread a core
    in each of them oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def scene(name):
    """10 frames with wide similarity gaps; the two scenes' fields and
    poses differ."""
    return make_scene(10, seed={"a": 3, "b": 4}[name])


def _cfg(cls, retrieval, **kw):
    return cls(**{**dict(seq_len=SEQ, sampling_period=2, retrieval_hw=RHW,
                         retrieval=retrieval, deterministic=True,
                         capacity=CAP), **kw})


def _modules(weights, retrieval):
    mvars, nvars = weights
    model = RelPoseGNN(RelPoseGNNConfig(**MODEL_KW)).eval()
    model.load_state_dict(state_dict_from_jax(
        mvars["params"], mvars["batch_stats"], STAGES), strict=True)
    netvlad = None
    if retrieval == "netvlad":
        netvlad = NetVLADEncoder(num_clusters=4).eval()
        netvlad.load_state_dict(netvlad_state_dict_from_jax(
            nvars["params"]), strict=True)
    return model, netvlad


def port_multi(weights, retrieval="netvlad", scenes=("a", "b"), **kw):
    ms = MultiSceneService(*_modules(weights, retrieval),
                           _cfg(ServiceConfig, retrieval, **kw),
                           device="cpu")
    for name in scenes:
        ms.add_scene(name, *scene(name), *STATS[name], batch=4)
    return ms


def port_single(weights, name, retrieval="netvlad", **kw):
    """A single-scene service built on scene `name` with the scene's
    normalization in the `norm_ms` form; returns (service, norm_ms)."""
    svc = RelocalizationService(*_modules(weights, retrieval),
                                _cfg(ServiceConfig, retrieval, **kw),
                                device="cpu")
    mean, std = map(torch.from_numpy, STATS[name])

    def norm(x01):
        return (x01 - mean) * (1.0 / std)

    svc.build(*scene(name), norm, batch=4)
    return svc, STATS[name]


def jax_multi(weights, retrieval="netvlad", scenes=("a", "b")):
    mvars, nvars = weights
    netvlad = JaxEncoder(num_clusters=4) if retrieval == "netvlad" else None
    ms = jax_multiscene.MultiSceneService(
        JaxRelPoseGNN(JaxConfig(**MODEL_KW)), mvars, netvlad,
        nvars if netvlad is not None else None,
        _cfg(jax_service.ServiceConfig, retrieval))
    for name in scenes:
        ms.add_scene(name, *scene(name), *STATS[name], batch=4)
    return ms


def jax_snapshot_to_port(src, dst):
    """Turn a JAX MultiSceneService snapshot into one the port loads: the
    tables and per-scene keys are the same `.npz` entries; only the model
    fingerprint (a hash of JAX tree paths) has no meaning here and is
    dropped, which the port's loader accepts."""
    z = dict(np.load(src))
    for k in FINGERPRINT_KEYS:
        z.pop(k)
    np.savez(dst, **z)


def queries(name):
    db, _ = scene(name)
    return np.concatenate([db[[4, 8]],
                           np.clip(db[[1, 6]] * 0.9 + 0.03, 0, 1)])


def _assert_same(a, b):
    for k in ("pose", "neighbors", "anchor"):
        assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])), k


@pytest.fixture(scope="module")
def pair(weights, tmp_path_factory):  # noqa: F811
    """Per retrieval mode: the JAX multi-scene service, its snapshot made
    loadable, and the port's service built on the same scenes."""
    tmp = tmp_path_factory.mktemp("multi")
    out = {}
    for mode in MODES:
        jms = jax_multi(weights, mode)
        raw, snap = str(tmp / f"{mode}.npz"), str(tmp / f"{mode}_port.npz")
        jms.save_database(raw)
        jax_snapshot_to_port(raw, snap)
        out[mode] = (jms, raw, snap, port_multi(weights, mode))
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["a", "b"])
def test_query_on_jax_tables_matches_jax(weights, pair, mode,  # noqa: F811
                                         name):
    """A JAX snapshot's tables answer the same in the port: neighbours
    and anchors exact, poses to 1e-4."""
    jms, _, snap, _ = pair[mode]
    ms = MultiSceneService(*_modules(weights, mode),
                           _cfg(ServiceConfig, mode), device="cpu")
    ms.load_database(snap)
    assert sorted(ms.scenes()) == ["a", "b"]
    assert ms.scene_count(name) == 10
    q = queries(name)
    want = jms.query(name, q)
    got = ms.query(name, q)
    np.testing.assert_array_equal(got["neighbors"].numpy(),
                                  np.asarray(want["neighbors"]))
    np.testing.assert_array_equal(got["anchor"].numpy(),
                                  np.asarray(want["anchor"]))
    np.testing.assert_allclose(got["pose"].numpy(), np.asarray(want["pose"]),
                               atol=1e-4)
    assert got["neighbors"][:2, 0].tolist() == [4, 8]


@pytest.mark.parametrize("mode", MODES)
def test_own_tables_match_jax(pair, mode):
    """The port's own embedding of each scene against the JAX tables, the
    queries on them, and the snapshot's keys."""
    jms, raw, _, ms = pair[mode]
    for name in ("a", "b"):
        mine, theirs = ms._scenes[name], jms._scenes[name]
        assert isinstance(mine, SceneDatabase)
        assert tuple(mine.desc.shape) == tuple(theirs.desc.shape)
        np.testing.assert_allclose(mine.desc.numpy(),
                                   np.asarray(theirs.desc), atol=2e-6)
        np.testing.assert_allclose(mine.emb.numpy(), np.asarray(theirs.emb),
                                   atol=1e-4)
        np.testing.assert_array_equal(mine.poses.numpy(),
                                      np.asarray(theirs.poses))
        np.testing.assert_array_equal(mine.valid.numpy(),
                                      np.asarray(theirs.valid))
        assert mine.hw == theirs.hw == (H, W)
        q = queries(name)
        want, got = jms.query(name, q), ms.query(name, q)
        np.testing.assert_array_equal(got["neighbors"].numpy(),
                                      np.asarray(want["neighbors"]))
        np.testing.assert_array_equal(got["anchor"].numpy(),
                                      np.asarray(want["anchor"]))
        np.testing.assert_allclose(got["pose"].numpy(),
                                   np.asarray(want["pose"]), atol=1e-4)


@pytest.mark.parametrize("mode", MODES)
def test_snapshot_keys_and_jax_loads_port_snapshot(weights,  # noqa: F811
                                                   pair, mode, tmp_path):
    jms, raw, _, ms = pair[mode]
    mine, mine_nofp = str(tmp_path / "p.npz"), str(tmp_path / "p_nofp.npz")
    ms.save_database(mine)
    assert sorted(np.load(mine).files) == sorted(np.load(raw).files)
    jax_snapshot_to_port(mine, mine_nofp)   # drops the fingerprint only
    jms2 = jax_multi(weights, mode, scenes=())
    jms2.load_database(mine_nofp)
    for name in ("a", "b"):
        np.testing.assert_array_equal(np.asarray(jms2._scenes[name].desc),
                                      ms._scenes[name].desc.numpy())
        np.testing.assert_array_equal(
            np.asarray(jms2._scenes[name].norm_ms[1]), STATS[name][1])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("deterministic", [True, False])
def test_multiscene_equals_single_scene_with_norm_ms(
        weights, pair, mode, deterministic):  # noqa: F811
    """Each scene served by the multi-scene service is bit-identical to a
    single-scene service built on the same frames and queried with
    `norm_ms`: tables, poses, neighbours, anchors."""
    ms = pair[mode][3] if deterministic else port_multi(
        weights, mode, deterministic=False)
    for name in ("a", "b"):
        single, norm_ms = port_single(weights, name, mode,
                                      deterministic=deterministic)
        assert torch.equal(ms._scenes[name].emb, single.db_emb)
        assert torch.equal(ms._scenes[name].desc, single.db_desc)
        q = queries(name)
        _assert_same(ms.query(name, q, 5),
                     single.query(q, None, 5, norm_ms=norm_ms))
        # uint8 queries take the same path
        q8 = (q * 255).astype(np.uint8)
        _assert_same(ms.query(name, q8, 5),
                     single.query(q8, None, 5, norm_ms=norm_ms))


def test_scenes_do_not_leak(pair):
    """The same pixels asked of two scenes are answered from each scene's
    own tables and normalization."""
    ms = pair["netvlad"][3]
    q = queries("a")
    out_a, out_b = ms.query("a", q), ms.query("b", q)
    assert out_a["neighbors"][:2, 0].tolist() == [4, 8]
    assert not torch.equal(out_a["pose"], out_b["pose"])
    assert not torch.equal(out_a["neighbors"], out_b["neighbors"])
    assert ms.scenes() == ["a", "b"]
    # scene b answers its own frames from its own tables
    own_b = ms.query("b", queries("b"))
    assert own_b["neighbors"][:2, 0].tolist() == [4, 8]


def test_add_frames_matches_fresh_scene(weights):  # noqa: F811
    imgs, poses = scene("a")
    grown = port_multi(weights, scenes=())
    # the same chunks of 4, 4 and 2 frames as the fresh build embeds
    grown.add_scene("a", imgs[:8], poses[:8], *STATS["a"], batch=4)
    grown.add_frames("a", imgs[8:], poses[8:], batch=4)
    fresh = port_multi(weights, scenes=("a",))
    assert grown.scene_count("a") == 10
    for f in ("desc", "emb", "poses", "valid"):
        assert torch.equal(getattr(grown._scenes["a"], f),
                           getattr(fresh._scenes["a"], f)), f
    _assert_same(grown.query("a", queries("a")),
                 fresh.query("a", queries("a")))


@pytest.mark.parametrize("deterministic", [True, False])
def test_invalidate_and_compact_per_scene(weights,  # noqa: F811
                                          deterministic):
    ms = port_multi(weights, deterministic=deterministic)
    q = queries("a")
    other = ms.query("b", queries("b"), 3)
    ms.invalidate_frames("a", [4, 5])
    before = ms.query("a", q, 3)
    assert not np.isin(before["neighbors"].numpy(), [4, 5]).any()
    old_to_new = ms.compact_scene("a")
    assert ms.scene_count("a") == 8 and ms.scene_count("b") == 10
    assert old_to_new[4] == old_to_new[5] == -1 and old_to_new[6] == 4
    after = ms.query("a", q, 3)
    np.testing.assert_array_equal(old_to_new[before["neighbors"].numpy()],
                                  after["neighbors"].numpy())
    assert torch.equal(before["pose"], after["pose"])
    _assert_same(other, ms.query("b", queries("b"), 3))
    with pytest.raises(ValueError, match="out of range"):
        ms.invalidate_frames("a", [8])


@pytest.mark.parametrize("mode", MODES)
def test_save_load_roundtrip_bitwise(weights, pair, mode,  # noqa: F811
                                     tmp_path):
    ms = pair[mode][3]
    path = str(tmp_path / "snap.npz")
    ms.save_database(path)
    # the load replaces the registry wholesale: a scene added before it
    # is gone afterwards
    loaded = port_multi(weights, mode, scenes=())
    loaded.add_scene("stale", *scene("b"), *STATS["a"], batch=4)
    loaded.load_database(path)
    assert sorted(loaded.scenes()) == ["a", "b"]
    for name in ("a", "b"):
        for f in ("desc", "emb", "poses", "valid"):
            assert torch.equal(getattr(loaded._scenes[name], f),
                               getattr(ms._scenes[name], f)), (name, f)
        assert loaded._scenes[name].hw == (H, W)
        assert torch.equal(loaded._scenes[name].norm_ms[1],
                           torch.from_numpy(STATS[name][1]))
        _assert_same(loaded.query(name, queries(name)),
                     ms.query(name, queries(name)))
    # growth goes on after a load
    imgs, poses = scene("a")
    loaded.add_frames("b", imgs[:2], poses[:2])
    assert loaded.scene_count("b") == 12


def test_query_stream_matches_sequential(weights):  # noqa: F811
    from relpose_gnn_tpu_torch.retrieval.subsample import fold_in

    ms = port_multi(weights, deterministic=False)
    q = queries("a")
    batches = [q[:2], q[2:], q[1:3]]
    one_by_one = [ms.query("a", b, fold_in(7, i))
                  for i, b in enumerate(batches)]
    streamed = list(ms.query_stream("a", batches, depth=2, rng=7))
    assert len(streamed) == 3
    for s, o in zip(streamed, one_by_one):
        assert isinstance(s["pose"], np.ndarray)
        _assert_same(s, o)
    with pytest.raises(KeyError, match="unknown scene"):
        ms.query_stream("nope", batches)


# ---------------------------------------------------------------------------
# every error of the contract
# ---------------------------------------------------------------------------


def test_requires_capacity(weights):  # noqa: F811
    with pytest.raises(ValueError, match="requires ServiceConfig.capacity"):
        MultiSceneService(*_modules(weights, "netvlad"),
                          _cfg(ServiceConfig, "netvlad", capacity=None),
                          device="cpu")


def test_entry_point_refuses_to_run_without_a_card(weights):  # noqa: F811
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiSceneService(*_modules(weights, "netvlad"),
                          _cfg(ServiceConfig, "netvlad"))


def test_scene_validation(weights):  # noqa: F811
    ms = port_multi(weights, scenes=("a",))
    imgs, poses = scene("b")
    with pytest.raises(ValueError, match="already added"):
        ms.add_scene("a", imgs, poses, *STATS["b"])
    big = np.concatenate([imgs, imgs])
    with pytest.raises(ValueError, match="> capacity"):
        ms.add_scene("big", big, np.concatenate([poses, poses]),
                     *STATS["b"])
    with pytest.raises(ValueError, match="does not match the image batch"):
        ms.add_scene("short", imgs, poses[:-1], *STATS["b"])
    with pytest.raises(ValueError, match="does not match the image batch"):
        ms.add_frames("a", imgs[:2], poses[:3])
    with pytest.raises(ValueError, match="capacity exceeded for scene 'a'"):
        ms.add_frames("a", imgs[:7], poses[:7])
    assert ms.scenes() == ["a"] and ms.scene_count("a") == 10


def test_unknown_scene_fails_with_available_list(weights):  # noqa: F811
    ms = port_multi(weights, scenes=("a",))
    for call in (lambda: ms.query("kitchen", queries("a")),
                 lambda: ms.scene_count("kitchen"),
                 lambda: ms.add_frames("kitchen", *scene("a")),
                 lambda: ms.invalidate_frames("kitchen", [0]),
                 lambda: ms.compact_scene("kitchen")):
        with pytest.raises(KeyError, match=r"unknown scene 'kitchen'.*\['a'\]"):
            call()
    empty = port_multi(weights, scenes=())
    with pytest.raises(KeyError, match="no scenes"):
        empty.query("a", queries("a"))


def test_resolution_guards(weights):  # noqa: F811
    ms = port_multi(weights, scenes=("a",))
    imgs, poses = scene("a")
    with pytest.raises(ValueError, match="mixed resolutions"):
        ms.query("a", imgs[:2, :, :32])
    with pytest.raises(ValueError, match="mixed resolutions"):
        ms.add_frames("a", imgs[:2, :24], poses[:2])


def test_load_rejections(weights, pair, tmp_path):  # noqa: F811
    ms = pair["netvlad"][3]
    path = str(tmp_path / "multi.npz")
    ms.save_database(path)
    # a single-scene snapshot, and the other way round
    single, _ = port_single(weights, "a")
    single_path = str(tmp_path / "single.npz")
    single.save_database(single_path)
    with pytest.raises(ValueError, match="not a MultiSceneService snapshot"):
        ms.load_database(single_path)
    with pytest.raises(ValueError, match="is a MultiSceneService snapshot"):
        single.load_database(path)
    # another retrieval mode, another retrieval resolution
    with pytest.raises(ValueError, match="retrieval='netvlad'"):
        port_multi(weights, "shared-trunk", scenes=()).load_database(path)
    with pytest.raises(ValueError, match="retrieval_hw="):
        port_multi(weights, scenes=(),
                   retrieval_hw=(32, 48)).load_database(path)
    # rows != capacity; the registry survives the failed load
    other = port_multi(weights, scenes=("b",), capacity=CAP + 1)
    with pytest.raises(ValueError, match=r"rows \(16\) != capacity \(17\)"):
        other.load_database(path)
    assert other.scenes() == ["b"] and other.scene_count("b") == 10
    # a snapshot whose second scene is malformed leaves nothing half-loaded
    z = dict(np.load(path))
    z["b/desc"] = z["b/desc"][:-1]
    broken = str(tmp_path / "broken.npz")
    np.savez(broken, **z)
    keep = port_multi(weights, scenes=("b",))
    with pytest.raises(ValueError, match="scene 'b' snapshot rows"):
        keep.load_database(broken)
    assert keep.scenes() == ["b"]
    # other weights
    model, netvlad = _modules(weights, "netvlad")
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.01)
    stranger = MultiSceneService(model, netvlad,
                                 _cfg(ServiceConfig, "netvlad"),
                                 device="cpu")
    with pytest.raises(ValueError, match="different model WEIGHTS"):
        stranger.load_database(path)
    # the JAX service's own fingerprint fails the structure check loudly
    with pytest.raises(ValueError, match="DIFFERENT parameter structure"):
        ms.load_database(pair["netvlad"][1])
    assert sorted(ms.scenes()) == ["a", "b"]


def test_embed_uses_reciprocal_multiply(weights):  # noqa: F811
    """A scene's tables come from (x - mean) * (1/std), not / std: with
    the division the embeddings differ in the last bits."""
    ms = port_multi(weights, "shared-trunk", scenes=("a",))
    svc = ms._svc
    mean, std = map(torch.from_numpy, STATS["a"])
    imgs = torch.from_numpy(scene("a")[0][:4])
    with torch.no_grad():
        mul = svc.model.encode_nodes(
            ((imgs - mean) * (1.0 / std))[:, None])[:, 0]
        div = svc.model.encode_nodes(((imgs - mean) / std)[:, None])[:, 0]
    assert torch.equal(ms._scenes["a"].emb[:4], mul)
    assert not torch.equal(mul, div)
    assert jnp.float32(1.0) / jnp.float32(STATS["a"][1][0]) \
        == np.float32(1.0) / STATS["a"][1][0]
