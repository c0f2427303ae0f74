"""The port's RelocalizationService against the JAX service, on a small
model (resnet18, feat_dim 32, seq_len 4, NetVLAD with 4 clusters, float32)
with the same weights, and the port's own contracts (growth, tombstones,
compaction, snapshots, bit identities, fail-loud checks).

The scene is synthetic with wide similarity gaps: overlapping crops of a
few smooth base fields, so that neighbour sets do not hinge on 1e-6
differences between the frameworks.

Tolerances.  Database tables: descriptors are L2-normalised (entries
~1e-2), atol 2e-6; backbone embeddings (a ResNet18 summed in another
order) atol 1e-4.  Deterministic queries on the SAME tables: neighbours
and anchors exact, poses atol 1e-4.  Everything the port compares with
itself (growth, compaction, snapshots, uint8, stream, windows) is exact.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.ndimage import gaussian_filter

from relpose_gnn_tpu.evaluation import service as jax_service
from relpose_gnn_tpu.models.netvlad import NetVLADEncoder as JaxEncoder
from relpose_gnn_tpu.models.posenet import RelPoseGNN as JaxRelPoseGNN
from relpose_gnn_tpu.models.posenet import RelPoseGNNConfig as JaxConfig
from relpose_gnn_tpu_torch.evaluation.service import (RelocalizationService,
                                                      ServiceConfig,
                                                      similarities)
from relpose_gnn_tpu_torch.models.convert import (netvlad_state_dict_from_jax,
                                                  state_dict_from_jax)
from relpose_gnn_tpu_torch.models.netvlad import NetVLADEncoder
from relpose_gnn_tpu_torch.models.posenet import RelPoseGNN, RelPoseGNNConfig

SEQ, H, W, RHW = 4, 32, 40, (48, 64)
STAGES = (2, 2, 2, 2)
MODEL_KW = dict(num_nodes=SEQ, feat_dim=32, edge_dim=32, node_dim=32, knn=2,
                backbone="resnet18", droprate=0.0)
FINGERPRINT_KEYS = ("model_struct", "model_checksum")
MODES = ("netvlad", "shared-trunk")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads while this module runs: the suite runs several
    test processes on one host, and torch's default of one thread a core
    in each of them oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def model_norm(x):
    """Works on jax arrays and torch tensors alike."""
    return (x - 0.5) / 0.25


def make_scene(n, seed=0, n_fields=3):
    """n frames [n, H, W, 3] in [0, 1]: sliding crops of `n_fields`
    smooth random fields (neighbouring crops overlap, fields differ)."""
    rng = np.random.default_rng(seed)
    fields = []
    for _ in range(n_fields):
        f = gaussian_filter(rng.normal(size=(90, 140, 3)), sigma=(5, 5, 0))
        fields.append((f - f.min()) / (f.max() - f.min()))
    per = -(-n // n_fields)
    frames = [fields[i // per][4 * (i % per):4 * (i % per) + H,
                               7 * (i % per):7 * (i % per) + W]
              for i in range(n)]
    return (np.stack(frames).astype(np.float32),
            rng.normal(size=(n, 6)).astype(np.float32))


@pytest.fixture(scope="module")
def weights():
    """JAX variables (numpy) of the pose model and the NetVLAD encoder."""
    jmodel = JaxRelPoseGNN(JaxConfig(**MODEL_KW))
    mvars = jax.device_get(jax.jit(lambda k: jmodel.init(
        k, jnp.ones((1, SEQ, H, W, 3)), jnp.ones((1, SEQ, SEQ), bool),
        train=False))(jax.random.PRNGKey(0)))
    jnet = JaxEncoder(num_clusters=4)
    nvars = jax.device_get(jax.jit(lambda k: jnet.init(
        k, jnp.ones((1, *RHW, 3))))(jax.random.PRNGKey(1)))
    return mvars, nvars


def port_service(weights, retrieval="netvlad", **cfg_kw):
    mvars, nvars = weights
    model = RelPoseGNN(RelPoseGNNConfig(**MODEL_KW)).eval()
    model.load_state_dict(state_dict_from_jax(
        mvars["params"], mvars["batch_stats"], STAGES), strict=True)
    netvlad = None
    if retrieval == "netvlad":
        netvlad = NetVLADEncoder(num_clusters=4).eval()
        netvlad.load_state_dict(netvlad_state_dict_from_jax(
            nvars["params"]), strict=True)
    cfg = ServiceConfig(**{**dict(seq_len=SEQ, sampling_period=2,
                                  retrieval_hw=RHW, retrieval=retrieval),
                           **cfg_kw})
    return RelocalizationService(model, netvlad, cfg, device="cpu")


def jax_svc(weights, retrieval="netvlad", **cfg_kw):
    mvars, nvars = weights
    cfg = jax_service.ServiceConfig(**{**dict(
        seq_len=SEQ, sampling_period=2, retrieval_hw=RHW,
        retrieval=retrieval), **cfg_kw})
    netvlad = JaxEncoder(num_clusters=4) if retrieval == "netvlad" else None
    return jax_service.RelocalizationService(
        JaxRelPoseGNN(JaxConfig(**MODEL_KW)), mvars, netvlad,
        nvars if netvlad is not None else None, cfg)


def strip_fingerprint(src, dst):
    z = dict(np.load(src))
    for k in FINGERPRINT_KEYS:
        z.pop(k)
    np.savez(dst, **z)


@pytest.fixture(scope="module")
def built(weights, tmp_path_factory):
    """Per retrieval mode: the JAX service and the port's, both built on
    the same 12-frame scene, and the JAX snapshot without fingerprint."""
    tmp = tmp_path_factory.mktemp("svc")
    db, poses = make_scene(12)
    out = {}
    for mode in MODES:
        js = jax_svc(weights, mode, deterministic=True)
        js.build(db, poses, model_norm, batch=4)
        ts = port_service(weights, mode, deterministic=True)
        ts.build(db, poses, model_norm, batch=4)
        raw = str(tmp / f"jax_{mode}.npz")
        js.save_database(raw)
        snap = str(tmp / f"jax_{mode}_nofp.npz")
        strip_fingerprint(raw, snap)
        out[mode] = (js, ts, raw, snap)
    return db, poses, out


@pytest.mark.parametrize("mode", MODES)
def test_build_tables_match_jax(weights, built, mode, tmp_path):
    _, _, services = built
    js, ts, _, snap = services[mode]
    loaded = port_service(weights, mode, deterministic=True)
    loaded.load_database(snap)            # the JAX tables, carried across
    assert loaded.db_count == ts.db_count == 12
    assert loaded.db_desc.dtype == ts.db_desc.dtype == torch.float32
    width = 4 * 512 if mode == "netvlad" else 32
    assert tuple(ts.db_desc.shape) == (12, width)
    np.testing.assert_allclose(ts.db_desc.numpy(), loaded.db_desc.numpy(),
                               atol=2e-6)
    np.testing.assert_allclose(ts.db_emb.numpy(), loaded.db_emb.numpy(),
                               atol=1e-4)
    assert torch.equal(ts.db_poses, loaded.db_poses)
    assert torch.equal(ts.db_valid, loaded.db_valid)
    # and the other way: the JAX service loads the port's snapshot
    mine, mine_nofp = str(tmp_path / "p.npz"), str(tmp_path / "p_nofp.npz")
    ts.save_database(mine)
    strip_fingerprint(mine, mine_nofp)
    js2 = jax_svc(weights, mode, deterministic=True)
    js2.load_database(mine_nofp)
    np.testing.assert_array_equal(np.asarray(js2.db_desc),
                                  ts.db_desc.numpy())
    np.testing.assert_array_equal(np.asarray(js2.db_emb), ts.db_emb.numpy())
    assert js2.db_count == 12 and js2._built_hw == (H, W)
    assert sorted(np.load(mine).files) == sorted(np.load(
        services[mode][2]).files)


@pytest.mark.parametrize("mode", MODES)
def test_deterministic_query_matches_jax(weights, built, mode):
    """The whole query on the same tables: neighbours and anchors exact,
    poses to 1e-4.  Queries: database frames (rank-0 is the frame itself)
    and perturbed ones."""
    db, _, services = built
    js, _, _, snap = services[mode]
    ts = port_service(weights, mode, deterministic=True)
    ts.load_database(snap)
    q = np.concatenate([db[[4, 9]], np.clip(db[[1, 6]] * 0.9 + 0.03, 0, 1)])
    want = js.query(q, model_norm)
    got = ts.query(q, model_norm)
    np.testing.assert_array_equal(got["neighbors"].numpy(),
                                  np.asarray(want["neighbors"]))
    np.testing.assert_array_equal(got["anchor"].numpy(),
                                  np.asarray(want["anchor"]))
    np.testing.assert_allclose(got["pose"].numpy(), np.asarray(want["pose"]),
                               atol=1e-4)
    assert got["neighbors"][:2, 0].tolist() == [4, 9]
    assert got["pose"].shape == (4, 6) and got["neighbors"].shape == (4, 3)
    # the port's own tables give the same neighbours on this scene
    own = services[mode][1].query(q, model_norm)
    assert torch.equal(own["neighbors"], got["neighbors"])
    np.testing.assert_allclose(own["pose"].numpy(), got["pose"].numpy(),
                               atol=1e-4)


@pytest.mark.parametrize("mode", MODES)
def test_norm_ms_matches_jax_and_model_norm(weights, built, mode):
    """norm_ms applies (x - mean) * (1/std), as the JAX service defines
    it: same neighbours as the model_norm call, poses within float32
    rounding of the two forms, and within 1e-4 of JAX's norm_ms query."""
    db, _, services = built
    js, ts, _, _ = services[mode]
    q = db[[2, 7]]
    ms = (np.full(3, 0.5, np.float32), np.full(3, 0.25, np.float32))
    got = ts.query(q, None, norm_ms=ms)
    ref = ts.query(q, model_norm)
    assert torch.equal(got["neighbors"], ref["neighbors"])
    np.testing.assert_allclose(got["pose"].numpy(), ref["pose"].numpy(),
                               atol=1e-5)
    want = js.query(q, None, norm_ms=tuple(map(jnp.asarray, ms)))
    np.testing.assert_array_equal(got["neighbors"].numpy(),
                                  np.asarray(want["neighbors"]))
    np.testing.assert_allclose(got["pose"].numpy(), np.asarray(want["pose"]),
                               atol=1e-4)


def test_resize_drift_against_jax_resize(weights):
    """`F.interpolate(bilinear, antialias=True, align_corners=False)`
    against `jax.image.resize(..., "bilinear")`, shrinking and enlarging:
    the resized pixels, then (as tests/test_service.py::TestResizeDrift
    measures the PIL path) the descriptors' cosine and the top-4 overlap
    on a scene of overlapping views."""
    ts = port_service(weights)
    rng = np.random.default_rng(0)
    field = gaussian_filter(rng.normal(size=(200, 270, 3)), sigma=(7, 7, 0))
    field = (field - field.min()) / (field.max() - field.min())
    frames = np.stack([field[3 * i:3 * i + 96, 4 * i:4 * i + 128]
                       for i in range(16)]).astype(np.float32)
    worst = 0.0
    for src in (frames, frames[:, ::4, ::4]):       # 96x128 down, 24x32 up
        want = jax.image.resize(jnp.asarray(src), (16, *RHW, 3), "bilinear")
        want = (np.asarray(want) - jax_service.IMAGENET_MEAN) \
            / jax_service.IMAGENET_STD
        got = ts._netvlad_input(torch.from_numpy(np.ascontiguousarray(src)))
        worst = max(worst, float(np.abs(got.numpy() - want).max()))
    # measured 5.3e-7 on the normalised input (values up to ~2.6):
    # 1.2e-7 on the [0, 1] pixels, divided by std ~0.225
    assert worst < 5e-6, worst
    with torch.no_grad():
        d_t = ts.netvlad(ts._netvlad_input(torch.from_numpy(frames))).numpy()
        x = jax.image.resize(jnp.asarray(frames), (16, *RHW, 3), "bilinear")
        x = (x - jnp.asarray(jax_service.IMAGENET_MEAN)) \
            / jnp.asarray(jax_service.IMAGENET_STD)
        d_j = ts.netvlad(torch.from_numpy(np.asarray(x))).numpy()
    assert np.sum(d_t * d_j, axis=1).min() > 1 - 1e-6

    def top4(d):
        sim = d.astype(np.float64) @ d.astype(np.float64).T
        np.fill_diagonal(sim, -np.inf)
        return np.argsort(-sim, axis=1)[:, :4]

    overlap = np.mean([len(set(a) & set(b)) / 4
                       for a, b in zip(top4(d_t), top4(d_j))])
    assert overlap == 1.0, overlap


# ---------------------------------------------------------------------------
# the port's own contracts
# ---------------------------------------------------------------------------


def _assert_same(a, b):
    for k in ("pose", "neighbors", "anchor"):
        assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])), k


@pytest.mark.parametrize("mode", MODES)
def test_add_frames_equals_fresh_build(weights, mode):
    db, poses = make_scene(12, seed=1)
    grown = port_service(weights, mode, deterministic=True, capacity=16)
    grown.build(db[:8], poses[:8], model_norm, batch=4)
    assert grown.db_count == 8 and grown.db_desc.shape[0] == 16
    grown.add_frames(db[8:], poses[8:], model_norm, batch=4)
    fresh = port_service(weights, mode, deterministic=True, capacity=16)
    fresh.build(db, poses, model_norm, batch=4)
    assert grown.db_count == fresh.db_count == 12
    for name in ("db_desc", "db_emb", "db_poses", "db_valid"):
        assert torch.equal(getattr(grown, name), getattr(fresh, name)), name
    exact = port_service(weights, mode, deterministic=True)
    exact.build(db, poses, model_norm, batch=4)
    q = db[9:12] * 0.98
    _assert_same(grown.query(q, model_norm), exact.query(q, model_norm))
    assert grown.query(q, model_norm)["neighbors"][:, 0].tolist() == [9, 10,
                                                                      11]


@pytest.mark.parametrize("deterministic,candidates",
                         [(True, 256), (False, None), (False, 8)])
def test_invalidate_and_compact_preserve_results(weights, deterministic,
                                                 candidates):
    db, poses = make_scene(12, seed=2)
    svc = port_service(weights, deterministic=deterministic, capacity=16,
                       retrieval_candidates=candidates)
    svc.build(db[:10], poses[:10], model_norm, batch=4)
    svc.invalidate_frames([0, 2, 7])
    q = np.clip(db[[3, 5, 8, 9]] * 0.97 + 0.01, 0, 1)
    seeds = (0, 1, 2)
    before = [svc.query(q, model_norm, s) for s in seeds]
    for out in before:
        nb = out["neighbors"]
        assert not (set(nb.flatten().tolist()) & {0, 2, 7})
        assert int(nb.max()) < 10 and int(nb.min()) >= 0
    mapping = svc.compact_database()
    assert svc.db_count == 7 and mapping.dtype == np.int64
    np.testing.assert_array_equal(
        mapping[:10], [-1, 0, -1, 1, 2, 3, 4, -1, 5, 6])
    assert (mapping[10:] == -1).all()
    for s, b in zip(seeds, before):
        a = svc.query(q, model_norm, s)
        np.testing.assert_array_equal(mapping[b["neighbors"].numpy()],
                                      a["neighbors"].numpy())
        assert torch.equal(a["pose"], b["pose"])
    # already compact: no new tables
    ref = svc.db_desc
    mapping2 = svc.compact_database()
    assert svc.db_desc is ref
    np.testing.assert_array_equal(mapping2[:7], np.arange(7))
    # the reclaimed slots take new frames (10 + 2 + 7 > 16 without them)
    svc.add_frames(db[10:], poses[10:], model_norm, batch=4)
    assert svc.db_count == 9
    if not deterministic:
        outs = {tuple(svc.query(q, model_norm, s)["neighbors"][0].tolist())
                for s in range(8)}
        assert len(outs) > 1          # the draws do vary with the seed


@pytest.mark.parametrize("mode,rank_dtype,bf16_emb", [
    ("netvlad", "float32", False), ("shared-trunk", "float32", False),
    ("netvlad", "bfloat16", False), ("netvlad", "float32", True)])
def test_save_load_round_trip_is_bit_exact(weights, tmp_path, mode,
                                           rank_dtype, bf16_emb):
    db, poses = make_scene(10, seed=3)
    src = port_service(weights, mode, deterministic=True, capacity=12,
                       rank_dtype=rank_dtype)
    src.build(db, poses, model_norm, batch=4)
    src.invalidate_frames([1])
    if bf16_emb:
        src.db_emb = src.db_emb.to(torch.bfloat16)
    path = str(tmp_path / "db.npz")
    src.save_database(path)
    dst = port_service(weights, mode, deterministic=True, capacity=12,
                       rank_dtype=rank_dtype)
    dst.load_database(path)
    for name in ("db_desc", "db_emb", "db_poses", "db_valid"):
        a, b = getattr(src, name), getattr(dst, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert dst.db_count == 10 and dst._built_hw == (H, W)
    assert dst.db_desc.dtype == getattr(torch, rank_dtype)
    q = db[2:5] * 0.99
    _assert_same(src.query(q, model_norm), dst.query(q, model_norm))
    # growth after a load adopts the call's normalization
    dst.add_frames(db[:2], poses[:2], model_norm, batch=4)
    assert dst.db_count == 12


def test_rank_dtype_bfloat16_contract(weights, tmp_path):
    """The table rounds once to bf16; similarities accumulate in float32
    (error against the float32 table under 5e-4, the bound the JAX tests
    state); a float32 snapshot loaded into a bf16 service equals a fresh
    bf16 build."""
    db, poses = make_scene(10, seed=4)
    f32 = port_service(weights, deterministic=True)
    f32.build(db, poses, model_norm, batch=4)
    bf = port_service(weights, deterministic=True, rank_dtype="bfloat16")
    bf.build(db, poses, model_norm, batch=4)
    assert bf.db_desc.dtype == torch.bfloat16
    assert torch.equal(bf.db_desc, f32.db_desc.to(torch.bfloat16))
    q_desc = f32.db_desc[:4]
    s32 = similarities(q_desc, f32.db_desc)
    sbf = similarities(q_desc, bf.db_desc)
    assert sbf.dtype == torch.float32
    assert 0 < (s32 - sbf).abs().max() < 5e-4
    path = str(tmp_path / "db.npz")
    f32.save_database(path)
    cast = port_service(weights, deterministic=True, rank_dtype="bfloat16")
    cast.load_database(path)
    assert torch.equal(cast.db_desc, bf.db_desc)
    out = bf.query(db[4:5], model_norm)
    assert torch.isfinite(out["pose"]).all()
    assert 0 <= int(out["neighbors"].min()) and \
        int(out["neighbors"].max()) < 10


def test_uint8_query_is_bit_identical_to_quantised_floats(weights):
    db, poses = make_scene(10, seed=5)
    rng = np.random.default_rng(5)
    db8 = (db * 255).astype(np.uint8)
    for det in (True, False):
        svc = port_service(weights, deterministic=det)
        svc.build(db8, poses, model_norm, batch=4)     # uint8 build too
        ref = port_service(weights, deterministic=det)
        ref.build(db8.astype(np.float32) / 255.0, poses, model_norm, batch=4)
        assert torch.equal(svc.db_desc, ref.db_desc)
        assert torch.equal(svc.db_emb, ref.db_emb)
        q8 = rng.integers(0, 256, size=(3, H, W, 3)).astype(np.uint8)
        _assert_same(svc.query(q8, model_norm, 3),
                     svc.query(q8.astype(np.float32) / 255.0, model_norm, 3))


@pytest.mark.parametrize("depth", [1, 3])
def test_query_stream_equals_sequential_queries(weights, depth):
    from relpose_gnn_tpu_torch.retrieval.subsample import fold_in
    db, poses = make_scene(16, seed=6)
    svc = port_service(weights, deterministic=False)
    svc.build(db, poses, model_norm, batch=8)
    rng = np.random.default_rng(6)
    batches = [rng.random((2, H, W, 3)).astype(np.float32)
               for _ in range(5)]
    want = [svc.query(b, model_norm, fold_in(11, i))
            for i, b in enumerate(batches)]
    got = list(svc.query_stream(batches, model_norm, depth=depth, rng=11))
    assert len(got) == 5 and isinstance(got[0]["pose"], np.ndarray)
    for g, w in zip(got, want):
        _assert_same(g, w)
    with pytest.raises(ValueError, match="depth"):
        list(svc.query_stream(batches, model_norm, depth=0))


@pytest.mark.parametrize("mode", MODES)
def test_windowed_selection_equals_full_sort(weights, mode):
    db, poses = make_scene(40, seed=7, n_fields=5)
    q = np.random.default_rng(7).random((3, H, W, 3)).astype(np.float32)
    for det in (False, True):
        outs = []
        for cand in (None, 16):
            svc = port_service(weights, mode, deterministic=det,
                               retrieval_candidates=cand)
            svc.build(db, poses, model_norm, batch=8)
            outs.append(svc.query(q, model_norm, 3))
        _assert_same(*outs)


def test_padding_and_scarce_valid_frames(weights):
    """Capacity padding is invisible, and with fewer valid frames than the
    strided window the ranks clamp to the last valid entry."""
    db, poses = make_scene(10, seed=8)
    q = db[3:6] * 0.97
    exact = port_service(weights, deterministic=True)
    exact.build(db, poses, model_norm, batch=4)
    padded = port_service(weights, deterministic=True, capacity=16)
    padded.build(db, poses, model_norm, batch=4)
    assert padded.db_desc.shape[0] == 16 and padded.db_count == 10
    _assert_same(exact.query(q, model_norm), padded.query(q, model_norm))
    small = port_service(weights, deterministic=True, capacity=16)
    small.build(db[:3], poses[:3], model_norm, batch=4)   # window is 5
    nb = small.query(db[:2], model_norm)["neighbors"]
    assert int(nb.min()) >= 0 and int(nb.max()) < 3
    exact.invalidate_frames(list(range(2, 10)))
    nb2 = exact.query(db[:2], model_norm)["neighbors"]
    assert set(nb2.flatten().tolist()) <= {0, 1}
    sto = port_service(weights, capacity=32, retrieval_candidates=None)
    sto.build(db[:6], poses[:6], model_norm, batch=4)
    for seed in range(3):
        nb3 = sto.query(q, model_norm, seed)["neighbors"]
        assert int(nb3.min()) >= 0 and int(nb3.max()) < 6


def test_query_with_db_uses_the_given_tables(weights, built):
    db, _, services = built
    ts = services["netvlad"][1]
    other = port_service(weights, deterministic=True)
    other._built_hw = (H, W)
    tables = (ts.db_desc, ts.db_emb, ts.db_poses, ts.db_valid)
    _assert_same(other.query_with_db(tables, db[:3], model_norm),
                 ts.query(db[:3], model_norm))


def test_device_none_without_cuda_raises_and_names_the_device(weights):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    mvars, _ = weights
    model = RelPoseGNN(RelPoseGNNConfig(**MODEL_KW))
    with pytest.raises(RuntimeError, match="CUDA device.*device='cpu'"):
        RelocalizationService(model, None,
                              ServiceConfig(retrieval="shared-trunk"))


def test_mesh_forms_need_a_built_database(weights):
    """The forms over several GPUs (tests/test_torch_sharding.py,
    tests/test_torch_sharded_db.py) refuse an empty database, as the
    query path does."""
    svc = port_service(weights, "shared-trunk")
    with pytest.raises(RuntimeError, match="database is empty"):
        svc.replicate_over(None)
    with pytest.raises(RuntimeError, match="database is empty"):
        svc.shard_database(None)
    assert not hasattr(svc, "query_compiles")


# every ValueError the JAX service raises, by the same message fragment


def _built_port(weights, n=8, **kw):
    db, poses = make_scene(n, seed=9)
    svc = port_service(weights, **kw)
    svc.build(db, poses, model_norm, batch=4)
    return svc, db, poses


def _snapshot(weights, tmp_path, **kw):
    svc, db, poses = _built_port(weights, **kw)
    path = str(tmp_path / "db.npz")
    svc.save_database(path)
    return path


def err_unknown_mode(weights, tmp_path):
    port_service(weights, retrieval="typo")


def err_unknown_rank_dtype(weights, tmp_path):
    port_service(weights, rank_dtype="float16")


def err_netvlad_needs_encoder(weights, tmp_path):
    RelocalizationService(RelPoseGNN(RelPoseGNNConfig(**MODEL_KW)), None,
                          ServiceConfig(seq_len=SEQ), device="cpu")


def err_add_frames_without_capacity(weights, tmp_path):
    svc, db, poses = _built_port(weights)
    svc.add_frames(db[:1], poses[:1], model_norm)


def err_build_over_capacity(weights, tmp_path):
    _built_port(weights, capacity=4)


def err_add_frames_over_capacity(weights, tmp_path):
    svc, db, poses = _built_port(weights, capacity=10)
    svc.add_frames(db[:3], poses[:3], model_norm)


def err_build_pose_mismatch(weights, tmp_path):
    db, poses = make_scene(8)
    port_service(weights, capacity=16).build(db, poses[:6], model_norm, 4)


def err_add_frames_pose_mismatch(weights, tmp_path):
    svc, db, poses = _built_port(weights, capacity=16)
    before = svc.db_poses.clone()
    try:
        svc.add_frames(db[:2], poses[:3], model_norm, batch=4)
    finally:     # the failed add mutated nothing
        assert torch.equal(svc.db_poses, before) and svc.db_count == 8


def err_add_frames_other_model_norm(weights, tmp_path):
    svc, db, poses = _built_port(weights, capacity=16)
    svc.add_frames(db[:1], poses[:1], lambda x: x)


def err_invalidate_too_large(weights, tmp_path):
    _built_port(weights)[0].invalidate_frames([8])


def err_invalidate_negative(weights, tmp_path):
    _built_port(weights)[0].invalidate_frames([-1])


def err_load_other_capacity(weights, tmp_path):
    path = _snapshot(weights, tmp_path, capacity=8)
    port_service(weights, capacity=12).load_database(path)


def err_load_other_retrieval_hw(weights, tmp_path):
    path = _snapshot(weights, tmp_path)
    port_service(weights, retrieval_hw=(24, 32)).load_database(path)


def err_load_other_retrieval_mode(weights, tmp_path):
    path = _snapshot(weights, tmp_path, retrieval="shared-trunk")
    port_service(weights).load_database(path)


def err_load_other_weights(weights, tmp_path):
    path = _snapshot(weights, tmp_path)
    dst = port_service(weights)
    with torch.no_grad():
        for p in dst.model.parameters():
            p.mul_(1.5).add_(0.01)
    dst.load_database(path)


def err_load_other_structure(weights, tmp_path):
    path = _snapshot(weights, tmp_path)
    dst = port_service(weights)
    dst.model = dst.model.to(torch.bfloat16)
    dst.load_database(path)


def err_load_jax_snapshot_with_fingerprint(weights, tmp_path):
    db, poses = make_scene(8, seed=9)
    js = jax_svc(weights, "shared-trunk")
    js.build(db, poses, model_norm, batch=4)
    path = str(tmp_path / "jax.npz")
    js.save_database(path)
    port_service(weights, "shared-trunk").load_database(path)


def err_load_multiscene_snapshot(weights, tmp_path):
    path = str(tmp_path / "ms.npz")
    np.savez(path, scenes=np.asarray(["a"]))
    port_service(weights).load_database(path)


def err_load_foreign_npz(weights, tmp_path):
    path = str(tmp_path / "junk.npz")
    np.savez(path, foo=np.zeros(3))
    port_service(weights).load_database(path)


def err_query_other_resolution(weights, tmp_path):
    svc, _, _ = _built_port(weights)
    svc.query(np.zeros((2, 16, 20, 3), np.float32), model_norm)


def err_add_frames_other_resolution(weights, tmp_path):
    svc, _, poses = _built_port(weights, capacity=16)
    svc.add_frames(np.zeros((2, 16, 20, 3), np.float32), poses[:2],
                   model_norm, batch=2)


FAIL_LOUD = [
    (err_unknown_mode, "retrieval mode"),
    (err_unknown_rank_dtype, "rank_dtype"),
    (err_netvlad_needs_encoder, "NetVLAD"),
    (err_add_frames_without_capacity, "capacity"),
    (err_build_over_capacity, "capacity"),
    (err_add_frames_over_capacity, "capacity exceeded"),
    (err_build_pose_mismatch, "poses shape"),
    (err_add_frames_pose_mismatch, "poses shape"),
    (err_add_frames_other_model_norm, "model_norm"),
    (err_invalidate_too_large, "out of range"),
    (err_invalidate_negative, "out of range"),
    (err_load_other_capacity, "capacity"),
    (err_load_other_retrieval_hw, "retrieval_hw"),
    (err_load_other_retrieval_mode, "retrieval="),
    (err_load_other_weights, "WEIGHTS"),
    (err_load_other_structure, "parameter structure"),
    (err_load_jax_snapshot_with_fingerprint, "parameter structure"),
    (err_load_multiscene_snapshot, "MultiSceneService"),
    (err_load_foreign_npz, "not a Relocalization"),
    (err_query_other_resolution, "embedded at"),
    (err_add_frames_other_resolution, "embedded at"),
]


@pytest.mark.parametrize("case,match", FAIL_LOUD,
                         ids=[c.__name__[4:] for c, _ in FAIL_LOUD])
def test_fails_loudly(weights, tmp_path, case, match):
    with pytest.raises(ValueError, match=match):
        case(weights, tmp_path)


def test_queries_before_build_raise(weights):
    svc = port_service(weights, "shared-trunk")
    for call in (lambda: svc.query(np.zeros((1, H, W, 3)), model_norm),
                 lambda: svc.invalidate_frames([0]),
                 svc.compact_database, lambda: svc.save_database("x")):
        with pytest.raises(RuntimeError, match="build"):
            call()


def test_service_config_mirrors_the_jax_config():
    mine = {f.name: f.default for f in dataclasses.fields(ServiceConfig)}
    theirs = {f.name: f.default
              for f in dataclasses.fields(jax_service.ServiceConfig)}
    assert mine == theirs
