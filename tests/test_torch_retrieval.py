"""The port's retrieval stack against the JAX package: VGG16 features,
NetVLAD pooling and the full encoder (weights carried over by
`netvlad_state_dict_from_jax`), the neighbour-selection core fed the bits
the JAX functions drew, and the port's own counter-based draws.

Tolerances.  VGG16 features (13 float32 convs, summed in another order
than XLA's): rtol 1e-4, atol 1e-5 on values up to ~1.  NetVLAD and encoder
descriptors are L2-normalised (entries ~1e-2): atol 2e-6; cosine to the
JAX descriptor >= 1 - 1e-6.  Selection, ranking and indices: exact.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from relpose_gnn_tpu.models import convert as jax_convert
from relpose_gnn_tpu.models.netvlad import NetVLAD as JaxNetVLAD
from relpose_gnn_tpu.models.netvlad import NetVLADEncoder as JaxEncoder
from relpose_gnn_tpu.models.vgg import VGG16Features as JaxVGG
from relpose_gnn_tpu.retrieval import netvlad_index as jax_index
from relpose_gnn_tpu.retrieval import subsample as jax_sub
from relpose_gnn_tpu_torch.models.convert import netvlad_state_dict_from_jax
from relpose_gnn_tpu_torch.models.netvlad import NetVLAD, NetVLADEncoder
from relpose_gnn_tpu_torch.models.vgg import VGG16Features
from relpose_gnn_tpu_torch.retrieval import netvlad_index, subsample

HW = (32, 48)
K = 4


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads while this module runs: the suite runs several
    test processes on one host, and torch's default of one thread a core
    in each of them oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def encoder_pair():
    """A small JAX NetVLADEncoder (4 clusters), its params as numpy, the
    port's encoder loaded from them, and one input batch."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, *HW, 3)).astype(np.float32)
    jenc = JaxEncoder(num_clusters=K)
    params = jax.device_get(jenc.init(jax.random.PRNGKey(0),
                                      jnp.asarray(x)))["params"]
    tenc = NetVLADEncoder(num_clusters=K).eval()
    tenc.load_state_dict(netvlad_state_dict_from_jax(params), strict=True)
    return jenc, params, tenc, x


def test_state_dict_is_the_inverse_of_convert_netvlad(encoder_pair):
    """Key for key what `convert_netvlad` reads, and converting back gives
    the JAX tree bit for bit."""
    _, params, tenc, _ = encoder_pair
    sd = netvlad_state_dict_from_jax(params)
    want_keys = {f"encoder.{i}.{s}" for i in jax_convert._VGG16_CONV_IDX
                 for s in ("weight", "bias")}
    want_keys |= {"pool.centroids", "pool.conv.weight"}
    assert set(sd) == want_keys == set(tenc.state_dict())
    back = jax_convert.convert_netvlad({k: v.numpy() for k, v in sd.items()})
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = jax.tree_util.tree_leaves_with_path(params)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="no netvlad_vgg16.tar"):
        netvlad_state_dict_from_jax({**params, "extra": {}})


def test_vgg16_features_match_jax(encoder_pair):
    _, params, tenc, x = encoder_pair
    want = JaxVGG().apply({"params": params["encoder"]}, jnp.asarray(x))
    with torch.no_grad():
        got = tenc.encoder(torch.from_numpy(x))
    assert got.shape == (3, HW[0] // 16, HW[1] // 16, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    assert isinstance(tenc.encoder, VGG16Features)


@pytest.mark.parametrize("vladv2", [False, True])
def test_netvlad_pool_matches_jax(vladv2):
    """The pooling alone on a [B, H, W, C] map whose flatten order over
    (H, W) matters: 3 x 5 positions, 16 channels, 4 clusters."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 3, 5, 16)).astype(np.float32)
    jpool = JaxNetVLAD(num_clusters=K, dim=16, vladv2=vladv2)
    params = jax.device_get(jpool.init(jax.random.PRNGKey(1),
                                       jnp.asarray(x)))["params"]
    if vladv2:
        params["assign_conv"]["bias"] = rng.normal(size=K).astype(np.float32)
    want = jpool.apply({"params": params}, jnp.asarray(x))
    tpool = NetVLAD(num_clusters=K, dim=16, vladv2=vladv2).eval()
    sd = {"centroids": torch.from_numpy(np.array(params["centroids"])),
          "conv.weight": torch.from_numpy(np.ascontiguousarray(
              np.asarray(params["assign_conv"]["kernel"]).transpose(
                  3, 2, 0, 1)))}
    if vladv2:
        sd["conv.bias"] = torch.from_numpy(params["assign_conv"]["bias"])
    tpool.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tpool(torch.from_numpy(x))
    assert got.shape == (2, K * 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


def test_netvlad_norm_clamps_the_norm_not_the_square():
    """An all-zero map: every residual is -mass * centroid, never 0/0; a
    zero vector normalises to zero (norm clamped at 1e-12), as in JAX."""
    tpool = NetVLAD(num_clusters=2, dim=4, normalize_input=True).eval()
    x = np.zeros((1, 2, 2, 4), np.float32)
    with torch.no_grad():
        tpool.centroids.zero_()
        got = tpool(torch.from_numpy(x))
    assert torch.equal(got, torch.zeros(1, 8))


def test_encoder_matches_jax(encoder_pair):
    jenc, params, tenc, x = encoder_pair
    want = np.asarray(jenc.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tenc(torch.from_numpy(x)).numpy()
    assert got.shape == (3, K * 512) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-6)
    assert np.sum(got * want, axis=1).min() >= 1 - 1e-6


def test_numpy_selection_equals_the_jax_packages():
    rng = np.random.default_rng(2)
    sim = rng.random(40).astype(np.float32)
    sim[[3, 9]] = sim[5]                          # exact ties
    invalid = rng.random(40) < 0.2
    for inv in (None, invalid):
        np.testing.assert_array_equal(
            subsample.rank_and_filter_numpy(sim, inv),
            jax_sub.rank_and_filter_numpy(sim, inv))
    order = jax_sub.rank_and_filter_numpy(sim, invalid)
    for seed in range(3):
        np.testing.assert_array_equal(
            subsample.subsample_ranked_numpy(
                order, 4, 3, np.random.default_rng(seed)),
            jax_sub.subsample_ranked_numpy(
                order, 4, 3, np.random.default_rng(seed)))
    imgs = rng.random((2, 4, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(netvlad_index.imagenet_normalize(imgs),
                                  jax_index.imagenet_normalize(imgs))
    np.testing.assert_array_equal(
        netvlad_index.netvlad_preprocess_7scenes(imgs[0], (8, 6)),
        jax_index.netvlad_preprocess_7scenes(imgs[0], (8, 6)))
    raw = rng.random((480, 640, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        netvlad_index.netvlad_preprocess_7scenes(raw),
        jax_index.netvlad_preprocess_7scenes(raw))


# ---------------------------------------------------------------------------
# ranking: explicit lower-index-first order
# ---------------------------------------------------------------------------


def _tied_similarity(rng, b, m, n_levels=6):
    """Similarities drawn from a few levels: many exact ties."""
    levels = rng.random(n_levels).astype(np.float32)
    return levels[rng.integers(0, n_levels, size=(b, m))]


@pytest.mark.parametrize("c", [None, 1, 7, 16, 40])
def test_ranked_indices_equal_stable_argsort(c):
    rng = np.random.default_rng(3)
    sim = _tied_similarity(rng, 5, 40)
    key = 1.0 - sim
    key[0, :4] = [0.0, -0.0, np.inf, -1.5]        # signs, zero forms, inf
    key[1, 10:20] = np.inf
    want = np.argsort(key, axis=1, kind="stable")[:, :c]
    got = subsample.ranked_indices(torch.from_numpy(key), c)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    # the same order as lax.top_k on the negated key, ties included (row
    # 0 left out: top_k orders -0.0 before +0.0, which no `1 - sim` key
    # holds, and the port treats the two zeros as equal, like the sort)
    if c is not None:
        _, jidx = jax.lax.top_k(-jnp.asarray(key[1:]), c)
        np.testing.assert_array_equal(got.numpy()[1:], np.asarray(jidx))
    with pytest.raises(TypeError, match="float32"):
        subsample.ranked_indices(torch.from_numpy(key.astype(np.float64)))


def test_cosine_topk_matches_jax_with_duplicate_frames():
    rng = np.random.default_rng(4)
    db = rng.normal(size=(12, 16)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    db[7] = db[2]                                  # duplicate frames
    db[9] = db[2]
    q = db[[2, 5]] + 0.0
    ws, wi = jax_sub.cosine_topk(jnp.asarray(db), jnp.asarray(q), 4)
    gs, gi = subsample.cosine_topk(torch.from_numpy(db),
                                   torch.from_numpy(q), 4)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=1e-6)
    assert gi[0, :3].tolist() == [2, 7, 9]


# ---------------------------------------------------------------------------
# the selection core, with the bits JAX drew
# ---------------------------------------------------------------------------

CORE_CASES = {
    "plain": dict(m=64, inv_p=0.0, c=64),
    "windowed": dict(m=64, inv_p=0.0, c=16),
    "invalid_mask": dict(m=64, inv_p=0.4, c=64),
    "invalid_windowed": dict(m=64, inv_p=0.4, c=24),
    "shortfall": dict(m=12, inv_p=0.5, c=12),
    "ties_straddle_window": dict(m=48, inv_p=0.1, c=8, ties=True),
}


@pytest.mark.parametrize("name", sorted(CORE_CASES))
def test_select_ranked_batch_matches_jax_given_its_bits(name):
    case = CORE_CASES[name]
    rng = np.random.default_rng(sorted(CORE_CASES).index(name))
    b, m, c, k, sp = 6, case["m"], case["c"], 4, 3
    sim = (_tied_similarity(rng, b, m, 3) if case.get("ties")
           else rng.random((b, m)).astype(np.float32))
    invalid = rng.random((b, m)) < case["inv_p"]
    key = np.where(invalid, np.inf, 1.0 - sim).astype(np.float32)
    # the ranked window as JAX builds it
    if c == m:
        order_j = jnp.argsort(jnp.asarray(key), axis=1, stable=True)
    else:
        _, order_j = jax.lax.top_k(-jnp.asarray(key), c)
    order = subsample.ranked_indices(torch.from_numpy(key),
                                     None if c == m else c)
    np.testing.assert_array_equal(order.numpy(), np.asarray(order_j))
    # the bits and offsets JAX draws
    drop_rng, start_rng = jax.random.split(jax.random.PRNGKey(7))
    bits = np.asarray(jax_sub._drop_mask(drop_rng, b, c))
    starts = np.asarray(jax.random.randint(start_rng, (b,), 0, sp))
    inv_sorted = np.take_along_axis(invalid, np.asarray(order_j), 1)
    want_idx, want_ok = jax_sub._select_ranked_batch(
        order_j, jnp.asarray(inv_sorted), jnp.asarray(bits),
        jnp.asarray(starts), k, sp)
    got_idx, got_ok = subsample.select_ranked_batch(
        order, torch.from_numpy(inv_sorted), torch.from_numpy(bits),
        torch.from_numpy(starts), k, sp)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    assert got_idx.dtype == torch.int64


def test_select_ranked_batch_zero_survivors_and_all_invalid():
    """No drop bit set: every slot falls back to the best-ranked VALID
    candidate; with every candidate invalid, to rank 0 (as JAX)."""
    order = torch.tensor([[5, 3, 8, 1], [2, 0, 7, 4]])
    inv = torch.tensor([[True, False, False, False],
                        [True, True, True, True]])
    bits = torch.zeros(2, 4, dtype=torch.bool)
    starts = torch.tensor([1, 0])
    idx, ok = subsample.select_ranked_batch(order, inv, bits, starts, 3, 2)
    want_idx, want_ok = jax_sub._select_ranked_batch(
        *(jnp.asarray(a.numpy()) for a in (order, inv, bits, starts)), 3, 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
    assert idx.tolist() == [[3, 3, 3], [2, 2, 2]] and not ok.any()


# ---------------------------------------------------------------------------
# the port's own draws
# ---------------------------------------------------------------------------


def test_draws_are_prefix_stable_and_balanced():
    full = subsample.draw_survive_bits(11, 8, 4096, "cpu")
    for n in (1, 17, 256, 1000):
        assert torch.equal(subsample.draw_survive_bits(11, 8, n, "cpu"),
                           full[:, :n])
    assert torch.equal(subsample.draw_survive_bits(11, 3, 50, "cpu"),
                       full[:3, :50])
    assert abs(full.float().mean().item() - 0.5) < 0.02
    assert not torch.equal(full, subsample.draw_survive_bits(12, 8, 4096,
                                                             "cpu"))
    assert not torch.equal(full[0], full[1])
    starts = subsample.draw_starts(11, 4000, 5, "cpu")
    assert starts.min() == 0 and starts.max() == 4
    counts = torch.bincount(starts, minlength=5).float() / 4000
    assert (counts - 0.2).abs().max() < 0.03
    assert subsample.fold_in(3, 0) != subsample.fold_in(3, 1)
    assert subsample.fold_in(3, 1) != subsample.fold_in(4, 1)
    assert 0 <= subsample.fold_in(2 ** 40 + 5, 7) < 2 ** 32


@pytest.mark.parametrize("inv_p", [0.0, 0.5, 0.97])
def test_results_do_not_depend_on_candidates(inv_p):
    """For one seed, every `candidates` value (None included) gives the
    same neighbours: with a sparse database (inv_p 0.97) the window falls
    short and the batch takes the full sort."""
    rng = np.random.default_rng(5)
    b, m, k, sp = 7, 300, 5, 3
    sim = torch.from_numpy(_tied_similarity(rng, b, m, 40))
    invalid = torch.from_numpy(rng.random((b, m)) < inv_p)
    for seed in (0, 123456789012):
        want = subsample.subsample_neighbors_batch(seed, sim, invalid, k, sp)
        assert want.shape == (b, k)
        assert not torch.gather(invalid, 1, want).any()
        for cand in (1, 16, 64, 299, 300, 1000):
            got = subsample.subsample_neighbors_batch(seed, sim, invalid, k,
                                                      sp, candidates=cand)
            assert torch.equal(got, want), (seed, cand)
    other = subsample.subsample_neighbors_batch(1, sim, invalid, k, sp)
    assert not torch.equal(other, want)
    with pytest.raises(ValueError, match="candidates"):
        subsample.subsample_neighbors_batch(0, sim, invalid, k, sp,
                                            candidates=0)


def test_selection_follows_the_host_pipeline_given_the_same_bits():
    """The device selection is the reference host pipeline (rank, filter,
    drop, stride, top-k) when both read the same drop bits and offset."""
    rng = np.random.default_rng(6)
    m, k, sp, seed = 120, 6, 4, 9
    sim = rng.random((1, m)).astype(np.float32)
    invalid = rng.random((1, m)) < 0.3
    got = subsample.subsample_neighbors_batch(
        seed, torch.from_numpy(sim), torch.from_numpy(invalid), k, sp)[0]
    order = subsample.rank_and_filter_numpy(sim[0], invalid[0])
    bits = subsample.draw_survive_bits(seed, 1, m, "cpu")[0].numpy()
    start = int(subsample.draw_starts(seed, 1, sp, "cpu")[0])
    kept = order[bits[:len(order)]]
    np.testing.assert_array_equal(got.numpy(), kept[start::sp][:k])
    one = subsample.subsample_neighbors(
        seed, torch.from_numpy(sim[0]), torch.from_numpy(invalid[0]), k, sp)
    assert torch.equal(one, got)


def test_netvlad_index_matches_jax(encoder_pair):
    jenc, params, tenc, x = encoder_pair
    jidx = jax_index.NetVLADIndex({"params": params}, batch_size=2,
                                  dtype=None, image_hw=HW, num_clusters=K)
    tidx = netvlad_index.NetVLADIndex(tenc, batch_size=2, device="cpu")
    jidx.build(x[:2])
    jidx.add(x[2:])
    tidx.build(x[:2])
    tidx.add(x[2:])
    assert tuple(tidx.descriptors.shape) == (3, K * 512)
    np.testing.assert_allclose(tidx.descriptors.numpy(),
                               np.asarray(jidx.descriptors), atol=2e-6)
    q = np.asarray(jidx.descriptors)[:2]
    np.testing.assert_allclose(tidx.similarities(q), jidx.similarities(q),
                               atol=1e-6)
    ts, ti = tidx.topk(q, 1)
    assert ti[:, 0].tolist() == [0, 1] and ts.shape == (2, 1)
    assert tidx.embed(x[:0]).shape == (0, K * 512)
    nb = tidx.graph_neighbors(q[0], 2, 1, np.random.default_rng(0))
    assert set(nb.tolist()) <= {0, 1, 2}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            netvlad_index.NetVLADIndex(tenc)
    with pytest.raises(RuntimeError, match="build"):
        netvlad_index.NetVLADIndex(tenc, device="cpu").similarities(q)
