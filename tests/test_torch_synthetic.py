"""The port's synthetic pose task (relpose_gnn_tpu_torch/data/synthetic.py)
against the JAX package's, and the port learning it on the CPU from the JAX
init (the counterpart of tests/test_end_to_end.py::test_learns_to_relocalize).

Tolerances, with their basis:
  * `synthetic_batch` / `synthetic_batches`: byte for byte (the same numpy
    draws and float32 expressions);
  * `make_device_batch_fn`: `jax.random` cannot be reproduced, so its
    layout is held exactly (stripes equal the pose components, the
    adjacency the JAX `fc_adjacency`, which columns are stripes) and its
    distribution statistically: over 512 draws a component's standard
    deviation lies within 15% of its target (1 for translations, 0.3 for
    log-quaternions; the estimate's own spread is about 3%);
  * the untrained held-out `median_t`: the JAX eval step's to 1e-4
    relative (the same weights; float32 embeddings agree to ~1e-6);
  * after 150 steps `after < 0.9 * before`, the JAX test's own bound.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from relpose_gnn_tpu.data import synthetic as jax_synthetic
from relpose_gnn_tpu.evaluation.evaluator import \
    compute_pose_errors as jax_pose_errors
from relpose_gnn_tpu.models.posenet import RelPoseGNN as JaxRelPoseGNN
from relpose_gnn_tpu.models.posenet import RelPoseGNNConfig as JaxConfig
from relpose_gnn_tpu.ops import graph as jax_graph
from relpose_gnn_tpu.training import trainer as jax_trainer
from relpose_gnn_tpu_torch.data import synthetic
from relpose_gnn_tpu_torch.evaluation.evaluator import compute_pose_errors
from relpose_gnn_tpu_torch.models.convert import train_state_from_jax
from relpose_gnn_tpu_torch.models.posenet import RelPoseGNN, RelPoseGNNConfig
from relpose_gnn_tpu_torch.training import trainer

SHAPE = dict(batch_size=3, num_nodes=4, height=32, width=40)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads while this module runs: the suite runs several
    test processes on one host, and torch's default of one thread a core
    in each of them oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _assert_bytes_equal(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("learnable", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_synthetic_batches_equal_jax_bytes(seed, learnable):
    got = synthetic.synthetic_batch(np.random.default_rng(seed),
                                    learnable=learnable, **SHAPE)
    want = jax_synthetic.synthetic_batch(np.random.default_rng(seed),
                                         learnable=learnable, **SHAPE)
    _assert_bytes_equal(got, want)
    got = list(synthetic.synthetic_batches(seed, 3, learnable=learnable,
                                           **SHAPE))
    want = list(jax_synthetic.synthetic_batches(seed, 3,
                                                learnable=learnable, **SHAPE))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _assert_bytes_equal(g, w)


def _stripe_columns(images: np.ndarray, poses: np.ndarray) -> list:
    """For each column of the frames, the pose component the whole
    column equals across the batch, nodes, rows and channels (else
    None)."""
    cols = []
    for c in range(images.shape[3]):
        col = images[:, :, :, c, :]
        comp = [k for k in range(6) if np.array_equal(
            col, np.broadcast_to(poses[..., k][..., None, None],
                                 col.shape))]
        cols.append(comp[0] if comp else None)
    return cols


def test_device_batch_layout_equals_jax():
    """Stripes equal the pose components exactly, over the same columns
    as the JAX generator's; the rest of the frame is noise; the
    adjacency is the JAX fc_adjacency."""
    b, n, h, w = 4, 5, 12, 40
    got = synthetic.make_device_batch_fn(b, n, h, w, device="cpu")(3, 0)
    want = jax.device_get(jax_synthetic.make_device_batch_fn(b, n, h, w)(
        jax.random.PRNGKey(3)))
    assert got["images"].shape == want["images"].shape == (b, n, h, w, 3)
    assert got["images"].dtype == torch.float32
    assert got["poses"].shape == want["poses"].shape == (b, n, 6)
    assert got["poses"].dtype == torch.float32
    g_img, g_poses = got["images"].numpy(), got["poses"].numpy()
    cols = _stripe_columns(g_img, g_poses)
    w6 = w // 6
    assert cols == [c // w6 if c < 6 * w6 else None for c in range(w)]
    assert cols == _stripe_columns(np.asarray(want["images"]),
                                   np.asarray(want["poses"]))
    np.testing.assert_array_equal(
        got["adj"].numpy(), np.broadcast_to(jax_graph.fc_adjacency(n),
                                            (b, n, n)))
    assert got["adj"].dtype == torch.bool
    np.testing.assert_array_equal(got["adj"].numpy(), np.asarray(want["adj"]))


def test_device_batch_distribution():
    """Poses ~ N(0, 1) with the log-quaternion scaled by 0.3; the noise
    outside the stripes ~ N(0, 1); without `learnable` no stripes."""
    b, n, h, w = 64, 8, 6, 14
    got = synthetic.make_device_batch_fn(b, n, h, w, device="cpu")(0, 5)
    std = got["poses"].reshape(-1, 6).std(0).numpy()
    np.testing.assert_allclose(std[:3], 1.0, rtol=0.15)
    np.testing.assert_allclose(std[3:], 0.3, rtol=0.15)
    assert abs(float(got["poses"].mean())) < 0.1
    tail = got["images"][:, :, :, 6 * (w // 6):]
    assert abs(float(tail.std()) - 1.0) < 0.1
    plain = synthetic.make_device_batch_fn(b, n, h, w, learnable=False,
                                           device="cpu")(0, 5)
    assert set(_stripe_columns(plain["images"].numpy(),
                               plain["poses"].numpy())) == {None}
    np.testing.assert_array_equal(plain["poses"].numpy(),
                                  got["poses"].numpy())


def test_device_batch_is_a_function_of_seed_and_step():
    gen = synthetic.make_device_batch_fn(2, 3, 8, 12, device="cpu")
    a, again = gen(1, 4), gen(1, 4)
    for k in a:
        assert torch.equal(a[k], again[k]), k
    for other in (gen(1, 5), gen(2, 4)):
        assert not torch.equal(a["images"], other["images"])
        assert not torch.equal(a["poses"], other["poses"])
    # another generator of the same shape draws the same batch
    twin = synthetic.make_device_batch_fn(2, 3, 8, 12, device="cpu")(1, 4)
    assert torch.equal(a["images"], twin["images"])


def test_device_batch_needs_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synthetic.make_device_batch_fn(1, 2, 4, 6)


# ---------------------------------------------------------------------------
# learning the task: tests/test_end_to_end.py::test_learns_to_relocalize
# ---------------------------------------------------------------------------

LEARN_CFG = dict(num_nodes=4, feat_dim=32, edge_dim=32, node_dim=32, knn=0,
                 backbone="resnet18", droprate=0.0)


def _np_tree(tree):
    if hasattr(tree, "items"):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.array(tree)


def _torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in b.items()}


def test_learns_to_relocalize_from_the_jax_init():
    """The JAX test's protocol on the port (float32, droprate 0, knn 0,
    static anchor 1, lr 1e-3, 150 steps over 4 batches), starting from
    the JAX init: the untrained held-out median equals the JAX eval
    step's, and training lowers it below 0.9 of that."""
    rng = np.random.default_rng(0)
    kw = dict(batch_size=8, num_nodes=4, height=32, width=40,
              learnable=True)
    train_batches = [synthetic.synthetic_batch(rng, **kw) for _ in range(4)]
    test_batch = synthetic.synthetic_batch(rng, **dict(kw, batch_size=16))

    jmodel = JaxRelPoseGNN(JaxConfig(**LEARN_CFG))
    jtcfg = jax_trainer.TrainerConfig(lr=1e-3, steps_per_epoch=50,
                                      weight_decay=0.0)
    images = jnp.asarray(train_batches[0]["images"])
    adj = jnp.asarray(train_batches[0]["adj"])
    variables = jax.jit(lambda k: jmodel.init(k, images, adj))(
        jax.random.PRNGKey(0))
    jstate = jax_trainer.create_train_state(
        jax.random.PRNGKey(0), jmodel, jtcfg, images, adj,
        variables=variables)
    jout = jax_trainer.make_eval_step(static_anchor=1)(
        jstate, jax.tree.map(jnp.asarray, test_batch))
    jax_before = jax_pose_errors(np.asarray(jout["pred"]),
                                 np.asarray(jout["target"])).median_t

    model = RelPoseGNN(RelPoseGNNConfig(**LEARN_CFG))
    state = trainer.create_train_state(model, trainer.TrainerConfig(
        lr=1e-3, steps_per_epoch=50, weight_decay=0.0))
    state.load_state_dict(train_state_from_jax(
        _np_tree(jax.device_get(jstate.params)),
        _np_tree(jax.device_get(jstate.batch_stats)),
        jax.device_get(jstate.opt_state)))
    eval_step = trainer.make_eval_step(static_anchor=1)
    test_t = _torch_batch(test_batch)

    def median_t():
        out = eval_step(state, test_t)
        return compute_pose_errors(out["pred"].numpy(),
                                   out["target"].numpy()).median_t

    before = median_t()
    assert before == pytest.approx(jax_before, rel=1e-4)
    step = trainer.make_train_step(state.optimizer.cfg)
    batches = [_torch_batch(b) for b in train_batches]
    for i in range(150):
        m = step(state, batches[i % 4], 1)
        assert torch.isfinite(m["loss"]), i
    after = median_t()
    assert after < before * 0.9, (before, after)
