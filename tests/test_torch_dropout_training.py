"""Training with dropout on: the port's train step against the JAX
trainer's, from one init, on the same batches, with the same dropout masks.

`jax.random` cannot be reproduced in torch, so the JAX trainer's masks are
read out of flax (`capture_intermediates` on its `nn.Dropout`, with the
dropout key the JAX train step derives for that step) and handed to the
port's `RelPoseGNN._dropout`.  What flax does with a mask (keep with
probability 1 - rate, scale the kept values by 1 / (1 - rate), one mask
for x and another for e) is then held, not assumed.

Tolerances, with their basis:
  * one step's loss: the JAX trainer's to 1e-5 relative (float32 sums in
    another order; measured 6e-7);
  * one step's gradients: each tensor's error against the JAX loss in
    float64 (two-pass BN variance, the same masks), as a share of the
    tensor's largest float64 entry, is within 3 x the JAX trainer's own
    float32 error, or 1e-4.  The JAX trainer's error is mostly flax's
    one-pass BN variance (median 9.5e-3 over the tensors against the
    port's 5.2e-6); in the first ResNet stage both lie at 1-3%, the
    port's at most 1.8 x the JAX trainer's above the 1e-4 floor
    (measured, printed);
  * 30 steps: the dynamics are chaotic.  The JAX trainer started from its
    own init times (1 + 2^-22) leaves its unperturbed run by 0.004-0.32
    in held-out median_t within 30-60 steps, as far as the port leaves
    it.  Mean gaps over the evaluations at 10, 20 and 30 steps, the
    perturbed run / the port, for dropout keys 1-4: 0.059 / 0.099,
    0.101 / 0.090, 0.073 / 0.085, 0.089 / 0.083 (measured; key 1 is this
    test's and prints).  So the port's mean gap may be at most 3 x the
    perturbed run's; a port that trained otherwise (a missing
    1 / (1 - rate), one mask for x and e, dropout in the eval) leaves it
    from the first step, which the first step's loss holds to 1e-5.
"""

from unittest import mock

import flax.linen as nn
import flax.linen.normalization as flax_norm
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relpose_gnn_tpu.evaluation.evaluator import \
    compute_pose_errors as jax_pose_errors
from relpose_gnn_tpu.models.posenet import RelPoseGNN as JaxRelPoseGNN
from relpose_gnn_tpu.models.posenet import RelPoseGNNConfig as JaxConfig
from relpose_gnn_tpu.training import trainer as jax_trainer
from relpose_gnn_tpu_torch.data import synthetic
from relpose_gnn_tpu_torch.evaluation.evaluator import compute_pose_errors
from relpose_gnn_tpu_torch.models.convert import train_state_from_jax
from relpose_gnn_tpu_torch.models.posenet import RelPoseGNN, RelPoseGNNConfig
from relpose_gnn_tpu_torch.training import trainer

CFG = dict(num_nodes=4, feat_dim=32, edge_dim=32, node_dim=32, knn=2,
           backbone="resnet18", droprate=0.5)
LR = 3e-4
DROP_KEY = 1
BATCH = dict(batch_size=8, num_nodes=4, height=32, width=40, learnable=True)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads while this module runs: the suite runs several
    test processes on one host, and torch's default of one thread a core
    in each of them oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    if hasattr(tree, "items"):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.array(tree)


def _torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in b.items()}


def _copy(tree):
    """The JAX train step donates its state: run on a copy."""
    return jax.tree.map(lambda a: jnp.array(a, copy=True), tree)


@pytest.fixture(scope="module")
def setup():
    """The JAX model, trainer config, init state and batches (4 training
    batches and a held-out one, numpy, from one seed)."""
    rng = np.random.default_rng(0)
    batches = [synthetic.synthetic_batch(rng, **BATCH) for _ in range(4)]
    test_batch = synthetic.synthetic_batch(rng, **dict(BATCH, batch_size=16))
    model = JaxRelPoseGNN(JaxConfig(**CFG))
    tcfg = jax_trainer.TrainerConfig(lr=LR, steps_per_epoch=1000,
                                     weight_decay=0.0)
    images = jnp.asarray(batches[0]["images"])
    adj = jnp.asarray(batches[0]["adj"])
    variables = jax.jit(lambda k: model.init(k, images, adj))(
        jax.random.PRNGKey(0))
    state = jax_trainer.create_train_state(jax.random.PRNGKey(0), model,
                                           tcfg, images, adj,
                                           variables=variables)
    return model, tcfg, state, batches, test_batch


def _drop_key(step: int):
    """The dropout key the JAX train step derives at `step`."""
    return jax.random.split(jax.random.fold_in(
        jax.random.PRNGKey(DROP_KEY), step))[0]


def _mask_fn(model):
    """(params, batch_stats, images, adj, key) -> flax's keep masks for x
    and e in a training forward with dropout key `key`."""

    def masks(params, batch_stats, images, adj, key):
        _, out = model.apply(
            {"params": params["model"], "batch_stats": batch_stats},
            images, adj, train=True, rngs={"dropout": key},
            mutable=["batch_stats", "intermediates"],
            capture_intermediates=lambda m, _: isinstance(m, nn.Dropout))
        return tuple(y != 0 for y in
                     out["intermediates"]["dropout"]["__call__"])

    return jax.jit(masks)


def _port_state(jstate):
    state = trainer.create_train_state(
        RelPoseGNN(RelPoseGNNConfig(**CFG)),
        trainer.TrainerConfig(lr=LR, steps_per_epoch=1000, weight_decay=0.0))
    state.load_state_dict(train_state_from_jax(
        _np_tree(jax.device_get(jstate.params)),
        _np_tree(jax.device_get(jstate.batch_stats)),
        jax.device_get(jstate.opt_state)))
    return state


_PORT_DROPOUT = RelPoseGNN._dropout


class _Masks:
    """Feeds queued keep masks (x first, then e) to the port's own
    `RelPoseGNN._dropout`: while it runs, its uniform draw returns 0
    where the mask keeps and 1 where it drops, so the keep test, the
    scaling and the zeros stay the port's."""

    def __init__(self):
        self.queue = []
        self.kept = []      # share kept where the input is not 0

    def __call__(self, module, x, generator):
        keep = torch.from_numpy(np.asarray(self.queue.pop(0)))
        assert keep.shape == x.shape
        self.kept.append(keep[x != 0].double().mean().item())
        uniform = (~keep).float()
        with mock.patch("torch.rand", lambda *a, **k: uniform):
            return _PORT_DROPOUT(module, x, generator)

    def patch(self):
        return mock.patch.object(RelPoseGNN, "_dropout",
                                 lambda module, x, gen: self(module, x, gen))


def _flat_grads(tree, batch_stats) -> dict:
    w = train_state_from_jax(_np_tree(jax.device_get(tree)),
                             _np_tree(jax.device_get(batch_stats)))
    out = {f"model.{k}": v.double() for k, v in w["model"].items()}
    for c in ("criterion", "criterion_R"):
        out.update({f"{c}.{k}": v.double() for k, v in w[c].items()})
    return out


def test_one_step_gradients_with_dropout_match_the_jax_trainer(setup):
    model, tcfg, jstate, batches, _ = setup
    batch = jax.tree.map(jnp.asarray, batches[0])
    key = _drop_key(0)
    grad_fn = jax.value_and_grad(jax_trainer.loss_fn, has_aux=True)
    (jax_loss, _), g32 = jax.jit(grad_fn, static_argnums=(2, 5))(
        jstate.params, jstate.batch_stats, jstate.apply_fn, batch, key,
        tcfg)
    masks = [np.asarray(m) for m in _mask_fn(model)(
        jstate.params, jstate.batch_stats, batch["images"], batch["adj"],
        key)]
    # read as "not 0 after flax's dropout", which also counts what the
    # ReLU before it zeroed: the same forward either way
    assert [m.shape for m in masks] == [(8, 4, 32), (8, 4, 4, 32)]
    assert not np.array_equal(masks[0], masks[1][:, :, 0])

    # the JAX loss in float64 with two-pass BN variance, the same masks
    queue = list(masks)

    def flax_dropout(self, inputs, deterministic=None, rng=None):
        return jnp.where(queue.pop(0), inputs / (1.0 - self.rate), 0)

    stats = flax_norm._compute_stats

    def two_pass(*args, **kw):
        return stats(*args, **dict(kw, use_fast_variance=False))

    def to64(tree):
        return jax.tree.map(lambda a: a.astype(jnp.float64)
                            if a.dtype == jnp.float32 else a, tree)

    jax.config.update("jax_enable_x64", True)
    try:
        with mock.patch.object(nn.Dropout, "__call__", flax_dropout), \
                mock.patch.object(flax_norm, "_compute_stats", two_pass):
            _, g64 = jax.jit(grad_fn, static_argnums=(2, 5))(
                to64(jstate.params), to64(jstate.batch_stats),
                jstate.apply_fn, to64(batch), key, tcfg)
        assert not queue
    finally:
        jax.config.update("jax_enable_x64", False)

    state = _port_state(jstate)
    dropout = _Masks()
    dropout.queue = list(masks)
    with dropout.patch():
        total, _ = trainer.loss_fn(state, _torch_batch(batches[0]),
                                   torch.Generator(), state.optimizer.cfg)
    assert not dropout.queue
    # flax keeps about 1 - rate of the nonzero inputs, of x and of e
    assert all(0.4 < k < 0.6 for k in dropout.kept), dropout.kept
    total.backward()
    assert total.item() == pytest.approx(float(jax_loss), rel=1e-5)

    want32, want64 = _flat_grads(g32, jstate.batch_stats), \
        _flat_grads(g64, jstate.batch_stats)
    checked, errors = 0, []
    for name, p in zip(state.optimizer.names, state.optimizer.params):
        ref = want64[name]
        scale = ref.abs().max().item()
        got = p.grad.double() if p.grad is not None else torch.zeros_like(ref)
        if scale == 0.0:
            assert got.abs().max().item() == 0.0, name
            continue
        port_err = (got - ref).abs().max().item() / scale
        jax_err = (want32[name] - ref).abs().max().item() / scale
        assert port_err <= max(3 * jax_err, 1e-4), (name, port_err, jax_err)
        errors.append((port_err, jax_err))
        checked += 1
    assert checked > 60
    port_errs, jax_errs = np.array(errors).T
    above = port_errs > 1e-4
    print(f"loss {total.item()} / JAX {float(jax_loss)}; error against "
          f"float64, median over {checked} tensors: port "
          f"{np.median(port_errs):.3g}, JAX {np.median(jax_errs):.3g}; "
          f"largest port / JAX above 1e-4: "
          f"{(port_errs / jax_errs)[above].max():.3g}")


def test_dropout_training_tracks_the_jax_trainer(setup):
    """30 steps, evaluations at 10, 20, 30: the port's held-out median_t
    stays as near the JAX trainer's as the JAX trainer's own run from an
    init perturbed by 2^-22 (module docstring)."""
    model, tcfg, jstate, batches, test_batch = setup
    steps, every = 30, 10
    key = jax.random.PRNGKey(DROP_KEY)
    jax_eval = jax_trainer.make_eval_step()
    jax_test = jax.tree.map(jnp.asarray, test_batch)

    def jax_median(state) -> float:
        out = jax_eval(state, jax_test)
        return jax_pose_errors(np.asarray(out["pred"]),
                               np.asarray(out["target"])).median_t

    mask_fn = _mask_fn(model)
    train_step = jax_trainer.make_train_step(tcfg)
    port = _port_state(jstate)
    port_step = trainer.make_train_step(port.optimizer.cfg)
    port_eval = trainer.make_eval_step()
    port_test = _torch_batch(test_batch)
    dropout = _Masks()

    def port_median() -> float:
        out = port_eval(port, port_test)
        return compute_pose_errors(out["pred"].numpy(),
                                   out["target"].numpy()).median_t

    assert port_median() == pytest.approx(jax_median(jstate), rel=1e-4)
    ref, js = [], _copy(jstate)
    got, losses = [], []
    with dropout.patch():
        for i in range(steps):
            batch = jax.tree.map(jnp.asarray, batches[i % 4])
            dropout.queue.extend(mask_fn(js.params, js.batch_stats,
                                         batch["images"], batch["adj"],
                                         _drop_key(i)))
            js, jm = train_step(js, batch, key)
            m = port_step(port, _torch_batch(batches[i % 4]), DROP_KEY)
            assert not dropout.queue
            losses.append((m["loss"].item(), float(jm["loss"])))
            if (i + 1) % every == 0:
                ref.append(jax_median(js))
                got.append(port_median())
    assert losses[0][0] == pytest.approx(losses[0][1], rel=1e-5)
    assert np.isfinite(losses).all()

    js = _copy(jstate)
    js = js.replace(params=jax.tree.map(lambda a: a * (1 + 2.0 ** -22),
                                        js.params))
    perturbed = []
    for i in range(steps):
        js, _ = train_step(js, jax.tree.map(jnp.asarray, batches[i % 4]),
                           key)
        if (i + 1) % every == 0:
            perturbed.append(jax_median(js))
    ref, got, perturbed = map(np.array, (ref, got, perturbed))
    port_gap = np.abs(got - ref).mean()
    chaos_gap = np.abs(perturbed - ref).mean()
    print(f"held-out median_t at steps 10, 20, 30: JAX {ref}, port {got}, "
          f"JAX perturbed {perturbed}; mean gaps {port_gap:.4f} / "
          f"{chaos_gap:.4f}")
    assert port_gap <= 3 * chaos_gap, (ref, got, perturbed)
