"""The port's training stack (relpose_gnn_tpu_torch/training, ops/pose.py,
the train-mode forward of models/) against the JAX package, on the CPU, at
the sizes of tests/test_trainer.py (resnet18, dims 32, 4 nodes, 32x40
images), inputs from numpy seeds, TF32 never involved (CPU).

Tolerances, with their basis:
  * attention-core VJP (the Function's eager backward against `jax.vjp`
    of the Pallas core in interpret mode, which reaches `_core_bwd`):
    float32 rtol 1e-5 (the same formulas; only the order of sums of
    C = 128 terms differs), bfloat16 one bfloat16 ulp (2^-8) of the
    largest gradient, since both round float32 gradients to bfloat16;
  * criteria and pose ops: rtol 1e-5, atol 1e-6 (a few float32 sums);
  * train-mode BN: outputs rtol = atol = 2e-5 (as the models' embeddings:
    convolutions summed in other orders), running statistics rtol = atol
    = 1e-5 (flax takes E[x^2] - E[x]^2, torch a two-pass variance);
  * optimizer against optax on the same gradients: atol 1e-6 on
    parameters of magnitude up to 1 (a few float32 ulps; torch and optax
    round the bias-corrected Adam step differently);
  * three train steps from one state: losses rtol 1e-5; gradients rtol =
    atol = 1e-4 (embedding differences of 1e-6 carried back through BN in
    train mode); parameters: an Adam update moves every weight by about
    lr whatever its gradient, so where the two frameworks' gradients are
    near zero and of opposite sign a weight moves up to 2 lr apart per
    update: max |diff| <= 2 lr x 3 updates, while the mean |diff| stays at
    rounding level (1e-6); BN running statistics rtol = atol = 1e-4
    (the later steps' batch statistics come from those weights);
  * eval step: rtol = atol = 1e-5, anchors exact.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from relpose_gnn_tpu.data.packed import (ConcatPackedDataset as
                                         JaxConcatPackedDataset)
from relpose_gnn_tpu.data.packed import PackedGraphDataset as JaxPacked
from relpose_gnn_tpu.data.packed import PackedGraphWriter as JaxWriter
from relpose_gnn_tpu.data import pipeline as jax_pipeline
from relpose_gnn_tpu.models.posenet import RelPoseGNN as JaxRelPoseGNN
from relpose_gnn_tpu.models.posenet import RelPoseGNNConfig as JaxConfig
from relpose_gnn_tpu.models.resnet import ResNet as JaxResNet
from relpose_gnn_tpu.ops import graph as jax_graph
from relpose_gnn_tpu.ops import pose as jax_pose
from relpose_gnn_tpu.ops.att_pallas import attention_core as jax_core
from relpose_gnn_tpu.training import criterion as jax_crit
from relpose_gnn_tpu.training import trainer as jax_trainer
from relpose_gnn_tpu_torch.data import pipeline
from relpose_gnn_tpu_torch.data.packed import (ConcatPackedDataset,
                                               PackedGraphDataset)
from relpose_gnn_tpu_torch.models.convert import (resnet_state_dict_from_jax,
                                                  train_state_from_jax)
from relpose_gnn_tpu_torch.models.posenet import (RelPoseGNN,
                                                  RelPoseGNNConfig,
                                                  init_weights)
from relpose_gnn_tpu_torch.models.resnet import ResNet
from relpose_gnn_tpu_torch.ops import att_core
from relpose_gnn_tpu_torch.ops import graph as graph_ops
from relpose_gnn_tpu_torch.ops import pose
from relpose_gnn_tpu_torch.training import criterion as crit
from relpose_gnn_tpu_torch.training import trainer

N, D, H, W = 4, 32, 32, 40
STAGES = (2, 2, 2, 2)
LR = 1e-4


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


def _cfg(**kw):
    base = dict(num_nodes=N, feat_dim=D, edge_dim=D, node_dim=D, knn=2,
                gnn_recursion=2, backbone="resnet18", droprate=0.0)
    base.update(kw)
    return base


def _batch(seed, b=2):
    rng = np.random.default_rng(seed)
    poses = rng.normal(size=(b, N, 6)).astype(np.float32)
    poses[..., 3:] *= 0.3
    return {"images": rng.normal(size=(b, N, H, W, 3)).astype(np.float32),
            "poses": poses,
            "adj": np.broadcast_to(~np.eye(N, dtype=bool), (b, N, N)).copy()}


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the attention core under autograd
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_vjp_matches_jax_core_bwd(dtype):
    rng = np.random.default_rng(0)
    e, c = 24, 128
    phi, theta, g = (rng.normal(size=(e, c)).astype(np.float32)
                     for _ in range(3))
    ybar = rng.normal(size=(e, c)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    y_j, vjp = jax.vjp(lambda p, t, gg: jax_core(p, t, gg, interpret=True),
                       *(jnp.asarray(a, jdt) for a in (phi, theta, g)))
    want = vjp(jnp.asarray(ybar))
    tdt = getattr(torch, dtype)
    args = [torch.from_numpy(a).to(tdt).requires_grad_()
            for a in (phi, theta, g)]
    y = att_core.attention_core(*args)
    assert y.grad_fn is not None and "AttentionCoreFunction" in \
        type(y.grad_fn).__name__
    got = torch.autograd.grad(y, args, torch.from_numpy(ybar))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               rtol=1e-5, atol=1e-6)
    for name, a, b in zip(("phi", "theta", "g"), got, want):
        assert a.dtype == tdt, name
        b = np.asarray(b.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-6,
                                       err_msg=name)
        else:
            scale = np.abs(b).max()
            np.testing.assert_allclose(a.float().numpy(), b, rtol=0,
                                       atol=2 ** -8 * scale, err_msg=name)


def test_attention_core_without_grad_is_the_plain_forward():
    rng = np.random.default_rng(1)
    args = [torch.from_numpy(rng.normal(size=(6, 8)).astype(np.float32))
            for _ in range(3)]
    y = att_core.attention_core(*args)
    assert y.grad_fn is None
    torch.testing.assert_close(y, att_core.attention_core_plain(*args),
                               rtol=0, atol=0)
    with torch.no_grad():
        z = att_core.attention_core(*(a.requires_grad_() for a in args))
    assert z.grad_fn is None


# ---------------------------------------------------------------------------
# pose ops and criteria
# ---------------------------------------------------------------------------


def _pose7(rng, *shape):
    t = rng.normal(size=shape + (3,))
    q = rng.normal(size=shape + (4,))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.concatenate([t, q], -1).astype(np.float32)


@pytest.mark.parametrize("name", ["vdot", "normalize", "qmult", "qinv",
                                  "qexp", "qlog", "rotate_vec_by_q",
                                  "compose_pose_quaternion",
                                  "invert_pose_quaternion", "calc_vo"])
def test_pose_ops_match_jax(name):
    rng = np.random.default_rng(2)
    p1, p2 = _pose7(rng, 5), _pose7(rng, 5)
    args = {"vdot": (p1, p2), "normalize": (p1,),
            "qmult": (p1[:, 3:], p2[:, 3:]), "qinv": (p1[:, 3:],),
            "qexp": (np.concatenate([p1[:4, :3], np.zeros((1, 3),
                                                          np.float32)]),),
            "qlog": (p1[:, 3:],), "rotate_vec_by_q": (p1[:, :3], p2[:, 3:]),
            "compose_pose_quaternion": (p1, p2),
            "invert_pose_quaternion": (p1,), "calc_vo": (p1, p2)}[name]
    want = getattr(jax_pose, name)(*(jnp.asarray(a) for a in args))
    got = getattr(pose, name)(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


_PARAMS = dict(sax=0.3, saq=-2.0, srx=-0.5, srq=-3.0)


def _criterion_case(form, rng):
    """(jax fn, port fn, args as numpy) for one criterion form."""
    p6 = lambda *s: rng.normal(size=s + (6,)).astype(np.float32)  # noqa
    if form == "pose_net":
        return (jax_crit.pose_net_criterion, crit.pose_net_criterion,
                (p6(10), p6(10)))
    if form == "pose_net_masked":
        mask = rng.random((2, 4, 4)) < 0.5
        return (jax_crit.pose_net_criterion, crit.pose_net_criterion,
                (p6(2, 4, 4), p6(2, 4, 4), mask))
    if form == "trans":
        return (jax_crit.pose_net_trans_criterion,
                crit.pose_net_trans_criterion, (p6(3, 5), p6(3, 5)))
    if form == "rot":
        mask = rng.random((3, 5)) < 0.5
        return (jax_crit.pose_net_rot_criterion,
                crit.pose_net_rot_criterion, (p6(3, 5), p6(3, 5), mask))
    if form == "mapnet_online":
        return (jax_crit.mapnet_online_criterion,
                crit.mapnet_online_criterion,
                (_pose7(rng, 2, 6), _pose7(rng, 2, 5)))
    if form == "mapnet_online_gps":
        return (lambda p, a, b: jax_crit.mapnet_online_criterion(
                    p, a, b, gps_mode=True),
                lambda p, a, b: crit.mapnet_online_criterion(
                    p, a, b, gps_mode=True),
                (_pose7(rng, 2, 6), _pose7(rng, 2, 6)))
    if form == "original":
        return (jax_crit.pose_net_criterion_original,
                crit.pose_net_criterion_original,
                (_pose7(rng, 7), _pose7(rng, 7) * 1.7))
    assert form == "mapnet"
    return (jax_crit.mapnet_criterion, crit.mapnet_criterion,
            (p6(2, 5), p6(2, 5)))


@pytest.mark.parametrize("form", ["pose_net", "pose_net_masked", "trans",
                                  "rot", "mapnet_online",
                                  "mapnet_online_gps", "original",
                                  "mapnet"])
def test_criteria_and_their_gradients_match_jax(form):
    rng = np.random.default_rng(3)
    jfn, tfn, args = _criterion_case(form, rng)

    def first(out):
        return out[0] if isinstance(out, tuple) else out

    jparams = {k: jnp.float32(v) for k, v in _PARAMS.items()}
    want, jgrads = jax.value_and_grad(
        lambda p, x: first(jfn(p, x, *map(jnp.asarray, args[1:]))),
        argnums=(0, 1))(jparams, jnp.asarray(args[0]))
    params = crit.init_mapnet_criterion_params(**_PARAMS)
    pred = torch.from_numpy(args[0]).requires_grad_()
    out = tfn(params, pred, *(torch.from_numpy(np.asarray(a))
                              for a in args[1:]))
    got = first(out)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(pred.grad.numpy(), np.asarray(jgrads[1]),
                               rtol=1e-5, atol=1e-6)
    for k, v in params.items():
        want_g = float(jgrads[0][k])
        got_g = 0.0 if v.grad is None else v.grad.item()
        np.testing.assert_allclose(got_g, want_g, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    if isinstance(out, tuple):
        jout = jfn(jparams, *map(jnp.asarray, args))
        for a, b in zip(out[1:], jout[1:]):
            np.testing.assert_allclose(a.item(), float(b), rtol=1e-5)


def test_quaternion_loss_matches_jax():
    rng = np.random.default_rng(4)
    q1, q2 = _pose7(rng, 9)[:, 3:], _pose7(rng, 9)[:, 3:]
    want = jax_crit.quaternion_loss(jnp.asarray(q1), jnp.asarray(q2))
    got = crit.quaternion_loss(torch.from_numpy(q1), torch.from_numpy(q2))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_criterion_params_are_learnable_float32_scalars():
    p = crit.init_criterion_params(0.5, -2.0)
    assert set(p) == {"sax", "saq"}
    assert all(v.requires_grad and v.dtype == torch.float32 and v.dim() == 0
               for v in p.values())
    m = crit.init_mapnet_criterion_params()
    assert {k: v.item() for k, v in m.items()} == dict(
        sax=-1.0, saq=-4.0, srx=-1.0, srq=-4.0)


# ---------------------------------------------------------------------------
# train-mode BatchNorm
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_resnet():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, H, W, 3)).astype(np.float32)
    model = JaxResNet(stage_sizes=STAGES, feat_dim=D)
    variables = _np_tree(jax.device_get(jax.jit(
        lambda k: model.init(k, x, train=False))(jax.random.PRNGKey(0))))
    return model, variables


def test_train_mode_bn_matches_flax_outputs_and_running_stats(jax_resnet):
    model, variables = jax_resnet
    params, stats = variables["params"], variables["batch_stats"]
    port = ResNet(STAGES, D)
    port.load_state_dict(resnet_state_dict_from_jax(params, stats, STAGES),
                         strict=True)
    rng = np.random.default_rng(6)
    for i in range(2):
        x = (rng.normal(size=(3, H, W, 3)) * (1 + i)).astype(np.float32)
        want, upd = model.apply({"params": params, "batch_stats": stats},
                                x, train=True, mutable=["batch_stats"])
        stats = _np_tree(upd["batch_stats"])
        got = port(torch.from_numpy(x), train=True)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)
    want_sd = resnet_state_dict_from_jax(params, stats, STAGES)
    for k, v in port.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
    # eval uses the running statistics, as flax's use_running_average
    x = rng.normal(size=(2, H, W, 3)).astype(np.float32)
    want = model.apply({"params": params, "batch_stats": stats}, x,
                       train=False)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_bf16_train_bn_keeps_float32_running_stats():
    torch.manual_seed(0)
    port = ResNet(STAGES, D, dtype=torch.bfloat16)
    x = torch.randn(2, H, W, 3)
    port(x, train=True)
    bn = port.bn1
    assert bn.running_mean.dtype == torch.float32
    # the update is 0.1 x the float32 batch mean of the bf16 conv output
    with torch.no_grad():
        y = torch.nn.functional.conv2d(
            x.to(torch.bfloat16).permute(0, 3, 1, 2),
            port.conv1.weight.to(torch.bfloat16), None, 2, 3).float()
    torch.testing.assert_close(bn.running_mean, 0.1 * y.mean((0, 2, 3)),
                               rtol=1e-5, atol=1e-6)
    assert int(bn.num_batches_tracked) == 0


# ---------------------------------------------------------------------------
# dropout and edge dropout: the port's own draws
# ---------------------------------------------------------------------------


def test_dropout_keeps_one_minus_rate_and_rescales():
    model = RelPoseGNN(RelPoseGNNConfig(**_cfg(droprate=0.3)))
    x = torch.ones(200, 100)
    a = model._dropout(x, torch.Generator().manual_seed(7))
    b = model._dropout(x, torch.Generator().manual_seed(7))
    c = model._dropout(x, torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.01  # 20000 draws
    torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1 / 0.7))
    with pytest.raises(ValueError, match="Generator"):
        model._dropout(x, None)


def test_eval_dropout_fires_at_eval_and_is_seeded():
    cfg = RelPoseGNNConfig(**_cfg(droprate=0.5, eval_dropout=True))
    model = RelPoseGNN(cfg)
    init_weights(model, torch.Generator().manual_seed(0))
    b = _torch_batch(_batch(9))
    with torch.no_grad():
        a1 = model(b["images"], b["adj"],
                   generator=torch.Generator().manual_seed(1))[0]
        a2 = model(b["images"], b["adj"],
                   generator=torch.Generator().manual_seed(1))[0]
        a3 = model(b["images"], b["adj"],
                   generator=torch.Generator().manual_seed(2))[0]
    assert torch.equal(a1, a2) and not torch.equal(a1, a3)
    with pytest.raises(ValueError, match="Generator"):
        model(b["images"], b["adj"])


def test_edge_dropout_mask_statistics_and_seeding():
    gen = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    m = graph_ops.edge_dropout_mask(gen(0), 8, 0.5, batch_shape=(500,))
    assert m.shape == (500, 8, 8) and m.dtype == torch.bool
    assert torch.equal(m, m.transpose(-1, -2))
    assert not m.diagonal(dim1=-2, dim2=-1).any()
    upper = m[:, torch.triu(torch.ones(8, 8, dtype=torch.bool), 1)]
    assert abs(upper.float().mean().item() - 0.5) < 0.01  # 14000 draws
    assert torch.equal(m, graph_ops.edge_dropout_mask(gen(0), 8, 0.5,
                                                      batch_shape=(500,)))
    assert not torch.equal(m, graph_ops.edge_dropout_mask(
        gen(1), 8, 0.5, batch_shape=(500,)))


def test_ensure_nonempty_matches_jax():
    rng = np.random.default_rng(10)
    mask = rng.random((6, 5, 5)) < 0.2
    mask[[1, 4]] = False
    want = jax_graph.ensure_nonempty(jnp.asarray(mask))
    got = graph_ops.ensure_nonempty(torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[1].sum() == 25


# ---------------------------------------------------------------------------
# the optimizer against optax
# ---------------------------------------------------------------------------


def _opt_params(rng):
    return {"model": {"w": rng.normal(size=(4, 3)).astype(np.float32),
                      "b": rng.normal(size=(3,)).astype(np.float32)},
            "criterion": {"sax": np.float32(0.1), "saq": np.float32(-2.0)},
            "criterion_R": {"sax": np.float32(0.0),
                            "saq": np.float32(-2.0)}}


class _Tiny(torch.nn.Module):
    def __init__(self, p):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(p["w"].copy()))
        self.b = torch.nn.Parameter(torch.from_numpy(p["b"].copy()))


def _port_opt(cfg, p):
    model = _Tiny(p["model"])
    c = crit.init_criterion_params(**{k: float(v) for k, v in
                                      p["criterion"].items()})
    cr = crit.init_criterion_params(**{k: float(v) for k, v in
                                       p["criterion_R"].items()})
    return trainer.make_optimizer(cfg, model, c, cr), {
        "model.w": model.w, "model.b": model.b,
        "criterion.sax": c["sax"], "criterion.saq": c["saq"],
        "criterion_R.sax": cr["sax"], "criterion_R.saq": cr["saq"]}


def _flat(tree):
    return {"model.w": tree["model"]["w"], "model.b": tree["model"]["b"],
            **{f"{g}.{k}": tree[g][k] for g in ("criterion", "criterion_R")
               for k in ("sax", "saq")}}


@pytest.mark.parametrize("kw", [
    dict(),
    dict(lr_decay_step=1, steps_per_epoch=2),            # decay every 2
    dict(grad_accum=2, lr_decay_step=1, steps_per_epoch=4),
    dict(filter_nans=True, weight_decay=0.0),
], ids=["plain", "decay_boundary", "grad_accum2_decay", "filter_nans"])
def test_optimizer_matches_optax(kw):
    cfg = trainer.TrainerConfig(lr=1e-2, **kw)
    rng = np.random.default_rng(11)
    p0 = _opt_params(rng)
    tx = jax_trainer.make_optimizer(jax_trainer.TrainerConfig(lr=1e-2, **kw))
    jp = jax.tree.map(jnp.asarray, p0)
    js = tx.init(jp)
    opt, named = _port_opt(cfg, p0)
    for i in range(7):
        g = jax.tree.map(lambda a: rng.normal(size=np.shape(a)).astype(
            np.float32), p0)
        if cfg.filter_nans and i == 2:
            g["model"]["w"][0, 0] = np.nan
        upd, js = tx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        for name, gv in _flat(g).items():
            named[name].grad = torch.from_numpy(np.array(gv, np.float32))
        opt.step()
        for name, want in _flat(jp).items():
            np.testing.assert_allclose(named[name].detach().numpy(),
                                       np.asarray(want), rtol=0, atol=1e-6,
                                       err_msg=f"update {i}: {name}")
    assert opt.updates == 7 // cfg.grad_accum


def test_optax_state_carries_over_mid_accumulation(jax_start):
    """train_state_from_jax's reading of an optax state (MultiSteps with
    zero_nans, mid-accumulation) continues exactly where optax would."""
    _, _, jstate = jax_start
    kw = dict(grad_accum=2, filter_nans=True, lr_decay_step=1,
              steps_per_epoch=4)
    tx = jax_trainer.make_optimizer(jax_trainer.TrainerConfig(lr=1e-2, **kw))
    update = jax.jit(tx.update)
    params = _np_tree(jax.device_get(jstate.params))
    variables = {"batch_stats": _np_tree(jax.device_get(jstate.batch_stats))}
    r = np.random.default_rng(13)
    full = [jax.tree.map(lambda a: r.normal(size=np.shape(a)).astype(
        np.float32), params) for _ in range(6)]
    jp = jax.tree.map(jnp.asarray, params)
    js = tx.init(jp)
    for g in full[:3]:  # one update + one micro-step folded in
        upd, js = update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
    model = RelPoseGNN(RelPoseGNNConfig(**_cfg()))
    state = trainer.create_train_state(model, trainer.TrainerConfig(
        lr=1e-2, **kw))
    state.load_state_dict(train_state_from_jax(
        _np_tree(jax.device_get(jp)), variables["batch_stats"],
        jax.device_get(js)))
    assert state.optimizer.updates == 1 and state.optimizer.mini_step == 1
    for g in full[3:]:
        upd, js = update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        gsd = train_state_from_jax(_np_tree(g), variables["batch_stats"])
        by_name = {**{f"model.{k}": v for k, v in gsd["model"].items()},
                   **{f"{c}.{k}": v for c in ("criterion", "criterion_R")
                      for k, v in gsd[c].items()}}
        for name, p in zip(state.optimizer.names, state.optimizer.params):
            p.grad = by_name[name].clone()
        state.optimizer.step()
    want = train_state_from_jax(_np_tree(jax.device_get(jp)),
                                variables["batch_stats"])
    got = state.model.state_dict()
    for k, v in want["model"].items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# train steps from one state
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_start():
    """A JAX TrainState of the tiny model, with non-trivial BN."""
    model = JaxRelPoseGNN(JaxConfig(**_cfg()))
    tcfg = jax_trainer.TrainerConfig(lr=LR, steps_per_epoch=10)
    b = _batch(0)
    images, adj = jnp.asarray(b["images"]), jnp.asarray(b["adj"])
    variables = jax.jit(lambda k: model.init(k, images, adj))(
        jax.random.PRNGKey(0))
    state = jax_trainer.create_train_state(
        jax.random.PRNGKey(0), model, tcfg, images, adj, variables=variables)
    return model, tcfg, state


def _fresh(jstate):
    """A copy of the fixture's JAX state (its train step donates it)."""
    return jax.tree.map(jnp.copy, jstate)


def _port_state(jstate, **cfg_kw):
    model = RelPoseGNN(RelPoseGNNConfig(**_cfg(**cfg_kw)))
    state = trainer.create_train_state(
        model, trainer.TrainerConfig(lr=LR, steps_per_epoch=10))
    state.load_state_dict(train_state_from_jax(
        _np_tree(jax.device_get(jstate.params)),
        _np_tree(jax.device_get(jstate.batch_stats)),
        jax.device_get(jstate.opt_state)))
    return state


def test_three_train_steps_match_jax(jax_start):
    model, tcfg, jstate = jax_start
    jstate = _fresh(jstate)
    state = _port_state(jstate)
    step = trainer.make_train_step(state.optimizer.cfg)
    # the JAX train step's body (trainer.py:178-182), its gradients kept
    grad_fn = jax.jit(jax.value_and_grad(jax_trainer.loss_fn, has_aux=True),
                      static_argnums=(2, 5))
    rng = jax.random.PRNGKey(0)
    for i in range(3):
        b = _batch(100 + i)
        jb = jax.tree.map(jnp.asarray, b)
        (jloss, (new_bs, _)), jgrads = grad_fn(
            jstate.params, jstate.batch_stats, jstate.apply_fn, jb, rng, tcfg)
        jstate = jstate.apply_gradients(jgrads).replace(batch_stats=new_bs)
        m = step(state, _torch_batch(b), 0)
        np.testing.assert_allclose(m["loss"].item(), float(jloss), rtol=1e-5,
                                   err_msg=f"step {i}")
        want = train_state_from_jax(_np_tree(jax.device_get(jgrads)),
                                    _np_tree(jax.device_get(
                                        jstate.batch_stats)))
        want = {**{f"model.{k}": v for k, v in want["model"].items()},
                **{f"{c}.{k}": v for c in ("criterion", "criterion_R")
                   for k, v in want[c].items()}}
        for name, p in zip(state.optimizer.names, state.optimizer.params):
            np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=f"step {i}: grad {name}")
    assert state.step == 3 and state.optimizer.updates == 3
    want = train_state_from_jax(_np_tree(jax.device_get(jstate.params)),
                                _np_tree(jax.device_get(
                                    jstate.batch_stats)))
    got = state.state_dict()
    diffs = []
    for k, v in want["model"].items():
        g = got["model"][k]
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(g.numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-4, err_msg=k)
        elif not k.endswith("num_batches_tracked"):
            diffs.append((g - v).abs().flatten())
    for c in ("criterion", "criterion_R"):
        for k, v in want[c].items():
            diffs.append((got[c][k] - v).abs().reshape(1))
    diffs = torch.cat(diffs)
    assert diffs.max().item() <= 2 * LR * 3, diffs.max().item()
    assert diffs.mean().item() <= 1e-6, diffs.mean().item()


def test_remat_gives_the_same_step_and_updates_bn_once(jax_start):
    _, _, jstate = jax_start
    b = _torch_batch(_batch(7))
    out = []
    for remat in (False, True):
        state = _port_state(jstate, remat=remat)
        m = trainer.make_train_step(state.optimizer.cfg)(state, b, 0)
        out.append((m["loss"], state.state_dict()["model"]))
    (l0, sd0), (l1, sd1) = out
    torch.testing.assert_close(l0, l1, rtol=0, atol=0)
    for k in sd0:
        torch.testing.assert_close(sd0[k], sd1[k], rtol=1e-6, atol=1e-7,
                                   msg=k)


def test_train_step_is_seeded_by_seed_and_step():
    cfg = RelPoseGNNConfig(**_cfg(droprate=0.5))
    tcfg = trainer.TrainerConfig(edge_dropout_effective=True)
    b = _torch_batch(_batch(8))
    losses = []
    for seed in (0, 0, 1):
        model = RelPoseGNN(cfg)
        init_weights(model, torch.Generator().manual_seed(0))
        state = trainer.create_train_state(model, tcfg)
        step = trainer.make_train_step(tcfg)
        losses.append([step(state, b, seed)["loss"].item()
                       for _ in range(2)])
    assert losses[0] == losses[1] and losses[0] != losses[2]
    assert losses[0][0] != losses[0][1]


# ---------------------------------------------------------------------------
# eval step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fuse", ["first", "mean", "median"])
def test_eval_step_matches_jax(jax_start, fuse):
    _, _, jstate = jax_start
    state = _port_state(jstate)
    b = _batch(20, b=3)
    want = jax_trainer.make_eval_step(fuse=fuse)(
        jstate, jax.tree.map(jnp.asarray, b))
    got = trainer.make_eval_step(fuse=fuse)(state, _torch_batch(b))
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["nbr"].numpy(), np.asarray(want["nbr"]))
    for k in ("pred", "target", "pred_abs"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    if fuse != "first":
        assert bool(got["fuse_ok"]) == bool(want["fuse_ok"])


def test_eval_step_static_anchor_matches_jax(jax_start):
    _, _, jstate = jax_start
    state = _port_state(jstate)
    b = _batch(21)
    want = jax_trainer.make_eval_step(static_anchor=1)(
        jstate, jax.tree.map(jnp.asarray, b))
    got = trainer.make_eval_step(static_anchor=1)(state, _torch_batch(b))
    assert (got["nbr"] == 1).all()
    np.testing.assert_allclose(got["pred"].numpy(), np.asarray(want["pred"]),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the feed
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def two_stores(tmp_path_factory):
    root = tmp_path_factory.mktemp("stores")
    rng = np.random.default_rng(30)
    roots = []
    for s, (n, mean) in enumerate(((7, 0.4), (5, 0.6))):
        r = str(root / f"s{s}")
        w = JaxWriter(r, n, N, 8, 10, mean=[mean] * 3, std=[0.2 + s] * 3)
        for _ in range(n):
            w.add(rng.random((N, 8, 10, 3)),
                  rng.normal(size=(N, 6)).astype(np.float32),
                  rng.random((N, N)) < 0.5, nbr_idx=rng.integers(0, 9, N - 1))
        w.finalize()
        roots.append(r)
    return roots


def test_data_iterator_batch_order_matches_jax(two_stores):
    port = ConcatPackedDataset([PackedGraphDataset(r) for r in two_stores])
    ref = JaxConcatPackedDataset([JaxPacked(r) for r in two_stores])
    for kw in (dict(seed=3, epochs=2), dict(shuffle=False,
                                            drop_remainder=False)):
        got = list(pipeline.data_iterator(port, 5, **kw))
        want = list(jax_pipeline.data_iterator(ref, 5, **kw))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_device_prefetch_normalises_per_record_like_jax(two_stores):
    port = ConcatPackedDataset([PackedGraphDataset(r) for r in two_stores])
    batch = port.batch(np.array([0, 8, 3, 11]))
    got = next(pipeline.device_prefetch(iter([batch]), port.mean, port.std,
                                        device="cpu"))
    want = jax_pipeline.normalize_per_record(
        jnp.asarray(batch["images"]), jnp.asarray(batch["norm_mean"]),
        jnp.asarray(batch["norm_std"]))
    assert set(got) == {"images", "poses", "adj"}
    np.testing.assert_allclose(got["images"].numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    single = PackedGraphDataset(two_stores[1])
    b1 = single.batch(np.arange(3))
    got = next(pipeline.device_prefetch(iter([b1]), single.mean, single.std,
                                        device="cpu"))
    want = jax_pipeline.make_normalizer(single.mean, single.std)(
        jnp.asarray(b1["images"]))
    np.testing.assert_allclose(got["images"].numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


def test_device_prefetch_raises_the_feed_error_after_its_batches():
    def feed():
        yield {"images": np.zeros((1, 2, 2, 3), np.uint8)}
        raise OSError("disk gone")

    it = pipeline.device_prefetch(feed(), np.zeros(3), np.ones(3), "cpu")
    assert next(it)["images"].shape == (1, 2, 2, 3)
    with pytest.raises(OSError, match="disk gone"):
        next(it)


def test_concat_dataset_refuses_mixed_stores(tmp_path, two_stores):
    w = JaxWriter(str(tmp_path / "f16"), 1, N, 8, 10, mean=[0.5] * 3,
                  std=[0.2] * 3, dtype="float16")
    w.add(np.zeros((N, 8, 10, 3)), np.zeros((N, 6), np.float32),
          np.ones((N, N), bool))
    w.finalize()
    with pytest.raises(ValueError, match="mixed image dtypes"):
        ConcatPackedDataset([PackedGraphDataset(two_stores[0]),
                             PackedGraphDataset(str(tmp_path / "f16"))])
