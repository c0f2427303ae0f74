"""The port's probe benches (relpose_gnn_tpu_torch/benchmarks/:
bench_backbone_stages, bench_bisect, bench_s2d, bench_stem_s2d2,
probe_eval) against the JAX package's scripts on the CPU, with the same
weights and inputs, and each bench's `main` end to end at a tiny size.

Tolerances:
* `stage_flops`: equal, as integers.
* The stage modules against the JAX `_Stem` / `_Stage` / `_Head`, which
  compute in bfloat16 as the port's do: max |port - jax| over max |jax|
  under STAGE_BF16_TOL.  Both round every convolution's output to
  bfloat16, but sum its products in another order, so an output within
  float32 rounding of a bfloat16 boundary rounds the other way in one of
  them: one bfloat16 ulp, up to 2^-7 of max |y| (values in [1, 2) against
  a max below 2), which the next blocks carry on.  Measured over four
  seeds: stem 6.3e-3 to 6.5e-3 (one such flip), layer1-4 7.4e-3 to
  1.5e-2 of max |y|; the head, a float32 mean and product after a
  bfloat16 input, 3.7e-7 to 5.0e-7.
* `packed_stem` against the JAX function in float32: 1e-5 of max |y|.
* The bisect's three steps and probe_eval's step against the JAX
  expressions in float32 (narrow R3: ResNet18, dims 32, 4-node graphs,
  kNN 2, the attention kernel's plain version): anchors equal, values
  within atol 1e-4, as tests/test_torch_serving.py holds the cached step.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import bench_backbone_stages as jax_stages
from benchmarks import bench_stem_s2d2 as jax_s2d2
from relpose_gnn_tpu.evaluation import serving as jax_serving
from relpose_gnn_tpu.models import fold_bn as jax_fold
from relpose_gnn_tpu.models.posenet import RelPoseGNN as JaxRelPoseGNN
from relpose_gnn_tpu.models.posenet import RelPoseGNNConfig as JaxConfig
from relpose_gnn_tpu.ops import graph as jax_graph
from relpose_gnn_tpu_torch.benchmarks import (bench_backbone_stages,
                                              bench_bisect, bench_s2d,
                                              bench_stem_s2d2, probe_eval)
from relpose_gnn_tpu_torch.models.convert import state_dict_from_jax
from relpose_gnn_tpu_torch.models.fold_bn import fold_relpose_backbone
from relpose_gnn_tpu_torch.models.posenet import RelPoseGNN, RelPoseGNNConfig

STAGE_BF16_TOL = {"stem": 2 ** -7, "layer1": 2.5e-2, "layer2": 2.5e-2,
                  "layer3": 2.5e-2, "layer4": 2.5e-2, "head": 1e-5}
PACKED_TOL = 1e-5
ATOL = 1e-4
B, N, D, H, W = 3, 4, 32, 32, 40
STAGES18 = (2, 2, 2, 2)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads while this module runs: the suite runs several
    test processes on one host, and torch's default of one thread a core
    in each of them oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# (a) the stage FLOPs, (b) the stage modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch", [1, 512])
@pytest.mark.parametrize("stage", list(jax_stages._STAGES))
def test_stage_flops_equal_the_jax_count(stage, batch):
    assert bench_backbone_stages.STAGES == jax_stages._STAGES
    assert (bench_backbone_stages.stage_flops(stage, batch)
            == jax_stages.stage_flops(stage, batch))


def _conv_into(conv, p):
    conv.weight.copy_(torch.from_numpy(
        np.asarray(p["kernel"], np.float32).transpose(3, 2, 0, 1)))
    conv.bias.copy_(torch.from_numpy(np.asarray(p["bias"], np.float32)))


def _port_stage(name, params):
    """The port's stage module with the JAX module's weights."""
    mod = bench_backbone_stages.stage_module(name).eval()
    with torch.no_grad():
        if name == "stem":
            _conv_into(mod.conv1, params["conv1"])
        elif name == "head":
            mod.fc.weight.copy_(torch.from_numpy(
                np.asarray(params["fc"]["kernel"], np.float32).T))
            mod.fc.bias.copy_(torch.from_numpy(
                np.asarray(params["fc"]["bias"], np.float32)))
        else:
            for i, block in enumerate(mod.blocks):
                p = params[f"b{i}"]
                _conv_into(block.conv1, p["conv1"])
                _conv_into(block.conv2, p["conv2"])
                if block.downsample is not None:
                    _conv_into(block.downsample[0], p["downsample_conv"])
    return mod


def _jax_stage(name):
    s = jax_stages._STAGES[name]
    if name == "stem":
        return jax_stages._Stem()
    if name == "head":
        return jax_stages._Head()
    return jax_stages._Stage(blocks=s["blocks"], filters=s["filters"],
                             stride=s["stride"])


def _random_variables(rng, shapes):
    """Seeded values for a flax variable tree of `shapes` (from
    `jax.eval_shape`, so nothing is compiled to draw them): kernels
    normal / sqrt(fan in), biases and BN shifts small, BN scales near 1,
    running means small and variances in [0.8, 1.2]."""
    def draw(path, leaf):
        name, shape = str(path[-1].key), leaf.shape
        if name == "kernel":
            x = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            x = 1.0 + 0.1 * rng.normal(size=shape)
        elif name == "var":
            x = rng.uniform(0.8, 1.2, shape)
        elif name == "mean":
            x = rng.uniform(-0.1, 0.1, shape)
        else:
            x = 0.05 * rng.normal(size=shape)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.mark.parametrize("stage", list(jax_stages._STAGES))
def test_stage_modules_match_jax_in_bf16(stage):
    h, w, c = jax_stages._STAGES[stage]["shape"]
    batch = 1 if stage in ("stem", "layer1", "layer2") else 2
    mod = _jax_stage(stage)
    rng = np.random.default_rng(5)
    variables = _random_variables(rng, jax.eval_shape(
        mod.init, jax.random.PRNGKey(3), jnp.zeros((1, h, w, c),
                                                   jnp.bfloat16)))
    xb = jnp.asarray(rng.normal(size=(batch, h, w, c)), jnp.bfloat16)
    want = np.asarray(jax.jit(mod.apply)(variables, xb).astype(jnp.float32))
    xt = torch.tensor(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16)
    if stage != "stem":
        xt = xt.permute(0, 3, 1, 2)       # NCHW view of NHWC memory
    with torch.inference_mode():
        got = _port_stage(stage, variables["params"])(xt).float()
    if got.dim() == 4:
        got = got.permute(0, 2, 3, 1)
    assert tuple(got.shape) == want.shape
    assert tuple(want.shape[1:]) == bench_backbone_stages.OUT_SHAPES[stage]
    assert _rel(got.numpy(), want) < STAGE_BF16_TOL[stage]


def test_stage_shapes_follow_the_port_resnet():
    """The stage inputs are what the port's ResNet34 stem and stages hand
    on at 256x341: each stage's output is the next one's input."""
    names = list(bench_backbone_stages.STAGES)
    for a, b in zip(names, names[1:]):
        assert bench_backbone_stages.OUT_SHAPES[a] == \
            bench_backbone_stages.STAGES[b]["shape"]


# ---------------------------------------------------------------------------
# (c) the packed stem
# ---------------------------------------------------------------------------


def test_packed_stem_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 256, 341, 3)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 48, 256)) * 0.05).astype(np.float32)
    b = (rng.normal(size=(256,)) * 0.05).astype(np.float32)
    want = np.asarray(jax.jit(jax_s2d2.packed_stem)(x, w, b))
    got = bench_stem_s2d2.packed_stem(
        torch.from_numpy(x), torch.from_numpy(w.transpose(3, 2, 0, 1)),
        torch.from_numpy(b)).numpy()
    assert got.shape == want.shape == (2, 128, 171, 64)
    assert _rel(got, want) < PACKED_TOL


# ---------------------------------------------------------------------------
# (d) the bisect's steps, (e) probe_eval's step
# ---------------------------------------------------------------------------


def _cfg(**kw):
    base = dict(num_nodes=N, feat_dim=D, edge_dim=D, node_dim=D, knn=2,
                backbone="resnet18", droprate=0.0)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def narrow():
    """Seeded JAX variables of a narrow R3 (BatchNorm statistics drawn so
    the fold is not the identity) and numpy inputs."""
    rng = np.random.default_rng(0)
    model = JaxRelPoseGNN(JaxConfig(**_cfg()))
    adj = np.broadcast_to(~np.eye(N, dtype=bool), (B, N, N)).copy()
    imgs = rng.normal(size=(B, N, H, W, 3)).astype(np.float32)
    variables = _random_variables(rng, jax.eval_shape(
        model.init, jax.random.PRNGKey(0), imgs[:1], adj[:1]))
    inputs = dict(imgs=imgs, adj=adj,
                  q=rng.normal(size=(B, H, W, 3)).astype(np.float32),
                  emb=rng.normal(size=(B, N - 1, D)).astype(np.float32),
                  poses=rng.normal(size=(B, N, 6)).astype(np.float32),
                  x0=rng.normal(size=(B, D)).astype(np.float32))
    return variables, inputs


def _port_model(variables, **kw):
    model = RelPoseGNN(RelPoseGNNConfig(**_cfg(**kw))).eval()
    model.load_state_dict(state_dict_from_jax(
        variables["params"], variables["batch_stats"], STAGES18),
        strict=True)
    return model


def test_bisect_steps_match_the_jax_expressions(narrow):
    variables, inp = narrow
    cfg = JaxConfig(**_cfg(compact_edges=True))
    fcfg, fvars = jax_fold.fold_relpose_backbone(cfg, variables)
    fmodel = JaxRelPoseGNN(fcfg)
    q, emb, poses, adj, x0 = (inp[k] for k in ("q", "emb", "poses", "adj",
                                               "x0"))

    @jax.jit
    def jax_steps(fvars, q, emb, poses, adj, x0):
        full = jax_serving.make_cached_eval_step(fmodel, ref_node=0)(
            fvars, q, emb, poses[:, 1:], adj)["pred"]
        bb = fmodel.apply(fvars, q[:, None], train=False,
                          method=JaxRelPoseGNN.encode_nodes)[:, 0]
        x = jnp.concatenate([x0[:, None], emb.astype(x0.dtype)], axis=1)
        _, pred_rel, _, aux = fmodel.apply(
            fvars, x, adj, train=False,
            method=JaxRelPoseGNN.from_embeddings)
        nbr = jax_graph.nearest_neighbor(aux["node_feats"], node=0)
        bb_rows = jnp.arange(pred_rel.shape[0])
        gnn = (poses[bb_rows, 1 + nbr - 1]
               - pred_rel[bb_rows, nbr, 0])
        return {"full": full, "backbone_only": bb, "gnn_only": gnn}

    want = jax_steps(fvars, q, emb, poses, adj, x0)

    _, model = fold_relpose_backbone(_port_model(variables,
                                                 compact_edges=True))
    steps = bench_bisect.make_steps(model, *(torch.from_numpy(inp[k]) for k
                                             in ("q", "emb", "poses", "adj",
                                                 "x0")))
    assert set(steps) == set(bench_bisect.STEPS)
    with torch.inference_mode():
        for name, fn in steps.items():
            np.testing.assert_allclose(fn().float().numpy(),
                                       np.asarray(want[name]), atol=ATOL,
                                       err_msg=name)


def test_probe_eval_step_matches_jax(narrow):
    variables, inp = narrow
    model = JaxRelPoseGNN(JaxConfig(**_cfg()))
    imgs, adj, poses = inp["imgs"], inp["adj"], inp["poses"]

    @jax.jit
    def eval_fn(variables, images, adj, poses):
        _, pred_rel, _, aux = model.apply(variables, images, adj,
                                          train=False)
        nbr = jax_graph.nearest_neighbor(aux["node_feats"], node=0)
        b = pred_rel.shape[0]
        return poses[jnp.arange(b), nbr] - pred_rel[jnp.arange(b), nbr, 0]

    want = eval_fn(variables, imgs, adj, poses)
    with torch.inference_mode():
        got = probe_eval.eval_fn(_port_model(variables),
                                 *map(torch.from_numpy, (imgs, adj, poses)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


# ---------------------------------------------------------------------------
# the benches end to end on the CPU
# ---------------------------------------------------------------------------

TINY = ["--device", "cpu", "--dtype", "float32", "--iters", "1",
        "--warmup", "0"]
MODEL = ["--backbone", "resnet18", "--dims", "32", "--height", "32",
         "--width", "40"]


def _run(capsys, bench, argv, tmp_path):
    path = tmp_path / "record.json"
    out = bench.main([*argv, "--json", str(path)])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == json.loads(json.dumps(out)) == json.loads(path.read_text())
    assert last["platform"] == "cpu" and last["card"] is None
    return last


def test_backbone_stages_main(capsys, tmp_path):
    rec = _run(capsys, bench_backbone_stages, [*TINY, "--batch", "1"],
               tmp_path)
    assert list(rec["stages"]) == list(bench_backbone_stages.STAGES)
    for name, row in rec["stages"].items():
        assert row["ms"] > 0 and row["bf16_peak_share"] is None
        assert row["gflop"] * 1e9 == bench_backbone_stages.stage_flops(
            name, 1)
        assert row["out_shape"] == list(
            bench_backbone_stages.OUT_SHAPES[name])
    one = _run(capsys, bench_backbone_stages,
               [*TINY, "--batch", "1", "--stage", "head"], tmp_path)
    assert list(one["stages"]) == ["head"]


def test_bisect_main(capsys, tmp_path, monkeypatch):
    calls = []
    plain = bench_bisect.att_core.attention_core_plain
    monkeypatch.setattr(
        "relpose_gnn_tpu_torch.ops.att_core.attention_core_plain",
        lambda *a: calls.append(1) or plain(*a))
    rec = _run(capsys, bench_bisect, [*TINY, *MODEL, "--seq-len", "4",
                                      "--batch", "3"], tmp_path)
    assert set(rec["step_ms"]) == set(bench_bisect.STEPS)
    assert rec["overlap_ms"] == pytest.approx(
        rec["bb_plus_gnn_ms"] - rec["step_ms"]["full"])
    # the plain core on the CPU: no launch; twice a call of full and gnn
    assert rec["attention_launches"] == 0
    assert len(calls) == 2 * 2 * 2 * 1


def test_probe_eval_main(capsys, tmp_path):
    rec = _run(capsys, probe_eval, [*TINY, *MODEL, "--seq-len", "4",
                                    "--batches", "2,3"], tmp_path)
    assert set(rec["batches"]) == {"2", "3"}
    for b, row in rec["batches"].items():
        assert row["qps"] == pytest.approx(int(b) / row["ms"] * 1e3)
    assert rec["attention_launches"] == {"2": 0, "3": 0}


def test_s2d_main(capsys, tmp_path):
    rec = _run(capsys, bench_s2d, [*TINY, "--backbone", "resnet18",
                                   "--dims", "32", "--height", "32",
                                   "--width", "40", "--batch", "2"],
               tmp_path)
    assert set(rec["stems"]) == {"7x7", "s2d"}
    assert rec["stems"]["s2d"]["flops_per_step"] > \
        rec["stems"]["7x7"]["flops_per_step"]
    # the same function up to float summation order
    assert rec["max_feature_diff"] < 1e-5 * rec["max_feature"]


def test_stem_s2d2_main(capsys, tmp_path):
    rec = _run(capsys, bench_stem_s2d2, [*TINY, "--batch", "2"], tmp_path)
    assert rec["packed_over_plain"] == pytest.approx(
        rec["packed_ms"] / rec["plain_ms"])
    assert rec["true_tap_gflop"] * 1e9 == 2 * 128 * 171 * 147 * 64 * 2


def test_probes_refuse_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    for bench in (bench_backbone_stages, bench_bisect, bench_s2d,
                  bench_stem_s2d2, probe_eval):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bench.main(["--batch" if bench is not probe_eval
                        else "--batches", "1"])
