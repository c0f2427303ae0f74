"""The port's headline bench (relpose_gnn_tpu_torch/benchmarks/bench_eval.py)
against the JAX package's root `bench.py` on the CPU: its reference
program (the baseline leg) and its measured step under each of the `--s2d`
/ `--compact` forms, with the same weights and inputs, then `main` end to
end at a tiny size; and the FLOP count of the attention core.

Narrow R3 in float32: ResNet18, dims 32, 4-node graphs, kNN 2, 32x40
frames, BatchNorm statistics drawn so that the fold is not the identity;
the attention core's plain version.  Weights cross over through
`models/convert.py::state_dict_from_jax`.

Tolerances: anchors equal.  The reference program's predictions within
atol 1e-5 of the JAX composition (bench.py:147-160; one unfolded forward,
measured ~1e-6).  The measured step within atol 1e-4 of the JAX serving
step (bench.py:235-258), as tests/test_torch_serving.py holds the cached
step: the fold and the s2d rewrite sum in another order on each side.
`main`'s self-check (the measured step against the reference program, in
float32) under 1e-4.  The FLOP count exact, as integers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relpose_gnn_tpu.evaluation import serving as jax_serving
from relpose_gnn_tpu.models import fold_bn as jax_fold
from relpose_gnn_tpu.models.posenet import RelPoseGNN as JaxRelPoseGNN
from relpose_gnn_tpu.models.posenet import RelPoseGNNConfig as JaxConfig
from relpose_gnn_tpu.ops import graph as jax_graph
from relpose_gnn_tpu_torch.benchmarks import _synthetic, _util, bench_eval
from relpose_gnn_tpu_torch.evaluation import serving
from relpose_gnn_tpu_torch.models.convert import state_dict_from_jax
from relpose_gnn_tpu_torch.models.posenet import RelPoseGNN, RelPoseGNNConfig
from relpose_gnn_tpu_torch.ops import att_core

B, N, D, H, W = 2, 4, 32, 32, 40
STAGES18 = (2, 2, 2, 2)
REF_ATOL = 1e-5
STEP_ATOL = 1e-4
TINY = ["--device", "cpu", "--backbone", "resnet18", "--dims", str(D),
        "--seq-len", str(N), "--height", str(H), "--width", str(W),
        "--dtype", "float32", "--iters", "1", "--batch-size", "4"]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads while this module runs: the suite runs several
    test processes on one host, and torch's default of one thread a core
    in each of them oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    """The narrow R3 preset: its GNN layout (dense) unless overridden."""
    base = dict(num_nodes=N, feat_dim=D, edge_dim=D, node_dim=D, knn=2,
                backbone="resnet18", droprate=0.0)
    base.update(kw)
    return base


def _random_variables(rng, shapes):
    """Seeded values for a flax variable tree of `shapes`: kernels normal
    / sqrt(fan in), BN scales near 1, running means small and variances
    in [0.8, 1.2], biases and shifts small."""
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


@pytest.fixture(scope="module")
def narrow():
    """Seeded JAX variables of the narrow R3 and one batch of graphs
    (numpy)."""
    rng = np.random.default_rng(0)
    adj = np.broadcast_to(~np.eye(N, dtype=bool), (B, N, N)).copy()
    imgs = rng.normal(size=(B, N, H, W, 3)).astype(np.float32)
    variables = _random_variables(rng, jax.eval_shape(
        JaxRelPoseGNN(JaxConfig(**_cfg())).init, jax.random.PRNGKey(0),
        imgs[:1], adj[:1]))
    poses = rng.normal(size=(B, N, 6)).astype(np.float32)
    return variables, (imgs, adj, poses)


def _port_model(variables):
    model = RelPoseGNN(RelPoseGNNConfig(**_cfg())).eval()
    model.load_state_dict(state_dict_from_jax(
        variables["params"], variables["batch_stats"], STAGES18),
        strict=True)
    return model


def test_reference_program_matches_jax(narrow):
    """bench.py:147-160 without the salt: the unfolded model over every
    node image, `nearest_neighbor`, the pose gather."""
    variables, (imgs, adj, poses) = narrow
    model = JaxRelPoseGNN(JaxConfig(**_cfg()))

    @jax.jit
    def eval_core(variables, images, adj, poses):
        _, pred_rel, _, aux = model.apply(variables, images, adj,
                                          train=False)
        nbr = jax_graph.nearest_neighbor(aux["node_feats"], node=0)
        b = pred_rel.shape[0]
        return (poses[jnp.arange(b), nbr]
                - pred_rel[jnp.arange(b), nbr, 0], nbr)

    want, want_nbr = eval_core(variables, imgs, adj, poses)
    with torch.inference_mode():
        got, nbr = bench_eval.reference_program(
            _port_model(variables), *map(torch.from_numpy,
                                         (imgs, adj, poses)))
    np.testing.assert_array_equal(nbr.numpy(), np.asarray(want_nbr))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=REF_ATOL)


@pytest.mark.parametrize("s2d,compact", [(False, False), (False, True),
                                         (True, False), (True, True)])
def test_measured_step_matches_jax(narrow, s2d, compact):
    """bench.py:235-258: the fold (with the s2d stem or not), the edge
    layout switch, the neighbours embedded by the serving model, the
    cached step."""
    variables, (imgs, adj, poses) = narrow
    fcfg, fvars = jax_fold.fold_relpose_backbone(
        JaxConfig(**_cfg()), variables, s2d_stem=s2d)
    fmodel = JaxRelPoseGNN(dataclasses.replace(fcfg, compact_edges=compact))
    nbr_imgs = imgs[:, 1:].reshape(B * (N - 1), H, W, 3)
    emb = jax_serving.make_embed_fn(fmodel)(fvars, nbr_imgs).reshape(
        B, N - 1, -1)
    want = jax_serving.make_cached_eval_step(fmodel, ref_node=0)(
        fvars, imgs[:, 0], emb, poses[:, 1:], adj)

    reference = _port_model(variables)
    served = _synthetic.serving_form(reference, s2d_stem=s2d,
                                     compact_edges=compact)
    assert not reference.cfg.compact_edges and not reference.cfg.bn_folded
    assert served.cfg.bn_folded and served.cfg.s2d_stem == s2d
    assert served.cfg.compact_edges == compact
    t = torch.from_numpy
    emb = serving.make_embed_fn(served)(t(nbr_imgs)).reshape(B, N - 1, -1)
    got = serving.make_cached_eval_step(served)(
        t(imgs[:, 0]), emb, t(poses[:, 1:]), t(adj))
    np.testing.assert_array_equal(got["nbr"].numpy(),
                                  np.asarray(want["nbr"]))
    np.testing.assert_allclose(got["pred"].numpy(), np.asarray(want["pred"]),
                               atol=STEP_ATOL)


def test_serving_form_refuses_s2d_for_a_vit():
    model = _synthetic.unfolded_pose_model(
        torch.device("cpu"), "R3-vit", None, feat_dim=D, edge_dim=D,
        node_dim=D, num_nodes=N, knn=2, vit_image_hw=(H, W))
    with pytest.raises(SystemExit, match="resnet backbones only"):
        _synthetic.serving_form(model, s2d_stem=True)
    served = _synthetic.serving_form(model)
    assert served is not model and served.cfg.compact_edges
    assert not model.cfg.compact_edges


def _main(capsys, argv):
    rec = bench_eval.main([*TINY, *argv])
    capsys.readouterr()
    return rec


def _attention_gflops(edges_per_graph, batch=4, passes=2):
    """3·E·C² a call: E messages (a graph's edges x the batch), C the
    attention block's width D / 8, one call a GNN pass."""
    return passes * 3 * batch * edges_per_graph * (D // 8) ** 2 / 1e9


@pytest.mark.parametrize("argv,s2d,compact,edges", [
    ([], False, True, N * 2),
    (["--s2d"], True, True, N * 2),
    (["--no-compact"], False, False, N * N),
])
def test_main_forms_skip_baseline(capsys, argv, s2d, compact, edges):
    """Under `--skip-baseline` every baseline_* and vs_* field is null;
    the self-check crosses the fold (and the s2d rewrite) in float32."""
    rec = _main(capsys, [*argv, "--skip-baseline"])
    assert rec["s2d"] == s2d and rec["compact"] == compact
    for key in ("vs_baseline", "vs_baseline_host_sync",
                "baseline_qps_device", "baseline_qps_host_sync",
                "baseline_chain", "baseline_replays"):
        assert rec[key] is None, key
    assert rec["self_check_same_anchor"]
    assert rec["self_check_max_err"] < 1e-4
    assert rec["attention_gflops"] == pytest.approx(
        _attention_gflops(edges), rel=1e-12)
    assert rec["step_gflops"] > rec["attention_gflops"] > 0
    assert rec["attention_launches"] == 0      # the plain core on the CPU


def test_main_refuses_s2d_for_a_vit(capsys):
    with pytest.raises(SystemExit, match="resnet backbones only"):
        bench_eval.main([*TINY, "--backbone", "vit", "--s2d",
                         "--skip-baseline"])


@pytest.mark.parametrize("shape", [(7, 16), (64, 4), (1, 256), (0, 8)])
@pytest.mark.parametrize("grad", [False, True])
def test_count_flops_adds_the_attention_core(shape, grad):
    """One `attention_core` call adds exactly 3·E·C², whichever
    implementation runs: what FlopCounterMode sees of the plain version
    (its einsum) is left out."""
    e, c = shape
    gen = torch.Generator().manual_seed(0)
    args = [torch.randn(e, c, generator=gen).requires_grad_(grad)
            for _ in range(3)]
    before = att_core.FLOPS
    assert _util.count_flops(
        lambda: att_core.attention_core(*args)) == 3 * e * c * c
    assert att_core.FLOPS - before == 3 * e * c * c
    # the tally rides on top of what FlopCounterMode counts around it
    m = torch.randn(3, 5, generator=gen)
    assert _util.count_flops(
        lambda: (att_core.attention_core(*args), m @ m.T)) == (
        3 * e * c * c + 2 * 3 * 5 * 3)


def test_device_chain_loop_holds_the_accumulator():
    """The CPU chain: one read at the end, the accumulator equal to the
    calls times the eager step's sum; a step that changes under the chain
    fails it."""
    x = torch.arange(6, dtype=torch.float32).reshape(1, 6)

    def step():
        return x + 1.0, torch.zeros(1, dtype=torch.int64)

    out = bench_eval.device_chain(step, 5, torch.device("cpu"))
    assert out["chain"] == "loop" and out["replays"] == 5
    assert out["acc"] == out["want"] == 5 * 21.0 and out["qps"] > 0
    calls = []

    def drifting():
        calls.append(1)
        return x * len(calls), None

    with pytest.raises(AssertionError, match="accumulator"):
        bench_eval.device_chain(drifting, 5, torch.device("cpu"))
