"""Fused pair MLP (relpose_gnn_tpu_torch/ops/pair_mlp.py) against the JAX
package's Pallas kernel in interpret mode, at the four shapes of
tests/test_pallas_gnn.py, plus the CUDA kernel against its plain version
where a card is present.

Tolerances.  float32: rtol 1e-4, atol 1e-3, as tests/test_pallas_gnn.py
holds the Pallas kernel to numpy (sums over up to 1024 hidden units in
another order).  bfloat16 operands: both sides round the operands and the
hidden activation to bfloat16 at the same places and accumulate in
float32, so they differ only where a float32 sum taken in another order
lands on the other side of a bfloat16 rounding boundary of the hidden
activation; one such flip moves the output by 2^-8 |h| |w2|, typically
4e-4 here and at worst 8e-3 (|h| up to ~5, |w2| up to ~0.4).  Measured on
the CPU: at most 4.0e-4 absolute at these shapes (|out| up to ~11); the
bound used, atol 2e-2 with rtol 1e-2, allows two worst-case flips.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from relpose_gnn_tpu.ops import gnn_pallas
from relpose_gnn_tpu_torch.benchmarks import (bench_pair_mlp,
                                              bench_pair_mlp_steps)
from relpose_gnn_tpu_torch.models.gnn import MLP2
from relpose_gnn_tpu_torch.ops import _build, pair_mlp

F32_TOL = dict(rtol=1e-4, atol=1e-3)
BF16_TOL = dict(rtol=1e-2, atol=2e-2)
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# (E, D, De, H, Dout, block_e, block_h): the two direct-kernel cases
FUSED_SHAPES = [(256, 32, 16, 512, 64, 128, 256),
                (128, 16, 16, 1024, 32, 128, 256)]
# (B, N, D, De, H, Dout, mode): the two pair_mlp_apply cases; E = 72 and
# H = 40 are ragged against every tile on purpose
APPLY_SHAPES = [(2, 6, 24, 8, 40, 8, "edge"), (1, 4, 16, 16, 32, 16, "msg")]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads while this module runs: the suite runs several
    test processes on one host, and torch's default of one thread a core
    in each of them oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _fused_inputs(e, d, de, h, do, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return [rng.normal(size=(e, d)).astype(f),
            rng.normal(size=(e, d)).astype(f),
            rng.normal(size=(e, de)).astype(f),
            (rng.normal(size=(d, h)) * 0.1).astype(f),
            (rng.normal(size=(d, h)) * 0.1).astype(f),
            (rng.normal(size=(de, h)) * 0.1).astype(f),
            rng.normal(size=h).astype(f),
            (rng.normal(size=(h, do)) * 0.1).astype(f),
            rng.normal(size=do).astype(f)]


def _apply_inputs(b, n, d, de, h, do, mode, seed=2):
    rng = np.random.default_rng(seed)
    f = np.float32
    k_in = (2 * d if mode == "edge" else d) + de
    return [rng.normal(size=(b, n, d)).astype(f),
            rng.normal(size=(b, n, n, de)).astype(f),
            (rng.normal(size=(k_in, h)) * 0.1).astype(f),
            rng.normal(size=h).astype(f),
            (rng.normal(size=(h, do)) * 0.1).astype(f),
            rng.normal(size=do).astype(f)]


def _cast_operands(arrs, dtype, weight_idx):
    """Weights (and operands) in the working dtype, biases float32."""
    out = [torch.from_numpy(a) for a in arrs]
    return [t.to(TORCH_DT[dtype]) if i in weight_idx else t
            for i, t in enumerate(out)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", FUSED_SHAPES)
def test_plain_matches_pallas_interpret(shape, dtype):
    *dims, be, bh = shape
    arrs = _fused_inputs(*dims)
    jdt = jnp.dtype(dtype)
    jargs = [jnp.asarray(a).astype(jdt) if i in (3, 4, 5, 7)
             else jnp.asarray(a) for i, a in enumerate(arrs)]
    want = gnn_pallas.fused_pair_mlp(*jargs, block_e=be, block_h=bh,
                                     interpret=True)
    targs = _cast_operands(arrs, dtype, (0, 1, 2, 3, 4, 5, 7))
    got = pair_mlp.fused_pair_mlp(*targs)
    assert got.dtype == torch.float32 and got.shape == (dims[0], dims[4])
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", APPLY_SHAPES)
def test_apply_matches_pallas_interpret(shape, dtype):
    *dims, mode = shape
    arrs = _apply_inputs(*dims, mode)
    want = gnn_pallas.pair_mlp_apply(
        *map(jnp.asarray, arrs), mode=mode, dtype=jnp.dtype(dtype),
        block_e=128, block_h=128, interpret=True)
    got = pair_mlp.pair_mlp_apply(*map(torch.from_numpy, arrs), mode=mode,
                                  dtype=TORCH_DT[dtype])
    b, n = dims[:2]
    assert got.shape == (b, n, n, dims[5]) and got.dtype == torch.float32
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("shape", APPLY_SHAPES)
def test_apply_matches_concat_mlp2_of_the_port(shape):
    """pair_mlp_apply == models/gnn.py::MLP2 over the concatenated input
    (float32; same tolerance, another summation order)."""
    b, n, d, de, h, do, mode = shape
    x, e, fc1k, fc1b, fc2k, fc2b = map(torch.from_numpy,
                                       _apply_inputs(*shape[:-1], mode))
    mlp = MLP2(fc1k.shape[0], h, do)
    with torch.no_grad():
        mlp[0].weight.copy_(fc1k.T)
        mlp[0].bias.copy_(fc1b)
        mlp[2].weight.copy_(fc2k.T)
        mlp[2].bias.copy_(fc2b)
        xs = x[:, :, None].expand(b, n, n, d)
        xt = x[:, None].expand(b, n, n, d)
        parts = [xs, xt, e] if mode == "edge" else [xs, e]
        want = mlp(torch.cat(parts, -1))
    got = pair_mlp.pair_mlp_apply(x, e, fc1k, fc1b, fc2k, fc2b, mode=mode,
                                  dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)


def test_node_table_indexing_equals_materialised_rows():
    """`nodes=N` reads the node table by pair exactly as the broadcast
    [E, D] copies would be read."""
    b, n, d, de, h, do = 2, 3, 5, 4, 7, 6
    arrs = _fused_inputs(b * n * n, d, de, h, do, seed=5)
    t = [torch.from_numpy(a) for a in arrs]
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(b, n, d)).astype(np.float32))
    xs = x[:, :, None].expand(b, n, n, d).reshape(-1, d)
    xt = x[:, None].expand(b, n, n, d).reshape(-1, d)
    want = pair_mlp.fused_pair_mlp(xs, xt, *t[2:])
    xf = x.reshape(b * n, d)
    got = pair_mlp.fused_pair_mlp(xf, xf, *t[2:], nodes=n)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_cpu_path_never_counts_a_launch():
    before = pair_mlp.LAUNCHES
    pair_mlp.fused_pair_mlp(*map(torch.from_numpy,
                                 _fused_inputs(8, 4, 4, 4, 4)))
    assert pair_mlp.LAUNCHES == before


@pytest.mark.parametrize("dtype,widths,aligned,want", [
    (torch.bfloat16, (2048, 2048, 2048, 2048), True, "wgmma"),
    (torch.bfloat16, (24, 8, 40, 8), True, "wgmma"),
    (torch.bfloat16, (16, 16, 32, 16), True, "wgmma"),
    (torch.bfloat16, (20, 8, 40, 8), True, "mma_sync"),     # D % 8
    (torch.bfloat16, (24, 12, 40, 8), True, "mma_sync"),    # De % 8
    (torch.bfloat16, (24, 8, 36, 8), True, "mma_sync"),     # H % 8
    (torch.bfloat16, (24, 8, 40, 10), True, "mma_sync"),    # Dout % 8
    (torch.bfloat16, (2048, 2048, 2048, 2048), False, "mma_sync"),
    (torch.float32, (2048, 2048, 2048, 2048), True, "fma"),
    (torch.float32, (3, 5, 1, 2), False, "fma"),
])
def test_kernel_route_by_dtype_and_shape(dtype, widths, aligned, want):
    """The route is a pure function of dtype, widths and alignment."""
    assert pair_mlp.kernel_route(dtype, *widths, aligned) == want
    # asking for the route the shape selects is the same as not asking
    assert pair_mlp.kernel_route(dtype, *widths, aligned, route=want) == want


@pytest.mark.parametrize("dtype,widths,aligned,route,exc", [
    (torch.bfloat16, (20, 8, 40, 8), True, "wgmma", ValueError),
    (torch.bfloat16, (2048, 2048, 2048, 2048), False, "wgmma", ValueError),
    (torch.bfloat16, (2048, 2048, 2048, 2048), True, "fma", ValueError),
    (torch.float32, (2048, 2048, 2048, 2048), True, "wgmma", ValueError),
    (torch.float32, (2048, 2048, 2048, 2048), True, "mma_sync", ValueError),
    (torch.bfloat16, (2048, 2048, 2048, 2048), True, "cublas", ValueError),
    (torch.float16, (2048, 2048, 2048, 2048), True, None, TypeError),
])
def test_kernel_route_refuses_what_does_not_fit(dtype, widths, aligned,
                                                route, exc):
    """A route asked for by name that the operands do not fit raises: it
    is a choice, never a fallback."""
    with pytest.raises(exc):
        pair_mlp.kernel_route(dtype, *widths, aligned, route=route)


def test_aligned_bf16_may_still_ask_for_mma_sync():
    assert pair_mlp.kernel_route(torch.bfloat16, 2048, 2048, 2048, 2048,
                                 route="mma_sync") == "mma_sync"


@pytest.mark.parametrize("route", [None, "wgmma", "mma_sync", "fma",
                                   "no-such-route"])
def test_route_is_not_looked_at_for_cpu_tensors(route):
    """CPU tensors take the plain version whatever `route` says, and no
    launch is counted on any route."""
    args = list(map(torch.from_numpy, _fused_inputs(8, 4, 4, 4, 4)))
    before = (pair_mlp.LAUNCHES, dict(pair_mlp.ROUTE_LAUNCHES))
    got = pair_mlp.fused_pair_mlp(*args, route=route)
    want = pair_mlp.fused_pair_mlp_plain(*args)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert (pair_mlp.LAUNCHES, pair_mlp.ROUTE_LAUNCHES) == before


def test_route_counts_cover_every_route_and_sum_to_the_total():
    assert set(pair_mlp.ROUTE_LAUNCHES) == {"fma", "mma_sync", "wgmma"}
    assert sum(pair_mlp.ROUTE_LAUNCHES.values()) == pair_mlp.LAUNCHES


def _meta_args(dtype=torch.float32):
    s = [(8, 4), (8, 4), (8, 3), (4, 5), (4, 5), (3, 5), (5,), (5, 2), (2,)]
    return [torch.empty(*shape, device="meta",
                        dtype=torch.float32 if i in (6, 8) else dtype)
            for i, shape in enumerate(s)]


def test_wrapper_refusals():
    """Tensors that are not on the CPU go to the kernel's checks: what the
    kernel does not take raises (shown on `meta` tensors, which need no
    card), and a well-formed call on a device that is not CUDA is refused
    for its device, never computed by the plain version."""
    with pytest.raises(ValueError, match="CUDA tensors"):
        pair_mlp.fused_pair_mlp(*_meta_args())
    mixed = _meta_args()
    mixed[2] = mixed[2].to(torch.bfloat16)
    with pytest.raises(TypeError, match="dtype"):
        pair_mlp.fused_pair_mlp(*mixed)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        pair_mlp.fused_pair_mlp(*_meta_args(torch.float16))
    strided = _meta_args()
    strided[3] = torch.empty(5, 4, device="meta").T
    with pytest.raises(ValueError, match="not contiguous"):
        pair_mlp.fused_pair_mlp(*strided)
    bad_shape = _meta_args()
    bad_shape[7] = torch.empty(6, 2, device="meta")
    with pytest.raises(ValueError, match="w2 has shape"):
        pair_mlp.fused_pair_mlp(*bad_shape)
    half = _meta_args()
    half[1] = None
    with pytest.raises(ValueError, match="both xt and w1b"):
        pair_mlp.fused_pair_mlp(*half)
    grad = _meta_args()
    grad[3].requires_grad_(True)
    with pytest.raises(RuntimeError, match="inference-only"):
        pair_mlp.fused_pair_mlp(*grad)
    with pytest.raises(ValueError, match="mode="):
        pair_mlp.pair_mlp_apply(*map(torch.from_numpy, _apply_inputs(
            1, 2, 4, 4, 4, 4, "edge")), mode="typo")


def test_bench_entry_runs_on_cpu_when_asked_and_refuses_by_default(capsys):
    out = bench_pair_mlp.main(["--batch", "2", "--nodes", "3", "--dims",
                               "32", "--iters", "2", "--device", "cpu"])
    # the concat form's last bf16 linear rounds its output: ~2^-9 relative
    assert out["rel_max_diff"] < 1e-2
    assert set(out["ms"]) == {"kernel", "concat", "split"}
    assert out["kernel_calls"] == 1 + 2 * (bench_pair_mlp.WARMUP + 2)
    assert "rel max diff kernel vs concat" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            bench_pair_mlp.main(["--batch", "1", "--nodes", "2", "--dims",
                                 "8", "--iters", "1"])


def test_steps_bench_names_its_builds_and_needs_the_card():
    """Every design step is a build of the source with its settings; the
    default build has none.  Off the card there is nothing to time."""
    steps = bench_pair_mlp_steps.STEPS
    assert steps["default"] == ()
    assert {"ring2", "tile128", "tile256", "rows_fast",
            "atomics"} <= set(steps)
    source = (_build.CSRC_DIR / "pair_mlp.cu").read_text()
    for defs in steps.values():
        for setting in defs:
            name, _, value = setting.partition("=")
            assert value and f"#ifndef {name}" in source, setting
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            bench_pair_mlp_steps.main(["--nodes", "2", "--dims", "8"])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [s[:5] for s in FUSED_SHAPES]
                         + [(72, 24, 8, 40, 8), (16, 16, 16, 32, 16),
                            (0, 8, 8, 8, 8), (7, 3, 5, 1, 2)])
def test_kernel_matches_plain_on_cuda(cuda_device, shape, dtype):
    args = [t.to(cuda_device) for t in _cast_operands(
        _fused_inputs(*shape), dtype, (0, 1, 2, 3, 4, 5, 7))]
    before = pair_mlp.LAUNCHES
    got = pair_mlp.fused_pair_mlp(*args)
    want = pair_mlp.fused_pair_mlp_plain(*args)
    torch.cuda.synchronize()
    assert pair_mlp.LAUNCHES == before + (1 if shape[0] else 0)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    torch.testing.assert_close(got, want, **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", APPLY_SHAPES)
def test_apply_kernel_matches_plain_on_cuda(cuda_device, shape):
    *dims, mode = shape
    args = [torch.from_numpy(a).to(cuda_device)
            for a in _apply_inputs(*dims, mode)]
    got = pair_mlp.pair_mlp_apply(*args, mode=mode, dtype=torch.float32)
    want = pair_mlp.pair_mlp_apply(*[a.cpu() for a in args], mode=mode,
                                   dtype=torch.float32)
    torch.testing.assert_close(got.cpu(), want, **F32_TOL)


def _bf16_ops(device, e_rows, d, de, h, dout, xt=True, seed=3):
    """Direct-row bfloat16 operands with weights scaled to keep the sums
    near 1; biases float32."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=device) * scale

    bf = torch.bfloat16
    k_in = (2 * d if xt else d) + de
    return [r(e_rows, d).to(bf), r(e_rows, d).to(bf) if xt else None,
            r(e_rows, de).to(bf), r(d, h, scale=k_in ** -0.5).to(bf),
            r(d, h, scale=k_in ** -0.5).to(bf) if xt else None,
            r(de, h, scale=k_in ** -0.5).to(bf), r(h) * 0.1,
            r(h, dout, scale=h ** -0.5).to(bf), r(dout) * 0.1]


# max |kernel - plain| over max |out|: chip_smoke.py derives the bound
PAIR_BF16_REL = 2e-3


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["wgmma", "mma_sync"])
@pytest.mark.parametrize("shape,xt", [
    ((1024, 2048, 2048, 2048, 2048), True),
    ((1024, 2048, 2048, 2048, 2048), False),
    ((16384, 2048, 2048, 2048, 2048), True),
    ((1000, 2048, 2048, 2056, 1032), True),      # ragged against every tile
    ((1000, 2048, 2048, 2056, 1032), False),
    ((72, 24, 8, 40, 8), True),
    ((129, 64, 8, 264, 136), True),
])
def test_bf16_routes_match_plain_on_cuda(cuda_device, shape, xt, route):
    """Both bfloat16 routes on the same aligned inputs, each counted on
    its own route."""
    args = _bf16_ops(cuda_device, *shape, xt=xt)
    before = dict(pair_mlp.ROUTE_LAUNCHES)
    got = pair_mlp.fused_pair_mlp(*args, route=route)
    want = pair_mlp.fused_pair_mlp_plain(*args)
    torch.cuda.synchronize()
    after = pair_mlp.ROUTE_LAUNCHES
    assert {k: after[k] - before[k] for k in after} == {
        "fma": 0, "mma_sync": 0, "wgmma": 0, route: 1}
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= PAIR_BF16_REL * float(
        want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["edge", "msg"])
@pytest.mark.parametrize("nodes", [8, 32])
def test_apply_takes_the_wgmma_route_at_the_bench_shapes(cuda_device, mode,
                                                         nodes):
    """`pair_mlp_apply` at B = 16, every width 2048 (E = 1024 and 16384):
    sliced weights stay 16-byte aligned, so the shape selects 'wgmma'."""
    rng = np.random.default_rng(4)
    d = 2048
    k_in = (2 * d if mode == "edge" else d) + d
    x = torch.from_numpy(rng.normal(size=(16, nodes, d)).astype(np.float32))
    e = torch.from_numpy(rng.normal(size=(16, nodes, nodes, d)).astype(
        np.float32))
    fc1 = torch.from_numpy((rng.normal(size=(k_in, d)) * k_in ** -0.5).astype(
        np.float32))
    fc2 = torch.from_numpy((rng.normal(size=(d, d)) * d ** -0.5).astype(
        np.float32))
    args = [t.to(cuda_device) for t in (
        x, e, fc1, torch.zeros(d), fc2, torch.zeros(d))]
    before = pair_mlp.ROUTE_LAUNCHES["wgmma"]
    got = pair_mlp.pair_mlp_apply(*args, mode=mode, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert pair_mlp.ROUTE_LAUNCHES["wgmma"] == before + 1
    bf = torch.bfloat16
    xf = args[0].reshape(-1, d).to(bf)
    edge = mode == "edge"
    want = pair_mlp.fused_pair_mlp_plain(
        xf, xf if edge else None, args[1].reshape(-1, d).to(bf),
        args[2][:d].to(bf), args[2][d:2 * d].to(bf) if edge else None,
        args[2][2 * d if edge else d:].to(bf), args[3], args[4].to(bf),
        args[5], nodes=nodes).reshape(got.shape)
    assert float((got - want).abs().max()) <= PAIR_BF16_REL * float(
        want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["wgmma", "mma_sync"])
@pytest.mark.parametrize("b,n,d,de,h,dout,mode", [
    (8, 10, 512, 512, 512, 512, "edge"),     # N no power of two: gathered
    (8, 10, 512, 512, 512, 512, "msg"),
    (2, 6, 24, 8, 40, 8, "edge"),
    (16, 16, 512, 256, 512, 256, "edge"),    # a block is part of one graph
    (16, 8, 256, 256, 256, 256, "edge"),     # a block is two whole graphs
    (40, 2, 64, 32, 136, 72, "edge"),
    (130, 1, 64, 32, 136, 72, "edge"),
    (3, 128, 64, 32, 136, 72, "edge"),       # the widest boxed node count
    (1, 136, 64, 32, 136, 72, "edge"),       # past it: gathered
])
def test_pair_grid_node_counts_on_cuda(cuda_device, b, n, d, de, h, dout,
                                       mode, route):
    """The pair grid at node counts that take each way of filling the
    'wgmma' route's operand tiles (boxes of a zero-stride view of the node
    table for powers of two up to 128, the gather otherwise), held to the
    plain version like the 'mma_sync' route on the same inputs."""
    rng = np.random.default_rng(5)
    bf = torch.bfloat16
    k_in = (2 * d if mode == "edge" else d) + de
    x = torch.from_numpy(rng.normal(size=(b * n, d)).astype(np.float32))
    e = torch.from_numpy(rng.normal(size=(b * n * n, de)).astype(np.float32))
    fc1 = torch.from_numpy((rng.normal(size=(k_in, h)) * k_in ** -0.5
                            ).astype(np.float32))
    fc2 = torch.from_numpy((rng.normal(size=(h, dout)) * h ** -0.5
                            ).astype(np.float32))
    x, e, fc1, fc2 = (t.to(cuda_device).to(bf) for t in (x, e, fc1, fc2))
    b1 = torch.from_numpy(rng.normal(size=h).astype(np.float32) * 0.1)
    b2 = torch.from_numpy(rng.normal(size=dout).astype(np.float32) * 0.1)
    edge = mode == "edge"
    args = [x, x if edge else None, e, fc1[:d],
            fc1[d:2 * d] if edge else None, fc1[2 * d if edge else d:],
            b1.to(cuda_device), fc2, b2.to(cuda_device)]
    got = pair_mlp.fused_pair_mlp(*args, nodes=n, route=route)
    want = pair_mlp.fused_pair_mlp_plain(*args, nodes=n)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= PAIR_BF16_REL * float(
        want.abs().max())


@pytest.mark.gpu
def test_ragged_widths_take_mma_sync_and_refuse_wgmma_on_cuda(cuda_device):
    args = _bf16_ops(cuda_device, 72, 20, 12, 36, 10)
    before = dict(pair_mlp.ROUTE_LAUNCHES)
    got = pair_mlp.fused_pair_mlp(*args)
    want = pair_mlp.fused_pair_mlp_plain(*args)
    torch.cuda.synchronize()
    assert pair_mlp.ROUTE_LAUNCHES["mma_sync"] == before["mma_sync"] + 1
    assert pair_mlp.ROUTE_LAUNCHES["wgmma"] == before["wgmma"]
    assert float((got - want).abs().max()) <= PAIR_BF16_REL * float(
        want.abs().max())
    with pytest.raises(ValueError, match="does not take"):
        pair_mlp.fused_pair_mlp(*args, route="wgmma")


@pytest.mark.gpu
def test_unaligned_view_takes_mma_sync_on_cuda(cuda_device):
    """A contiguous view that starts 2 bytes into its storage is not
    16-byte aligned: no tensor map can describe it."""
    args = _bf16_ops(cuda_device, 128, 64, 64, 128, 128)
    w2 = torch.empty(128 * 128 + 1, dtype=torch.bfloat16,
                     device=cuda_device)[1:].view(128, 128)
    w2.copy_(args[7])
    args[7] = w2
    before = dict(pair_mlp.ROUTE_LAUNCHES)
    got = pair_mlp.fused_pair_mlp(*args)
    want = pair_mlp.fused_pair_mlp_plain(*args)
    torch.cuda.synchronize()
    assert pair_mlp.ROUTE_LAUNCHES["mma_sync"] == before["mma_sync"] + 1
    assert float((got - want).abs().max()) <= PAIR_BF16_REL * float(
        want.abs().max())
    with pytest.raises(ValueError, match="not 16-byte aligned"):
        pair_mlp.fused_pair_mlp(*args, route="wgmma")
