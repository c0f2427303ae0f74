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
from relpose_gnn_tpu_torch.benchmarks import bench_pair_mlp
from relpose_gnn_tpu_torch.models.gnn import MLP2
from relpose_gnn_tpu_torch.ops import pair_mlp

F32_TOL = dict(rtol=1e-4, atol=1e-3)
BF16_TOL = dict(rtol=1e-2, atol=2e-2)
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# (E, D, De, H, Dout, block_e, block_h): the two direct-kernel cases
FUSED_SHAPES = [(256, 32, 16, 512, 64, 128, 256),
                (128, 16, 16, 1024, 32, 128, 256)]
# (B, N, D, De, H, Dout, mode): the two pair_mlp_apply cases; E = 72 and
# H = 40 are ragged against every tile on purpose
APPLY_SHAPES = [(2, 6, 24, 8, 40, 8, "edge"), (1, 4, 16, 16, 32, 16, "msg")]


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
