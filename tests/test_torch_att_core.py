"""Attention core (relpose_gnn_tpu_torch/ops/att_core.py) and AttentionBlock
against the JAX package, plus the CUDA kernel against its plain version
where a card is present.

Tolerance rtol = atol = 1e-5, as in tests/test_att_pallas.py.  Measured
basis on CPU: the plain torch core differs from `attention_core_xla` by at
most ~5e-7 at (40, 256), the JAX interpret-mode kernel from XLA by ~4e-7.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from relpose_gnn_tpu.models.attention import AttentionBlock as JaxAttention
from relpose_gnn_tpu.ops.att_pallas import attention_core as jax_core
from relpose_gnn_tpu.ops.att_pallas import attention_core_xla
from relpose_gnn_tpu_torch.models.attention import AttentionBlock
from relpose_gnn_tpu_torch.ops import att_core

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads while this module runs: the suite runs several
    test processes on one host, and torch's default of one thread a core
    in each of them oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(e, c, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(e, c)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("e,c", [(32, 128), (40, 256), (7, 4)])
def test_cpu_core_matches_jax(e, c):
    """On CPU tensors the wrapper is the plain version; it matches the XLA
    oracle everywhere and the Pallas kernel (interpret mode) where the
    kernel's lane rule allows (C a multiple of 128)."""
    phi, theta, g = _inputs(e, c)
    got = att_core.attention_core(*map(torch.from_numpy, (phi, theta, g)))
    assert got.dtype == torch.float32 and got.shape == (e, c)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(attention_core_xla(phi, theta, g)), **TOL)
    if c % 128 == 0:
        want = jax_core(phi, theta, g, block_e=16, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _extreme_inputs(case, e, c):
    phi, theta, g = _inputs(e, c, seed=7)
    if case == "scale3":
        return [3 * a for a in (phi, theta, g)]
    if case == "scale8":
        return [8 * a for a in (phi, theta, g)]
    if case == "constant_theta":     # every logit of a row is the row max
        return [phi, np.full_like(theta, 0.75), g]
    if case == "one_hot_rows":       # a lone large theta takes all weight
        theta = theta.copy()
        theta[:, 0] = 40.0
        return [np.abs(phi) + 1.0, theta, g]
    raise ValueError(case)


@pytest.mark.parametrize("case", ["scale3", "scale8", "constant_theta",
                                  "one_hot_rows"])
@pytest.mark.parametrize("e,c", [(9, 256), (5, 130), (6, 1)])
def test_plain_core_matches_jax_at_extreme_inputs(case, e, c):
    """The plain version is what the CUDA kernel is held to on the card;
    here it is pinned to the JAX oracle where the logits are large (inputs
    scaled by 3 and 8: products to +-200 and beyond), where every weight
    of a row is equal, where one weight takes the whole row, and at C = 1.
    Both sides round the product phi * theta to float32 and subtract the
    row max, so they agree to the usual tolerance even there."""
    phi, theta, g = _extreme_inputs(case, e, c)
    got = att_core.attention_core_plain(
        *map(torch.from_numpy, (phi, theta, g)))
    want = np.asarray(attention_core_xla(phi, theta, g))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if case == "constant_theta":     # y is the plain mean of g
        np.testing.assert_allclose(got.numpy(),
                                   np.broadcast_to(g.mean(-1, keepdims=True),
                                                   g.shape), **TOL)
    if case == "one_hot_rows" and c > 1:
        np.testing.assert_allclose(got.numpy(),
                                   np.broadcast_to(g[:, :1], g.shape), **TOL)


@pytest.mark.parametrize("scale", [3.0, 8.0])
def test_plain_core_against_float64_at_scaled_inputs(scale):
    """How far the float32 plain version is from its own formula in
    float64 when the logits are large: its rounded product costs half an
    ulp of the logit (2^-24 |f|), which the softmax turns into a relative
    error of the weights.  The CUDA kernel keeps the product exact inside
    an FMA, so on the card it is held to the float64 evaluation there;
    this pins the size of the plain version's own term."""
    phi, theta, g = [scale * a for a in _inputs(64, 256, seed=8)]
    got = att_core.attention_core_plain(
        *map(torch.from_numpy, (phi, theta, g))).numpy()
    p64, t64, g64 = (a.astype(np.float64) for a in (phi, theta, g))
    f = p64[:, :, None] * t64[:, None, :]
    w = np.exp(f - f.max(-1, keepdims=True))
    want = (w * g64[:, None, :]).sum(-1) / w.sum(-1)
    err = np.abs(got - want).max()
    # half an ulp of the largest logit, times the largest |g| difference
    bound = 2.0 ** -24 * np.abs(f).max() * 2 * np.abs(g).max()
    assert err <= bound


def test_cpu_path_never_counts_a_launch():
    before = att_core.LAUNCHES
    att_core.attention_core(*map(torch.from_numpy, _inputs(5, 8)))
    assert att_core.LAUNCHES == before


def test_non_cpu_non_cuda_tensors_raise():
    """The wrapper computes the plain version only for CPU tensors; any
    other device goes to the kernel's checks, which refuse it."""
    a = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        att_core.attention_core(a, a, a)


def test_attention_block_matches_flax():
    c = 64
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, c)).astype(np.float32)
    jblk = JaxAttention(c)
    params = jblk.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = jblk.apply({"params": params}, jnp.asarray(x))

    blk = AttentionBlock(c)
    with torch.no_grad():
        for name in ("g", "theta", "phi", "W"):
            lin = getattr(blk, name)
            lin.weight.copy_(torch.from_numpy(
                np.asarray(params[name]["kernel"]).T.copy()))
            lin.bias.copy_(torch.from_numpy(np.array(params[name]["bias"])))
        got = blk(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c", [(32, 128), (40, 256), (7, 4), (4096, 256),
                                 (0, 256), (3, 1000)])
def test_kernel_matches_plain_on_cuda(cuda_device, dtype, e, c):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    args = [torch.randn(e, c, generator=gen, device=cuda_device).to(dtype)
            for _ in range(3)]
    before = att_core.LAUNCHES
    got = att_core.attention_core(*args)
    want = att_core.attention_core_plain(*args)
    torch.cuda.synchronize()
    assert att_core.LAUNCHES == before + (1 if e else 0)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.gpu
def test_kernel_refuses_grad(cuda_device):
    """Inputs that require grad no longer raise: the forward still
    launches the kernel (never the plain version), under
    `AttentionCoreFunction`, and its gradients equal autograd through the
    plain version (rtol = atol = 1e-5, the forward's tolerance)."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    args = [torch.randn(8, 16, device=cuda_device, generator=gen
                        ).requires_grad_() for _ in range(3)]
    ybar = torch.randn(8, 16, device=cuda_device, generator=gen)
    before = att_core.LAUNCHES
    got = torch.autograd.grad(att_core.attention_core(*args), args, ybar)
    assert att_core.LAUNCHES == before + 1
    want = torch.autograd.grad(att_core.attention_core_plain(*args), args,
                               ybar)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **TOL)


def _plain_f64(phi, theta, g):
    phi, theta, g = (a.double() for a in (phi, theta, g))
    w = torch.softmax(phi[:, :, None] * theta[:, None, :], dim=-1)
    return torch.einsum("eij,ej->ei", w, g)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale", [1.0, 3.0, 8.0])
@pytest.mark.parametrize("e,c", [(5, 1), (72, 130), (3, 1000), (2, 1024),
                                 (1, 256), (4097, 256), (4097, 130)])
def test_kernel_at_extreme_shapes_and_scales_on_cuda(cuda_device, dtype,
                                                     scale, e, c):
    """C = 1, 130, 1000, 1024 and E = 1, 4097, inputs scaled by 3 and 8.
    Unit scale and bfloat16 inputs (whose products are exact in float32)
    are held to the plain version; scaled float32 inputs to the plain
    version's formula in float64, since there the float32 plain version's
    rounded product is the larger error (see chip_smoke.py, KERNEL_TOL)."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    args = [(torch.randn(e, c, generator=gen, device=cuda_device)
             * scale).to(dtype) for _ in range(3)]
    got = att_core.attention_core(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    if scale == 1.0 or dtype == torch.bfloat16:
        torch.testing.assert_close(
            got, att_core.attention_core_plain(*args), **TOL)
    else:
        torch.testing.assert_close(got.double(), _plain_f64(*args), **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_rows_are_independent_on_cuda(cuda_device, dtype):
    """A row's result depends on nothing but that row: not on E, not on
    its place in the block or the grid."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    args = [(torch.randn(4097, 256, generator=gen, device=cuda_device)
             * 3).to(dtype) for _ in range(3)]
    big = att_core.attention_core(*args)
    for lo, hi in ((0, 1), (1, 2), (2047, 2048), (4096, 4097), (5, 77)):
        part = att_core.attention_core(
            *[a[lo:hi].contiguous() for a in args])
        assert torch.equal(part, big[lo:hi])
