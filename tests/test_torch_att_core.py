"""Attention core (relpose_gnn_tpu_torch/ops/att_core.py) and AttentionBlock
against the JAX package.  The CUDA kernel's cases are in
tests/test_torch_att_core_cuda.py, which imports nothing of JAX, so that
the card's machine can collect it.

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
