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
    a = torch.randn(8, 16, device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="inference-only"):
        att_core.attention_core(a, a, a)
