"""The attention core's CUDA kernel (relpose_gnn_tpu_torch/csrc/att_core.cu)
against its plain version on the card; every case skips where there is
none.  Nothing of JAX or of the JAX package is imported, so that the
card's machine (which has no flax) can collect this file:

    python -m pytest tests/test_torch_att_core_cuda.py -m gpu

Tolerance rtol = atol = 1e-5, as in tests/test_torch_att_core.py.
"""

import pytest
import torch

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
def test_kernel_forward_under_autograd_on_cuda(cuda_device):
    """Inputs that require grad: the forward launches the kernel (never
    the plain version) under `AttentionCoreFunction`, and its gradients
    equal autograd through the plain version (rtol = atol = 1e-5, the
    forward's tolerance)."""
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
