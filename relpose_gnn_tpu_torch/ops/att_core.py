"""Rank-1 bottleneck attention core: the CUDA kernel and its plain version.

    y[e, i] = sum_j softmax_j(phi[e, i] * theta[e, j]) * g[e, j]

Port of `relpose_gnn_tpu/ops/att_pallas.py` (`attention_core` and its
oracle `attention_core_xla`).  `AttentionBlock` (models/attention.py) runs
it on every GNN message.  The kernel is `csrc/att_core.cu`; its source
comment says what bounds it and how it is laid out.

`attention_core` decides by the tensors' device: CPU tensors take
`attention_core_plain`; CUDA tensors launch the kernel or raise.  When
grad is enabled and an input requires it, the call goes through
`AttentionCoreFunction`, the counterpart of the JAX custom VJP `_core`
(att_pallas.py:91-125): the forward is the same kernel (or, for CPU
tensors, the plain version), the backward `attention_core_backward` is an
eager mirror of `_core_bwd`, which is plain XLA in the JAX package too.
It materialises [E, C, C] in float32 (128 MiB per tensor at E = 512,
C = 256), as the JAX backward does.
"""

from __future__ import annotations

import ctypes

import torch

from relpose_gnn_tpu_torch.ops import _build

# Kernel launches so far in this process.  A run can zero it, drive the
# main path and read it to show that the path went through the kernel.
LAUNCHES = 0
# Floating-point operations of the attention core so far in this process:
# 3·E·C² a call, the TPU kernel's own cost estimate (att_pallas.py:84-87),
# counted where `attention_core` is called, so that the count is the same
# whichever implementation runs.  `benchmarks/_util.py::count_flops` adds
# it, since FlopCounterMode cannot see into the kernel.
FLOPS = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_C = 1024


def attention_core_plain(phi: torch.Tensor, theta: torch.Tensor,
                         g: torch.Tensor) -> torch.Tensor:
    """The PyTorch statement of `attention_core_xla`: materialises the
    [..., C, C] logits and computes in float32.  Returns float32."""
    phi, theta, g = (a.float() for a in (phi, theta, g))
    f = phi[..., :, None] * theta[..., None, :]
    w = torch.softmax(f, dim=-1)
    return torch.einsum("...ij,...j->...i", w, g)


def _lib() -> ctypes.CDLL:
    lib = _build.load("att_core")
    if lib.att_core_forward.argtypes is None:
        lib.att_core_forward.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.att_core_forward.restype = ctypes.c_int
        lib.att_core_error_string.argtypes = [ctypes.c_int]
        lib.att_core_error_string.restype = ctypes.c_char_p
    return lib


def _check_kernel_inputs(phi, theta, g, what: str = "attention_core") -> None:
    """Raise on what the row-per-block attention kernels cannot take
    (`what` names the caller in the message)."""
    for name, a in (("phi", phi), ("theta", theta), ("g", g)):
        if a.device.type != "cuda":
            raise ValueError(f"{what}: {name} is on {a.device}; "
                             "the kernel takes CUDA tensors")
        if a.device != phi.device:
            raise ValueError(f"{what}: inputs on different devices "
                             f"({phi.device} vs {a.device})")
        if a.dtype not in _DTYPE_CODE:
            raise TypeError(f"{what}: {name} has dtype {a.dtype}; "
                            "the kernel takes float32 or bfloat16")
        if a.dtype != phi.dtype:
            raise TypeError(f"{what}: inputs differ in dtype "
                            f"({phi.dtype} vs {a.dtype})")
        if a.dim() != 2 or a.shape != phi.shape:
            raise ValueError(f"{what}: {name} has shape "
                             f"{tuple(a.shape)}; want [E, C] like phi "
                             f"{tuple(phi.shape)}")
        if not a.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
    c = phi.shape[1]
    if not 1 <= c <= _MAX_C:
        raise ValueError(f"{what}: C={c} outside [1, {_MAX_C}]")


def attention_core_backward(phi: torch.Tensor, theta: torch.Tensor,
                            g: torch.Tensor, y: torch.Tensor,
                            ybar: torch.Tensor) -> tuple:
    """The VJP of the attention core, `_core_bwd`'s formulas in float32:
    with w = softmax_j(f), f_ij = phi_i * theta_j,
        gbar_j     = sum_i w_ij ybar_i
        fbar_ij    = ybar_i * w_ij * (g_j - y_i)
        phibar_i   = sum_j fbar_ij theta_j
        thetabar_j = sum_i fbar_ij phi_i
    `y` is the forward's output.  Returns (phibar, thetabar, gbar), each
    cast to its input's dtype."""
    p32, t32, g32 = (a.float() for a in (phi, theta, g))
    yb = ybar.float()
    w = torch.softmax(p32[..., :, None] * t32[..., None, :], dim=-1)
    gbar = torch.einsum("eij,ei->ej", w, yb)
    fbar = yb[..., :, None] * w * (g32[..., None, :] - y.float()[..., :, None])
    phibar = torch.einsum("eij,ej->ei", fbar, t32)
    thetabar = torch.einsum("eij,ei->ej", fbar, p32)
    return (phibar.to(phi.dtype), thetabar.to(theta.dtype), gbar.to(g.dtype))


class AttentionCoreFunction(torch.autograd.Function):
    """The attention core under autograd: `_forward` (the kernel on CUDA
    tensors, the plain version on CPU tensors) and the eager backward.
    Saves (phi, theta, g, y) as the JAX `_core_fwd` does."""

    @staticmethod
    def forward(ctx, phi, theta, g):
        y = _forward(phi, theta, g)
        ctx.save_for_backward(phi, theta, g, y)
        return y

    @staticmethod
    def backward(ctx, ybar):
        return attention_core_backward(*ctx.saved_tensors, ybar)


def attention_core(phi: torch.Tensor, theta: torch.Tensor,
                   g: torch.Tensor) -> torch.Tensor:
    """phi, theta, g: [E, C] -> float32 [E, C].

    CPU tensors: `attention_core_plain`.  CUDA tensors (float32 or
    bfloat16, contiguous, 1 <= C <= 1024): the kernel, launched on the
    current stream; anything it cannot take raises.  Differentiable:
    with grad enabled and an input that requires it, through
    `AttentionCoreFunction` (same forward, eager backward).  Adds the
    call's 3·E·C² to `FLOPS`."""
    global FLOPS
    FLOPS += 3 * phi.numel() * phi.shape[-1]
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (phi, theta, g)):
        return AttentionCoreFunction.apply(phi, theta, g)
    return _forward(phi, theta, g)


def _forward(phi: torch.Tensor, theta: torch.Tensor,
             g: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
    if phi.device.type == "cpu":
        return attention_core_plain(phi, theta, g)
    _check_kernel_inputs(phi, theta, g)
    e, c = phi.shape
    y = torch.empty((e, c), dtype=torch.float32, device=phi.device)
    if e == 0:
        return y
    lib = _lib()
    with _build.on_device(phi.device):
        stream = torch.cuda.current_stream(phi.device).cuda_stream
        err = lib.att_core_forward(phi.data_ptr(), theta.data_ptr(),
                                   g.data_ptr(), y.data_ptr(), e, c,
                                   _DTYPE_CODE[phi.dtype], stream)
    if err != 0:
        msg = lib.att_core_error_string(err).decode()
        raise RuntimeError(f"att_core launch failed: {msg} (error {err})")
    LAUNCHES += 1
    return y
