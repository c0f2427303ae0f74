"""Rank-1 bottleneck attention core: the CUDA kernel and its plain version.

    y[e, i] = sum_j softmax_j(phi[e, i] * theta[e, j]) * g[e, j]

Port of `relpose_gnn_tpu/ops/att_pallas.py` (`attention_core` and its
oracle `attention_core_xla`).  `AttentionBlock` (models/attention.py) runs
it on every GNN message.  The kernel is `csrc/att_core.cu`; its source
comment says what bounds it and how it is laid out.

`attention_core` decides by the tensors' device: CPU tensors take
`attention_core_plain`; CUDA tensors launch the kernel or raise.  The
kernel is forward-only: the backward (an eager mirror of the JAX
`_core_bwd`) arrives with the training slice.
"""

from __future__ import annotations

import ctypes

import torch

from relpose_gnn_tpu_torch.ops import _build

# Kernel launches so far in this process.  A run can zero it, drive the
# main path and read it to show that the path went through the kernel.
LAUNCHES = 0

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


def _check_kernel_inputs(phi, theta, g) -> None:
    for name, a in (("phi", phi), ("theta", theta), ("g", g)):
        if a.device.type != "cuda":
            raise ValueError(f"attention_core: {name} is on {a.device}; "
                             "the kernel takes CUDA tensors")
        if a.device != phi.device:
            raise ValueError("attention_core: inputs on different devices "
                             f"({phi.device} vs {a.device})")
        if a.dtype not in _DTYPE_CODE:
            raise TypeError(f"attention_core: {name} has dtype {a.dtype}; "
                            "the kernel takes float32 or bfloat16")
        if a.dtype != phi.dtype:
            raise TypeError("attention_core: inputs differ in dtype "
                            f"({phi.dtype} vs {a.dtype})")
        if a.dim() != 2 or a.shape != phi.shape:
            raise ValueError(f"attention_core: {name} has shape "
                             f"{tuple(a.shape)}; want [E, C] like phi "
                             f"{tuple(phi.shape)}")
        if not a.is_contiguous():
            raise ValueError(f"attention_core: {name} is not contiguous")
    c = phi.shape[1]
    if not 1 <= c <= _MAX_C:
        raise ValueError(f"attention_core: C={c} outside [1, {_MAX_C}]")
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (phi, theta, g)):
        raise RuntimeError(
            "attention_core: the CUDA kernel is inference-only (no "
            "backward yet); call it under torch.inference_mode() or "
            "torch.no_grad()")


def attention_core(phi: torch.Tensor, theta: torch.Tensor,
                   g: torch.Tensor) -> torch.Tensor:
    """phi, theta, g: [E, C] -> float32 [E, C].

    CPU tensors: `attention_core_plain`.  CUDA tensors (float32 or
    bfloat16, contiguous, 1 <= C <= 1024): the kernel, launched on the
    current stream; anything it cannot take raises."""
    global LAUNCHES
    if phi.device.type == "cpu":
        return attention_core_plain(phi, theta, g)
    _check_kernel_inputs(phi, theta, g)
    e, c = phi.shape
    y = torch.empty((e, c), dtype=torch.float32, device=phi.device)
    if e == 0:
        return y
    lib = _lib()
    with torch.cuda.device(phi.device):
        stream = torch.cuda.current_stream(phi.device).cuda_stream
        err = lib.att_core_forward(phi.data_ptr(), theta.data_ptr(),
                                   g.data_ptr(), y.data_ptr(), e, c,
                                   _DTYPE_CODE[phi.dtype], stream)
    if err != 0:
        msg = lib.att_core_error_string(err).decode()
        raise RuntimeError(f"att_core launch failed: {msg} (error {err})")
    LAUNCHES += 1
    return y
