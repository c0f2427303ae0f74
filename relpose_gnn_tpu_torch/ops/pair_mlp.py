"""Fused pair MLP: the CUDA kernel, its wrapper and its plain version.

    out = relu(xs @ w1a + xt @ w1b + e @ w1c + b1) @ w2 + b2

Port of `relpose_gnn_tpu/ops/gnn_pallas.py` (`fused_pair_mlp`,
`pair_mlp_apply`).  The kernels are in `csrc/pair_mlp.cu`, three routes:
'fma' (float32 operands, FMA loops), 'wgmma' (bfloat16 operands with
widths that are multiples of 8 and 16-byte aligned pointers:
warp-specialised wgmma, a TMA weight ring, partial sums joined by bulk
reduce-add) and 'mma_sync' (any other bfloat16 shape: mma.sync with
masked loads).  `kernel_route` picks one from dtype and shape; the source
note says what bounds them and who owns the accumulator.  As in the JAX
package, no model path calls it (the GNN uses the split-weight
`PairMLP2`); it is reached from `benchmarks/bench_pair_mlp.py`.

Operands (xs, xt, e) are cast to the weights' dtype, float32 or bfloat16;
both products accumulate in float32; the hidden activation is rounded to
the weights' dtype before the second product; biases and the result are
float32.  Weights are in the JAX orientation, `[in, out]`.

`fused_pair_mlp` decides by the tensors' device: CPU tensors take
`fused_pair_mlp_plain`; CUDA tensors launch the kernel of their route or
raise (`route=` asks for one by name; it is a choice, never a fallback:
nothing catches a route that fails to build or launch).  Forward
only.  What the TPU wrapper pads (E to `block_e`, H to `block_h`) the
kernel masks itself, so those parameters and `interpret` do not exist here.
"""

from __future__ import annotations

import ctypes

import torch

from relpose_gnn_tpu_torch.ops import _build

# Kernel launches so far in this process (see ops/att_core.py): all
# routes together, and each route's own.
LAUNCHES = 0
ROUTE_LAUNCHES = {"fma": 0, "mma_sync": 0, "wgmma": 0}

_ROUTE_CODE = {"fma": 0, "mma_sync": 1, "wgmma": 2}


def kernel_route(dtype: torch.dtype, d: int, de: int, h: int, dout: int,
                 aligned: bool = True, route: str | None = None) -> str:
    """Which kernel of `csrc/pair_mlp.cu` takes these operands: a choice
    by dtype and shape, never a fallback.

    float32 -> 'fma'.  bfloat16 -> 'wgmma' when every width is a multiple
    of 8 (16-byte row strides for the tensor maps) and every pointer is
    16-byte aligned (`aligned`), else 'mma_sync', which masks everything.
    `route` asks for one by name and raises if it does not fit."""
    if dtype == torch.float32:
        fits = ("fma",)
    elif dtype == torch.bfloat16:
        wide = aligned and not any(w % 8 for w in (d, de, h, dout))
        fits = ("wgmma", "mma_sync") if wide else ("mma_sync",)
    else:
        raise TypeError(f"fused_pair_mlp: weights have dtype {dtype}; "
                        "the kernel takes float32 or bfloat16")
    if route is None:
        return fits[0]
    if route not in _ROUTE_CODE:
        raise ValueError(f"fused_pair_mlp: route={route!r} (want one of "
                         f"{sorted(_ROUTE_CODE)})")
    if route not in fits:
        raise ValueError(
            f"fused_pair_mlp: route {route!r} does not take {dtype} "
            f"operands of widths D={d} De={de} H={h} Dout={dout}"
            f"{'' if aligned else ', not 16-byte aligned'} (it fits "
            f"{' or '.join(fits)})")
    return route


def _pair_rows(x: torch.Tensor, nodes: int, target: bool) -> torch.Tensor:
    """[B * N, D] node table -> the [B * N * N, D] rows the pair grid
    reads: the source node's (pair p reads row p // N) or the target
    node's (row (p // N^2) * N + p % N).  A broadcast view, reshaped."""
    d = x.shape[-1]
    xb = x.reshape(-1, nodes, d)
    grid = xb[:, None, :, :] if target else xb[:, :, None, :]
    return grid.expand(-1, nodes, nodes, d).reshape(-1, d)


def fused_pair_mlp_plain(xs, xt, e, w1a, w1b, w1c, b1, w2, b2,
                         nodes: int = 0) -> torch.Tensor:
    """The same function in plain PyTorch, with the kernel's casts: the
    operands rounded to the weights' dtype, float32 products and sums
    (products of bfloat16 values are exact in float32), the hidden
    activation rounded to the weights' dtype, float32 out."""
    dt = w1a.dtype
    if nodes:
        xt = None if xt is None else _pair_rows(xt, nodes, target=True)
        xs = _pair_rows(xs, nodes, target=False)
    h = xs.to(dt).float() @ w1a.float() + e.to(dt).float() @ w1c.float()
    if xt is not None:
        h = h + xt.to(dt).float() @ w1b.float()
    h = torch.relu(h + b1.float()).to(dt).float()
    return h @ w2.float() + b2.float()


def _lib(defines: tuple = ()) -> ctypes.CDLL:
    lib = _build.load("pair_mlp", defines)
    if lib.pair_mlp_forward.argtypes is None:
        lib.pair_mlp_forward.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_longlong] + [ctypes.c_int] * 6
            + [ctypes.c_void_p])
        lib.pair_mlp_forward.restype = ctypes.c_int
        lib.pair_mlp_error_string.argtypes = [ctypes.c_int]
        lib.pair_mlp_error_string.restype = ctypes.c_char_p
    return lib


def _check_kernel_inputs(xs, xt, e, w1a, w1b, w1c, b1, w2, b2,
                         nodes: int) -> None:
    named = [("xs", xs), ("e", e), ("w1a", w1a), ("w1c", w1c), ("b1", b1),
             ("w2", w2), ("b2", b2)]
    if (xt is None) != (w1b is None):
        raise ValueError("fused_pair_mlp: pass both xt and w1b, or neither")
    if xt is not None:
        named += [("xt", xt), ("w1b", w1b)]
    for name, a in named:
        if not a.is_contiguous():
            raise ValueError(f"fused_pair_mlp: {name} is not contiguous")
        want = torch.float32 if name in ("b1", "b2") else w1a.dtype
        if a.dtype != want:
            raise TypeError(
                f"fused_pair_mlp: {name} has dtype {a.dtype}, want {want} "
                "(operands and weights share one dtype, biases are "
                "float32)")
    if w1a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_pair_mlp: weights have dtype {w1a.dtype}; "
                        "the kernel takes float32 or bfloat16")
    d, h = w1a.shape if w1a.dim() == 2 else (-1, -1)
    de = e.shape[-1]
    dout = w2.shape[-1]
    rows = e.shape[0]
    if nodes < 0 or (nodes and rows % (nodes * nodes)):
        raise ValueError(f"fused_pair_mlp: {rows} rows are no whole "
                         f"number of {nodes} x {nodes} pair grids")
    x_rows = rows // nodes if nodes else rows
    shapes = [("xs", xs, (x_rows, d)), ("e", e, (rows, de)),
              ("w1a", w1a, (d, h)), ("w1c", w1c, (de, h)), ("b1", b1, (h,)),
              ("w2", w2, (h, dout)), ("b2", b2, (dout,))]
    if xt is not None:
        shapes += [("xt", xt, (x_rows, d)), ("w1b", w1b, (d, h))]
    for name, a, want in shapes:
        if tuple(a.shape) != want:
            raise ValueError(f"fused_pair_mlp: {name} has shape "
                             f"{tuple(a.shape)}, want {want}")
    if min(d, de, h, dout) < 1:
        raise ValueError("fused_pair_mlp: every width must be at least 1")
    if nodes and xt is not None and xt.data_ptr() != xs.data_ptr():
        raise ValueError("fused_pair_mlp: with nodes > 0, xs and xt are "
                         "the same node table")
    if torch.is_grad_enabled() and any(a.requires_grad for _, a in named):
        raise RuntimeError(
            "fused_pair_mlp: the CUDA kernel is inference-only (no "
            "backward); call it under torch.inference_mode() or "
            "torch.no_grad()")
    for name, a in named:
        if a.device.type != "cuda":
            raise ValueError(f"fused_pair_mlp: {name} is on {a.device}; "
                             "the kernel takes CUDA tensors")
        if a.device != xs.device:
            raise ValueError("fused_pair_mlp: inputs on different devices "
                             f"({xs.device} vs {a.device})")


def _run_kernel(lib: ctypes.CDLL, route: str | None, xs, xt, e, w1a, w1b,
                w1c, b1, w2, b2, nodes: int) -> torch.Tensor:
    """Launch the kernel of `route` (None: the one `kernel_route` picks)
    from the build `lib` on checked CUDA tensors and count the launch."""
    global LAUNCHES
    rows, de = e.shape
    d, h = w1a.shape
    dout = w2.shape[1]
    out = torch.empty((rows, dout), dtype=torch.float32, device=xs.device)
    tensors = [a for a in (xs, xt, e, w1a, w1b, w1c, b1, w2, b2, out)
               if a is not None]
    route = kernel_route(w1a.dtype, d, de, h, dout,
                         all(a.data_ptr() % 16 == 0 for a in tensors), route)
    if rows == 0:
        return out
    with _build.on_device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        err = lib.pair_mlp_forward(
            xs.data_ptr(), None if xt is None else xt.data_ptr(),
            e.data_ptr(), w1a.data_ptr(),
            None if w1b is None else w1b.data_ptr(), w1c.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            rows, d, de, h, dout, nodes, _ROUTE_CODE[route], stream)
    if err != 0:
        msg = lib.pair_mlp_error_string(err).decode()
        raise RuntimeError(f"pair_mlp launch on route {route!r} failed: "
                           f"{msg} (error {err})")
    LAUNCHES += 1
    ROUTE_LAUNCHES[route] += 1
    return out


def fused_pair_mlp(xs: torch.Tensor, xt: torch.Tensor | None,
                   e: torch.Tensor, w1a: torch.Tensor,
                   w1b: torch.Tensor | None, w1c: torch.Tensor,
                   b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                   nodes: int = 0, route: str | None = None) -> torch.Tensor:
    """relu(xs@w1a + xt@w1b + e@w1c + b1) @ w2 + b2 -> float32 [E, Dout].

    xs, xt: [E, D]; e: [E, De]; w1a, w1b: [D, H]; w1c: [De, H]; b1: [H];
    w2: [H, Dout]; b2: [Dout].  xt and w1b may both be None (no
    target-node operand, the 'msg' form).  With `nodes=N`, xs and xt are
    one [B * N, D] node table and row p of the pair grid reads its rows
    p // N and (p // N^2) * N + p % N, so the [E, D] broadcasts are never
    materialised.

    CPU tensors: `fused_pair_mlp_plain` (`route` is not looked at).  CUDA
    tensors (operands and weights all float32 or all bfloat16, biases
    float32, contiguous): the kernel `kernel_route` picks for them, or the
    one `route` names ('fma', 'mma_sync', 'wgmma'), launched on the
    current stream; anything it cannot take raises."""
    if xs.device.type == "cpu":
        return fused_pair_mlp_plain(xs, xt, e, w1a, w1b, w1c, b1, w2, b2,
                                    nodes)
    _check_kernel_inputs(xs, xt, e, w1a, w1b, w1c, b1, w2, b2, nodes)
    return _run_kernel(_lib(), route, xs, xt, e, w1a, w1b, w1c, b1, w2, b2,
                       nodes)


def pair_mlp_apply(x: torch.Tensor, e: torch.Tensor,
                   fc1_kernel: torch.Tensor, fc1_bias: torch.Tensor,
                   fc2_kernel: torch.Tensor, fc2_bias: torch.Tensor,
                   mode: str = "edge",
                   dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Dense-layer entry point: [B, N, D] nodes + [B, N, N, De] edges.

    mode='edge':  out[s,t] = MLP2([x_s, x_t, e_st])   (edge update)
    mode='msg':   out[s,t] = MLP2([x_s, e_st])        (message MLP)

    `fc1_kernel` is the concat-layout first layer, [2D + De, H] ('edge')
    or [D + De, H] ('msg'), sliced per operand; operands and weights are
    cast to `dtype`.  The node table is handed to the kernel as it is and
    indexed by pair there.  Returns float32 [B, N, N, Dout]."""
    b, n, d = x.shape
    de = e.shape[-1]
    if mode == "edge":
        w1a, w1b, w1c = (fc1_kernel[:d], fc1_kernel[d:2 * d],
                         fc1_kernel[2 * d:])
    elif mode == "msg":
        w1a, w1b, w1c = fc1_kernel[:d], None, fc1_kernel[d:]
    else:
        raise ValueError(f"mode={mode!r} (want 'edge' or 'msg')")
    xf = x.reshape(b * n, d).to(dtype).contiguous()
    out = fused_pair_mlp(
        xf, None if w1b is None else xf,
        e.reshape(b * n * n, de).to(dtype).contiguous(),
        w1a.to(dtype).contiguous(),
        None if w1b is None else w1b.to(dtype).contiguous(),
        w1c.to(dtype).contiguous(), fc1_bias.float().contiguous(),
        fc2_kernel.to(dtype).contiguous(), fc2_bias.float().contiguous(),
        nodes=n)
    return out.reshape(b, n, n, -1)
