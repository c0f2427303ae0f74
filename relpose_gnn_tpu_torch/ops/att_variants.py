"""Restructured forms of the attention core: CUDA kernels and plain versions.

Every function here computes what `ops/att_core.py::attention_core` does,

    y[e, i] = sum_j softmax_j(phi[e, i] * theta[e, j]) * g[e, j]

by another route.  They are the port of the three probe kernels of the JAX
package's benches, one entry function per TPU kernel:

  `variant_core(name, phi, theta, g)`   benchmarks/bench_att_variants.py
      `v1_exp2`      phi scaled by log2(e) once, `exp2` per logit
      `v2_mxu`       the two sums over j as one product `w @ [g | 1]`
      `v3_exp2_mxu`  both
  `restructured_core(name, ...)`        benchmarks/bench_att_variants2.py
      `base`         row max scanned over j (the production TPU body)
      `v1`           row max analytic, from max/min theta: equals `base`
                     bit for bit
      `v2`           analytic max, j swept in chunks of 128 with partial
                     (z, y) per chunk, added in chunk order
  `exp2_core(...)`                      benchmarks/bench_att_exp2.py
      the body of `v1_exp2` (one kernel instantiation serves both)

The kernels are in `csrc/att_variants.cu`; its comment says how each form
is laid out on Hopper.  The TPU's `block_e` tiling and its padding of E are
not carried over.  Every entry function takes `route`: None, the default
route (the scalar forms and the tensor-core forms redesigned around what
the production kernel's redesign taught: several chains a thread, packed
broadcast loads, one FMA per logit and a raw `ex2.approx`; two `mma.sync`
a tile where the first kernels spent three), or "simple", the first
kernels of these forms, kept unchanged as the yardstick each redesigned
form is timed against.  `v1_exp2` and `exp2_core` run their first kernel
on both routes.  `v1` equals `base` bit for bit on each route.  The
port's benches (`benchmarks/bench_att_variants.py`,
`bench_att_variants2.py`, `bench_att_exp2.py`) time the default route in
turns with the production kernel, which agrees with every form here to
1e-5 of max |y|, not bit for bit (its logit is one FMA in the exp2
domain).

Each entry function decides by the tensors' device: CPU tensors take the
form's plain version (`PLAIN[form]`, written with the body's own
arithmetic) whatever the route; CUDA tensors launch the route's kernel or
raise.  `LAUNCHES` counts kernel launches per entry and form, whatever the
route; `ROUTE_LAUNCHES` counts them per route.
"""

from __future__ import annotations

import ctypes

import torch

from relpose_gnn_tpu_torch.ops import _build
from relpose_gnn_tpu_torch.ops.att_core import (_DTYPE_CODE,
                                                _check_kernel_inputs)

LOG2E = 1.4426950408889634
CHUNK = 128

# name of each form of each entry -> the kernel's form code (the `Form`
# enum of csrc/att_variants.cu)
VARIANT_FORMS = {"v1_exp2": 3, "v2_mxu": 4, "v3_exp2_mxu": 5}
RESTRUCTURED_FORMS = {"base": 0, "v1": 1, "v2": 2}
EXP2_FORM = 3

# route name -> the kernel's route code; None asks for the default route
ROUTES = {None: 0, "simple": 1}

# the form codes whose default route is a redesigned kernel; the exp2 form
# runs its first kernel on both routes.  Their default route keeps the
# exact product phi * theta inside an FMA, where the plain versions and
# route "simple" round it to float32.
REDESIGNED_FORMS = frozenset({0, 1, 2, 4, 5})

# route -> form code -> the __global__ kernel of csrc/att_variants.cu that
# runs it (a profiler's span of a launch carries that name)
KERNEL_NAMES = {
    None: {0: "variant_chains_kernel", 1: "variant_chains_kernel",
           2: "variant_chains_kernel", 3: "att_variant_kernel",
           4: "variant_tc_kernel", 5: "variant_tc_kernel"},
    "simple": {0: "att_variant_kernel", 1: "att_variant_kernel",
               2: "att_variant_kernel", 3: "att_variant_kernel",
               4: "att_variant_mma_kernel", 5: "att_variant_mma_kernel"},
}

# Kernel launches so far in this process, by "<entry>/<form>" (and plain
# "exp2_core") whatever the route, and by route ("default" for None).  A
# run can zero them (`reset_launches`), drive a path and read them to show
# that the path went through the kernels.
LAUNCHES: dict[str, int] = {
    **{f"variant_core/{n}": 0 for n in VARIANT_FORMS},
    **{f"restructured_core/{n}": 0 for n in RESTRUCTURED_FORMS},
    "exp2_core": 0,
}
ROUTE_LAUNCHES: dict[str, int] = {"default": 0, "simple": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, ROUTE_LAUNCHES):
        for key in counts:
            counts[key] = 0


# ---------------------------------------------------------------------------
# plain versions, one per kernel body
# ---------------------------------------------------------------------------


def _f32(phi, theta, g):
    return tuple(a.float() for a in (phi, theta, g))


def _analytic_max(phi: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """[E, C] row max of phi_i * theta_j over j, from max/min theta."""
    tmax = theta.max(dim=-1, keepdim=True).values
    tmin = theta.min(dim=-1, keepdim=True).values
    return torch.maximum(phi * tmax, phi * tmin)


def _sums(w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return torch.sum(w * g[:, None, :], dim=-1) / torch.sum(w, dim=-1)


def scanned_plain(phi, theta, g) -> torch.Tensor:
    """`base`: materialised logits, row max scanned over j."""
    phi, theta, g = _f32(phi, theta, g)
    f = phi[:, :, None] * theta[:, None, :]
    m = f.max(dim=-1, keepdim=True).values
    return _sums(torch.exp(f - m), g)


def analytic_plain(phi, theta, g) -> torch.Tensor:
    """`v1`: the row max is max(phi * max theta, phi * min theta), one of
    the row's own rounded products, so the result equals `scanned_plain`
    bit for bit."""
    phi, theta, g = _f32(phi, theta, g)
    m = _analytic_max(phi, theta)
    f = phi[:, :, None] * theta[:, None, :]
    return _sums(torch.exp(f - m[:, :, None]), g)


def chunked_plain(phi, theta, g) -> torch.Tensor:
    """`v2`: analytic max, then j in chunks of 128 with running (z, y);
    the chunks' partial sums are added in chunk order."""
    phi, theta, g = _f32(phi, theta, g)
    m = _analytic_max(phi, theta)
    z = torch.zeros_like(phi)
    y = torch.zeros_like(phi)
    for j in range(0, phi.shape[1], CHUNK):
        th, gg = theta[:, j:j + CHUNK], g[:, j:j + CHUNK]
        w = torch.exp(phi[:, :, None] * th[:, None, :] - m[:, :, None])
        z = z + torch.sum(w, dim=-1)
        y = y + torch.sum(w * gg[:, None, :], dim=-1)
    return y / z


def exp2_plain(phi, theta, g) -> torch.Tensor:
    """`v1_exp2` and `exp2_core`: phi scaled by log2(e) once per row, the
    row max of the scaled logits, `exp2` per logit."""
    phi, theta, g = _f32(phi, theta, g)
    f = (phi * LOG2E)[:, :, None] * theta[:, None, :]
    m = f.max(dim=-1, keepdim=True).values
    return _sums(torch.exp2(f - m), g)


def _mxu_plain(phi, theta, g, use_exp2: bool) -> torch.Tensor:
    phi, theta, g = _f32(phi, theta, g)
    if use_exp2:
        phi = phi * LOG2E
    f = phi[:, :, None] * theta[:, None, :]
    m = f.max(dim=-1, keepdim=True).values
    w = (torch.exp2 if use_exp2 else torch.exp)(f - m)
    gz = torch.stack([g, torch.ones_like(g)], dim=-1)          # [E, C, 2]
    yz = torch.einsum("eij,ejk->eik", w, gz)                   # float32
    return yz[:, :, 0] / yz[:, :, 1]


def mxu_plain(phi, theta, g) -> torch.Tensor:
    """`v2_mxu`: z and y as one batched float32 product `w @ [g | 1]`."""
    return _mxu_plain(phi, theta, g, False)


def exp2_mxu_plain(phi, theta, g) -> torch.Tensor:
    """`v3_exp2_mxu`: the exp2 prescale and the product form together."""
    return _mxu_plain(phi, theta, g, True)


# kernel form code -> its plain version
PLAIN = {0: scanned_plain, 1: analytic_plain, 2: chunked_plain,
         3: exp2_plain, 4: mxu_plain, 5: exp2_mxu_plain}


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = _build.load("att_variants")
    if lib.att_variants_forward.argtypes is None:
        lib.att_variants_forward.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.att_variants_forward.restype = ctypes.c_int
        lib.att_variants_error_string.argtypes = [ctypes.c_int]
        lib.att_variants_error_string.restype = ctypes.c_char_p
    return lib


def _run(key: str, form: int, route: str | None, phi, theta,
         g) -> torch.Tensor:
    """CPU tensors: the form's plain version, whatever the route.  CUDA
    tensors: the route's kernel, launched on the current stream and
    counted under `key` and the route; anything it cannot take raises."""
    if route not in ROUTES:
        raise ValueError(f"{key}: unknown route {route!r}; expected None "
                         "(the default route) or 'simple'")
    if phi.device.type == "cpu":
        return PLAIN[form](phi, theta, g)
    _check_kernel_inputs(phi, theta, g, what=key)
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (phi, theta, g)):
        raise RuntimeError(
            f"{key}: the CUDA kernel is inference-only (no backward); "
            "call it under torch.inference_mode() or torch.no_grad()")
    e, c = phi.shape
    y = torch.empty((e, c), dtype=torch.float32, device=phi.device)
    if e == 0:
        return y
    lib = _lib()
    with torch.cuda.device(phi.device):
        stream = torch.cuda.current_stream(phi.device).cuda_stream
        err = lib.att_variants_forward(
            phi.data_ptr(), theta.data_ptr(), g.data_ptr(), y.data_ptr(), e,
            c, _DTYPE_CODE[phi.dtype], form, ROUTES[route], stream)
    if err != 0:
        msg = lib.att_variants_error_string(err).decode()
        raise RuntimeError(f"att_variants launch failed ({key}, route "
                           f"{route!r}): {msg} (error {err})")
    LAUNCHES[key] += 1
    ROUTE_LAUNCHES[route or "default"] += 1
    return y


def _form(forms: dict, name: str, entry: str) -> int:
    if name not in forms:
        raise ValueError(f"{entry}: unknown form {name!r}; expected one of "
                         f"{sorted(forms)}")
    return forms[name]


def variant_core(name: str, phi: torch.Tensor, theta: torch.Tensor,
                 g: torch.Tensor, route: str | None = None) -> torch.Tensor:
    """phi, theta, g: [E, C] -> float32 [E, C], by form `name`
    (`v1_exp2`, `v2_mxu`, `v3_exp2_mxu`) on `route` (None: the default
    route; "simple": the first kernels)."""
    form = _form(VARIANT_FORMS, name, "variant_core")
    return _run(f"variant_core/{name}", form, route, phi, theta, g)


def restructured_core(name: str, phi: torch.Tensor, theta: torch.Tensor,
                      g: torch.Tensor, route: str | None = None
                      ) -> torch.Tensor:
    """phi, theta, g: [E, C] -> float32 [E, C], by form `name` (`base`,
    `v1`, `v2`) on `route` (None: the default route; "simple": the first
    kernels).  `v1` equals `base` bit for bit, on the CPU and on the card,
    on each route.  `restructured_core("v1", ..., route="simple")` is the
    form the production kernel had before its redesign."""
    form = _form(RESTRUCTURED_FORMS, name, "restructured_core")
    return _run(f"restructured_core/{name}", form, route, phi, theta, g)


def exp2_core(phi: torch.Tensor, theta: torch.Tensor, g: torch.Tensor,
              route: str | None = None) -> torch.Tensor:
    """phi, theta, g: [E, C] -> float32 [E, C] with exp2 and the hoisted
    log2(e) scale; one kernel on both routes."""
    return _run("exp2_core", EXP2_FORM, route, phi, theta, g)


# ---------------------------------------------------------------------------
# the least time the card could take
# ---------------------------------------------------------------------------


def core_work(e: int, c: int, in_itemsize: int, form: int | None) -> dict:
    """Bytes moved and operations done by one call at [E, C], for the
    bound: three inputs read once, the float32 output written once;
    E * C^2 exponentials; and the float32 operations per logit beside the
    exponential.  `form` None is the production kernel.

    Per logit: the product, the subtraction of the max, the sum into z
    and the multiply-add into y count 5, as for the production kernel
    (which fuses the first two into one multiply-add).  A
    scanned max adds the product again and a compare (7).  An exponential
    counts as one special-function operation whether it is `exp` or
    `exp2`, so the exp2 forms have the production kernel's bound: what
    they save is inside `expf`, which the bound does not see.  The
    tensor-core forms move the 3 operations of the two sums onto the
    tensor cores: 12 TF32 operations per logit (the first kernel's 3
    products over 2 useful columns, the default route's 2 over 3; the
    padding columns are not counted).  The bound is the function's, the
    same on both routes."""
    logits = e * c * c
    mma = form in (4, 5)
    fp32 = 5 + (2 if form == 0 else 0) - (3 if mma else 0)
    return {"bytes": 3 * e * c * in_itemsize + 4 * e * c,
            "exponentials": logits, "fp32_ops": fp32 * logits,
            "tf32_ops": 12 * logits if mma else 0}
