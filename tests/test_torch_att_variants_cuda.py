"""The attention-variant kernels (relpose_gnn_tpu_torch/csrc/att_variants.cu)
on both routes: their wrapper's routes and counts on the CPU, and the
kernels against their plain versions on the card, where every such case
skips if there is none.  Nothing of JAX or of the JAX package is imported,
so that the card's machine (which has no flax) can collect this file:

    python -m pytest tests/test_torch_att_variants_cuda.py -m gpu

Tolerance 1e-5 relative to max |y|, the bar the JAX benches set, by the
rule `chip_smoke.py` holds too (see its VARIANT_REL_TOL).  On float32
inputs scaled by 3 and 8 the logits reach |f| ~ 200-1500, and the plain
versions' rounding of phi * theta (2^-24 |f|) alone moves them by up to
~1e-5 of max |y| off the function.  There a form that rounds the product
as they do (route "simple", and the exp2 form on both routes) is held to
its plain version; a form that keeps the exact product in an FMA, as the
production kernel does (the default route's redesigned forms), is held
to the function in float64 and to the production kernel.  Everywhere else
every form is held to its plain version and to the production kernel.
"""

import functools
import re

import pytest
import torch

from relpose_gnn_tpu_torch.ops import _build, att_core, att_variants

REL_TOL = 1e-5
ROUTES = (None, "simple")
SCALES = (1.5, 3.0, 8.0)
ENTRIES = {
    "variant_core": functools.partial(att_variants.variant_core, "v2_mxu"),
    "restructured_core": functools.partial(att_variants.restructured_core,
                                           "v1"),
    "exp2_core": att_variants.exp2_core,
}


def _all_forms():
    """key in LAUNCHES -> (wrapper, kernel form code)."""
    forms = {f"variant_core/{n}": (functools.partial(
        att_variants.variant_core, n), code)
        for n, code in att_variants.VARIANT_FORMS.items()}
    forms.update({f"restructured_core/{n}": (functools.partial(
        att_variants.restructured_core, n), code)
        for n, code in att_variants.RESTRUCTURED_FORMS.items()})
    forms["exp2_core"] = (att_variants.exp2_core, att_variants.EXP2_FORM)
    return forms


FORM_KEYS = tuple(_all_forms())


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads while this module runs: the suite runs several
    test processes on one host, and torch's default of one thread a core
    in each of them oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    """max |got - want| over max |want|, in float64."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


def _inputs(e, c, device, seed=0, scale=1.5, dtype=torch.float32):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [(torch.randn(e, c, generator=gen, device=device) * scale
             ).to(dtype) for _ in range(3)]


# ---------------------------------------------------------------------------
# the routes, on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_unknown_route_raises(entry):
    a = torch.zeros(2, 4)
    with pytest.raises(ValueError, match="unknown route 'fast'"):
        ENTRIES[entry](a, a, a, route="fast")
    with pytest.raises(ValueError, match="unknown route 'default'"):
        ENTRIES[entry](a, a, a, route="default")


# forms whose plain version sums through a batched GEMM (`_mxu_plain`):
# MKL's CPU GEMM does not promise the same bits from one call to the next
# (its kernel and blocking are chosen at run time), so two calls of such a
# plain version may differ in the last bit
GEMM_FORMS = {att_variants.VARIANT_FORMS["v2_mxu"],
              att_variants.VARIANT_FORMS["v3_exp2_mxu"]}


@pytest.mark.parametrize("route", ROUTES)
def test_cpu_tensors_take_plain_on_every_route(route, monkeypatch):
    """On the CPU every form on either route calls its plain version once,
    on the tensors it was given, and returns that call's result unchanged;
    a form whose plain version has no GEMM also equals a second call of
    it bit for bit.  No launch is counted in either count."""
    launches = dict(att_variants.LAUNCHES)
    by_route = dict(att_variants.ROUTE_LAUNCHES)
    args = _inputs(6, 20, "cpu", seed=1)
    plain = dict(att_variants.PLAIN)
    calls = []

    def spy(form):
        def call(*a):
            out = plain[form](*a)
            calls.append((form, a, out))
            return out
        return call

    for form in plain:
        monkeypatch.setitem(att_variants.PLAIN, form, spy(form))
    for fn, form in _all_forms().values():
        calls.clear()
        got = fn(*args, route=route)
        assert len(calls) == 1 and calls[0][0] == form
        assert all(a is b for a, b in zip(calls[0][1], args))
        assert got is calls[0][2]
        if form not in GEMM_FORMS:
            assert torch.equal(got, plain[form](*args))
    assert att_variants.LAUNCHES == launches
    assert att_variants.ROUTE_LAUNCHES == by_route


def test_route_launches_has_its_keys():
    assert set(att_variants.ROUTES) == {None, "simple"}
    assert sorted(att_variants.ROUTE_LAUNCHES) == ["default", "simple"]
    assert sorted(att_variants.LAUNCHES) == sorted(FORM_KEYS)
    att_variants.ROUTE_LAUNCHES["simple"] += 2
    att_variants.LAUNCHES["exp2_core"] += 1
    att_variants.reset_launches()
    assert set(att_variants.ROUTE_LAUNCHES.values()) == {0}
    assert set(att_variants.LAUNCHES.values()) == {0}


# form code -> float32 operations per logit beside the exponential, and
# TF32 operations per logit: what the bound counted before the routes
# existed, unchanged (the bound is the function's)
CORE_WORK = {None: (5, 0), 0: (7, 0), 1: (5, 0), 2: (5, 0), 3: (5, 0),
             4: (2, 12), 5: (2, 12)}


@pytest.mark.parametrize("form", list(CORE_WORK))
def test_core_work_is_the_functions(form):
    e, c = 32768, 256
    w = att_variants.core_work(e, c, 4, form)
    fp32, tf32 = CORE_WORK[form]
    assert w == {"bytes": 4 * 4 * e * c, "exponentials": e * c * c,
                 "fp32_ops": fp32 * e * c * c, "tf32_ops": tf32 * e * c * c}


def test_kernel_names_tell_the_routes_apart():
    """Profiler spans are matched by a kernel's name: `KERNEL_NAMES` names
    every __global__ kernel of the source, each route's kernels have their
    own names, and none is inside another."""
    source = (_build.CSRC_DIR / "att_variants.cu").read_text()
    names = re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+"
                       r"(\w+)\(", source)
    assert sorted(names) == sorted(
        {n for by_form in att_variants.KERNEL_NAMES.values()
         for n in by_form.values()})
    assert not any(a != b and a in b for a in names for b in names)
    assert set(att_variants.KERNEL_NAMES) == set(ROUTES)
    for by_form in att_variants.KERNEL_NAMES.values():
        assert sorted(by_form) == sorted(att_variants.PLAIN)


def test_redesigned_forms_are_those_the_routes_split():
    """A form is redesigned exactly where its default route runs another
    kernel than route "simple"; the exp2 form runs its first kernel on
    both."""
    names = att_variants.KERNEL_NAMES
    assert att_variants.REDESIGNED_FORMS == {
        form for form in att_variants.PLAIN
        if names[None][form] != names["simple"][form]}
    assert att_variants.EXP2_FORM not in att_variants.REDESIGNED_FORMS


# ---------------------------------------------------------------------------
# the kernels, on a card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _f64(phi, theta, g):
    """The function in float64 on the same inputs (widened exactly)."""
    phi, theta, g = (a.double() for a in (phi, theta, g))
    w = torch.softmax(phi[:, :, None] * theta[:, None, :], dim=-1)
    return torch.einsum("eij,ej->ei", w, g)


@pytest.mark.gpu
@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c", [(72, 40), (72, 130), (64, 256), (4096, 256),
                                 (0, 256), (3, 1000), (5, 1)])
@pytest.mark.parametrize("key", FORM_KEYS)
def test_kernel_matches_plain_on_cuda(cuda_device, key, dtype, e, c, route,
                                      scale):
    args = _inputs(e, c, cuda_device, scale=scale, dtype=dtype)
    fn, form = _all_forms()[key]
    before = att_variants.LAUNCHES[key]
    before_route = att_variants.ROUTE_LAUNCHES[route or "default"]
    got = fn(*args, route=route)
    torch.cuda.synchronize()
    assert att_variants.LAUNCHES[key] == before + (1 if e else 0)
    assert att_variants.ROUTE_LAUNCHES[route or "default"] == \
        before_route + (1 if e else 0)
    if not e:
        return
    assert bool(torch.isfinite(got).all())
    plain = att_variants.PLAIN[form](*args)
    exact_product = route is None and form in att_variants.REDESIGNED_FORMS
    if dtype == torch.float32 and scale > SCALES[0] and exact_product:
        assert _rel(got, _f64(*args)) < REL_TOL
    else:
        assert _rel(got, plain) < REL_TOL
    if dtype == torch.bfloat16 or scale == SCALES[0] or exact_product:
        assert _rel(got, att_core.attention_core(*args)) < REL_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("e,c", [(64, 256), (72, 130), (4096, 256)])
def test_kernel_v1_equals_base_bitwise_on_cuda(cuda_device, e, c, route,
                                               scale):
    args = _inputs(e, c, cuda_device, seed=1, scale=scale)
    base = att_variants.restructured_core("base", *args, route=route)
    assert torch.equal(
        att_variants.restructured_core("v1", *args, route=route), base)
    # v2 differs by the order of its sums only
    assert _rel(att_variants.restructured_core("v2", *args, route=route),
                base) < REL_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("route", ROUTES)
def test_kernels_refuse_grad(cuda_device, route):
    a = torch.randn(8, 16, device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="inference-only"):
        att_variants.exp2_core(a, a, a, route=route)
    with pytest.raises(RuntimeError, match="inference-only"):
        att_variants.variant_core("v2_mxu", a, a, a, route=route)
