"""The restructured attention-core forms (relpose_gnn_tpu_torch/ops/
att_variants.py) against the Pallas bodies they replace, run in interpret
mode, and against the port's own core, and the bench entry points on the
CPU.  The CUDA kernels' cases on the card, and the routes of the wrapper,
are in tests/test_torch_att_variants_cuda.py, which imports nothing of JAX
so that the card's machine can collect it.

Tolerance 1e-5 relative to max |y|, the bar the JAX benches set.  Measured
on the CPU: every plain form is within 1.1e-6 of `attention_core_plain`
and within 1e-6 of its Pallas body at C = 256.
"""

import functools
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from benchmarks import bench_att_exp2 as jax_exp2
from benchmarks import bench_att_variants as jax_variants
from benchmarks import bench_att_variants2 as jax_variants2
from relpose_gnn_tpu.ops.att_pallas import _kernel as jax_base_kernel
from relpose_gnn_tpu_torch.benchmarks import (bench_att_core, bench_att_exp2,
                                              bench_att_variants,
                                              bench_att_variants2)
from relpose_gnn_tpu_torch.ops import att_core, att_variants

REL_TOL = 1e-5
SHAPES = [(32, 256), (20, 256), (32, 130), (20, 40)]
VARIANTS = tuple(att_variants.VARIANT_FORMS)
RESTRUCTURED = tuple(att_variants.RESTRUCTURED_FORMS)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads while this module runs: the suite runs several
    test processes on one host, and torch's default of one thread a core
    in each of them oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(e, c, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(e, c)) * scale).astype(np.float32)
            for _ in range(3)]


def _torch(args, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in args]


def _rel(got, want):
    """max |got - want| over max |want|; arrays, or tensors on any device."""
    got, want = (np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
                 for a in (got, want))
    return float(np.abs(got - want).max() / np.abs(want).max())


def _pallas(body, phi, theta, g):
    """One Pallas kernel body over the whole [E, C] block, interpreted."""
    e, c = phi.shape
    return pl.pallas_call(
        body, out_shape=jax.ShapeDtypeStruct((e, c), jnp.float32),
        interpret=True)(*map(jnp.asarray, (phi, theta, g)))


JAX_BODIES = {"base": jax_base_kernel, "v1": jax_variants2._kernel_v1,
              "v2": jax_variants2._kernel_v2}


@pytest.mark.parametrize("e,c", SHAPES)
@pytest.mark.parametrize("name", VARIANTS)
def test_variant_core_matches_pallas_body(name, e, c):
    args = _inputs(e, c)
    want = jax_variants.variant_core(name, *map(jnp.asarray, args),
                                     interpret=True)
    got = att_variants.variant_core(name, *_torch(args))
    assert got.dtype == torch.float32 and got.shape == (e, c)
    assert _rel(got.numpy(), want) < REL_TOL


# the Pallas v2 body sweeps whole chunks of 128 only; at a ragged C the
# port's v2 is held against the port's core below
@pytest.mark.parametrize("name,e,c", [
    (n, e, c) for n in RESTRUCTURED for e, c in SHAPES
    if n != "v2" or c % 128 == 0])
def test_restructured_core_matches_pallas_body(name, e, c):
    args = _inputs(e, c, seed=1)
    want = _pallas(JAX_BODIES[name], *args)
    got = att_variants.restructured_core(name, *_torch(args))
    assert _rel(got.numpy(), want) < REL_TOL


@pytest.mark.parametrize("e,c", SHAPES)
def test_exp2_core_matches_pallas_body(e, c):
    args = _inputs(e, c, seed=2)
    want = _pallas(jax_exp2._kernel_exp2, *args)
    got = att_variants.exp2_core(*_torch(args))
    assert _rel(got.numpy(), want) < REL_TOL


def _all_forms():
    forms = {f"variant_core/{n}": functools.partial(
        att_variants.variant_core, n) for n in VARIANTS}
    forms.update({f"restructured_core/{n}": functools.partial(
        att_variants.restructured_core, n) for n in RESTRUCTURED})
    forms["exp2_core"] = att_variants.exp2_core
    return forms


FORM_KEYS = tuple(_all_forms())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("key", FORM_KEYS)
def test_plain_form_matches_port_core(key, dtype):
    """Every plain form within 1e-5 of `attention_core_plain`, float32
    and bfloat16 inputs (widened on entry), C = 256 and ragged C."""
    fn = _all_forms()[key]
    for e, c in SHAPES + [(3, 1000), (5, 1)]:
        args = _torch(_inputs(e, c, seed=3, scale=1.5), dtype)
        got = fn(*args)
        assert got.dtype == torch.float32
        assert _rel(got, att_core.attention_core_plain(*args)) < REL_TOL


@pytest.mark.parametrize("e,c", SHAPES + [(64, 256)])
def test_plain_v1_equals_plain_base_bitwise(e, c):
    args = _torch(_inputs(e, c, seed=4, scale=3.0))
    base = att_variants.restructured_core("base", *args)
    v1 = att_variants.restructured_core("v1", *args)
    assert torch.equal(v1, base)
    # v2 differs by summation order only
    v2 = att_variants.restructured_core("v2", *args)
    assert _rel(v2, base) < REL_TOL


def test_exp2_core_is_variant_v1_exp2():
    args = _torch(_inputs(20, 130, seed=5))
    assert torch.equal(att_variants.exp2_core(*args),
                       att_variants.variant_core("v1_exp2", *args))


def test_cpu_path_never_counts_a_launch():
    before = dict(att_variants.LAUNCHES)
    for fn in _all_forms().values():
        fn(*_torch(_inputs(5, 8)))
    assert att_variants.LAUNCHES == before
    assert sorted(before) == sorted(FORM_KEYS)
    att_variants.LAUNCHES["exp2_core"] += 3
    att_variants.reset_launches()
    assert set(att_variants.LAUNCHES.values()) == {0}


def test_unknown_form_raises():
    a = torch.zeros(2, 4)
    with pytest.raises(ValueError, match="unknown form 'v9'"):
        att_variants.variant_core("v9", a, a, a)
    with pytest.raises(ValueError, match="unknown form 'v1_exp2'"):
        att_variants.restructured_core("v1_exp2", a, a, a)


@pytest.mark.parametrize("key", FORM_KEYS)
def test_non_cpu_non_cuda_tensors_raise(key):
    """The wrappers compute the plain version only for CPU tensors; any
    other device goes to the kernel's checks, which refuse it."""
    a = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        _all_forms()[key](a, a, a)


def test_core_work_counts():
    w = att_variants.core_work(16384, 256, 4, None)
    assert w["bytes"] == 4 * 16384 * 256 * 4
    assert w["exponentials"] == 16384 * 256 * 256
    assert w["fp32_ops"] == 5 * w["exponentials"] and w["tf32_ops"] == 0
    assert att_variants.core_work(8, 16, 2, 0)["fp32_ops"] == 7 * 8 * 256
    mma = att_variants.core_work(8, 16, 2, 4)
    assert mma["fp32_ops"] == 2 * 8 * 256 and mma["tf32_ops"] == 12 * 8 * 256
    assert mma["bytes"] == 3 * 8 * 16 * 2 + 4 * 8 * 16


# ---------------------------------------------------------------------------
# the bench entry points, on the CPU at a tiny size
# ---------------------------------------------------------------------------


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("c", [128, 40])
def test_bench_att_variants_on_cpu(capsys, c):
    out = bench_att_variants.main(["--device", "cpu", "--e", "24", "--c",
                                   str(c), "--iters", "1"])
    rec = _last_json(capsys)
    assert rec == json.loads(json.dumps(out))
    assert rec["platform"] == "cpu" and rec["card"] is None
    assert set(rec["ms"]) == {"v0", *VARIANTS}
    assert all(v < REL_TOL for v in rec["rel_max_diff"].values())
    assert set(rec["launches"].values()) == {0}     # no kernel on the CPU
    out = bench_att_variants.main(["--device", "cpu", "--e", "8", "--c", "16",
                                   "--check-only"])
    assert "ms" not in out and "correctness OK" in capsys.readouterr().out


@pytest.mark.parametrize("argv,timed", [
    ([], {"v0", *RESTRUCTURED}), (["--kernel", "v2"], {"v0", "v2"}),
    (["--exact"], None)])
def test_bench_att_variants2_on_cpu(capsys, argv, timed):
    out = bench_att_variants2.main(["--device", "cpu", "--e", "24", "--c",
                                    "130", "--iters", "1", *argv])
    text = capsys.readouterr().out
    assert "v1: mismatched bit-patterns 0/" in text
    assert out["exact"]["v1"]["mismatched"] == 0
    assert out["exact"]["v2"]["rel_max_diff"] < REL_TOL
    assert (set(out["ms"]) == timed) if timed else ("ms" not in out)
    assert json.loads(text.strip().splitlines()[-1])["bench"] \
        == "att_variants2"


def test_bench_att_exp2_and_core_on_cpu(capsys):
    out = bench_att_exp2.main(["--device", "cpu", "--e", "24", "--c", "40",
                               "--iters", "1"])
    rec = _last_json(capsys)
    assert set(rec["ms"]) == {"v0", "exp2"} and out["rel_err"]["exp2"] < 1e-5
    assert rec["launches"] == {"exp2_core": 0}
    out = bench_att_core.main(["--device", "cpu", "--e", "16", "--c", "24",
                               "--iters", "1"])
    rec = _last_json(capsys)
    assert set(rec["ms"]) == {"float32", "bfloat16"}
    assert set(rec["ms"]["float32"]) == {"kernel", "plain"}
    assert rec["launches"] == 0


def test_benches_refuse_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    for bench in (bench_att_core, bench_att_variants, bench_att_variants2,
                  bench_att_exp2):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bench.main(["--e", "8", "--c", "16"])
