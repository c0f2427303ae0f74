"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program.  Each case imports in a fresh
interpreter and reads `sys.modules` by whole top-level name (the port's
name begins with the JAX package's)."""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys

import pytest

from portbench.tests.conftest import ROOT

FORBIDDEN = ["jax", "jaxlib", "flax", "optax", "orbax", "relpose_gnn_tpu"]

_PROBE = """
import importlib, importlib.util, json, sys
for m in {modules!r}:
    importlib.import_module(m)
for path in {files!r}:
    spec = importlib.util.spec_from_file_location("reader", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps(sorted({{k.split(".")[0] for k in sys.modules}})))
"""


def _loaded(modules, files=()) -> set:
    code = _PROBE.format(modules=list(modules), files=list(files))
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def _harness_modules():
    mods = ["portbench", "portbench.run", "portbench.trace",
            "portbench.work", "portbench.scenes", "portbench.program",
            "portbench.check_serve", "portbench.check_train",
            "portbench.faults", "portbench.calibrate", "portbench.readers"]
    mods += ["portbench.drivers." + os.path.basename(p)[:-3] for p in
             glob.glob(os.path.join(ROOT, "portbench", "drivers", "*.py"))
             if not p.endswith("__init__.py")]
    return mods


def _reference_modules():
    """The reference's modules, its encoders among them."""
    mods = ["portbench.reference", "portbench.reference.encoders"]
    for pkg in ("reference", "reference/encoders"):
        mods += ["portbench." + pkg.replace("/", ".") + "."
                 + os.path.basename(p)[:-3] for p in
                 glob.glob(os.path.join(ROOT, "portbench", pkg, "*.py"))
                 if not p.endswith("__init__.py")]
    return mods


@pytest.mark.parametrize("what", ["harness", "program", "reference"])
def test_no_jax_is_loaded(what):
    """The harness with every driver and metric reader; the program's
    entries the drivers reach; the reference."""
    files = ()
    if what == "harness":
        mods = _harness_modules()
        files = glob.glob(os.path.join(ROOT, "portbench", "metrics", "*.py"))
    elif what == "program":
        mods = ["relpose_gnn_tpu_torch.evaluation.service",
                "relpose_gnn_tpu_torch.training.trainer",
                "relpose_gnn_tpu_torch.data.device_cache",
                "relpose_gnn_tpu_torch.models.posenet",
                "relpose_gnn_tpu_torch.models.netvlad"]
    else:
        mods = _reference_modules()
    loaded = _loaded(mods, files)
    assert not loaded & set(FORBIDDEN), sorted(loaded & set(FORBIDDEN))
    if what == "program":
        assert "relpose_gnn_tpu_torch" in loaded


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded(_reference_modules())
    assert "relpose_gnn_tpu_torch" not in loaded
    assert "portbench" in loaded


def test_harness_loads_the_program_only_when_it_runs():
    """Importing the harness (drivers, readers, work counts) loads no
    module of the program: the program is reached inside a run."""
    loaded = _loaded(_harness_modules(),
                     glob.glob(os.path.join(ROOT, "portbench", "metrics",
                                            "*.py")))
    assert "relpose_gnn_tpu_torch" not in loaded


def test_the_run_refuses_a_loaded_jax_module(monkeypatch):
    """The guard a run applies once its window has closed."""
    from portbench import run
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert "jaxlib" in run.forbidden_modules()
    monkeypatch.delitem(sys.modules, "jaxlib.xla_client")
    monkeypatch.setitem(sys.modules, "relpose_gnn_tpu_torch_x", object())
    assert "relpose_gnn_tpu" not in run.forbidden_modules()
