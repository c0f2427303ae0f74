"""Node encoders found by name: the configurations' parameters, weights
and counts of work held to what they were before the encoders became
files of their own, and a new encoder taken with no edit of the
harness."""

from __future__ import annotations

import hashlib
import json
import math
import os
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import program, scenes, work
from portbench.reference import encoders, nets, params
from portbench.tests import conftest as C

FP32 = nets.Precision("float32")

# read on the CPU from the harness as it stood with the encoders inside
# nets.py and params.py: the number of `relpose_spec` entries, the SHA-256
# of the spec as canonical JSON ([[name, [shape], kind], ...], no spaces),
# the SHA-256 of the weights drawn from scenes.generator(seed, "weights",
# "cpu") at seeds 0 and 1 (each tensor's name, then its bytes, in spec
# order), and the work counts per query or graph
PINNED = {
    "r3": {
        "spec": (248, "ba09fc964d4b4c625a5c5e1f3e4a34d0"
                      "7148d1c2c37dca5ba7bfad41398afa08"),
        "weights": ("19d8c862ba81614675f81222af6349ef"
                    "c181c76c018b53ec918eaf21b63dabb4",
                    "fc3ab1c19d7ecc21badc50221ab04514"
                    "8b28bb4e408da541eb6d2cf2b5d7995e"),
        "flops": {"serve_trunk_b128": 18028019712.0,
                  "serve_netvlad_b128": 48550133760.0,
                  "train_b32": 321827373056.0},
    },
    "r3-vit": {
        "spec": (182, "d1e23409f34fd92895fd6d40d581ece6"
                      "a9145ef591045e8dc08b16dcb08cce42"),
        "weights": ("04fc09eb5b0fed3a613b0a0b7affd296"
                    "27903e76768c7550b50db343e30425ac",
                    "15cdaa588b92e3ba36bac2b2226e5a44"
                    "bb296fc62b0e63c6d8546012d67516e4"),
        "flops": {"serve_trunk_b128": 66840170496.0},
    },
}


def _load(*parts):
    with open(os.path.join(C.ROOT, "portbench", *parts)) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(PINNED))
def test_spec_is_pinned(name):
    spec = params.relpose_spec(_load("configs", name + ".json")["model"])
    canon = json.dumps([[n, list(s), k] for n, s, k in spec],
                       separators=(",", ":"))
    assert (len(spec), hashlib.sha256(canon.encode()).hexdigest()) == \
        PINNED[name]["spec"]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(PINNED))
def test_weights_are_pinned(name, seed):
    """At full size: the draw order and every kind's slice and scale."""
    m = _load("configs", name + ".json")["model"]
    w = params.relpose_weights(m, scenes.generator(seed, "weights", "cpu"))
    h = hashlib.sha256()
    for n, _, _ in params.relpose_spec(m):
        h.update(n.encode())
        h.update(w[n].contiguous().numpy().tobytes())
    assert h.hexdigest() == PINNED[name]["weights"][seed]


@pytest.mark.parametrize("name,traffic", [
    (n, t) for n in sorted(PINNED) for t in PINNED[n]["flops"]])
def test_work_counts_are_pinned(name, traffic):
    cfg = _load("configs", name + ".json")
    t = _load("traffic", traffic + ".json")
    count = (work.train_flops_per_graph if t["driver"] == "train_loop"
             else work.serve_flops_per_query)(cfg, t)
    assert count == PINNED[name]["flops"][traffic]


TOY = '''"""A toy encoder: mean pool over the pixels, then a linear and a gain
of a kind of its own."""
import torch
MODULE = "toy"
KINDS = {"toy_gain": lambda z, shape: 2.0 + z.abs()}
def spec(m):
    f = m["feat_dim"]
    return [("toy.fc.weight", (f, 3), "fan_in"), ("toy.fc.bias", (f,), "bias"),
            ("toy.gain", (f,), "toy_gain")]
def forward(sd, m, x, prec, train=False):
    y = prec.linear(x.mean(dim=(1, 2)), sd["toy.fc.weight"], sd["toy.fc.bias"])
    return y * sd["toy.gain"]
'''


@pytest.fixture
def toy():
    """`encoders/toy_pool.py`, written for the test and removed after."""
    name = "toy_pool"
    path = os.path.join(encoders.HERE, name + ".py")
    with open(path, "w") as f:
        f.write(TOY)
    try:
        yield dict(C.TINY_MODEL, backbone=name)
    finally:
        os.remove(path)
        sys.modules.pop(f"{encoders.__name__}.{name}", None)


def _encode_flops(m, rows):
    sd = params.meta_weights(params.relpose_spec(m))
    h, w = m["image_hw"]
    with FlopCounterMode(display=False) as c:
        nets.encode(sd, m, torch.empty((rows, h, w, 3), device="meta"), FP32)
    return c.get_total_flops()


def test_a_new_encoder_is_found_by_name(toy):
    """A new file under encoders/ reaches the spec, the weights (with its
    own kind), the reference's encode and both counts of work."""
    f = toy["feat_dim"]
    spec = params.relpose_spec(toy)
    assert spec[:3] == [("toy.fc.weight", (f, 3), "fan_in"),
                        ("toy.fc.bias", (f,), "bias"),
                        ("toy.gain", (f,), "toy_gain")]
    assert spec[3:] == params.relpose_spec(C.TINY_MODEL)[-len(spec) + 3:]
    w = params.relpose_weights(toy, scenes.generator(5, "weights", "cpu"))
    # every kind of this spec draws from the normal: z is the whole draw
    z = torch.randn(sum(math.prod(s) for _, s, _ in spec),
                    generator=scenes.generator(5, "weights", "cpu"))
    torch.testing.assert_close(w["toy.gain"], 2.0 + z[4 * f:5 * f].abs(),
                               rtol=0, atol=0)
    x = torch.rand(3, *toy["image_hw"], 3)
    want = (x.mean(dim=(1, 2)) @ w["toy.fc.weight"].T
            + w["toy.fc.bias"]) * w["toy.gain"]
    torch.testing.assert_close(nets.encode(w, toy, x, FP32), want)

    serve = dict(C.TINY_SERVE, retrieval="shared-trunk")
    r18 = {"model": C.TINY_MODEL}
    b = serve["batch"]
    # the same work but the encode: the toy's in place of ResNet18's
    assert work.serve_flops_per_query({"model": toy}, serve) == \
        pytest.approx(work.serve_flops_per_query(r18, serve)
                      - _encode_flops(C.TINY_MODEL, b) / b
                      + _encode_flops(toy, b) / b, rel=1e-12)
    assert _encode_flops(toy, b) == 2 * b * 3 * f
    train = work.train_flops_per_graph({"model": toy}, C.TINY_TRAIN)
    assert 0 < train < work.train_flops_per_graph(r18, C.TINY_TRAIN)


def test_an_unknown_backbone_names_the_file_it_looked_for():
    m = dict(C.TINY_MODEL, backbone="no_such_encoder")
    for call in (lambda: params.relpose_spec(m),
                 lambda: nets.encode({}, m, torch.zeros(1, 8, 8, 3), FP32)):
        with pytest.raises(LookupError, match=r"encoders/no_such_encoder\.py"):
            call()


def test_a_kind_may_not_take_a_harness_kind_s_name():
    spec = [("a", (2,), "bias")]
    with pytest.raises(ValueError, match="bias"):
        params.make_weights(spec, scenes.generator(1, "w", "cpu"),
                            {"bias": lambda z, shape: z})
    with pytest.raises(KeyError, match="no_kind"):
        params.make_weights([("a", (2,), "no_kind")],
                            scenes.generator(1, "w", "cpu"))


VIT = {"backbone": "vit", "preset": "R3-vit",
       "vit": {"patch": 16, "dim": 768, "depth": 12, "heads": 12,
               "mlp_ratio": 4}}


@pytest.mark.parametrize("extra,remat", [
    ({}, False), ({"program": {"remat": True}}, True), (VIT, False)])
def test_the_program_section_reaches_the_program(extra, remat):
    """The model section's `program` fields are passed to the program's
    config last; the encoder's `MODULE` names the program's module that
    holds it (the one the serve driver hooks for `encode_ms.serve`)."""
    m = {**C.TINY_MODEL, "preset": "R3", **extra}
    w = params.relpose_weights(m, scenes.generator(2, "weights", "cpu"))
    model = program.pose_model(m, w, "cpu")
    assert model.cfg.remat is remat
    prefix = encoders.find(m["backbone"]).MODULE + "."
    enc = getattr(model, prefix[:-1])
    assert set(enc.state_dict()) == {n[len(prefix):] for n in w
                                     if n.startswith(prefix)}
