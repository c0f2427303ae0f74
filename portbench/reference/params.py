"""Parameter names, shapes and initial distributions of the configurations.

The names are the published state dicts' (torchvision ResNet and VGG16
indices, `netvlad_vgg16.tar`, timm's ViT, the reference PoseNetX_R2), so
one dict of weights serves both the program (`load_state_dict(strict=
True)`) and this reference.  `make_weights` draws a whole spec on one
device from one generator in a few large calls.

Kinds: `fan_in` (a normal scaled to variance 1 / fan-in: lecun's rule),
`bias` (normal, 0.02), `bn_weight` (1 + 0.1 normal), `bn_bias` and
`bn_mean` (0.1 normal), `bn_var` (uniform in [0.5, 1.5]), `ln_weight`
(1 + 0.05 normal), `embed` (normal, 0.02), `unit_rows` (rows of |normal|
scaled to unit length: NetVLAD's centroids, like the features it pools),
`assign` (the centroids times `NETVLAD_ALPHA`, NetVLAD's own
initialisation of its assignment), `count` (int64 zeros, BatchNorm's
`num_batches_tracked`).  An encoder may add kinds of its own
(`encoders/__init__.py`).
"""

from __future__ import annotations

import math

import torch

from portbench.reference import encoders

VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512)
# NetVLAD's assignment sharpness at initialisation (Arandjelovic et al.:
# alpha large, so that each feature is assigned mostly to one centroid)
NETVLAD_ALPHA = 30.0


def add_bn(spec: list, name: str, c: int) -> None:
    """A BatchNorm's five entries, in torch's order."""
    spec += [(f"{name}.weight", (c,), "bn_weight"),
             (f"{name}.bias", (c,), "bn_bias"),
             (f"{name}.running_mean", (c,), "bn_mean"),
             (f"{name}.running_var", (c,), "bn_var"),
             (f"{name}.num_batches_tracked", (), "count")]


def add_linear(spec: list, name: str, out: int, inp: int) -> None:
    """A linear layer's weight [out, inp] and bias."""
    spec += [(f"{name}.weight", (out, inp), "fan_in"),
             (f"{name}.bias", (out,), "bias")]


def relpose_spec(m: dict) -> list:
    """The pose model: the node encoder of `m["backbone"]`, `proj_edge`,
    one weight-tied GNN layer `gnn1` (edge MLP, message MLP, attention
    block, update MLP), the absolute and relative heads."""
    f, de, dn = m["feat_dim"], m["edge_dim"], m["node_dim"]
    spec = list(encoders.find(m["backbone"]).spec(m))
    add_linear(spec, "proj_edge", de, 2 * f)
    g = "gnn1."
    add_linear(spec, g + "edge_model.edge_mlp.0", de, 2 * f + de)
    add_linear(spec, g + "edge_model.edge_mlp.2", de, de)
    add_linear(spec, g + "mlp.0", dn, f + de)
    add_linear(spec, g + "mlp.2", dn, dn)
    for name in ("g", "theta", "phi"):
        add_linear(spec, g + f"att.{name}", dn // 8, dn)
    add_linear(spec, g + "att.W", dn, dn // 8)
    add_linear(spec, g + "mlp_updating.0", dn, f + dn)
    add_linear(spec, g + "mlp_updating.2", dn, dn)
    for name, width in (("fc_xyz", dn), ("fc_wpqr", dn), ("fc_xyz_R", de),
                        ("fc_wpqr_R", de)):
        add_linear(spec, name, 3, width)
    return spec


def netvlad_spec(r: dict) -> list:
    """VGG16's thirteen convs (torchvision indices) and NetVLAD's
    centroids and assignment conv (no bias: vladv1)."""
    spec, i, cin = [], 0, 3
    for c in VGG16_CFG:
        if c == "M":
            i += 1
            continue
        spec += [(f"encoder.{i}.weight", (c, cin, 3, 3), "fan_in"),
                 (f"encoder.{i}.bias", (c,), "bias")]
        cin, i = c, i + 2
    k, d = r["num_clusters"], r["encoder_dim"]
    spec += [("pool.centroids", (k, d), "unit_rows"),
             ("pool.conv.weight", (k, d, 1, 1), "assign")]
    return spec


# the kinds drawn from the spec's one standard normal draw: z -> weight
_FROM_NORMAL = {
    "fan_in": lambda z, shape: z / math.sqrt(math.prod(shape[1:])),
    "bias": lambda z, shape: 0.02 * z,
    "embed": lambda z, shape: 0.02 * z,
    "bn_weight": lambda z, shape: 1.0 + 0.1 * z,
    "bn_bias": lambda z, shape: 0.1 * z,
    "bn_mean": lambda z, shape: 0.1 * z,
    "ln_weight": lambda z, shape: 1.0 + 0.05 * z,
}
# and those drawn otherwise (`unit_rows` from the normal draw too)
_OTHER = ("unit_rows", "bn_var", "assign", "count")


@torch.no_grad()
def make_weights(spec: list, generator: torch.Generator,
                 kinds: dict | None = None) -> dict:
    """The weights of `spec` on the generator's device, float32 (int64 for
    counts): one normal draw and one uniform draw for the whole spec,
    sliced and scaled per tensor.  `kinds` adds kinds of an encoder's own
    ({kind: fn(z, shape)}, z its slice of the normal draw), beside these
    and under other names."""
    kinds = dict(kinds or {})
    clash = set(kinds) & (set(_FROM_NORMAL) | set(_OTHER))
    if clash:
        raise ValueError(f"kinds {sorted(clash)} are the harness's own")
    kinds.update(_FROM_NORMAL)
    dev = generator.device
    sizes = [math.prod(s) for _, s, _ in spec]
    n_norm = sum(n for n, (_, _, k) in zip(sizes, spec)
                 if k not in ("bn_var", "assign", "count"))
    n_unif = sum(n for n, (_, _, k) in zip(sizes, spec) if k == "bn_var")
    normal = torch.randn(n_norm, generator=generator, device=dev)
    unif = torch.rand(max(n_unif, 1), generator=generator, device=dev)
    out, a, b = {}, 0, 0
    centroids = None
    for (name, shape, kind), n in zip(spec, sizes):
        if kind == "count":
            out[name] = torch.zeros(shape, dtype=torch.int64, device=dev)
            continue
        if kind == "bn_var":
            out[name] = (0.5 + unif[b:b + n]).reshape(shape)
            b += n
            continue
        if kind == "assign":
            out[name] = (NETVLAD_ALPHA * centroids).reshape(shape)
            continue
        z = normal[a:a + n].reshape(shape)
        a += n
        if kind == "unit_rows":
            t = z.abs()
            t = t / t.norm(dim=-1, keepdim=True)
            centroids = t
        else:
            t = kinds[kind](z, shape)
        out[name] = t.contiguous()
    return out


def relpose_weights(m: dict, generator: torch.Generator) -> dict:
    """The pose model's weights: `make_weights` of `relpose_spec(m)` with
    the kinds its encoder defines."""
    kinds = getattr(encoders.find(m["backbone"]), "KINDS", None)
    return make_weights(relpose_spec(m), generator, kinds)


def meta_weights(spec: list) -> dict:
    """The spec's tensors on the `meta` device (shapes only), for counting
    work."""
    return {name: torch.empty(shape, device="meta",
                              dtype=torch.int64 if kind == "count"
                              else torch.float32)
            for name, shape, kind in spec}
