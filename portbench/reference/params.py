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
`num_batches_tracked`).
"""

from __future__ import annotations

import math

import torch

RESNET_STAGES = {"resnet34": (3, 4, 6, 3), "resnet18": (2, 2, 2, 2)}
VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512)
# NetVLAD's assignment sharpness at initialisation (Arandjelovic et al.:
# alpha large, so that each feature is assigned mostly to one centroid)
NETVLAD_ALPHA = 30.0


def _bn(spec: list, name: str, c: int) -> None:
    spec += [(f"{name}.weight", (c,), "bn_weight"),
             (f"{name}.bias", (c,), "bn_bias"),
             (f"{name}.running_mean", (c,), "bn_mean"),
             (f"{name}.running_var", (c,), "bn_var"),
             (f"{name}.num_batches_tracked", (), "count")]


def _linear(spec: list, name: str, out: int, inp: int) -> None:
    spec += [(f"{name}.weight", (out, inp), "fan_in"),
             (f"{name}.bias", (out,), "bias")]


def resnet_spec(prefix: str, backbone: str, feat_dim: int) -> list:
    """torchvision BasicBlock ResNet, unfolded (BatchNorm after every
    conv), the classifier replaced by `fc: 512 -> feat_dim`."""
    spec = [(f"{prefix}conv1.weight", (64, 3, 7, 7), "fan_in")]
    _bn(spec, f"{prefix}bn1", 64)
    in_planes = 64
    for s, n in enumerate(RESNET_STAGES[backbone]):
        planes = 64 * 2 ** s
        for b in range(n):
            stride = 2 if s > 0 and b == 0 else 1
            p = f"{prefix}layer{s + 1}.{b}."
            spec.append((p + "conv1.weight", (planes, in_planes, 3, 3),
                         "fan_in"))
            _bn(spec, p + "bn1", planes)
            spec.append((p + "conv2.weight", (planes, planes, 3, 3),
                         "fan_in"))
            _bn(spec, p + "bn2", planes)
            if stride != 1 or in_planes != planes:
                spec.append((p + "downsample.0.weight",
                             (planes, in_planes, 1, 1), "fan_in"))
                _bn(spec, p + "downsample.1", planes)
            in_planes = planes
    _linear(spec, f"{prefix}fc", feat_dim, in_planes)
    return spec


def vit_spec(prefix: str, v: dict, feat_dim: int, image_hw) -> list:
    """timm's ViT names: patch embedding, CLS, position table, `depth`
    pre-norm blocks (fused qkv), final norm, then `fc` to feat_dim."""
    d, p = v["dim"], v["patch"]
    tokens = (image_hw[0] // p) * (image_hw[1] // p) + 1
    spec = [(f"{prefix}patch_embed.proj.weight", (d, 3, p, p), "fan_in"),
            (f"{prefix}patch_embed.proj.bias", (d,), "bias"),
            (f"{prefix}cls_token", (1, 1, d), "embed"),
            (f"{prefix}pos_embed", (1, tokens, d), "embed")]
    for i in range(v["depth"]):
        b = f"{prefix}blocks.{i}."
        spec += [(b + "norm1.weight", (d,), "ln_weight"),
                 (b + "norm1.bias", (d,), "bias")]
        _linear(spec, b + "attn.qkv", 3 * d, d)
        _linear(spec, b + "attn.proj", d, d)
        spec += [(b + "norm2.weight", (d,), "ln_weight"),
                 (b + "norm2.bias", (d,), "bias")]
        _linear(spec, b + "mlp.fc1", v["mlp_ratio"] * d, d)
        _linear(spec, b + "mlp.fc2", d, v["mlp_ratio"] * d)
    spec += [(f"{prefix}norm.weight", (d,), "ln_weight"),
             (f"{prefix}norm.bias", (d,), "bias")]
    _linear(spec, f"{prefix}fc", feat_dim, d)
    return spec


def relpose_spec(m: dict) -> list:
    """The pose model: node encoder, `proj_edge`, one weight-tied GNN
    layer `gnn1` (edge MLP, message MLP, attention block, update MLP),
    the absolute and relative heads."""
    f, de, dn = m["feat_dim"], m["edge_dim"], m["node_dim"]
    if m["backbone"] == "vit":
        spec = vit_spec("encoder.", m["vit"], f, m["image_hw"])
    else:
        spec = resnet_spec("feature_extractor.", m["backbone"], f)
    _linear(spec, "proj_edge", de, 2 * f)
    g = "gnn1."
    _linear(spec, g + "edge_model.edge_mlp.0", de, 2 * f + de)
    _linear(spec, g + "edge_model.edge_mlp.2", de, de)
    _linear(spec, g + "mlp.0", dn, f + de)
    _linear(spec, g + "mlp.2", dn, dn)
    for name in ("g", "theta", "phi"):
        _linear(spec, g + f"att.{name}", dn // 8, dn)
    _linear(spec, g + "att.W", dn, dn // 8)
    _linear(spec, g + "mlp_updating.0", dn, f + dn)
    _linear(spec, g + "mlp_updating.2", dn, dn)
    for name, width in (("fc_xyz", dn), ("fc_wpqr", dn), ("fc_xyz_R", de),
                        ("fc_wpqr_R", de)):
        _linear(spec, name, 3, width)
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


_NORMAL = {"fan_in", "bias", "bn_weight", "bn_bias", "bn_mean", "ln_weight",
           "embed", "unit_rows"}


@torch.no_grad()
def make_weights(spec: list, generator: torch.Generator) -> dict:
    """The weights of `spec` on the generator's device, float32 (int64 for
    counts): one normal draw and one uniform draw for the whole spec,
    sliced and scaled per tensor."""
    dev = generator.device
    sizes = [math.prod(s) for _, s, _ in spec]
    n_norm = sum(n for n, (_, _, k) in zip(sizes, spec) if k in _NORMAL)
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
        if kind == "fan_in":
            t = z / math.sqrt(math.prod(shape[1:]))
        elif kind in ("bias", "embed"):
            t = 0.02 * z
        elif kind == "bn_weight":
            t = 1.0 + 0.1 * z
        elif kind in ("bn_bias", "bn_mean"):
            t = 0.1 * z
        elif kind == "ln_weight":
            t = 1.0 + 0.05 * z
        else:   # unit_rows
            t = z.abs()
            t = t / t.norm(dim=-1, keepdim=True)
            centroids = t
        out[name] = t.contiguous()
    return out


def meta_weights(spec: list) -> dict:
    """The spec's tensors on the `meta` device (shapes only), for counting
    work."""
    return {name: torch.empty(shape, device="meta",
                              dtype=torch.int64 if kind == "count"
                              else torch.float32)
            for name, shape, kind in spec}
