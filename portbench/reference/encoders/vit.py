"""ViT-B/16 (Dosovitskiy et al., An Image is Worth 16x16 Words, ICLR 2021)
as the program states it: the node encoder of `backbone: "vit"`, its
widths in the model section's `vit`.  timm's names: patch embedding, CLS,
position table, `depth` pre-norm blocks (fused qkv), final norm, then
`fc` to feat_dim."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.params import add_linear

MODULE = "encoder"
LN_EPS = 1e-6


def spec(m: dict) -> list:
    v, prefix = m["vit"], MODULE + "."
    d, p = v["dim"], v["patch"]
    tokens = (m["image_hw"][0] // p) * (m["image_hw"][1] // p) + 1
    out = [(f"{prefix}patch_embed.proj.weight", (d, 3, p, p), "fan_in"),
           (f"{prefix}patch_embed.proj.bias", (d,), "bias"),
           (f"{prefix}cls_token", (1, 1, d), "embed"),
           (f"{prefix}pos_embed", (1, tokens, d), "embed")]
    for i in range(v["depth"]):
        b = f"{prefix}blocks.{i}."
        out += [(b + "norm1.weight", (d,), "ln_weight"),
                (b + "norm1.bias", (d,), "bias")]
        add_linear(out, b + "attn.qkv", 3 * d, d)
        add_linear(out, b + "attn.proj", d, d)
        out += [(b + "norm2.weight", (d,), "ln_weight"),
                (b + "norm2.bias", (d,), "bias")]
        add_linear(out, b + "mlp.fc1", v["mlp_ratio"] * d, d)
        add_linear(out, b + "mlp.fc2", d, v["mlp_ratio"] * d)
    out += [(f"{prefix}norm.weight", (d,), "ln_weight"),
            (f"{prefix}norm.bias", (d,), "bias")]
    add_linear(out, f"{prefix}fc", m["feat_dim"], d)
    return out


def forward(sd, m, x, prec, train=False):
    """Pre-norm blocks, LayerNorm eps 1e-6, tanh GELU, q / sqrt(head dim),
    CLS readout, `fc`; trailing rows and columns that fill no patch are
    cropped.  No layer depends on `train`."""
    v, prefix = m["vit"], MODULE + "."
    p, d, heads = v["patch"], v["dim"], v["heads"]
    b, h, w, _ = x.shape
    hp, wp = h // p, w // p
    x = x[:, :hp * p, :wp * p].permute(0, 3, 1, 2)
    x = prec.conv(x, sd[prefix + "patch_embed.proj.weight"],
                  sd[prefix + "patch_embed.proj.bias"], p, 0)
    x = x.flatten(2).transpose(1, 2)
    x = torch.cat([sd[prefix + "cls_token"].expand(b, 1, d), x], 1)
    x = x + sd[prefix + "pos_embed"]
    t, hd = x.shape[1], d // heads

    def ln(t_, name):
        return prec.q(F.layer_norm(t_, (d,), sd[name + ".weight"],
                                   sd[name + ".bias"], LN_EPS))

    def lin(t_, name):
        return prec.linear(t_, sd[name + ".weight"], sd[name + ".bias"])

    for i in range(v["depth"]):
        blk = f"{prefix}blocks.{i}."
        qkv = lin(ln(x, blk + "norm1"), blk + "attn.qkv")
        q, k, val = qkv.reshape(b, t, 3, heads, hd).permute(2, 0, 3, 1, 4)
        att = torch.softmax(prec.q(q / math.sqrt(hd))
                            @ prec.q(k).transpose(-1, -2), dim=-1)
        y = (prec.q(att) @ prec.q(val)).transpose(1, 2).reshape(b, t, d)
        x = prec.q(x + lin(y, blk + "attn.proj"))
        y = prec.q(F.gelu(lin(ln(x, blk + "norm2"), blk + "mlp.fc1"),
                          approximate="tanh"))
        x = prec.q(x + lin(y, blk + "mlp.fc2"))
    x = ln(x, prefix + "norm")
    return lin(x[:, 0], prefix + "fc")
