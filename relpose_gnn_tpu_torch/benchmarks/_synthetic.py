"""Seeded models, frames and database tables for the benches and the smoke run.

The repository holds no trained checkpoint, so whatever times or smoke-tests
the serving path builds its models here: published widths (preset R3, or
the stretch presets R3-vit and R3-32; VGG16 + NetVLAD with 64 clusters x
512), weights random from a seed.  The
benches take the widths as flags so that the CPU tests can run them at a
tiny size; the defaults are the full ones.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses

import torch
import torch.nn.functional as F

from relpose_gnn_tpu_torch.evaluation.service import (RelocalizationService,
                                                      ServiceConfig)
from relpose_gnn_tpu_torch.models.fold_bn import fold_relpose_backbone
from relpose_gnn_tpu_torch.models.netvlad import NetVLADEncoder
from relpose_gnn_tpu_torch.models.posenet import (RelPoseGNN,
                                                  RelPoseGNNConfig,
                                                  init_weights)

DTYPES = {"bfloat16": torch.bfloat16, "float32": None}


def add_model_args(ap: argparse.ArgumentParser) -> None:
    """The flags that size the models; the defaults are the full widths."""
    ap.add_argument("--model-name", default="R3",
                    help="config preset: R3, or the stretch configs "
                         "R3-vit (the ViT-B/16 node encoder) / R3-32 "
                         "(32-node graphs)")
    ap.add_argument("--backbone", default=None,
                    help="override the preset's backbone (resnet18 / "
                         "resnet34 / vit)")
    ap.add_argument("--dims", type=int, default=None,
                    help="override feat_dim, edge_dim and node_dim")
    ap.add_argument("--seq-len", type=int, default=None,
                    help="graph size (query + neighbours); default: the "
                         "preset's")
    ap.add_argument("--clusters", type=int, default=64,
                    help="NetVLAD clusters (descriptor = clusters x 512)")
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--width", type=int, default=341)
    ap.add_argument("--dtype", default="bfloat16", choices=tuple(DTYPES))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' must be asked for")


def model_overrides(args) -> dict:
    kw = {}
    if args.backbone is not None:
        kw["backbone"] = args.backbone
    if args.dims is not None:
        kw.update(feat_dim=args.dims, edge_dim=args.dims, node_dim=args.dims)
    if args.seq_len is not None:
        kw["num_nodes"] = args.seq_len
        kw["knn"] = min(4, args.seq_len - 2)
    # a ViT's position table is built for the frames' size
    kw["vit_image_hw"] = (args.height, args.width)
    return kw


def pose_model(device: torch.device, name: str = "R3",
               dtype: torch.dtype | None = torch.bfloat16, seed: int = 0,
               **overrides) -> RelPoseGNN:
    """The serving form (`serving_form`: BN folded, compact edges) of a
    preset with seeded weights."""
    return serving_form(unfolded_pose_model(device, name, dtype, seed,
                                            **overrides))


def serving_form(model: RelPoseGNN, s2d_stem: bool = False,
                 compact_edges: bool = True) -> RelPoseGNN:
    """`model` (unfolded) as it is served, with the same weights: a ResNet
    backbone's BatchNorm folded into its convolutions (a ViT has none),
    with `s2d_stem` the stem in its space-to-depth form, and the GNN on
    the compact edge list unless `compact_edges` is False.  `model` itself
    is left as it is.  A ViT with `s2d_stem` raises SystemExit (the stem
    rewrite is a ResNet's), rather than serve the plain encoder under an
    s2d label."""
    if model.cfg.backbone.startswith("resnet"):
        _, served = fold_relpose_backbone(model, s2d_stem=s2d_stem)
    elif s2d_stem:
        raise SystemExit(f"--s2d applies to resnet backbones only (this "
                         f"model uses {model.cfg.backbone})")
    else:
        served = copy.deepcopy(model)
    # the edge layout is a switch of the forward; the weights are the same
    served.cfg = dataclasses.replace(served.cfg,
                                     compact_edges=compact_edges)
    return served


def unfolded_pose_model(device: torch.device, name: str = "R3",
                        dtype: torch.dtype | None = torch.bfloat16,
                        seed: int = 0, **overrides) -> RelPoseGNN:
    """A preset with seeded weights before the fold: a ResNet backbone's
    BatchNorm statistics random (a ViT has none)."""
    cfg = RelPoseGNNConfig.preset(name, dtype=dtype, **overrides)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.device(device):
        model = RelPoseGNN(cfg).eval()
    init_weights(model, gen)
    if cfg.backbone == "vit":
        return model
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1, generator=gen)
                m.running_var.uniform_(0.8, 1.2, generator=gen)
    return model


def netvlad_encoder(device: torch.device, num_clusters: int = 64,
                    dtype: torch.dtype | None = torch.bfloat16,
                    seed: int = 1) -> NetVLADEncoder:
    """VGG16 + NetVLAD (`num_clusters` x 512), seeded weights."""
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.device(device):
        enc = NetVLADEncoder(num_clusters=num_clusters, encoder_dim=512,
                             dtype=dtype).eval()
    init_weights(enc, gen)
    with torch.no_grad():
        enc.pool.centroids.uniform_(0, 1, generator=gen)
    return enc


def models_from_args(args, device: torch.device, with_netvlad: bool):
    dtype = DTYPES[args.dtype]
    model = pose_model(device, args.model_name, dtype, args.seed,
                       **model_overrides(args))
    netvlad = (netvlad_encoder(device, args.clusters, dtype, args.seed + 1)
               if with_netvlad else None)
    return model, netvlad


def synthetic_frames(device: torch.device, n: int, h: int, w: int,
                     seed: int) -> torch.Tensor:
    """n uint8 frames [n, h, w, 3] on the host, made on the device in
    bulk: each is a smooth random colour field (a 6x8 grid enlarged to
    h x w) plus pixel noise, so frames differ in their large-scale
    structure the way views of different places do, and no two are
    near-duplicates."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for i in range(0, n, 128):
        k = min(128, n - i)
        coarse = torch.rand(k, 3, 6, 8, device=device, generator=gen)
        img = F.interpolate(coarse, size=(h, w), mode="bicubic",
                            align_corners=False)
        img = img + 0.05 * torch.randn(k, 3, h, w, device=device,
                                       generator=gen)
        img = (img.clamp(0, 1) * 255).to(torch.uint8).permute(0, 2, 3, 1)
        out.append(img.contiguous().cpu())
    return torch.cat(out)


def synth_database(svc: RelocalizationService, m: int, seed: int = 2) -> None:
    """Fill `svc`'s tables with `m` random rows made on the device, in
    the shapes and types `build()` leaves (unit-norm descriptor rows in
    rank_dtype, float32 embeddings, poses, all valid): the query path
    reads only these tensors, so a deployment-sized `m` costs no pixel
    upload and no embedding pass."""
    dev = svc.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    feat = svc.model.cfg.feat_dim
    dv = (feat if svc.cfg.retrieval == "shared-trunk"
          else svc.netvlad.num_clusters * svc.netvlad.encoder_dim)
    rows = m if svc.cfg.capacity is None else int(svc.cfg.capacity)
    if m > rows:
        raise ValueError(f"database has {m} frames > capacity {rows}")
    desc = F.normalize(torch.randn(rows, dv, device=dev, generator=gen),
                       dim=-1)
    svc.db_desc = desc.to(svc._rank_dt)
    svc.db_emb = torch.randn(rows, feat, device=dev, generator=gen)
    svc.db_poses = torch.randn(rows, 6, device=dev, generator=gen)
    svc.db_valid = torch.arange(rows, device=dev) < m
    svc.db_count = m


def make_norm(device: torch.device, mean: float = 0.45, std: float = 0.2):
    """The benches' scene normalization `(x - mean) / std`, dividing by a
    tensor (on CUDA a Python scalar divisor becomes a reciprocal
    multiply)."""
    mean_t = torch.tensor(mean, device=device)
    std_t = torch.tensor(std, device=device)

    def model_norm(x01):
        return (x01 - mean_t) / std_t

    return model_norm


def service_from_args(args, device: torch.device, **cfg_kw
                      ) -> RelocalizationService:
    """The service the benches time: models from the flags, retrieval
    mode, resolution and table type from the flags where present."""
    mode = getattr(args, "retrieval_mode", "netvlad")
    model, netvlad = models_from_args(args, device, mode == "netvlad")
    cfg = ServiceConfig(**{**dict(
        seq_len=model.cfg.num_nodes,
        retrieval_hw=tuple(getattr(args, "retrieval_hw", (192, 256))),
        retrieval=mode, rank_dtype=getattr(args, "rank_dtype", "float32")),
        **cfg_kw})
    return RelocalizationService(model, netvlad, cfg, device=device)
