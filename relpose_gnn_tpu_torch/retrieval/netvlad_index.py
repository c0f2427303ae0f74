"""NetVLAD descriptor index: batched embedding + on-device retrieval.

Port of `relpose_gnn_tpu/retrieval/netvlad_index.py`: the descriptor
database is one [M, 32768] device tensor and query ranking is one
full-float32 matrix product.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from relpose_gnn_tpu_torch import resolve_device
from relpose_gnn_tpu_torch.data.image_io import resize_bilinear
from relpose_gnn_tpu_torch.models.netvlad import NetVLADEncoder
from relpose_gnn_tpu_torch.models.posenet import init_weights
from relpose_gnn_tpu_torch.ops.camera import crop_by_intrinsic
from relpose_gnn_tpu_torch.retrieval import subsample

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# 7-Scenes Kinect intrinsics: RGB camera vs depth camera
K_7SCENES_RGB = np.array([[525.0, 0, 320], [0, 525.0, 240], [0, 0, 1]])
K_7SCENES_DEPTH = np.array([[585.0, 0, 320], [0, 585.0, 240], [0, 0, 1]])


def imagenet_normalize(images: np.ndarray) -> np.ndarray:
    """[..., H, W, 3] float RGB in [0,1] -> ImageNet-normalized (the
    transform at dataset_7Scenes_multi.py:162-163)."""
    return (images - IMAGENET_MEAN) / IMAGENET_STD


def netvlad_preprocess_7scenes(img_01: np.ndarray,
                               out_hw: tuple[int, int] = (192, 256)
                               ) -> np.ndarray:
    """Reference NetVLAD input geometry for a 7-Scenes frame: a raw
    640x480 frame is first cropped from the RGB to the depth intrinsics'
    field of view (`ops/camera.py::crop_by_intrinsic`); every frame is then
    resized to 192x256 (PIL's bilinear resample of the uint8-quantised
    image, `data/image_io.py::resize_bilinear`) and ImageNet-normalized."""
    if img_01.shape[:2] == (480, 640):
        img_01 = crop_by_intrinsic(img_01, K_7SCENES_RGB, K_7SCENES_DEPTH)
    u8 = (np.clip(img_01, 0, 1) * 255).astype(np.uint8)
    out = resize_bilinear(u8, (out_hw[1], out_hw[0])).astype(np.float32)
    return imagenet_normalize(out / 255.0)


def seeded_encoder(num_clusters: int = 64, encoder_dim: int = 512,
                   dtype: torch.dtype | None = torch.bfloat16,
                   seed: int = 0) -> NetVLADEncoder:
    """A NetVLADEncoder with weights drawn from `seed` (on the CPU), for
    use without a released checkpoint (smoke runs)."""
    encoder = NetVLADEncoder(num_clusters=num_clusters,
                             encoder_dim=encoder_dim, dtype=dtype)
    gen = torch.Generator().manual_seed(seed)
    init_weights(encoder, gen)
    with torch.no_grad():
        encoder.pool.centroids.uniform_(0, 1, generator=gen)
    return encoder


class NetVLADIndex:
    """Builds and queries a descriptor database on `device` (None: the
    CUDA card).  `encoder` is a NetVLADEncoder with its weights loaded;
    without one a seeded random encoder is made (smoke use)."""

    def __init__(self, encoder: NetVLADEncoder | None = None,
                 batch_size: int = 16,
                 dtype: torch.dtype | None = torch.bfloat16, seed: int = 0,
                 num_clusters: int = 64, encoder_dim: int = 512,
                 device: torch.device | str | None = None):
        self.device = resolve_device(device)
        if encoder is None:
            encoder = seeded_encoder(num_clusters, encoder_dim, dtype, seed)
        self.encoder = encoder.to(self.device).eval()
        self.batch_size = batch_size
        self.descriptors: torch.Tensor | None = None  # [M, K * dim]

    @torch.inference_mode()
    def embed(self, images: np.ndarray) -> np.ndarray:
        """[B, H, W, 3] ImageNet-normalized -> [B, K*encoder_dim] float32."""
        out = [self.encoder(torch.as_tensor(
                   images[i:i + self.batch_size],
                   device=self.device)).float().cpu().numpy()
               for i in range(0, len(images), self.batch_size)]
        if out:
            return np.concatenate(out)
        return np.zeros(
            (0, self.encoder.num_clusters * self.encoder.encoder_dim),
            np.float32)

    def build(self, images: Iterable[np.ndarray] | np.ndarray) -> None:
        self.descriptors = torch.as_tensor(self.embed(np.asarray(images)),
                                           device=self.device)

    def add(self, images: np.ndarray) -> None:
        d = torch.as_tensor(self.embed(np.asarray(images)),
                            device=self.device)
        self.descriptors = (d if self.descriptors is None
                            else torch.cat([self.descriptors, d]))

    def _require_built(self) -> torch.Tensor:
        if self.descriptors is None:
            raise RuntimeError("NetVLADIndex: call build() first")
        return self.descriptors

    def similarities(self, query_desc: np.ndarray) -> np.ndarray:
        """Cosine similarity of queries vs the whole DB: [Q, M], in full
        float32 (ranking is sensitive on near-duplicate frames; TF32 is
        refused), by the port's one scorer (`subsample.similarities`)."""
        db = self._require_built()
        q = torch.as_tensor(query_desc, dtype=torch.float32,
                            device=self.device)
        return subsample.similarities(q, db).cpu().numpy()

    def topk(self, query_desc: np.ndarray, k: int):
        scores, idx = subsample.cosine_topk(
            self._require_built(),
            torch.as_tensor(query_desc, device=self.device), k)
        return scores.cpu().numpy(), idx.cpu().numpy()

    def graph_neighbors(self, query_desc: np.ndarray, k: int,
                        sampling_period: int, rng: np.random.Generator,
                        invalid: np.ndarray | None = None) -> np.ndarray:
        """Full reference neighbor-selection pipeline for one query
        (rank -> filter -> random drop -> stride -> top-k)."""
        sim = self.similarities(query_desc[None])[0]
        order = subsample.rank_and_filter_numpy(sim, invalid)
        return subsample.subsample_ranked_numpy(order, k, sampling_period,
                                                rng)
