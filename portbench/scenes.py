"""The benchmark's inputs, made from the seed: a scene, its frames and their
poses, on the card in a few large draws.

A scene is a long textured strip (smooth noise at three scales, like a
wall the camera pans along); a frame is the crop of it at a horizontal
offset with its own pixel noise; the frame's pose is a smooth function of
the offset.  So frames near each other on the strip look alike and have
near poses, and retrieval has something to find, as in a real scene.
(With random weights the embeddings of a graph's frames still lie close
together, so near-ties in the graph's kNN are common: the checks allow
for them.)  Every seed gives the same sizes; the seed moves only the
texture, the offsets and the noise.

`seed_of(seed, name)` derives the seed of one draw from the run's seed.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch
import torch.nn.functional as F


def seed_of(seed: int, name: str) -> int:
    """A 63-bit seed for the draw `name` of run `seed`."""
    h = hashlib.sha256(f"{int(seed)}:{name}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, name: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed_of(seed, name))


class Scene:
    """A strip of `length` columns at height `hw[0]`; frames `hw` wide."""

    def __init__(self, seed: int, hw, length: int, device,
                 pixel_noise: float = 6.0):
        self.hw, self.length, self.device = tuple(hw), int(length), device
        self.pixel_noise = pixel_noise
        self.seed = seed
        g = generator(seed, "texture", device)
        h, w = self.hw[0], self.length + self.hw[1]
        tex = torch.zeros(1, 3, h, w, device=device)
        for cell, amp in ((32, 60.0), (8, 30.0), (2, 12.0)):
            z = torch.randn(1, 3, -(-h // cell) + 1, -(-w // cell) + 1,
                            generator=g, device=device)
            tex += amp * F.interpolate(z, scale_factor=cell, mode="bilinear",
                                       align_corners=False)[..., :h, :w]
        self.texture = (128.0 + tex[0]).permute(1, 2, 0).contiguous()

    def offsets(self, n: int, name: str) -> torch.Tensor:
        """n offsets uniform on the strip (int64, on the card)."""
        g = generator(self.seed, name, self.device)
        return torch.randint(0, self.length, (n,), generator=g,
                             device=self.device)

    def frames(self, offsets: torch.Tensor, name: str,
               chunk: int = 256) -> np.ndarray:
        """uint8 [n, H, W, 3] on the host: the crops at `offsets`, each with
        its own noise."""
        g = generator(self.seed, name, self.device)
        h, w = self.hw
        out = np.empty((len(offsets), h, w, 3), np.uint8)
        cols = torch.arange(w, device=self.device)
        for i in range(0, len(offsets), chunk):
            o = offsets[i:i + chunk]
            crop = self.texture[:, o[:, None] + cols[None, :]]  # [H, n, W, 3]
            crop = crop.permute(1, 0, 2, 3)
            crop = crop + self.pixel_noise * torch.randn(
                crop.shape, generator=g, device=self.device)
            out[i:i + chunk] = crop.round().clamp(0, 255).to(
                torch.uint8).cpu().numpy()
        return out

    def poses(self, offsets: torch.Tensor) -> np.ndarray:
        """float32 [n, 6] = [t (metres), log q]: a smooth path along the
        strip (one metre a thousand columns)."""
        o = offsets.double().cpu().numpy()
        t = np.stack([o * 1e-3, 0.3 * np.sin(o * 1.1e-3),
                      0.2 * np.cos(o * 0.7e-3)], -1)
        q = np.stack([0.15 * np.sin(o * 0.9e-3), 0.1 * np.cos(o * 1.3e-3),
                      0.05 * np.sin(o * 0.5e-3 + 1.0)], -1)
        return np.concatenate([t, q], -1).astype(np.float32)


def graph_offsets(scene: Scene, graphs: int, nodes: int, stride: int,
                  name: str) -> torch.Tensor:
    """[graphs, nodes] offsets: each graph a run of `nodes` frames
    `stride` columns apart from a random start, as a training graph of
    nearby frames."""
    start = scene.offsets(graphs, name) % max(1, scene.length
                                              - stride * (nodes - 1))
    return start[:, None] + stride * torch.arange(nodes,
                                                  device=start.device)


def normalization(stats: dict) -> tuple[np.ndarray, np.ndarray]:
    """The scene's (mean, std) of pixels in [0, 1], per channel."""
    return (np.asarray(stats["mean"], np.float32),
            np.asarray(stats["std"], np.float32))
