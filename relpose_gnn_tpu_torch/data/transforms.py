"""Host-side image transforms for the input pipeline.

Port of `relpose_gnn_tpu/data/transforms.py`, the reference's torchvision
transform stacks:
  * 7-Scenes:  Resize(256) + Normalize(per-scene stats mean, sqrt(var))
  * Cambridge: Resize(256) + ColorJitter(0.5, 0.5, 0.5, 0.2) +
    Normalize(0.5, 0.25)

Resize(256) = shortest side to 256 with aspect preserved, PIL's bilinear
(antialiased) resample as torchvision's PIL backend runs it, here through
the port's own copy (`data/image_io.py::resize_bilinear`, bit for bit).
Frames stay uint8 / float HWC numpy arrays: the packed stores hold uint8
and normalise on the device.

Colour frames decode with the port's PNG decoder (`data/image_io.py`), so
nothing here needs PIL.
"""

from __future__ import annotations

import numpy as np

from relpose_gnn_tpu_torch.data import image_io


def short_side_size(h: int, w: int, size: int) -> tuple[int, int]:
    """(new width, new height) of torchvision's `Resize(int)`: the
    shorter side -> `size`, the other side rounded."""
    if h <= w:
        return max(1, round(size * w / h)), size
    return size, max(1, round(size * h / w))


def resize_short_side(img: np.ndarray, size: int = 256) -> np.ndarray:
    """torchvision `Resize(int)` semantics on a uint8 [H, W, 3] frame (or
    anything `np.asarray` makes one of)."""
    img = np.asarray(img)
    return image_io.resize_bilinear(img, short_side_size(*img.shape[:2],
                                                         size))


def load_rgb(path: str) -> np.ndarray | None:
    """RGB decode to uint8 [H, W, 3]; a file that cannot be read, or that
    PIL fails on with an IOError (`image_io.CorruptPNG`), gives None:
    callers skip forward, as they did on PIL's IOError."""
    try:
        return image_io.decode_png(path)
    except image_io.CorruptPNG:
        return None


def to_float_chw_free(img: np.ndarray) -> np.ndarray:
    """uint8 HWC -> float32 HWC in [0, 1] (ToTensor without the CHW
    transpose: the port keeps NHWC at its public functions)."""
    return np.asarray(img, np.float32) / 255.0


def normalize(x: np.ndarray, mean, std) -> np.ndarray:
    """[..., H, W, 3] in [0,1] -> normalized."""
    mean = np.asarray(mean, np.float32).reshape(1, 1, -1)
    std = np.asarray(std, np.float32).reshape(1, 1, -1)
    return (x - mean) / std


def _gray(im: np.ndarray) -> np.ndarray:
    return 0.299 * im[..., 0] + 0.587 * im[..., 1] + 0.114 * im[..., 2]


def color_jitter(rng: np.random.Generator, x: np.ndarray,
                 brightness: float = 0.5, contrast: float = 0.5,
                 saturation: float = 0.5, hue: float = 0.2) -> np.ndarray:
    """torchvision ColorJitter on float RGB [0,1] arrays.

    Factors drawn from `rng` uniformly in [max(0, 1-a), 1+a] (hue in
    [-h, h]) in the order brightness, contrast, saturation, hue, then one
    permutation orders the operations (the JAX function's draws)."""
    ops = []
    if brightness > 0:
        fb = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
        ops.append(lambda im: np.clip(im * fb, 0, 1))
    if contrast > 0:
        fc = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)

        def _contrast(im):
            gray = _gray(im).mean()
            return np.clip((im - gray) * fc + gray, 0, 1)
        ops.append(_contrast)
    if saturation > 0:
        fs = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)

        def _sat(im):
            gray = _gray(im)[..., None]
            return np.clip((im - gray) * fs + gray, 0, 1)
        ops.append(_sat)
    if hue > 0:
        fh = rng.uniform(-hue, hue)

        def _hue(im):
            # hue rotation in YIQ space: the chroma plane turned by 2 pi f
            y = _gray(im)
            i = (0.596 * im[..., 0] - 0.274 * im[..., 1]
                 - 0.322 * im[..., 2])
            q = (0.211 * im[..., 0] - 0.523 * im[..., 1]
                 + 0.312 * im[..., 2])
            ang = 2 * np.pi * fh
            i2 = i * np.cos(ang) - q * np.sin(ang)
            q2 = i * np.sin(ang) + q * np.cos(ang)
            r = y + 0.956 * i2 + 0.621 * q2
            g = y - 0.272 * i2 - 0.647 * q2
            b = y - 1.106 * i2 + 1.703 * q2
            return np.clip(np.stack([r, g, b], -1), 0, 1)
        ops.append(_hue)
    for j in rng.permutation(len(ops)):
        x = ops[j](x)
    return x


def load_and_preprocess(path: str, size: int = 256,
                        mean=None, std=None) -> np.ndarray | None:
    """Decode + resize (+optional normalize) one image -> [H, W, 3] f32."""
    img = load_rgb(path)
    if img is None:
        return None
    x = to_float_chw_free(resize_short_side(img, size))
    if mean is not None:
        x = normalize(x, mean, std)
    return x
