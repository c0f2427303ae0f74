"""Host-side image transforms for the input pipeline.

Port of `relpose_gnn_tpu/data/transforms.py`, the reference's torchvision
transform stacks:
  * 7-Scenes:  Resize(256) + Normalize(per-scene stats mean, sqrt(var))
  * Cambridge: Resize(256) + ColorJitter(0.5, 0.5, 0.5, 0.2) +
    Normalize(0.5, 0.25)

Resize(256) = shortest side to 256 with aspect preserved, PIL bilinear
(antialiased), torchvision's PIL backend.  Frames stay uint8 / float HWC
numpy arrays: the packed stores hold uint8 and normalise on the device.

PIL is imported by the functions that decode or resize, never when this
module is imported: a machine without PIL can import every loader, and a
call that needs PIL raises an ImportError naming it.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    from PIL import Image


def pil_image():
    """The `PIL.Image` module; an ImportError naming PIL where it is not
    installed (nothing falls back to another decoder or resize)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "decoding and resizing frames needs PIL (Pillow), which is not "
            "installed") from e
    return Image


def resize_short_side(img: Image.Image, size: int = 256) -> Image.Image:
    """torchvision `Resize(int)` semantics: shorter side -> `size`."""
    Image = pil_image()
    w, h = img.size
    if h <= w:
        nh, nw = size, max(1, round(size * w / h))
    else:
        nw, nh = size, max(1, round(size * h / w))
    return img.resize((nw, nh), Image.BILINEAR)


def load_rgb(path: str) -> Image.Image | None:
    """RGB decode; an unreadable file gives None (callers skip forward)."""
    Image = pil_image()
    try:
        img = Image.open(path)
        return img.convert("RGB")
    except (IOError, OSError):
        return None


def to_float_chw_free(img: Image.Image) -> np.ndarray:
    """PIL -> float32 HWC in [0, 1] (ToTensor without the CHW transpose:
    the port keeps NHWC at its public functions)."""
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
