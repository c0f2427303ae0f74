"""The port's own PNG codec and bilinear resize for colour and depth frames.

The JAX package decodes and resizes frames with PIL; the card's machine
has no PIL, so the port keeps its own copy of that work:

  * `decode_png(path) -> uint8 [H, W, 3]`: Python's `zlib` inflates the
    concatenated IDAT chunks and `csrc/imageio.cc::png_unfilter` undoes the
    five per-row filters.  Bit depth 8, colour types 0 (gray, replicated),
    2 (RGB), 3 (palette through PLTE) and 6 (RGBA, alpha dropped), what
    `Image.open(p).convert("RGB")` gives for them.  Interlaced (Adam7)
    images, other bit depths, gray + alpha and JPEG files raise ValueError
    naming what is refused.  The file is read as PIL reads it: the chunks
    before the image data with their CRCs checked, then the IDAT chunks
    that follow in a row, whose CRCs PIL skips, and nothing after the
    image data.  Bytes PIL fails on with an IOError (a bad signature, a bad
    CRC before the image data, image data cut short or that does not
    inflate) raise `CorruptPNG`, a ValueError; a file that cannot be read
    gives None.
  * `decode_gray_png(path) -> uint8 or uint16 [H, W]`: a grayscale PNG of
    bit depth 8 or 16 (7-Scenes depth frames are 16-bit, big-endian in the
    file), what `np.asarray(Image.open(p))` gives in PIL's modes L and
    I;16.  `CorruptPNG.in_header` tells a file PIL's `Image.open` already
    refuses (the JAX depth loader's None) from one whose image data PIL
    fails on only when it reads the pixels.
  * `encode_png(path, image)`: uint8 RGB or uint16 gray, filter type 0
    and `zlib`, for the synthetic scenes; its bytes are its own, its
    pixels PIL reads back.
  * `resize_bilinear(image, (w, h))`: `Image.resize((w, h),
    Image.BILINEAR)` bit for bit (`csrc/imageio.cc::resize_bilinear_u8`):
    the triangle filter widened by the scale when shrinking, weights in
    fixed point at 22 fractional bits, the horizontal pass first, rounded
    to uint8 between the passes.
  * `resize_bilinear16(image, (w, h))`: the same for uint16 [H, W], as
    PIL resizes mode I;16 (`csrc/imageio.cc::resize_bilinear_u16`): the
    normalised weights in double, each pass rounded half up to uint16.

`COUNTS` holds the frames decoded and resized, and the seconds spent, since
`reset_counts()`.

The library builds with g++ on first use into `_build/` through
`ops/_build.py::build_host`, like the graph reader; nothing falls back to
PIL where it does not build.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import time
import zlib

import numpy as np

from relpose_gnn_tpu_torch.ops import _build

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 6: 4}   # accepted colour types
_COLOUR_NAMES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray + alpha",
                 6: "RGBA"}

_lib = None
_lib_lock = threading.Lock()

# Frames done and seconds spent, summed over threads, by `decode_png`
# ("decode") and `resize_bilinear` ("resize") since `reset_counts()`.
COUNTS = {"decode": [0, 0.0], "resize": [0, 0.0]}
_counts_lock = threading.Lock()


def reset_counts() -> None:
    with _counts_lock:
        for c in COUNTS.values():
            c[:] = [0, 0.0]


def _count(kind: str, t0: float) -> None:
    dt = time.perf_counter() - t0
    with _counts_lock:
        COUNTS[kind][0] += 1
        COUNTS[kind][1] += dt


class CorruptPNG(ValueError):
    """Bytes PIL would not decode: a bad signature, a bad CRC or a
    truncated chunk before the image data, or image data that is cut
    short or does not inflate.  `in_header`: the fault lies before the
    image data, where PIL's `Image.open` fails; else PIL fails only once
    it reads the pixels."""

    def __init__(self, msg: str, in_header: bool = True):
        super().__init__(msg)
        self.in_header = in_header


def load() -> ctypes.CDLL:
    """Build (if needed) and load `csrc/imageio.cc`; one handle per
    process."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build.build_host("imageio")))
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.png_unfilter.restype = ctypes.c_int
            lib.png_unfilter.argtypes = [u8p, ctypes.c_int64, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int, u8p]
            lib.resize_bilinear_u8.restype = ctypes.c_int
            lib.resize_bilinear_u8.argtypes = [u8p, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_int,
                                               u8p, ctypes.c_int,
                                               ctypes.c_int]
            u16p = ctypes.POINTER(ctypes.c_uint16)
            lib.resize_bilinear_u16.restype = ctypes.c_int
            lib.resize_bilinear_u16.argtypes = [u16p, ctypes.c_int,
                                                ctypes.c_int, u16p,
                                                ctypes.c_int, ctypes.c_int]
            _lib = lib
        return _lib


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _split(data: bytes) -> tuple[dict, bytes]:
    """({type: payload} of the chunks before the image data, the image
    data), read as PIL reads a PNG: CRCs checked up to the first IDAT;
    the payloads of the IDAT chunks that follow it in a row, their CRCs
    not read, a payload cut short by the end of the file kept as far as
    it goes; nothing after them read."""
    if data[:3] == b"\xff\xd8\xff":
        raise ValueError("a JPEG file is refused: the port decodes PNG "
                         "only")
    if data[:8] != PNG_SIGNATURE:
        raise CorruptPNG("not a PNG: bad signature")
    header = {}
    pos = 8
    while True:
        if pos + 8 > len(data):
            raise CorruptPNG("truncated PNG: no image data")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        if ctype == b"IDAT":
            break
        if ctype == b"IEND":   # PIL's Image.open stops here and succeeds
            raise CorruptPNG("PNG ends before its image data",
                             in_header=False)
        end = pos + 8 + length
        if end + 4 > len(data):
            raise CorruptPNG(f"truncated PNG: chunk {ctype!r} runs past the "
                             "end of the file")
        payload = data[pos + 8:end]
        crc, = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(ctype + payload) != crc:
            raise CorruptPNG(f"bad CRC in PNG chunk {ctype!r}")
        header.setdefault(ctype, payload)
        pos = end + 4
    idat = []
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        if ctype != b"IDAT":
            break
        idat.append(data[pos + 8:pos + 8 + length])
        pos += 12 + length
    return header, b"".join(idat)


def _read(path: str) -> bytes | None:
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError:
        return None


def decode_png(path: str) -> np.ndarray | None:
    """Decode the PNG at `path` to uint8 [H, W, 3]; None where the file
    cannot be read (see the module's docstring for what is accepted and
    what raises)."""
    t0 = time.perf_counter()
    data = _read(path)
    if data is None:
        return None
    image = _decode(data)
    _count("decode", t0)
    return image


def decode_gray_png(path: str) -> np.ndarray | None:
    """Decode the grayscale PNG at `path` (bit depth 8 or 16) to uint8 or
    uint16 [H, W]; None where the file cannot be read."""
    t0 = time.perf_counter()
    data = _read(path)
    if data is None:
        return None
    chunks, idat = _split(data)
    width, height, depth, colour, _ = _header(chunks, depths=(8, 16),
                                              colours=(0,))
    pixels = _unfiltered(idat, height, width * depth // 8, depth // 8)
    image = (pixels.reshape(height, width) if depth == 8 else
             pixels.reshape(-1).view(">u2").astype(np.uint16).reshape(
                 height, width))
    _count("decode", t0)
    return image


def _header(chunks: dict, depths=(8,), colours=tuple(_CHANNELS)) -> tuple:
    """(width, height, bit depth, colour type, PLTE) of a PNG's chunks
    before its image data; raises on what is corrupt or refused."""
    if len(chunks.get(b"IHDR", b"")) != 13:
        raise CorruptPNG("PNG without a valid IHDR chunk")
    header = struct.unpack(">IIBBBBB", chunks[b"IHDR"])
    plte = chunks.get(b"PLTE")
    if plte is not None:
        plte = np.frombuffer(plte, np.uint8).reshape(-1, 3)
    width, height, depth, colour, _, _, interlace = header
    if interlace:
        raise ValueError("interlaced (Adam7) PNG is refused: the port "
                         "decodes non-interlaced images only")
    names = ", ".join(_COLOUR_NAMES[c] for c in colours)
    if depth not in depths:
        raise ValueError(f"{depth}-bit {_COLOUR_NAMES.get(colour, colour)} "
                         f"PNG is refused: the port decodes bit depth "
                         f"{' or '.join(map(str, depths))} only ({names})")
    if colour not in colours:
        raise ValueError(f"PNG colour type {colour} "
                         f"({_COLOUR_NAMES.get(colour, 'unknown')}) is "
                         f"refused here: the port decodes {names}")
    if width < 1 or height < 1:
        raise CorruptPNG(f"PNG of size {width}x{height}")
    return width, height, depth, colour, plte


def _unfiltered(idat: bytes, height: int, stride: int, bpp: int
                ) -> np.ndarray:
    """The image data inflated and unfiltered: uint8 [height, stride]."""
    needed = height * (stride + 1)
    try:
        # inflate only the rows the image has, as PIL's decoder stops there
        raw = zlib.decompressobj().decompress(idat, needed)
    except zlib.error as e:
        raise CorruptPNG(f"PNG image data does not inflate: {e}",
                         in_header=False) from e
    if len(raw) < needed:
        raise CorruptPNG(f"truncated PNG image data: {len(raw)} bytes for "
                         f"{height} rows of {stride + 1}", in_header=False)
    raw = np.frombuffer(raw, np.uint8)
    pixels = np.empty((height, stride), np.uint8)
    rc = load().png_unfilter(_u8p(raw), raw.size, height, stride, bpp,
                             _u8p(pixels))
    if rc != 0:
        raise CorruptPNG(f"unknown PNG filter type in row {-rc - 1}",
                         in_header=False)
    return pixels


def _decode(data: bytes) -> np.ndarray:
    chunks, idat = _split(data)
    width, height, _, colour, plte = _header(chunks)
    channels = _CHANNELS[colour]
    pixels = _unfiltered(idat, height, width * channels, channels).reshape(
        height, width, channels)
    if colour == 3:
        if plte is None:
            raise CorruptPNG("palette PNG without a PLTE chunk")
        idx = pixels[..., 0]
        if int(idx.max()) >= len(plte):
            raise CorruptPNG(f"palette index {int(idx.max())} past the "
                             f"{len(plte)} PLTE entries", in_header=False)
        return plte[idx]
    if colour == 0:
        return np.repeat(pixels, 3, axis=2)
    if colour == 6:
        return np.ascontiguousarray(pixels[..., :3])
    return pixels


def _chunk(ctype: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(ctype + payload)))


def encode_png(path: str, image: np.ndarray) -> None:
    """Write uint8 [H, W, 3] as an RGB PNG, or uint16 [H, W] as a 16-bit
    gray one (a depth frame): every row filter type 0, deflated at zlib's
    level 6 (PIL's default)."""
    image = np.ascontiguousarray(image)
    if image.dtype == np.uint16 and image.ndim == 2:
        depth, colour = 16, 0
        pixels = image.astype(">u2").view(np.uint8)
    elif image.dtype == np.uint8 and image.ndim == 3 and image.shape[2] == 3:
        depth, colour = 8, 2
        pixels = image
    else:
        raise ValueError(f"encode_png takes uint8 [H, W, 3] or uint16 "
                         f"[H, W], not {image.dtype} {image.shape}")
    h, w = image.shape[:2]
    rows = np.zeros((h, 1 + pixels[0].size), np.uint8)
    rows[:, 1:] = pixels.reshape(h, -1)
    data = (PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour,
                                          0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)


def resize_bilinear(image: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """uint8 [H, W, C] -> uint8 [h, w, C] for `size = (w, h)`, PIL's
    argument order: what `Image.resize(size, Image.BILINEAR)` computes on
    an RGB (C = 3) or gray (C = 1) image, bit for bit."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or min(image.shape) < 1:
        raise ValueError(f"resize_bilinear takes uint8 [H, W, C], not "
                         f"{image.dtype} {image.shape}")
    w, h = (int(v) for v in size)
    if w < 1 or h < 1:
        raise ValueError(f"resize_bilinear to {size}")
    t0 = time.perf_counter()
    out = np.empty((h, w, image.shape[2]), np.uint8)
    load().resize_bilinear_u8(_u8p(image), image.shape[0], image.shape[1],
                              image.shape[2], _u8p(out), h, w)
    _count("resize", t0)
    return out


def resize_bilinear16(image: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """uint16 [H, W] -> uint16 [h, w] for `size = (w, h)`: what
    `Image.resize(size, Image.BILINEAR)` computes on PIL's mode I;16, bit
    for bit."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint16 or image.ndim != 2 or min(image.shape) < 1:
        raise ValueError(f"resize_bilinear16 takes uint16 [H, W], not "
                         f"{image.dtype} {image.shape}")
    w, h = (int(v) for v in size)
    if w < 1 or h < 1:
        raise ValueError(f"resize_bilinear16 to {size}")
    t0 = time.perf_counter()
    out = np.empty((h, w), np.uint16)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    load().resize_bilinear_u16(image.ctypes.data_as(u16p), image.shape[0],
                               image.shape[1], out.ctypes.data_as(u16p), h, w)
    _count("resize", t0)
    return out
