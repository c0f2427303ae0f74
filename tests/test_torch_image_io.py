"""The port's image library (`data/image_io.py`, `csrc/imageio.cc`) against
PIL, which the JAX package decodes and resizes with.

  * `decode_png` equals `Image.open(p).convert("RGB")` bit for bit on PNGs
    written here with a chosen filter type per row (None, Sub, Up,
    Average, Paeth, on the first row and after it, on pixel values that
    tie Paeth's predictors), colour types 0, 2, 3 and 6, the image data
    split over several IDAT chunks, and on PNGs PIL writes;
  * every refused form raises ValueError naming it; a missing file gives
    None, and the loaders' `load_rgb` gives None on exactly the damaged
    files where PIL raises an IOError (a bad CRC before the image data,
    image data cut short or that does not inflate) and PIL's pixels on the
    rest (a bad IDAT or IEND CRC, no IEND, bytes after the image data);
  * `resize_bilinear` equals `Image.resize(size, Image.BILINEAR)` bit for
    bit: the loaders' 640x480 -> 341x256 and 1920x1080 -> 455x256,
    `crop_by_intrinsic`'s 7-Scenes ratio (640x480 -> 713x534 and back),
    the NetVLAD input 192x256, upscales and odd small sizes, RGB and gray;
  * `encode_png` round-trips through PIL;
  * depth frames: `decode_gray_png` equals `np.asarray(Image.open(p))`
    on 16-bit and 8-bit gray PNGs (every filter pattern, several IDAT
    chunks, PNGs PIL writes), `resize_bilinear16` equals PIL's BILINEAR
    resize of mode I;16 at the sizes above, and the port's
    `SevenScenes.load_depth` gives the JAX loader's result (PIL inside)
    on the same files: the depth in metres with 65535 -> 0 after the
    resize, None where PIL's `Image.open` fails, an exception where PIL
    fails on the pixels, over the damaged files of the colour rule made
    16-bit.

Tolerance: none, every comparison is exact.
"""

import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from relpose_gnn_tpu_torch.data import image_io
from relpose_gnn_tpu_torch.data import transforms as T

COLOUR_CHANNELS = {0: 1, 2: 3, 3: 1, 6: 4}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _filter_rows(pixels, filters):
    """The PNG encoder's side of the five filters, row by row in Python:
    uint8 [H, W, C] and one filter type per row -> the filtered bytes."""
    h = pixels.shape[0]
    rows = pixels.reshape(h, -1).astype(np.int64)
    bpp = pixels.shape[2]
    out = bytearray()
    for r in range(h):
        cur = rows[r]
        up = rows[r - 1] if r else np.zeros_like(cur)
        f = filters[r]
        line = []
        for i in range(len(cur)):
            a = cur[i - bpp] if i >= bpp else 0
            b = up[i]
            c = up[i - bpp] if i >= bpp else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[f]
            line.append((cur[i] - pred) % 256)
        out += bytes([f]) + bytes(line)
    return bytes(out)


def _chunk(ctype, payload):
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(ctype + payload)))


def write_png(path, pixels, filters, colour, idat_splits=1, palette=None,
              depth=8, interlace=0):
    """A PNG of `pixels` (uint8 [H, W, C]) with the given row filters,
    its deflated data cut into `idat_splits` IDAT chunks."""
    h, w = pixels.shape[:2]
    data = zlib.compress(_filter_rows(pixels, filters))
    cuts = np.linspace(0, len(data), idat_splits + 1).astype(int)
    body = _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0,
                                       0, interlace))
    if palette is not None:
        body += _chunk(b"PLTE", palette.tobytes())
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        body += _chunk(b"IDAT", data[lo:hi])
    with open(path, "wb") as f:
        f.write(image_io.PNG_SIGNATURE + body + _chunk(b"IEND", b""))


def _pil_rgb(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


PATTERNS = {
    # one filter type on every row, the first row included
    **{f"all-{f}": (lambda h, f=f: [f] * h) for f in range(5)},
    "cycle": lambda h: [r % 5 for r in range(h)],
    "reverse-cycle": lambda h: [4 - r % 5 for r in range(h)],
    "random": lambda h: list(np.random.default_rng(h).integers(0, 5, h)),
}


def _pixels(colour, values, seed, h=11, w=9):
    """uint8 [h, w, C] for `colour`; 'ties' draws from {0, 1, 2, 3}, where
    Paeth's three distances tie often, 'full' from all of 0..255."""
    rng = np.random.default_rng(seed)
    hi = 4 if values == "ties" else 256
    return rng.integers(0, hi, (h, w, COLOUR_CHANNELS[colour]),
                        dtype=np.uint8)


@pytest.mark.parametrize("values", ["full", "ties"])
@pytest.mark.parametrize("pattern", list(PATTERNS))
@pytest.mark.parametrize("colour", [0, 2, 3, 6])
def test_decode_equals_pil_for_every_filter_pattern(tmp_path, colour,
                                                    pattern, values):
    pixels = _pixels(colour, values, seed=colour)
    palette = None
    if colour == 3:
        palette = np.random.default_rng(7).integers(0, 256, (256, 3),
                                                    dtype=np.uint8)
    path = str(tmp_path / "f.png")
    write_png(path, pixels, PATTERNS[pattern](pixels.shape[0]), colour,
              idat_splits=3, palette=palette)
    got = image_io.decode_png(path)
    assert got.dtype == np.uint8 and got.shape == (11, 9, 3)
    np.testing.assert_array_equal(got, _pil_rgb(path))


@pytest.mark.parametrize("mode,shape", [("RGB", (48, 64, 3)),
                                        ("L", (37, 29)),
                                        ("RGBA", (33, 40, 4)),
                                        ("P", (41, 35, 3)),
                                        ("RGB", (480, 640, 3))])
def test_decode_equals_pil_on_pngs_pil_writes(tmp_path, mode, shape):
    """PIL picks its own filters per row (and one IDAT or several)."""
    rng = np.random.default_rng(len(shape) + shape[0])
    arr = rng.integers(0, 256, shape, dtype=np.uint8)
    img = Image.fromarray(arr)
    if mode == "P":
        img = img.convert("P", palette=Image.ADAPTIVE, colors=97)
    path = str(tmp_path / f"{mode}.png")
    img.save(path)
    np.testing.assert_array_equal(image_io.decode_png(path), _pil_rgb(path))
    assert T.load_rgb(path) is not None


def _valid_png(tmp_path):
    path = str(tmp_path / "ok.png")
    write_png(path, _pixels(2, "full", 0), [1] * 11, 2)
    return bytearray(Path(path).read_bytes())


def _refused(tmp_path, case):
    """(bytes of a refused file, the pattern its ValueError must name,
    whether it counts as corrupt)."""
    data = _valid_png(tmp_path)
    if case == "interlaced":
        path = str(tmp_path / "i.png")
        write_png(path, _pixels(2, "full", 0), [0] * 11, 2, interlace=1)
        return Path(path).read_bytes(), "interlaced", False
    if case == "16-bit":
        path = str(tmp_path / "d.png")
        write_png(path, _pixels(2, "full", 0), [0] * 11, 2, depth=16)
        return Path(path).read_bytes(), "16-bit RGB", False
    if case == "gray+alpha":
        path = str(tmp_path / "ga.png")
        write_png(path, _pixels(0, "full", 0).repeat(2, axis=2), [0] * 11,
                  4)
        return Path(path).read_bytes(), "gray \\+ alpha", False
    if case == "jpeg":
        return b"\xff\xd8\xff\xe0" + bytes(data[4:]), "JPEG", False
    if case == "signature":
        data[1] = ord("Q")
        return bytes(data), "signature", True
    if case == "crc":
        data[8 + 8 + 13] ^= 0xFF   # a byte of IHDR's CRC (PIL checks
        return bytes(data), "CRC", True   # those before the image data)
    if case == "truncated":
        return bytes(data[:len(data) // 2]), "truncated", True
    if case == "filter-type":
        path = str(tmp_path / "ft.png")
        pixels = _pixels(2, "full", 0)
        raw = bytearray(_filter_rows(pixels, [0] * 11))
        raw[3 * (1 + 9 * 3)] = 9    # row 3's filter byte
        body = (_chunk(b"IHDR", struct.pack(">IIBBBBB", 9, 11, 8, 2, 0, 0,
                                            0))
                + _chunk(b"IDAT", zlib.compress(bytes(raw)))
                + _chunk(b"IEND", b""))
        return image_io.PNG_SIGNATURE + body, "filter type in row 3", True
    raise ValueError(case)


REFUSED = ["interlaced", "16-bit", "gray+alpha", "jpeg", "signature", "crc",
           "truncated", "filter-type"]


@pytest.mark.parametrize("case", REFUSED)
def test_refused_forms_raise(tmp_path, case):
    data, match, corrupt = _refused(tmp_path, case)
    path = tmp_path / "bad.png"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=match) as err:
        image_io.decode_png(str(path))
    assert isinstance(err.value, image_io.CorruptPNG) == corrupt
    # the loaders skip a corrupt frame, as they did on PIL's IOError, and
    # raise on a form the port refuses to decode
    if corrupt:
        assert T.load_rgb(str(path)) is None
    else:
        with pytest.raises(ValueError, match=match):
            T.load_rgb(str(path))


def _corrupt_variants(pixels=None, colour=2, depth=8):
    """{name: PNG bytes} of damaged files, each with the pixels of
    `_pixels(2, "full", 0)` (or `pixels`, uint8 [H, W, bytes a pixel],
    of `colour` at `depth`) where it still decodes: PIL checks the CRCs
    of the chunks before the image data only, reads the IDAT chunks that
    follow in a row, and stops inflating at the image's last row."""
    if pixels is None:
        pixels = _pixels(2, "full", 0)
    h, w = pixels.shape[:2]
    rows = _filter_rows(pixels, [1] * h)
    z = zlib.compress(rows)
    ihdr = _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0,
                                       0, 0))

    def chunk(ctype, payload, crc=None):
        good = _chunk(ctype, payload)
        return good if crc is None else good[:-4] + struct.pack(">I", crc)

    end = _chunk(b"IEND", b"")
    sig = image_io.PNG_SIGNATURE
    bad_adler = z[:-4] + bytes(b ^ 0xFF for b in z[-4:])
    return {
        "bad IDAT CRC": sig + ihdr + chunk(b"IDAT", z, 1) + end,
        "bad second IDAT CRC": (sig + ihdr + chunk(b"IDAT", z[:10])
                                + chunk(b"IDAT", z[10:], 1) + end),
        "bad IEND CRC": sig + ihdr + chunk(b"IDAT", z) + chunk(b"IEND", b"",
                                                                7),
        "bad CRC after the image data": (sig + ihdr + chunk(b"IDAT", z)
                                         + chunk(b"tEXt", b"a\0b", 7) + end),
        "bad CRC of an ancillary chunk before it": (
            sig + ihdr + chunk(b"tEXt", b"a\0b", 7) + chunk(b"IDAT", z)
            + end),
        "bad CRC of an unknown chunk before it": (
            sig + ihdr + chunk(b"zzZz", b"abc", 7) + chunk(b"IDAT", z) + end),
        "no IEND": sig + ihdr + chunk(b"IDAT", z),
        "no IEND and no IDAT CRC": sig + ihdr + chunk(b"IDAT", z)[:-4],
        "cut inside the image data": (sig + ihdr + chunk(b"IDAT", z))[:-20],
        "bytes after IEND": sig + ihdr + chunk(b"IDAT", z) + end + b"xyz",
        "bytes after the image data": sig + ihdr + chunk(b"IDAT", z) + b"xyz",
        "too few rows inflate": (sig + ihdr
                                 + chunk(b"IDAT", zlib.compress(rows[:-5]))
                                 + end),
        "more rows inflate": (sig + ihdr
                              + chunk(b"IDAT", zlib.compress(rows + b"12345"))
                              + end),
        "bad deflate data": (sig + ihdr
                             + chunk(b"IDAT", b"\x78\x9c" + b"\xff" * 30)
                             + end),
        "bad Adler-32 after the last row": (sig + ihdr
                                            + chunk(b"IDAT", bad_adler) + end),
        "data after the deflate stream": (sig + ihdr
                                          + chunk(b"IDAT", z + b"junk") + end),
        "IEND before the image data": (sig + ihdr + end
                                       + chunk(b"IDAT", z)),
    }


@pytest.mark.parametrize("case", list(_corrupt_variants()))
def test_load_rgb_skips_exactly_where_pil_fails(tmp_path, case):
    """The JAX loaders skip a frame where PIL raises an IOError; the
    port's `load_rgb` gives None on the same files and the same pixels on
    the rest, so the two packages' stores hold the same frames."""
    path = tmp_path / "damaged.png"
    path.write_bytes(_corrupt_variants()[case])
    try:
        want = _pil_rgb(str(path))
    except OSError:
        want = None
    got = T.load_rgb(str(path))
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(want, _pixels(2, "full", 0))
        np.testing.assert_array_equal(got, want)


def test_missing_file_gives_none(tmp_path):
    assert image_io.decode_png(str(tmp_path / "missing.png")) is None
    assert T.load_rgb(str(tmp_path / "missing.png")) is None


RESIZES = [
    ((480, 640), (341, 256)),     # 7-Scenes frame -> Resize(256)
    ((1080, 1920), (455, 256)),   # Cambridge frame -> Resize(256)
    ((480, 640), (713, 534)),     # crop_by_intrinsic: 585 / 525
    ((480, 640), (256, 192)),     # NetVLAD input
    ((534, 713), (256, 192)),
    ((40, 32), (256, 192)),       # upscales
    ((32, 40), (341, 256)),
    ((5, 7), (13, 11)),
    ((7, 5), (3, 2)),             # odd small sizes
    ((13, 17), (17, 13)),
    ((1, 1), (4, 3)),
    ((3, 9), (9, 1)),
    ((37, 37), (20, 37)),         # one axis only
    ((37, 37), (37, 20)),
    ((20, 30), (30, 20)),         # the same size: a copy
]


@pytest.mark.parametrize("channels", [3, 1])
@pytest.mark.parametrize("src,size", RESIZES)
def test_resize_equals_pil_bilinear(src, size, channels):
    rng = np.random.default_rng(src[0] * 7 + size[0])
    img = rng.integers(0, 256, (*src, channels), dtype=np.uint8)
    pil = Image.fromarray(img[..., 0] if channels == 1 else img)
    want = np.asarray(pil.resize(size, Image.BILINEAR)).reshape(
        size[1], size[0], channels)
    got = image_io.resize_bilinear(img, size)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_resize_of_smooth_frames_equals_pil():
    """Smooth content, where the fixed-point rounding sits on the .5
    boundaries more often than on noise."""
    y, x = np.mgrid[0:480, 0:640]
    img = np.stack([(x * 255 // 639), (y * 255 // 479),
                    ((x + y) // 5) % 256], -1).astype(np.uint8)
    for size in ((341, 256), (713, 534), (256, 192), (1280, 960)):
        np.testing.assert_array_equal(
            image_io.resize_bilinear(img, size),
            np.asarray(Image.fromarray(img).resize(size, Image.BILINEAR)))


@pytest.mark.parametrize("shape", [(21, 34, 3), (1, 7, 3), (33, 1, 3),
                                   (480, 640, 3)])
def test_encode_round_trips_through_pil(tmp_path, shape):
    img = np.random.default_rng(shape[0]).integers(0, 256, shape,
                                                   dtype=np.uint8)
    path = str(tmp_path / "e.png")
    image_io.encode_png(path, img)
    with Image.open(path) as im:
        assert im.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(im), img)
    np.testing.assert_array_equal(image_io.decode_png(path), img)


def test_encode_16bit_gray_round_trips_through_pil(tmp_path):
    d, _ = _depth16(11, 48, 64)
    path = str(tmp_path / "d.png")
    image_io.encode_png(path, d)
    with Image.open(path) as im:
        assert im.mode == "I;16"
        np.testing.assert_array_equal(np.asarray(im), d)
    np.testing.assert_array_equal(image_io.decode_gray_png(path), d)


def test_bad_arguments_raise():
    for bad in (np.zeros((4, 4, 3), np.float32), np.zeros((4, 4), np.uint8),
                np.zeros((0, 4, 3), np.uint8)):
        with pytest.raises(ValueError, match="resize_bilinear takes"):
            image_io.resize_bilinear(bad, (2, 2))
    with pytest.raises(ValueError, match="resize_bilinear to"):
        image_io.resize_bilinear(np.zeros((4, 4, 3), np.uint8), (0, 2))
    for bad in (np.zeros((4, 4, 3), np.float32), np.zeros((4, 4, 4),
                                                          np.uint8)):
        with pytest.raises(ValueError, match="encode_png takes"):
            image_io.encode_png("x.png", bad)


def test_library_builds_into_the_ports_build_dir():
    lib = image_io.load()
    path = image_io._build.host_library_path("imageio")
    assert lib is image_io.load() and path.is_file()
    assert path.parent.name == "_build"
    assert path.parent.parent.name == "relpose_gnn_tpu_torch"


def test_counts_frames_and_seconds(tmp_path):
    """`COUNTS` adds one frame and its seconds per decode and per resize
    since `reset_counts()`, and nothing for a file that cannot be read."""
    path = str(tmp_path / "ok.png")
    write_png(path, _pixels(2, "full", 0), [1] * 11, 2)
    image_io.reset_counts()
    frame = image_io.decode_png(path)
    image_io.decode_png(str(tmp_path / "missing.png"))
    image_io.resize_bilinear(frame, (5, 4))
    image_io.resize_bilinear(frame, (3, 2))
    (n_dec, t_dec), (n_res, t_res) = (image_io.COUNTS["decode"],
                                      image_io.COUNTS["resize"])
    assert (n_dec, n_res) == (1, 2) and t_dec > 0 and t_res > 0
    image_io.reset_counts()
    assert image_io.COUNTS == {"decode": [0, 0.0], "resize": [0, 0.0]}


# ---------------------------------------------------------------------------
# depth frames: 16-bit (and 8-bit) gray
# ---------------------------------------------------------------------------


def _depth16(seed, h=11, w=9):
    """uint16 [h, w] depths in mm, some invalid (65535), and its PNG
    bytes a pixel (big-endian) as uint8 [h, w, 2]."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 8000, (h, w)).astype(np.uint16)
    d[rng.random((h, w)) < 0.1] = 65535
    return d, d.astype(">u2").view(np.uint8).reshape(h, w, 2)


@pytest.mark.parametrize("pattern", list(PATTERNS))
@pytest.mark.parametrize("depth", [16, 8])
def test_decode_gray_equals_pil_for_every_filter_pattern(tmp_path, depth,
                                                         pattern):
    if depth == 16:
        want, pixels = _depth16(3)
    else:
        pixels = _pixels(0, "full", 3)
        want = pixels[..., 0]
    path = str(tmp_path / "d.png")
    write_png(path, pixels, PATTERNS[pattern](pixels.shape[0]), 0,
              idat_splits=3, depth=depth)
    got = image_io.decode_gray_png(path)
    with Image.open(path) as im:
        assert im.mode == ("I;16" if depth == 16 else "L")
        pil = np.asarray(im)
    assert got.dtype == pil.dtype and got.shape == (11, 9)
    np.testing.assert_array_equal(got, pil)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(480, 640), (37, 29), (1, 5)])
def test_decode_gray_equals_pil_on_pngs_pil_writes(tmp_path, shape):
    d = np.random.default_rng(shape[0]).integers(0, 65536, shape).astype(
        np.uint16)
    path = str(tmp_path / "d.png")
    Image.fromarray(d).save(path)
    np.testing.assert_array_equal(image_io.decode_gray_png(path), d)


def test_decode_gray_refuses_colour_and_reads_none_where_missing(tmp_path):
    path = str(tmp_path / "c.png")
    write_png(path, _pixels(2, "full", 0), [0] * 11, 2)
    with pytest.raises(ValueError, match="refused here"):
        image_io.decode_gray_png(path)
    assert image_io.decode_gray_png(str(tmp_path / "missing.png")) is None


@pytest.mark.parametrize("src,size", RESIZES)
def test_resize16_equals_pil_bilinear(src, size):
    rng = np.random.default_rng(src[0] * 7 + size[0])
    img = rng.integers(0, 65536, src).astype(np.uint16)
    img[rng.random(src) < 0.1] = 65535
    want = np.asarray(Image.fromarray(img).resize(size, Image.BILINEAR))
    got = image_io.resize_bilinear16(img, size)
    assert got.dtype == np.uint16 and got.shape == (size[1], size[0])
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="resize_bilinear16 takes"):
        image_io.resize_bilinear16(img.astype(np.uint8), size)


def _load_depth(module, path, image_size):
    """`SevenScenes.load_depth` of the JAX package or the port on one
    file: ("ok", depth), ("none",) or ("raises",)."""
    import types
    ds = types.SimpleNamespace(d_imgs=[path], image_size=image_size)
    try:
        out = module.SevenScenes.load_depth(ds, 0)
    except Exception:  # noqa: BLE001 - either package's failure
        return ("raises",)
    return ("none",) if out is None else ("ok", out)


@pytest.mark.parametrize("image_size", [256, 6])
@pytest.mark.parametrize("kind", ["16-bit", "8-bit"])
def test_load_depth_equals_the_jax_loader(tmp_path, kind, image_size):
    """640x480 -> 341x256 (the loaders' size) and a downscale to 6 rows;
    the 65535 rule after the resize."""
    from relpose_gnn_tpu.data import seven_scenes as jax_7s
    from relpose_gnn_tpu_torch.data import seven_scenes
    rng = np.random.default_rng(5)
    d = rng.integers(500, 4000, (480, 640)).astype(np.uint16)
    d[100:300, 200:260] = 65535
    if kind == "8-bit":
        d = (d // 16).astype(np.uint8)
    path = str(tmp_path / "frame-000000.depth.png")
    Image.fromarray(d).save(path)
    got = _load_depth(seven_scenes, path, image_size)
    want = _load_depth(jax_7s, path, image_size)
    assert got[0] == want[0] == "ok"
    assert got[1].dtype == want[1].dtype == np.float32
    np.testing.assert_array_equal(got[1], want[1])
    if kind == "16-bit" and image_size == 256:
        assert got[1].shape == (256, 341) and (got[1] == 0).any()


@pytest.mark.parametrize("case", list(_corrupt_variants()))
def test_load_depth_follows_pil_on_damaged_16bit_files(tmp_path, case):
    """The JAX depth loader gives None where PIL's `Image.open` fails and
    raises where PIL fails reading the pixels; the port does the same on
    the same damaged 16-bit files, and gives PIL's depths on the rest."""
    from relpose_gnn_tpu.data import seven_scenes as jax_7s
    from relpose_gnn_tpu_torch.data import seven_scenes
    _, pixels = _depth16(7)
    path = str(tmp_path / "damaged.depth.png")
    Path(path).write_bytes(_corrupt_variants(pixels, 0, 16)[case])
    got = _load_depth(seven_scenes, path, 6)
    want = _load_depth(jax_7s, path, 6)
    assert got[0] == want[0], (got[0], want[0])
    if want[0] == "ok":
        np.testing.assert_array_equal(got[1], want[1])
