"""The port's own JPEG decoder (``ops/csrc/decode.cpp``) against libjpeg, on the CPU.

The port links no libjpeg; libjpeg is an oracle here only, through PIL
(Pillow 12.1's bundled libjpeg-turbo 3.1) and through the JAX package's
decoder (this box's libjpeg-turbo 2.1.5). The bar is bit-equality, not a
tolerance: both decode with libjpeg-turbo's default settings, whose integer
arithmetic the port follows.

- Every committed fixture in ``tests/golden/torch_jpeg/`` (quality 50, 75
  and 95; 4:4:4, 4:2:2, 4:2:0, and from ``libjpeg_tool.cpp`` 4:4:0 and
  4:1:1; grey; progressive; restart markers; ``keep_rgb``; 16-bit
  quantisation tables; 1 x 1 to 333 x 500) decodes bit-equal to PIL and to
  its committed libjpeg decode (``decodes.npz``, which ``chip_smoke.py``
  holds the card to).
- The features beyond those (``FEATURE_FIXTURES``, committed too): CMYK and
  YCCK (4:2:0 on C and C, as Photoshop writes it), Motion-JPEG frames
  without their Huffman tables, arithmetic coding (sequential and
  progressive, restarts, non-default DAC conditioning), block smoothing of
  incomplete progressive streams, and lossless frames (written here by
  ``lossless_jpeg``: PIL and this box's libjpeg write none). Each decodes
  bit-equal to PIL and its committed decode; its ADM crop equals the JAX
  package's ``decode_center_crop`` (through PIL at the short side, where
  nothing resamples; through the JAX decoder's own resize of PIL's pixels
  at 48 px; and on the bytes themselves where that decoder reads them);
  and it equals this box's libjpeg where that reads it. libjpeg-turbo 2.1.5
  bounds block smoothing's neighbour rows by iMCU row, 3.1 by image block
  row: the two differ where a component is sampled 2 vertically
  (``SMOOTHING_2_1_DIFFERS``), and the port follows 3.1, PIL's.
- Sizes from 1 to 6 pixels a side in every subsampling, where libjpeg
  switches between its triangle filters and plain replication; block
  smoothing after every scan count; the seven lossless predictors.
- The colour-space rule (JFIF, then Adobe's transform flag, then component
  ids) on marker sets edited from PIL's files.
- ``decode_center_crop`` against the JAX package's decoder at 48, 192 and
  288 px: its 8-bit levels bit-equal, its floats within float32's eps
  (1.2e-7, one rounding of a value of order 1). The port
  scales a level v as the JAX transforms do, v / 255 * 2 - 1 (so that the
  service's crops equal the JAX service's, which crops through PIL); the
  JAX decoder, built with ``-march=native``, fuses v * (2 / 255) - 1 into
  one multiply-add, which rounds once less.
- The refusals, each naming itself, where libjpeg's 8-bit decode (PIL)
  refuses too: 12-bit, DNL, hierarchical, lossless arithmetic coding (SOF11),
  2 components, a lossless frame in YCbCr, a Huffman table slot without a
  table and no standard one, a truncated file and a damaged restart marker.
- The service's upload limit: a forged frame header of 65535 x 65535
  pixels is probed without allocating its buffers and refused above
  PIL's decompression-bomb limit, as PIL at its default limit refuses it.
- Decodes from eight threads at once equal the serial ones.

``python tests/test_torch_jpeg.py`` rewrites the fixtures (needs PIL, g++
and libjpeg's headers), after checking that PIL and this box's libjpeg
decode each one to the same bits.
"""
import io
import os
import struct
import subprocess
import sys
import tempfile
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from PIL import Image

from torch_native_build import jax_native as jax_native_built

jax_native_built(required=False)  # before any test reaches make (torch_native_build)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "golden", "torch_jpeg")
DECODES = os.path.join(FIXTURES, "decodes.npz")

# name -> (height, width, how): PIL save options, or ("libjpeg", sampling,
# quality, progressive, arithmetic) for libjpeg_tool.
PIL_FIXTURES = {
    "q50_420_61x77": (61, 77, dict(quality=50, subsampling=2)),
    "q75_422_61x77": (61, 77, dict(quality=75, subsampling=1)),
    "q95_444_61x77": (61, 77, dict(quality=95, subsampling=0)),
    "q75_420_1x1": (1, 1, dict(quality=75, subsampling=2)),
    "q75_420_7x9": (7, 9, dict(quality=75, subsampling=2)),
    "q75_444_7x9": (7, 9, dict(quality=75, subsampling=0)),
    "q75_420_333x500": (333, 500, dict(quality=75, subsampling=2)),
    "progressive_420_333x500": (333, 500, dict(quality=85, progressive=True)),
    "progressive_444_61x77": (61, 77, dict(quality=90, subsampling=0, progressive=True)),
    "grey_61x77": (61, 77, dict(quality=75, mode="L")),
    "grey_progressive_7x9": (7, 9, dict(quality=75, progressive=True, mode="L")),
    "restart_420_61x77": (61, 77, dict(quality=75, restart_marker_blocks=2)),
    "restart_progressive_422_61x77": (61, 77, dict(quality=75, subsampling=1,
                                                   progressive=True, restart_marker_rows=1)),
    "keep_rgb_61x77": (61, 77, dict(quality=90, subsampling=0, keep_rgb=True)),
    "qtables16_61x77": (61, 77, dict(qtables=[[300 + i for i in range(64)],
                                              [400 + i for i in range(64)]])),
}
LIBJPEG_FIXTURES = {
    "s440_61x77": (61, 77, ("12,11,11", 75, 0, 0)),
    "s411_61x77": (61, 77, ("41,11,11", 75, 0, 0)),
    "s440_progressive_61x77": (61, 77, ("12,11,11", 80, 1, 0)),
    "s411_progressive_7x9": (7, 9, ("41,11,11", 80, 1, 0)),
    "arithmetic_61x77": (61, 77, ("22,11,11", 75, 0, 1)),
}
DECODED = sorted(PIL_FIXTURES) + sorted(LIBJPEG_FIXTURES)

# The features past baseline that libjpeg decodes: name -> (height, width,
# picture seed, how), how one of ("pil", save options), ("libjpeg",
# sampling, quality, progressive, arithmetic, *libjpeg_tool options),
# ("lossless", lossless_jpeg options), ("no_dht", fixture: its DHT segments
# dropped) or ("scans", fixture, n: its first n scans).
FEATURE_FIXTURES = {
    "cmyk_444_61x77": (61, 77, 200, ("pil", dict(quality=80, mode="CMYK"))),
    "cmyk_progressive_61x77": (61, 77, 201, ("pil", dict(quality=80, progressive=True,
                                                         mode="CMYK"))),
    "cmyk_arithmetic_422_61x77": (61, 77, 202, ("libjpeg", "21,11,11,21", 75, 0, 1,
                                                "colorspace=cmyk")),
    "ycck_420_61x77": (61, 77, 203, ("libjpeg", "22,11,11,22", 75, 0, 0, "colorspace=ycck")),
    "ycck_progressive_7x9": (7, 9, 204, ("libjpeg", "22,11,11,22", 80, 1, 0,
                                         "colorspace=ycck")),
    "ycck_progressive_420_71x93": (71, 93, 205, ("libjpeg", "22,11,11,22", 80, 1, 0,
                                                 "colorspace=ycck")),
    "mjpeg_420_61x77": (61, 77, 0, ("no_dht", "q50_420_61x77")),
    "mjpeg_grey_61x77": (61, 77, 0, ("no_dht", "grey_61x77")),
    "arithmetic_progressive_420_71x93": (71, 93, 206, ("libjpeg", "22,11,11", 80, 1, 1)),
    "arithmetic_restart_422_61x77": (61, 77, 207, ("libjpeg", "21,11,11", 75, 0, 1,
                                                   "restart=5")),
    "arithmetic_restart_progressive_444_61x77": (61, 77, 208, ("libjpeg", "11,11,11", 85, 1,
                                                               1, "restart=7")),
    "arithmetic_dac_61x77": (61, 77, 209, ("libjpeg", "22,11,11", 75, 0, 1, "dac=2,6,20")),
    "arithmetic_dac_progressive_61x77": (61, 77, 210, ("libjpeg", "22,11,11", 75, 1, 1,
                                                       "dac=1,3,1")),
    "progressive_420_71x93": (71, 93, 211, ("pil", dict(quality=85, progressive=True))),
    "smooth_444_61x77_s1": (61, 77, 0, ("scans", "progressive_444_61x77", 1)),
    "smooth_444_61x77_s3": (61, 77, 0, ("scans", "progressive_444_61x77", 3)),
    "smooth_444_61x77_s6": (61, 77, 0, ("scans", "progressive_444_61x77", 6)),
    "smooth_420_71x93_s1": (71, 93, 0, ("scans", "progressive_420_71x93", 1)),
    "smooth_420_71x93_s2": (71, 93, 0, ("scans", "progressive_420_71x93", 2)),
    "smooth_420_71x93_s5": (71, 93, 0, ("scans", "progressive_420_71x93", 5)),
    "smooth_arithmetic_420_71x93_s2": (71, 93, 0, ("scans", "arithmetic_progressive_420_71x93",
                                                   2)),
    "smooth_arithmetic_420_71x93_s4": (71, 93, 0, ("scans", "arithmetic_progressive_420_71x93",
                                                   4)),
    "smooth_ycck_420_71x93_s3": (71, 93, 0, ("scans", "ycck_progressive_420_71x93", 3)),
    "lossless_p1_61x77": (61, 77, 212, ("lossless", dict(psv=1))),
    "lossless_p2_pt2_61x77": (61, 77, 213, ("lossless", dict(psv=2, pt=2))),
    "lossless_p3_restart_61x77": (61, 77, 214, ("lossless", dict(psv=3, restart_rows=4))),
    "lossless_grey_p4_61x77": (61, 77, 215, ("lossless", dict(psv=4, grey=True))),
    "lossless_420_p5_61x77": (61, 77, 216, ("lossless", dict(
        psv=5, sampling=[(2, 2), (1, 1), (1, 1)]))),
    "lossless_scans_p6_restart_61x77": (61, 77, 217, ("lossless", dict(
        psv=6, interleave=False, restart_rows=3))),
    "lossless_adobe_rgb_p7_pt1_61x77": (61, 77, 218, ("lossless", dict(
        psv=7, pt=1, ids=[82, 71, 66], marker=("adobe", 0)))),
    "lossless_cmyk_p4_61x77": (61, 77, 219, ("lossless", dict(psv=4, cmyk=True))),
}
FEATURES = sorted(FEATURE_FIXTURES)
# Block smoothing's neighbour rows, where a component is sampled 2
# vertically: libjpeg-turbo 2.1.5 (the JAX decoder's) bounds them by iMCU
# row, 3.1 (PIL's, the port's) by image block row.
SMOOTHING_2_1_DIFFERS = {"smooth_420_71x93_s1", "smooth_420_71x93_s2", "smooth_420_71x93_s5",
                         "smooth_arithmetic_420_71x93_s2", "smooth_arithmetic_420_71x93_s4",
                         "smooth_ycck_420_71x93_s3"}


def picture(h: int, w: int, seed: int) -> np.ndarray:
    """Smooth colour fields, an edge and a little noise: what a photo gives
    the entropy coder and the upsampler, deterministic."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    r = 128 + 100 * np.sin(x / (w / 6 + 1) + y / (h / 4 + 1))
    g = 128 + 100 * np.cos(y / (h / 5 + 1)) * np.sin(x / (w / 3 + 1))
    b = 255 * ((x + 2 * y) % 32 < 16)
    a = np.stack([r, g, b], -1) + rng.normal(0, 6, (h, w, 3))
    return np.clip(np.rint(a), 0, 255).astype(np.uint8)


def fixture_path(name: str) -> str:
    return os.path.join(FIXTURES, f"{name}.jpg")


def read(name: str) -> bytes:
    with open(fixture_path(name), "rb") as f:
        return f.read()


def pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def pil_jpeg(a: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(a).convert(kw.pop("mode", "RGB")).save(buf, "JPEG", **kw)
    return buf.getvalue()


def cmyk_picture(h: int, w: int, seed: int) -> np.ndarray:
    """``picture`` with a fourth plane, for CMYK and YCCK streams."""
    a = picture(h, w, seed)
    return np.concatenate([a, 255 - a[..., :1]], -1)


def cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """What PIL makes of libjpeg's CMYK: read inverted (``CMYK;I``), then
    its ``cmyk2rgb``, K' - K' * C' / 255 in 8-bit fixed point."""
    c, k = cmyk[..., :3].astype(np.int64), cmyk[..., 3:].astype(np.int64)
    t = (255 - c) * k + 128
    return np.clip(k - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


# T.81 K.3's DC luminance table, which the lossless writer codes with.
STD_DC_COUNTS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]


class _Bits:
    """Entropy-coded bytes: 0xFF stuffed with 0x00, the last byte padded
    with ones."""

    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.acc, self.n = (self.acc << 1) | ((value >> i) & 1), self.n + 1
            if self.n == 8:
                self.out += b"\xff\x00" if self.acc == 0xFF else bytes([self.acc])
                self.acc = self.n = 0

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def lossless_jpeg(img: np.ndarray, psv: int = 1, pt: int = 0, sampling=None,
                  restart_rows: int = 0, interleave: bool = True, ids=None,
                  marker=None) -> bytes:
    """An 8-bit lossless (SOF3) JPEG of ``img`` (H, W) or (H, W, C), as T.81
    Annex H writes one: each sample (shifted right by the point transform
    ``pt``) less its predictor ``psv``, Huffman-coded with the standard DC
    luminance table. ``sampling``: (h, v) per component, a subsampled one
    taking every (hmax / h, vmax / v)th sample; ``restart_rows``: MCU rows
    per restart interval; ``interleave``: one scan, else one per
    component; ``marker``: "jfif" or ("adobe", transform). Components past
    the image in an MCU repeat its edge."""
    img = np.asarray(img, np.int64)
    img = img[..., None] if img.ndim == 2 else img
    height, width, nc = img.shape
    sampling = sampling or [(1, 1)] * nc
    ids = ids or list(range(1, nc + 1))
    hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
    mcux, mcuy = -(-width // hmax), -(-height // vmax)
    interleave = interleave and nc > 1
    planes = []
    for c, (h, v) in enumerate(sampling):
        dw, dh = -(-width * h // hmax), -(-height * v // vmax)
        plane = img[::vmax // v, ::hmax // h, c][:dh, :dw] >> pt
        pw, ph = (mcux * h, mcuy * v) if interleave else (dw, dh)
        planes.append(np.pad(plane, ((0, ph - dh), (0, pw - dw)), mode="edge"))

    def differences(p, first_rows):
        d = np.empty_like(p)
        for y in range(p.shape[0]):
            for x in range(p.shape[1]):
                if y in first_rows:
                    pred = 1 << (7 - pt) if x == 0 else p[y, x - 1]
                elif x == 0:
                    pred = p[y - 1, 0]
                else:
                    ra, rb, rc = p[y, x - 1], p[y - 1, x], p[y - 1, x - 1]
                    pred = (ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1),
                            rb + ((ra - rc) >> 1), (ra + rb) >> 1)[psv - 1]
                d[y, x] = (p[y, x] - pred) & 0xFFFF
        return np.where(d >= 32768, d - 65536, d)

    codes, code, k = {}, 0, 0
    for length, count in enumerate(STD_DC_COUNTS, 1):
        for _ in range(count):
            codes[k], code, k = (code, length), code + 1, k + 1
        code <<= 1

    def segment(m: int, body: bytes) -> bytes:
        return bytes([0xFF, m]) + struct.pack(">H", len(body) + 2) + body

    out = b"\xff\xd8"
    if marker == "jfif":
        out += segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    elif marker is not None:
        out += segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([marker[1]]))
    out += segment(0xC3, struct.pack(">BHHB", 8, height, width, nc) + b"".join(
        bytes([ids[c], (h << 4) | v, 0]) for c, (h, v) in enumerate(sampling)))
    out += segment(0xC4, bytes([0] + STD_DC_COUNTS + list(range(12))))
    for scan in [list(range(nc))] if interleave else [[c] for c in range(nc)]:
        rows, per_row = (mcuy, mcux) if interleave else planes[scan[0]].shape
        diffs = {}
        for c in scan:
            v = sampling[c][1] if interleave else 1
            diffs[c] = differences(planes[c], {m * v for m in range(rows)
                                               if m % (restart_rows or rows) == 0})
        if restart_rows:
            out += segment(0xDD, struct.pack(">H", restart_rows * per_row))
        out += segment(0xDA, bytes([len(scan)]) + b"".join(bytes([ids[c], 0]) for c in scan)
                       + bytes([psv, 0, pt]))
        bits = _Bits()
        for m in range(rows):
            if restart_rows and m and m % restart_rows == 0:
                out += bits.flush() + bytes([0xFF, 0xD0 + (m // restart_rows - 1) % 8])
                bits = _Bits()
            for col in range(per_row):
                for c in scan:
                    h, v = sampling[c] if interleave else (1, 1)
                    for y in range(v):
                        for x in range(h):
                            d = int(diffs[c][m * v + y, col * h + x])
                            cat = 16 if d == 32768 else abs(d).bit_length()
                            bits.put(*codes[cat])
                            if 0 < cat < 16:
                                bits.put(d if d > 0 else d + (1 << cat) - 1, cat)
        out += bits.flush()
    return out + b"\xff\xd9"


def feature_bytes(name: str, tool: str | None = None, tmp: str | None = None) -> bytes:
    """A feature fixture as ``FEATURE_FIXTURES`` describes it (``tool``: the
    built libjpeg_tool, for those libjpeg writes)."""
    h, w, seed, how = FEATURE_FIXTURES[name]
    kind, args = how[0], how[1:]
    if kind == "pil":
        return pil_jpeg(picture(h, w, seed), **args[0])
    if kind == "libjpeg":
        raw, out = os.path.join(tmp, "in.raw"), os.path.join(tmp, "out.jpg")
        cmyk = any(o.startswith("colorspace=") for o in args[4:])
        (cmyk_picture if cmyk else picture)(h, w, seed).tofile(raw)
        subprocess.run([tool, "encode", raw, str(w), str(h), args[0], *map(str, args[1:4]),
                        out, *args[4:]], check=True)
        with open(out, "rb") as f:
            return f.read()
    if kind == "lossless":
        opts = dict(args[0])
        img = picture(h, w, seed)
        if opts.pop("grey", False):
            img = img[..., 0]
        if opts.pop("cmyk", False):
            img, opts["marker"] = cmyk_picture(h, w, seed), ("adobe", 0)
        return lossless_jpeg(img, **opts)
    if kind == "no_dht":
        return _rebuild(read(args[0]), drop=(0xC4,))
    return _first_scans(read(args[0]), args[1])


@pytest.fixture(scope="module")
def native():
    from jpdvt_mt_ntnu_tpu_torch.ops import native

    return native


@pytest.fixture(scope="module")
def decodes():
    with np.load(DECODES) as z:
        return dict(z)


# ------------------------------------------------------------------ decoding

def test_formats_are_png_and_jpeg_everywhere(native):
    assert native.formats() == ("png", "jpeg")


@pytest.mark.parametrize("name", DECODED)
def test_fixture_decodes_bit_equal_to_pil_and_libjpeg(native, decodes, name):
    data = read(name)
    got = native.decode_rgb(data)
    want = pil_rgb(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, decodes[name])
    assert native.probe(data) == (want.shape[1], want.shape[0])


@pytest.mark.parametrize("sampling", [0, 1, 2], ids=["444", "422", "420"])
@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
def test_small_sizes_bit_equal_to_pil(native, sampling, progressive):
    """1 to 6 pixels a side: libjpeg filters a chroma row more than two
    samples wide and replicates a narrower one."""
    for h in range(1, 7):
        for w in range(1, 7):
            data = pil_jpeg(picture(h, w, h * 7 + w), quality=80, subsampling=sampling,
                            progressive=progressive)
            np.testing.assert_array_equal(native.decode_rgb(data), pil_rgb(data),
                                          err_msg=f"{h}x{w}")


def _segments(data: bytes):
    """The marker segments before the first SOS, and the rest."""
    out, p = [], 2
    while True:
        m, n = data[p + 1], int.from_bytes(data[p + 2:p + 4], "big")
        out.append((m, data[p:p + 2 + n]))
        p += 2 + n
        if m == 0xDA:
            return out, data[p:]


def _rebuild(data: bytes, drop=(), add=b"", adobe_transform=None) -> bytes:
    segs, rest = _segments(data)
    body = b"".join(s[:-1] + bytes([adobe_transform])
                    if m == 0xEE and adobe_transform is not None else s
                    for m, s in segs if m not in drop)
    return b"\xff\xd8" + add + body + rest


def test_colour_space_rule_follows_libjpeg(native):
    """JFIF means YCbCr; else Adobe's transform flag (0: RGB); else the
    component ids ('R', 'G', 'B': RGB)."""
    a = picture(40, 50, 3)
    rgb = pil_jpeg(a, quality=90, subsampling=0, keep_rgb=True)
    ycc = pil_jpeg(a, quality=90, subsampling=0)
    jfif = [s for m, s in _segments(ycc)[0] if m == 0xE0][0]
    adobe = [s for m, s in _segments(rgb)[0] if m == 0xEE][0]
    cases = [_rebuild(rgb, add=jfif), _rebuild(rgb, drop=(0xEE,)),
             _rebuild(rgb, adobe_transform=1), _rebuild(rgb, adobe_transform=2),
             _rebuild(ycc, drop=(0xE0,), add=adobe), _rebuild(ycc, drop=(0xE0,))]
    outs = [native.decode_rgb(d) for d in cases]
    for d, got in zip(cases, outs):
        np.testing.assert_array_equal(got, pil_rgb(d))
    # The rule matters: the same scan read as RGB and as YCbCr differ.
    assert (outs[0] != outs[1]).any()


@pytest.mark.parametrize("size", [48, 192, 288])
def test_center_crop_bit_equal_to_the_jax_decoder(native, size):
    jax_native = jax_native_built()
    assert jax_native.available()  # libjpeg through the JAX package's decoder
    for name in ("q75_420_333x500", "progressive_420_333x500", "q95_444_61x77",
                 "s411_61x77", "grey_61x77"):
        data = read(name)
        mine = native.decode_center_crop(data, size)
        theirs = jax_native.decode_center_crop(data, size)
        np.testing.assert_array_equal(np.rint((mine + 1) * 127.5),
                                      np.rint((theirs + 1) * 127.5), err_msg=name)
        np.testing.assert_allclose(mine, theirs, rtol=0, atol=np.finfo(np.float32).eps)


def test_threads_decode_in_parallel(native):
    """No global state: eight threads at once give the serial results."""
    names = (DECODED + FEATURES) * 2
    serial = [native.decode_rgb(read(n)) for n in names]
    with ThreadPoolExecutor(8) as pool:
        parallel = list(pool.map(lambda n: native.decode_rgb(read(n)), names))
    for n, a, b in zip(names, serial, parallel):
        np.testing.assert_array_equal(a, b, err_msg=n)


# ------------------------------------------------ the features past baseline

def _jax_native_crop(data: bytes, size: int):
    """The JAX package's decoder on the bytes themselves (this box's
    libjpeg), or None where it hands them to PIL."""
    jax_native = jax_native_built()
    out = np.empty((size, size, 3), np.float32)
    return out if jax_native._load().jn_decode_center_crop(data, len(data), size, out) == 0 \
        else None


def _assert_same_crop(mine: np.ndarray, theirs: np.ndarray, name: str) -> None:
    """8-bit levels equal, floats within float32's eps (see the module's
    docstring)."""
    np.testing.assert_array_equal(np.rint((mine + 1) * 127.5), np.rint((theirs + 1) * 127.5),
                                  err_msg=name)
    np.testing.assert_allclose(mine, theirs, rtol=0, atol=np.finfo(np.float32).eps, err_msg=name)


@pytest.mark.parametrize("name", FEATURES)
def test_libjpeg_features_decode_bit_equal(native, decodes, name):
    """CMYK/YCCK, Motion-JPEG, arithmetic coding, block smoothing and
    lossless: the RGB is PIL's (the JAX datasets' decode) and the committed
    decode, and the ADM crop the JAX package's ``decode_center_crop``."""
    jax_native = jax_native_built()
    data = read(name)
    got = native.decode_rgb(data)
    want = pil_rgb(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, decodes[name])
    assert native.probe(data) == (want.shape[1], want.shape[0])
    # At the short side nothing resamples: the JAX package's crop through PIL.
    side = min(want.shape[:2])
    _assert_same_crop(native.decode_center_crop(data, side),
                      jax_native._pil_decode_center_crop(data, side), name)
    # At 48 px the JAX decoder's own resize, of PIL's pixels (as a PNG) and,
    # where that decoder reads the stream itself, of its own decode.
    mine = native.decode_center_crop(data, 48)
    png = io.BytesIO()
    Image.fromarray(want).save(png, "PNG")
    _assert_same_crop(mine, jax_native.decode_center_crop(png.getvalue(), 48), name)
    theirs = _jax_native_crop(data, 48)
    if theirs is not None and name not in SMOOTHING_2_1_DIFFERS:
        _assert_same_crop(mine, theirs, name)


@pytest.fixture(scope="module")
def libjpeg_tool(tmp_path_factory):
    return _tool(str(tmp_path_factory.mktemp("libjpeg_tool")))


@pytest.mark.parametrize("name", [n for n in FEATURES if not n.startswith("lossless")])
def test_features_bit_equal_to_the_system_libjpeg(native, libjpeg_tool, tmp_path, name):
    """This box's libjpeg-turbo 2.1.5 (which reads no lossless frame) gives
    the same pixels (CMYK through PIL's conversion), but for the block
    smoothing rows that 3.1 bounds otherwise."""
    got = native.decode_rgb(read(name))
    theirs = _libjpeg_decode(libjpeg_tool, fixture_path(name), str(tmp_path))
    if name in SMOOTHING_2_1_DIFFERS:
        assert (got != theirs).any(), name
    else:
        np.testing.assert_array_equal(got, theirs)


@pytest.mark.parametrize("sampling", [0, 1, 2], ids=["444", "422", "420"])
def test_block_smoothing_after_every_scan_bit_equal_to_pil(native, sampling):
    """Progressive streams cut after each of their scans, at sizes that
    leave a last iMCU row partly padded and one or two block columns."""
    for h, w in ((9, 17), (17, 9), (23, 41), (40, 33)):
        data = pil_jpeg(picture(h, w, h + w), quality=70, subsampling=sampling,
                        progressive=True)
        for n in range(1, data.count(b"\xff\xda")):
            cut = _first_scans(data, n)
            np.testing.assert_array_equal(native.decode_rgb(cut), pil_rgb(cut),
                                          err_msg=f"{h}x{w}, {n} scans")


@pytest.mark.parametrize("sampling", [0, 1, 2], ids=["444", "422", "420"])
def test_motion_jpeg_frames_take_the_standard_tables(native, sampling):
    """PIL's baseline files use the standard tables: without their DHT
    segments they decode to the same pixels."""
    for h, w in ((7, 9), (61, 77)):
        data = pil_jpeg(picture(h, w, h * w), quality=60, subsampling=sampling)
        bare = _rebuild(data, drop=(0xC4,))
        assert b"\xff\xc4" not in bare[:bare.index(b"\xff\xda")]
        np.testing.assert_array_equal(native.decode_rgb(bare), pil_rgb(bare))
        np.testing.assert_array_equal(native.decode_rgb(bare), native.decode_rgb(data))


@pytest.mark.parametrize("psv", range(1, 8))
def test_lossless_predictors_bit_equal_to_pil(native, psv):
    """Each predictor with point transforms, restarts, subsampling (which a
    lossless frame replicates), one scan or one per component, grey."""
    a = picture(13, 19, psv)
    cases = [lossless_jpeg(a, psv), lossless_jpeg(a, psv, pt=psv % 4, restart_rows=2),
             lossless_jpeg(a[..., 0], psv, pt=1, restart_rows=5),
             lossless_jpeg(a, psv, sampling=[(2, 1), (1, 1), (1, 1)], interleave=False,
                           restart_rows=1),
             lossless_jpeg(a, psv, sampling=[(1, 2), (1, 1), (1, 1)], restart_rows=1),
             lossless_jpeg(a, psv, sampling=[(1, 2), (1, 1), (1, 1)], interleave=False,
                           restart_rows=3)]
    for i, data in enumerate(cases):
        np.testing.assert_array_equal(native.decode_rgb(data), pil_rgb(data), err_msg=str(i))
    # What goes in comes out where nothing is subsampled or shifted.
    np.testing.assert_array_equal(native.decode_rgb(cases[0]), a)


# ------------------------------------------------------------------ refusals

def _with_sof(data: bytes, marker: int | None = None, precision: int | None = None,
              height: int | None = None, width: int | None = None) -> bytes:
    """``data`` with its frame header's marker, precision, height or width changed."""
    i = next(i for i in range(2, len(data)) if data[i] == 0xFF and data[i + 1] in (0xC0, 0xC2))
    b = bytearray(data)
    if marker is not None:
        b[i + 1] = marker
    if precision is not None:
        b[i + 4] = precision
    if height is not None:
        b[i + 5:i + 7] = height.to_bytes(2, "big")
    if width is not None:
        b[i + 7:i + 9] = width.to_bytes(2, "big")
    return bytes(b)


def _first_scans(data: bytes, n: int) -> bytes:
    """A progressive stream cut after its first ``n`` scans, with its EOI."""
    starts = [i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0xDA]
    return data[:starts[n]] + b"\xff\xd9"


def _refusals():
    base = read("q50_420_61x77")
    restart = bytearray(read("restart_420_61x77"))
    rst = next(i for i in range(len(restart) - 1)
               if restart[i] == 0xFF and 0xD0 <= restart[i + 1] <= 0xD7)
    restart[rst + 1] = 0xD5  # RST5 where RST0 belongs
    slot2 = bytearray(_rebuild(base, drop=(0xC4,)))
    slot2[slot2.index(b"\xff\xda") + 6] = 0x22  # the first component's tables: 2 and 2
    lossless = lossless_jpeg(picture(20, 30, 4), 1)
    # (bytes, what the message names, whether libjpeg refuses it too)
    return {
        "12bit": (_with_sof(base, precision=12), "12-bit", True),
        "dnl": (_with_sof(base, height=0), "DNL", True),
        "hierarchical": (_with_sof(base, marker=0xC5), "hierarchical", True),
        "lossless_arithmetic": (lossless.replace(b"\xff\xc3", b"\xff\xcb"), "SOF11", True),
        "two_components": (lossless_jpeg(picture(20, 30, 4)[..., :2], 1), "2-component", True),
        "lossless_ycbcr": (lossless_jpeg(picture(20, 30, 4), 1, marker="jfif"),
                           "lossless JPEG in YCbCr", True),
        "huffman_slot2": (bytes(slot2), "DC Huffman table 2 is not defined", True),
        "truncated": (base[:len(base) // 2], "truncated.*byte offset", False),
        "no_eoi": (base[:-2], "no EOI", False),
        "bad_restart": (bytes(restart), "RST0 at byte offset", False),
    }


@pytest.mark.parametrize("case", ["12bit", "dnl", "hierarchical", "lossless_arithmetic",
                                  "two_components", "lossless_ycbcr", "huffman_slot2",
                                  "truncated", "no_eoi", "bad_restart"])
def test_refused_streams_name_themselves(native, case):
    data, pattern, libjpeg_refuses = _refusals()[case]
    for call in (native.decode_rgb, lambda d: native.decode_center_crop(d, 48)):
        with pytest.raises(ValueError, match=pattern):
            call(data)
    if libjpeg_refuses:  # libjpeg's 8-bit decode, through PIL
        with pytest.raises(OSError):
            pil_rgb(data)


def test_service_refuses_an_upload_above_the_pixel_limit(native, monkeypatch):
    """A few hundred bytes declaring 65535 x 65535 pixels (tens of GB of
    coefficients) are probed without allocating and refused by the
    service from the header."""
    from jpdvt_mt_ntnu_tpu_torch.serve.service import MAX_UPLOAD_PIXELS, PuzzleService

    forged = _with_sof(read("q50_420_61x77"), height=65535, width=65535)
    assert native.probe(forged) == (65535, 65535)
    fake = types.SimpleNamespace(cfg=types.SimpleNamespace(image_size=48))
    with pytest.raises(ValueError, match="65535x65535 pixels, above the limit of 178956970"):
        PuzzleService._prep(fake, forged)
    # PIL at its default limit (the JAX package lifts it) refuses it too.
    monkeypatch.setattr(Image, "MAX_IMAGE_PIXELS", MAX_UPLOAD_PIXELS // 2)
    with pytest.raises(Image.DecompressionBombError):
        pil_rgb(forged)
    # Under the limit the crop is the plain one.
    ok = read("q75_420_333x500")
    np.testing.assert_array_equal(native.decode_center_crop(ok, 48, max_pixels=333 * 500),
                                  native.decode_center_crop(ok, 48))


# ------------------------------------------------------------ regeneration

def _tool(tmp: str) -> str:
    exe = os.path.join(tmp, "libjpeg_tool")
    subprocess.run(["g++", "-O2", "-std=c++17", "-o", exe,
                    os.path.join(FIXTURES, "libjpeg_tool.cpp"), "-ljpeg"], check=True)
    return exe


def _libjpeg_decode(exe: str, path: str, tmp: str) -> np.ndarray:
    """libjpeg's default decode: RGB, or CMYK turned into RGB as PIL does."""
    raw = os.path.join(tmp, "out.raw")
    subprocess.run([exe, "decode", path, raw], check=True)
    with open(raw, "rb") as f:
        w, h, c = np.frombuffer(f.read(12), np.int32)
        px = np.frombuffer(f.read(), np.uint8).reshape(h, w, c)
    return cmyk_to_rgb(px) if c == 4 else px


def regenerate() -> None:
    os.makedirs(FIXTURES, exist_ok=True)
    decoded = {}
    with tempfile.TemporaryDirectory() as tmp:
        exe = _tool(tmp)
        for i, (name, (h, w, kw)) in enumerate(sorted(PIL_FIXTURES.items())):
            with open(fixture_path(name), "wb") as f:
                f.write(pil_jpeg(picture(h, w, i), **kw))
        for i, (name, (h, w, (hv, q, prog, arith))) in enumerate(sorted(LIBJPEG_FIXTURES.items())):
            raw = os.path.join(tmp, "in.raw")
            picture(h, w, 100 + i).tofile(raw)
            subprocess.run([exe, "encode", raw, str(w), str(h), hv, str(q), str(prog),
                            str(arith), fixture_path(name)], check=True)
        derived = ("no_dht", "scans")  # written from the fixtures before them
        for name in sorted(FEATURES, key=lambda n: FEATURE_FIXTURES[n][3][0] in derived):
            data = feature_bytes(name, exe, tmp)
            with open(fixture_path(name), "wb") as f:
                f.write(data)
        for name in DECODED + FEATURES:
            with open(fixture_path(name), "rb") as f:
                want = pil_rgb(f.read())
            if not name.startswith("lossless"):  # which this box's libjpeg cannot read
                same = (want == _libjpeg_decode(exe, fixture_path(name), tmp)).all()
                assert same != (name in SMOOTHING_2_1_DIFFERS), name
            decoded[name] = want
    np.savez_compressed(DECODES, **decoded)
    total = sum(os.path.getsize(os.path.join(FIXTURES, f)) for f in os.listdir(FIXTURES))
    print(f"{len(decoded)} fixtures decoded by PIL, and alike by libjpeg where it reads "
          f"them; {total} bytes")


if __name__ == "__main__":
    sys.exit(regenerate())
