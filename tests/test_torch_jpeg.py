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
- Sizes from 1 to 6 pixels a side in every subsampling, where libjpeg
  switches between its triangle filters and plain replication.
- The colour-space rule (JFIF, then Adobe's transform flag, then component
  ids) on marker sets edited from PIL's files.
- ``decode_center_crop`` against the JAX package's decoder at 48, 192 and
  288 px: its 8-bit levels bit-equal, its floats within float32's eps
  (1.2e-7, one rounding of a value of order 1). The port
  scales a level v as the JAX transforms do, v / 255 * 2 - 1 (so that the
  service's crops equal the JAX service's, which crops through PIL); the
  JAX decoder, built with ``-march=native``, fuses v * (2 / 255) - 1 into
  one multiply-add, which rounds once less.
- The refusals, each naming itself: arithmetic coding, CMYK, lossless,
  12-bit, DNL, unrefined progressive coefficients (libjpeg's block
  smoothing), a truncated file and a damaged restart marker.
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
import subprocess
import sys
import tempfile
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from PIL import Image

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
}
REFUSED_FIXTURES = {"arithmetic_61x77": (61, 77, ("22,11,11", 75, 0, 1))}
DECODED = sorted(PIL_FIXTURES) + sorted(LIBJPEG_FIXTURES)


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
    from jpdvt_mt_ntnu_tpu.ops import native as jax_native

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
    names = DECODED * 3
    serial = [native.decode_rgb(read(n)) for n in names]
    with ThreadPoolExecutor(8) as pool:
        parallel = list(pool.map(lambda n: native.decode_rgb(read(n)), names))
    for n, a, b in zip(names, serial, parallel):
        np.testing.assert_array_equal(a, b, err_msg=n)


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


def _refusals(native):
    base = read("q50_420_61x77")
    cmyk = io.BytesIO()
    Image.fromarray(picture(20, 30, 4)).convert("CMYK").save(cmyk, "JPEG")
    restart = bytearray(read("restart_420_61x77"))
    rst = next(i for i in range(len(restart) - 1)
               if restart[i] == 0xFF and 0xD0 <= restart[i + 1] <= 0xD7)
    restart[rst + 1] = 0xD5  # RST5 where RST0 belongs
    return {
        "arithmetic": (read("arithmetic_61x77"), native.NotPortedError, "arithmetic"),
        "cmyk": (cmyk.getvalue(), native.NotPortedError, "CMYK/YCCK"),
        "lossless": (_with_sof(base, marker=0xC3), native.NotPortedError, "lossless"),
        "12bit": (_with_sof(base, precision=12), ValueError, "12-bit"),
        "dnl": (_with_sof(base, height=0), ValueError, "DNL"),
        "unrefined_progressive": (_first_scans(read("progressive_444_61x77"), 3),
                                  native.NotPortedError, "block smoothing"),
        "truncated": (base[:len(base) // 2], ValueError, "truncated.*byte offset"),
        "no_eoi": (base[:-2], ValueError, "no EOI"),
        "bad_restart": (bytes(restart), ValueError, "RST0 at byte offset"),
    }


@pytest.mark.parametrize("case", ["arithmetic", "cmyk", "lossless", "12bit", "dnl",
                                  "unrefined_progressive", "truncated", "no_eoi",
                                  "bad_restart"])
def test_refused_streams_name_themselves(native, case):
    data, error, pattern = _refusals(native)[case]
    for call in (native.decode_rgb, lambda d: native.decode_center_crop(d, 48)):
        with pytest.raises(error, match=pattern) as info:
            call(data)
        if error is ValueError:  # libjpeg refuses these too: not "not ported"
            assert not isinstance(info.value, native.NotPortedError)
    if case in ("arithmetic", "cmyk", "unrefined_progressive"):
        pil_rgb(data)  # which libjpeg (through PIL) decodes


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
    raw = os.path.join(tmp, "out.raw")
    subprocess.run([exe, "decode", path, raw], check=True)
    with open(raw, "rb") as f:
        w, h = np.frombuffer(f.read(8), np.int32)
        return np.frombuffer(f.read(), np.uint8).reshape(h, w, 3)


def regenerate() -> None:
    os.makedirs(FIXTURES, exist_ok=True)
    decoded = {}
    with tempfile.TemporaryDirectory() as tmp:
        exe = _tool(tmp)
        for i, (name, (h, w, kw)) in enumerate(sorted(PIL_FIXTURES.items())):
            with open(fixture_path(name), "wb") as f:
                f.write(pil_jpeg(picture(h, w, i), **kw))
        for i, (name, (h, w, (hv, q, prog, arith))) in enumerate(
                sorted({**LIBJPEG_FIXTURES, **REFUSED_FIXTURES}.items())):
            raw = os.path.join(tmp, "in.raw")
            picture(h, w, 100 + i).tofile(raw)
            subprocess.run([exe, "encode", raw, str(w), str(h), hv, str(q), str(prog),
                            str(arith), fixture_path(name)], check=True)
        for name in DECODED:
            with open(fixture_path(name), "rb") as f:
                want = pil_rgb(f.read())
            assert (want == _libjpeg_decode(exe, fixture_path(name), tmp)).all(), name
            decoded[name] = want
    np.savez_compressed(DECODES, **decoded)
    total = sum(os.path.getsize(os.path.join(FIXTURES, f)) for f in os.listdir(FIXTURES))
    print(f"{len(decoded)} fixtures decoded alike by PIL and libjpeg; {total} bytes")


if __name__ == "__main__":
    sys.exit(regenerate())
