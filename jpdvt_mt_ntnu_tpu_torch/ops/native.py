"""ctypes bindings of the port's host code: assignment solvers and image decode.

Counterpart of ``jpdvt_mt_ntnu_tpu/ops/native.py``. ``csrc/assignment.cpp``
(the port's copy of ``native/src/assignment.cpp``) and ``csrc/decode.cpp``
(of ``native/src/decode.cpp``) are built with ``g++`` into ``_build/`` at
first use by ``ops/_build.py``. There is no fallback: a failed build
raises, and so does a format the decoder does not take. No PIL is used.

Decode: the PNG container is read here (chunks, CRCs, zlib, palette) for
8-bit, non-interlaced images, which is what the service's page and its
own writer send; the scanline filters and the ADM center crop run in C.
:func:`decode_rgb` returns the whole RGB image (the datasets' decode),
:func:`decode_center_crop` the ADM crop (the service's and the eval
harness's).
JPEG is decoded by the port's own decoder in ``csrc/decode.cpp``, bit-equal
to libjpeg-turbo's default decode (baseline, extended sequential and
progressive Huffman streams), on every machine: no libjpeg is linked. A
stream it does not take and truncated or corrupt data raise ``ValueError``
naming the feature or the byte offset; :class:`NotPortedError`, a
``ValueError``, marks the features that libjpeg decodes and the port does
not yet (arithmetic coding, lossless, CMYK/YCCK, block smoothing), so that
a dataset fails loudly on them instead of treating them as a corrupt file.
:func:`decode_center_crop`'s ``max_pixels`` refuses, from the header
alone, an image that declares more pixels (the service's uploads); the
datasets set none, as the reference's datasets lift PIL's limit for real
scans above it.
"""

from __future__ import annotations

import ctypes
import functools
import struct
import zlib

import numpy as np

from . import _build

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_JPEG_SOI = b"\xff\xd8\xff"
# PNG colour type -> channels at 8 bits (3, a palette, is expanded to RGB).
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


class NotPortedError(ValueError):
    """A JPEG feature that libjpeg decodes and the port's decoder does not."""


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("assignment")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    for fn in (lib.jp_greedy_batch, lib.jp_hungarian_batch):
        fn.argtypes = [f32p, ctypes.c_int, ctypes.c_int, i32p]
        fn.restype = None
    return lib


def _solve(fn_name: str, dist) -> np.ndarray:
    d = np.ascontiguousarray(np.asarray(dist, dtype=np.float32))
    if d.ndim < 2 or d.shape[-1] != d.shape[-2]:
        raise ValueError(f"distances must be (..., P, P); got {d.shape}")
    lead, n = d.shape[:-2], d.shape[-1]
    flat = d.reshape(-1, n, n)
    out = np.empty(flat.shape[:2], dtype=np.int32)
    getattr(_lib(), fn_name)(flat, flat.shape[0], n, out)
    return out.reshape(*lead, n)


def greedy_permutation(dist) -> np.ndarray:
    """(..., P, P) float distances -> (..., P) int32 slot per piece: the
    greedy column scan (``assignment.greedy_permutation``'s result)."""
    return _solve("jp_greedy_batch", dist)


def hungarian_permutation(dist) -> np.ndarray:
    """(..., P, P) float distances -> (..., P) int32 slot per piece of least
    total distance (the optimal assignment)."""
    return _solve("jp_hungarian_batch", dist)


@functools.cache
def _decode_lib() -> ctypes.CDLL:
    lib = _build.load("decode")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.jp_formats.argtypes = []
    lib.jp_png_unfilter.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int, u8p]
    lib.jp_center_crop.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, f32p]
    msg = [ctypes.c_char_p, ctypes.c_int]  # the error message's buffer
    lib.jp_jpeg_center_crop.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
                                        f32p, *msg]
    lib.jp_jpeg_probe.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                  ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                                  *msg]
    lib.jp_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
                                   ctypes.c_int, u8p, *msg]
    for fn in (lib.jp_formats, lib.jp_png_unfilter, lib.jp_center_crop,
               lib.jp_jpeg_center_crop, lib.jp_jpeg_probe, lib.jp_jpeg_decode):
        fn.restype = ctypes.c_int
    return lib


def formats() -> tuple[str, ...]:
    """The formats the decoder takes: ``("png", "jpeg")`` on every machine."""
    bits = _decode_lib().jp_formats()
    return tuple(name for bit, name in ((1, "png"), (2, "jpeg")) if bits & bit)


def _jpeg_call(fn_name: str, data: bytes, *args) -> int:
    """Call a JPEG entry point; raise with its message on -1, -8 and -9."""
    buf = ctypes.create_string_buffer(256)
    rc = getattr(_decode_lib(), fn_name)(data, len(data), *args, buf, len(buf))
    if rc in (-1, -8, -9):
        error = NotPortedError if rc == -9 else ValueError
        raise error(f"{buf.value.decode(errors='replace')} (native decoder)")
    return rc


def _png_chunks(data: bytes):
    """(type, body) of each chunk, the CRCs checked."""
    pos = len(PNG_SIGNATURE)
    while pos + 12 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError("PNG truncated (native decoder)")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC (native decoder)")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG has no IEND chunk (native decoder)")


def _png_header(data: bytes) -> tuple[int, int, int, int, int]:
    if data[:8] != PNG_SIGNATURE or data[12:16] != b"IHDR":
        raise ValueError("not a PNG (native decoder)")
    return struct.unpack(">IIBBxxB", data[16:29])


def png_pixels(data: bytes) -> np.ndarray:
    """An 8-bit, non-interlaced PNG -> (H, W, C) uint8: C = 1 grey, 2 grey
    + alpha, 3 RGB (palette images too), 4 RGBA."""
    width, height, depth, colour, interlace = _png_header(data)
    if depth != 8 or colour not in _PNG_CHANNELS or interlace:
        raise ValueError(f"PNG of bit depth {depth}, colour type {colour}, interlace "
                         f"{interlace}: the native decoder takes 8-bit, non-interlaced "
                         "grey, RGB, palette and alpha images")
    idat, palette = [], None
    for kind, body in _png_chunks(data):
        if kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body[:len(body) // 3 * 3], np.uint8).reshape(-1, 3)
    channels = _PNG_CHANNELS[colour]
    need = height * (1 + width * channels)  # a filter byte, then the row
    try:  # inflate no more than the header's rows hold
        raw = zlib.decompressobj().decompress(b"".join(idat), need)
    except zlib.error as e:
        raise ValueError(f"PNG data does not inflate (native decoder): {e}") from e
    if not width or not height or len(raw) < need:
        raise ValueError(f"PNG holds {len(raw)} of the {need} bytes its header "
                         "declares (native decoder)")
    out = np.empty((height, width, channels), np.uint8)
    rc = _decode_lib().jp_png_unfilter(raw, len(raw), width, height, channels, out)
    if rc != 0:
        raise ValueError(f"PNG scanlines rejected (native code {rc})")
    if colour == 3:
        if palette is None or out.max() >= len(palette):
            raise ValueError("PNG palette missing or too short (native decoder)")
        out = palette[out[..., 0]]
    return out


def decode_center_crop(data: bytes, image_size: int, max_pixels: int | None = None
                       ) -> np.ndarray:
    """PNG or JPEG bytes -> (S, S, 3) float32 in [-1, 1]: decode, then the
    ADM center crop (box halving, bicubic resize, crop). Raises
    ``ValueError`` for a format the decoder does not take, or an image
    above ``max_pixels``, which the header alone tells."""
    if max_pixels is not None:
        w, h = probe(data)
        if w * h > max_pixels:
            raise ValueError(f"image of {w}x{h} pixels, above the limit of {max_pixels} "
                             "pixels (native decoder)")
    out = np.empty((image_size, image_size, 3), np.float32)
    if data[:8] == PNG_SIGNATURE:
        px = png_pixels(data)
        h, w, c = px.shape
        rc = _decode_lib().jp_center_crop(px, w, h, c, image_size, out)
    elif data[:3] == _JPEG_SOI:
        rc = _jpeg_call("jp_jpeg_center_crop", data, image_size, out)
    else:
        raise ValueError("neither a PNG nor a JPEG (native decoder)")
    if rc != 0:
        raise ValueError(f"decode failed (native code {rc})")
    return out


def decode_rgb(data: bytes) -> np.ndarray:
    """PNG or JPEG bytes -> the whole (H, W, 3) uint8 RGB image: grey is
    repeated over the three channels and alpha dropped, as PIL's
    ``convert("RGB")`` does. Raises ``ValueError`` for a format the
    decoder does not take, naming it."""
    if data[:8] == PNG_SIGNATURE:
        px = png_pixels(data)
        if px.shape[2] < 3:
            return np.ascontiguousarray(np.repeat(px[..., :1], 3, axis=2))
        return np.ascontiguousarray(px[..., :3])
    if data[:3] == _JPEG_SOI:
        w, h = probe(data)
        out = np.empty((h, w, 3), np.uint8)
        rc = _jpeg_call("jp_jpeg_decode", data, w, h, out)
        if rc != 0:
            raise ValueError(f"JPEG decode failed (native code {rc})")
        return out
    raise ValueError("neither a PNG nor a JPEG (native decoder)")


def probe(data: bytes) -> tuple[int, int]:
    """(width, height) of an encoded PNG or JPEG."""
    if data[:8] == PNG_SIGNATURE:
        return _png_header(data)[:2]
    if data[:3] == _JPEG_SOI:
        w, h = ctypes.c_int(), ctypes.c_int()
        rc = _jpeg_call("jp_jpeg_probe", data, ctypes.byref(w), ctypes.byref(h))
        if rc != 0:
            raise ValueError(f"JPEG header rejected (native code {rc})")
        return w.value, h.value
    raise ValueError("neither a PNG nor a JPEG (native decoder)")
