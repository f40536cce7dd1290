"""PNG writer for the service's responses, standard library only.

Counterpart of PIL's PNG save in ``jpdvt_mt_ntnu_tpu/serve/service.py``
(``_array_to_b64``): 8-bit RGB, every scanline with filter 0, one zlib
stream. The bytes differ from PIL's (which picks its filters itself); the
pixels are the same.
"""

from __future__ import annotations

import base64
import binascii
import struct
import zlib

import numpy as np

from ..data import transforms as T
from ..ops.native import PNG_SIGNATURE

_COLOUR = {1: 0, 3: 2, 4: 6}  # channels -> PNG colour type


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", binascii.crc32(kind + body)))


def encode_png(img: np.ndarray) -> bytes:
    """uint8 (H, W) grey or (H, W, 3|4) RGB/RGBA -> PNG bytes."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8 pixels, got {a.dtype}")
    if a.ndim == 2:
        a = a[..., None]
    h, w, c = a.shape
    if c not in _COLOUR:
        raise ValueError(f"encode_png takes 1, 3 or 4 channels, got {c}")
    raw = np.zeros((h, 1 + w * c), np.uint8)  # a leading 0: filter type None
    raw[:, 1:] = a.reshape(h, w * c)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOUR[c], 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))


def array_to_b64(arr: np.ndarray) -> str:
    """[-1, 1] HWC float -> base64 PNG, truncating to uint8 as the JAX
    service does (``(denormalize(x) * 255).astype(uint8)``)."""
    a = (T.denormalize(np.asarray(arr)) * 255).astype(np.uint8)
    return base64.b64encode(encode_png(a)).decode("utf-8")
