"""Host-side image transforms on uint8 RGB arrays, numpy and C, no PIL.

Counterpart of ``jpdvt_mt_ntnu_tpu/data/transforms.py``, which transforms
PIL images. Here an image is an (H, W, 3) uint8 array, and what PIL
computes in C (resampling, ``reduce``, ``blend``, the ``L`` and ``HSV``
conversions) runs in ``ops/csrc/transforms.cpp``, written after Pillow's
own arithmetic, so that every transform gives Pillow 12.1's bytes
(``tests/test_torch_port_data.py`` holds them to PIL). Crops and flips
are numpy slices. The library is built by g++ at first use
(``ops/_build.py``).
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np

from ..ops import _build

# Pillow's Resampling values.
LANCZOS, BILINEAR, BICUBIC, BOX = 1, 2, 3, 4
_SUPPORT = {LANCZOS: 3.0, BILINEAR: 1.0, BICUBIC: 2.0, BOX: 0.5}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("transforms")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f, i, n = ctypes.c_float, ctypes.c_int, ctypes.c_long
    lib.jp_resample.argtypes = [u8p, i, i, f, f, f, f, i, i, i, u8p]
    lib.jp_reduce.argtypes = [u8p, i, i, i, i, i, i, i, i, u8p]
    lib.jp_blend.argtypes = [u8p, u8p, n, f, u8p]
    for fn in (lib.jp_rgb_to_l, lib.jp_rgb_to_hsv, lib.jp_hsv_to_rgb):
        fn.argtypes = [u8p, n, u8p]
        fn.restype = None
    lib.jp_resample.restype = lib.jp_reduce.restype = ctypes.c_int
    lib.jp_blend.restype = None
    return lib


def _rgb(img: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(img)
    if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] != 3:
        raise ValueError(f"transforms take (H, W, 3) uint8 images, got {a.dtype} {a.shape}")
    return a


def resize(img: np.ndarray, size: tuple[int, int], resample: int,
           box: tuple[float, float, float, float] | None = None,
           reducing_gap: float | None = None) -> np.ndarray:
    """``Image.resize(size, resample, box, reducing_gap)``; ``size`` is
    (width, height), as in PIL."""
    a = _rgb(img)
    h, w = a.shape[:2]
    box = (0, 0, w, h) if box is None else tuple(box)
    size = (int(size[0]), int(size[1]))
    if size == (w, h) and box == (0, 0, w, h):
        return a.copy()
    if reducing_gap is not None:
        fx = int((box[2] - box[0]) / size[0] / reducing_gap) or 1
        fy = int((box[3] - box[1]) / size[1] / reducing_gap) or 1
        if fx > 1 or fy > 1:
            # Image._get_safe_box, then reduce, then the box in reduced pixels.
            sup = _SUPPORT[resample] - 0.5
            sx = sup * (box[2] - box[0]) / size[0]
            sy = sup * (box[3] - box[1]) / size[1]
            rb = (max(0, int(box[0] - sx)), max(0, int(box[1] - sy)),
                  min(w, math.ceil(box[2] + sx)), min(h, math.ceil(box[3] + sy)))
            a = reduce(a, (fx, fy), rb)
            box = ((box[0] - rb[0]) / fx, (box[1] - rb[1]) / fy,
                   (box[2] - rb[0]) / fx, (box[3] - rb[1]) / fy)
            h, w = a.shape[:2]
    out = np.empty((size[1], size[0], 3), np.uint8)
    rc = _lib().jp_resample(a, w, h, *box, size[0], size[1], resample, out)
    if rc != 0:
        raise ValueError(f"resize of {w}x{h} to {size} over {box} rejected (native code {rc})")
    return out


def reduce(img: np.ndarray, factor: tuple[int, int],
           box: tuple[int, int, int, int] | None = None) -> np.ndarray:
    """``Image.reduce(factor, box)``: (fx, fy) integer box averages."""
    a = _rgb(img)
    h, w = a.shape[:2]
    x0, y0, x1, y1 = (0, 0, w, h) if box is None else box
    fx, fy = factor
    out = np.empty((-(-(y1 - y0) // fy), -(-(x1 - x0) // fx), 3), np.uint8)
    rc = _lib().jp_reduce(a, w, h, fx, fy, x0, y0, x1 - x0, y1 - y0, out)
    if rc != 0:
        raise ValueError(f"reduce of {w}x{h} by {factor} over {box} rejected (native code {rc})")
    return out


def center_crop_arr(img: np.ndarray, image_size: int) -> np.ndarray:
    """ADM center crop: BOX halving while the short side is at least twice
    the target, a BICUBIC resize of the short side to it, then the crop
    (the reference's ``train_JPDVT.py:79-97``, from guided-diffusion)."""
    a = _rgb(img)
    while min(a.shape[:2]) >= 2 * image_size:
        a = resize(a, (a.shape[1] // 2, a.shape[0] // 2), BOX)
    scale = image_size / min(a.shape[:2])
    a = resize(a, (round(a.shape[1] * scale), round(a.shape[0] * scale)), BICUBIC)
    cy = (a.shape[0] - image_size) // 2
    cx = (a.shape[1] - image_size) // 2
    return a[cy:cy + image_size, cx:cx + image_size].copy()


def resize_shorter(img: np.ndarray, size: int) -> np.ndarray:
    """torchvision ``Resize(int)``: the shorter side to ``size``, BILINEAR."""
    h, w = img.shape[:2]
    if w <= h:
        return resize(img, (size, max(1, round(h * size / w))), BILINEAR)
    return resize(img, (max(1, round(w * size / h)), size), BILINEAR)


def _thumbnail_size(w: int, h: int, max_size: int) -> tuple[int, int] | None:
    """``Image.thumbnail``'s size within (max_size, max_size), keeping the
    aspect ratio (Pillow 12), or None where the image fits."""
    x, y = max_size, max_size
    if x >= w and y >= h:
        return None
    aspect = w / h

    def round_aspect(number: float, key) -> int:
        return max(min(math.floor(number), math.ceil(number), key=key), 1)

    if x / y >= aspect:
        x = round_aspect(y * aspect, key=lambda n: abs(aspect - n / y))
    else:
        y = round_aspect(x / aspect, key=lambda n: 0 if n == 0 else abs(aspect - x / n))
    return x, y


def safe_resize(img: np.ndarray, max_size: int = 2048) -> np.ndarray:
    """Thumbnail very large scans first (datasets.py:161-167): PIL's
    ``thumbnail((max_size, max_size), LANCZOS)``, whose resize first
    ``reduce``s by an integer factor (``reducing_gap=2.0``)."""
    h, w = img.shape[:2]
    if max(w, h) <= max_size:
        return img
    size = _thumbnail_size(w, h, max_size)
    if size is None or size == (w, h):
        return img
    return resize(img, size, LANCZOS, reducing_gap=2.0)


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    left, top = (w - size) // 2, (h - size) // 2
    return img[top:top + size, left:left + size]


def random_crop(img: np.ndarray, size: int, rng: np.random.Generator) -> np.ndarray:
    h, w = img.shape[:2]
    left = int(rng.integers(0, w - size + 1))
    top = int(rng.integers(0, h - size + 1))
    return img[top:top + size, left:left + size]


def flip_left_right(img: np.ndarray) -> np.ndarray:
    return img[:, ::-1]


def flip_top_bottom(img: np.ndarray) -> np.ndarray:
    return img[::-1]


def blend(a: np.ndarray, b: np.ndarray, alpha: float) -> np.ndarray:
    """``Image.blend(a, b, alpha)`` of two images of one shape."""
    a, b = np.ascontiguousarray(a, np.uint8), np.ascontiguousarray(b, np.uint8)
    if a.shape != b.shape:
        raise ValueError(f"blend of {a.shape} and {b.shape}")
    out = np.empty_like(a)
    _lib().jp_blend(a, b, a.size, alpha, out)
    return out


def to_l(img: np.ndarray) -> np.ndarray:
    """``convert("L")``: (H, W, 3) -> (H, W) luma."""
    a = _rgb(img)
    out = np.empty(a.shape[:2], np.uint8)
    _lib().jp_rgb_to_l(a, a.shape[0] * a.shape[1], out)
    return out


def to_hsv(img: np.ndarray) -> np.ndarray:
    a = _rgb(img)
    out = np.empty_like(a)
    _lib().jp_rgb_to_hsv(a, a.shape[0] * a.shape[1], out)
    return out


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    a = _rgb(hsv)
    out = np.empty_like(a)
    _lib().jp_hsv_to_rgb(a, a.shape[0] * a.shape[1], out)
    return out


def color_jitter(img: np.ndarray, rng: np.random.Generator, *,
                 brightness: float = 0.4, contrast: float = 0.4,
                 saturation: float = 0.4, hue: float = 0.1) -> np.ndarray:
    """torchvision-style jitter: a uniform factor in [1-x, 1+x] per op, the
    ops in ``rng.shuffle``'s order, the hue shifted in [-h, h] by rolling
    the HSV hue; the draws, order and arithmetic of the JAX package's
    (PIL's ``ImageEnhance`` Brightness, Contrast and Color)."""
    img = _rgb(img)
    ops = []
    if brightness:
        ops.append(("b", float(rng.uniform(1 - brightness, 1 + brightness))))
    if contrast:
        ops.append(("c", float(rng.uniform(1 - contrast, 1 + contrast))))
    if saturation:
        ops.append(("s", float(rng.uniform(1 - saturation, 1 + saturation))))
    if hue:
        ops.append(("h", float(rng.uniform(-hue, hue))))
    rng.shuffle(ops)
    for kind, f in ops:
        if kind == "b":
            img = blend(np.zeros_like(img), img, f)
        elif kind == "c":
            luma = to_l(img)
            mean = int(float(luma.sum(dtype=np.int64)) / luma.size + 0.5)
            img = blend(np.full_like(img, mean), img, f)
        elif kind == "s":
            img = blend(np.repeat(to_l(img)[..., None], 3, axis=2), img, f)
        else:
            hsv = to_hsv(img).astype(np.int16)
            hsv[..., 0] = (hsv[..., 0] + int(f * 255)) % 256
            img = hsv_to_rgb(hsv.astype(np.uint8))
    return img


def to_array(img: np.ndarray) -> np.ndarray:
    """uint8 RGB (H, W, 3) -> float32 [0, 1], HWC."""
    return np.asarray(img, dtype=np.float32) / 255.0


def normalize(x: np.ndarray) -> np.ndarray:
    """[0, 1] -> [-1, 1] (the reference's Normalize(0.5, 0.5))."""
    return x * 2.0 - 1.0


def denormalize(x: np.ndarray) -> np.ndarray:
    return np.clip(x * 0.5 + 0.5, 0.0, 1.0)
