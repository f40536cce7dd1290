"""Host-side image transforms for the service, numpy only.

Counterpart of the part of ``jpdvt_mt_ntnu_tpu/data/transforms.py`` that
serving uses (``to_array``, ``normalize``, ``denormalize``), on uint8
arrays instead of PIL images. ``center_crop_arr``'s work (the ADM crop)
is done by the native decoder (``ops/native.decode_center_crop``).
"""

from __future__ import annotations

import numpy as np


def to_array(img: np.ndarray) -> np.ndarray:
    """uint8 RGB (H, W, 3) -> float32 [0, 1], HWC."""
    return np.asarray(img, dtype=np.float32) / 255.0


def normalize(x: np.ndarray) -> np.ndarray:
    """[0, 1] -> [-1, 1] (the reference's Normalize(0.5, 0.5))."""
    return x * 2.0 - 1.0


def denormalize(x: np.ndarray) -> np.ndarray:
    return np.clip(x * 0.5 + 0.5, 0.0, 1.0)
