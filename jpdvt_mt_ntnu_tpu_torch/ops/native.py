"""ctypes bindings of the port's host assignment solvers.

Counterpart of the assignment half of ``jpdvt_mt_ntnu_tpu/ops/native.py``:
``csrc/assignment.cpp`` (the port's copy of ``native/src/assignment.cpp``)
is built with ``g++`` into ``_build/`` at first use by ``ops/_build.py``.
There is no fallback: a failed build raises. The image decoder
(``native/src/decode.cpp``) is not part of the port yet.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from . import _build


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
