"""The image datasets users train and evaluate on: MET, TEXMET, image folders.

Counterpart of ``jpdvt_mt_ntnu_tpu/data/datasets.py`` (``METDataset``,
``TEXMETDataset``, ``ImageFolderDataset``, ``rand_erode`` and
``_split_indices``; the synthetic set is ``data/synthetic.py``). Items are
float32 (H, W, 3) arrays in [-1, 1], as there.

The files are decoded by the port's native decoder (``ops/native.
decode_rgb``: PNG, and JPEG bit-equal to libjpeg's decode, on every
machine) and transformed by ``data/transforms.py``, whose arithmetic is
Pillow's, so an item equals the JAX package's for the same seed and call
order. No PIL and no sklearn: the split is a numpy copy of sklearn's
``train_test_split``.

A file the decoder refuses raises a ``ValueError`` that names the file.
TEXMET's black image for a file that fails to decode is the reference's
behaviour; the decoder takes every JPEG that libjpeg decodes (CMYK,
arithmetic coding, lossless, ...), so only a file libjpeg cannot decode
either (a corrupt one) turns black.
"""

from __future__ import annotations

import itertools
import os
from typing import Sequence

import numpy as np

from ..ops import native
from . import transforms as T

_IMG_EXTS = (".jpg", ".jpeg", ".png")


def train_test_split(items: Sequence, test_size: int, seed: int) -> tuple[list, list]:
    """sklearn's ``train_test_split(items, test_size=<int>, random_state=seed)``
    without shuffling options: ``RandomState(seed).permutation(n)``, the
    first ``test_size`` for test, the rest for train."""
    n = len(items)
    if not 0 < test_size < n:
        raise ValueError(f"test_size={test_size} should be positive and smaller than "
                         f"the number of samples {n}")
    perm = np.random.RandomState(seed).permutation(n)
    return [items[i] for i in perm[test_size:]], [items[i] for i in perm[:test_size]]


def _split_indices(n: int, seed: int = 42, test_size: int = 2000, val_size: int = 1000):
    """(train, val, test) index lists: test first, then val from the rest
    (the reference's datasets.py:35-36)."""
    train, test = train_test_split(list(range(n)), test_size, seed)
    train, val = train_test_split(train, val_size, seed)
    return train, val, test


def load_rgb(path: str) -> np.ndarray:
    """A file -> (H, W, 3) uint8 RGB through the native decoder; its
    ``ValueError`` names the file."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return native.decode_rgb(data)
    except ValueError as e:
        raise type(e)(f"{path}: {e}") from e


class _AtomicCounter:
    """A counter whose ``next`` is atomic under the GIL (``itertools.count``)."""

    def __init__(self):
        self._c = itertools.count()

    def next(self) -> int:
        return next(self._c)


class _Base:
    image_files: list[str]

    def __len__(self) -> int:
        return len(self.image_files)


class METDataset(_Base):
    """MET artworks with gapped-collage synthesis (reference datasets.py:19-104).

    Items are (288, 288, 3): a 3 x 3 collage of 96 px crops of 100 px
    regions 48 px apart. The root holds image subdirectories; the three
    lexicographically first are read, and of them the files ending in
    ``.jpg``, sorted. Split: 2,000 test, then 1,000 val of the rest, seed 42.
    """

    def __init__(self, image_dir: str, split: str, seed: int = 42):
        self.split = split
        files: list[str] = []
        for d in sorted(os.listdir(image_dir))[:3]:
            full = os.path.join(image_dir, d)
            files += [os.path.join(full, k) for k in sorted(os.listdir(full))
                      if k.lower().endswith(".jpg")]
        self.all_files = files
        train, val, test = _split_indices(len(files), seed=seed)
        pick = {"train": train, "val": val, "test": test}[split]
        self.image_files = [files[i] for i in pick]
        self._seed = seed
        self._epoch_salt = _AtomicCounter()

    def __getitem__(self, i: int) -> np.ndarray:
        # A generator per call (the loader maps items over threads); the
        # counter salts repeat visits so that epochs differ.
        rng = np.random.default_rng((self._seed, i, self._epoch_salt.next()))
        img = T.resize_shorter(load_rgb(self.image_files[i]), 398)
        if self.split == "train":
            img = T.random_crop(img, 398, rng)
            if rng.random() < 0.5:
                img = T.flip_left_right(img)
            img = T.color_jitter(img, rng)
        else:
            img = T.center_crop(img, 398)
        arr = T.normalize(T.to_array(img))
        return rand_erode(arr, rng, n=3, patch_out=96, region=100, gap=48)


class TEXMETDataset(_Base):
    """TEXMET textiles (reference datasets.py:106-248): ``{split}_files.txt``
    lists the names under ``images/``; missing files are left out
    (``missing`` counts them); patches of 64 px at 192, else 96."""

    def __init__(self, data_dir: str, split: str, image_size: int = 288, seed: int = 0):
        self.split = split
        self.image_size = image_size
        split_file = os.path.join(data_dir, f"{split}_files.txt")
        if not os.path.exists(split_file):
            raise FileNotFoundError(f"Split file not found: {split_file}")
        with open(split_file) as f:
            names = [os.path.basename(line.strip()) for line in f if line.strip()]
        candidates = [os.path.join(data_dir, "images", n) for n in names]
        self.image_files = [p for p in candidates if os.path.exists(p)]
        self.missing = len(candidates) - len(self.image_files)
        self.patch_out = 64 if image_size == 192 else 96
        self._seed = seed
        self._epoch_salt = _AtomicCounter()

    def __getitem__(self, i: int) -> np.ndarray:
        out_size = self.patch_out * 3
        rng = np.random.default_rng((self._seed, i, self._epoch_salt.next()))
        try:
            img = T.safe_resize(load_rgb(self.image_files[i]))
            img = T.resize_shorter(img, 398)
            if self.split == "train":
                img = T.random_crop(img, 398, rng)
                if rng.random() < 0.5:
                    img = T.flip_left_right(img)
                if rng.random() < 0.2:
                    img = T.flip_top_bottom(img)
                img = T.color_jitter(img, rng, brightness=0.3, contrast=0.3,
                                     saturation=0.3, hue=0.05)
            else:
                img = T.center_crop(img, 398)
            arr = T.normalize(T.to_array(img))
            return rand_erode(arr, rng, n=3, patch_out=self.patch_out,
                              region=self.patch_out + self.patch_out // 2,
                              gap=self.patch_out // 2)
        except Exception:
            # The reference's black image for a file that fails (datasets.py:
            # 245-248), at the configured size.
            return np.zeros((out_size, out_size, 3), dtype=np.float32)


class ImageFolderDataset(_Base):
    """Every image under ``root``, with the reference's inference transform
    (``center_crop_arr`` and normalise, inference.py:197-201)."""

    def __init__(self, root: str, image_size: int, extensions: Sequence[str] = _IMG_EXTS):
        self.image_size = image_size
        files = []
        for dirpath, _, names in os.walk(root):
            for n in sorted(names):
                if n.lower().endswith(tuple(extensions)):
                    files.append(os.path.join(dirpath, n))
        self.image_files = sorted(files)

    def __getitem__(self, i: int) -> np.ndarray:
        img = T.center_crop_arr(load_rgb(self.image_files[i]), self.image_size)
        return T.normalize(T.to_array(img))


def rand_erode(arr: np.ndarray, rng: np.random.Generator, *, n: int = 3,
               patch_out: int = 96, region: int = 100, gap: int = 48) -> np.ndarray:
    """Gapped-collage puzzle synthesis (reference datasets.py:73-88,205-223):
    a random ``patch_out`` crop of each of the n x n ``region`` cells, cells
    ``gap`` apart, tiled into an (n * patch_out, n * patch_out, C) array."""
    c = arr.shape[-1]
    out = np.zeros((n * patch_out, n * patch_out, c), dtype=arr.dtype)
    stride = region + gap
    for i in range(n):
        for j in range(n):
            top, left = i * stride, j * stride
            cell = arr[top:top + region, left:left + region]
            dy = int(rng.integers(0, cell.shape[0] - patch_out + 1))
            dx = int(rng.integers(0, cell.shape[1] - patch_out + 1))
            out[i * patch_out:(i + 1) * patch_out,
                j * patch_out:(j + 1) * patch_out] = cell[dy:dy + patch_out, dx:dx + patch_out]
    return out
