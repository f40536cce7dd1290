"""Analysis of eval journals (progress CSVs): the reference notebooks as a script.

Counterpart of ``jpdvt_mt_ntnu_tpu/tools/metrics_report.py``, with ``csv``
and numpy in place of pandas: overall puzzle and patch accuracy, the
unprocessed count, and the solve-time statistics of ``metrics.ipynb``, plus
the first perfect and failed files (reference image_model/metrics.ipynb,
sample_visualize_texrec.ipynb). ``--hist`` draws the solve-time histogram
(50 bins) as bars into an image and writes it as a PNG through
``serve/png.py``; its title goes into the report.

    python -m jpdvt_mt_ntnu_tpu_torch.tools.metrics_report logs/ \\
        [--total-expected 100000] [--grid 3] [--hist out.png]

Runs on the host only.
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import os

import numpy as np

from ..serve.png import encode_png

HIST_BINS = 50
HIST_SIZE = (360, 640)  # pixels, rows x columns
HIST_BAR = (0x5B, 0x8D, 0xEF)


def load_journals(path: str) -> dict[str, np.ndarray]:
    """One CSV, or every ``*progress*.csv`` in a directory, merged in name
    order: column name -> array (numbers as float64, text as str)."""
    files = (sorted(glob.glob(os.path.join(path, "*progress*.csv")))
             if os.path.isdir(path) else [path])
    if not files:
        raise FileNotFoundError(f"no progress CSVs under {path}")
    rows: list[dict] = []
    for f in files:
        with open(f, newline="") as fh:
            rows.extend(csv.DictReader(fh))
    cols = {k: [r.get(k, "") for r in rows] for k in (rows[0] if rows else {})}
    out = {}
    for k, v in cols.items():
        try:
            out[k] = np.array([float(x) for x in v], np.float64)
        except ValueError:
            out[k] = np.array(v, dtype=str)
    return out


def report(df: dict[str, np.ndarray], grid: int = 3, total_expected: int = 0) -> dict:
    p = grid * grid
    n = len(df["puzzle_correct"]) if "puzzle_correct" in df else 0
    out = {
        "images_processed": n,
        "puzzle_accuracy": float(df["puzzle_correct"].mean()) if n else 0.0,
        "patch_accuracy": float(df["patch_matches"].sum() / (n * p)) if n else 0.0,
        "unprocessed": max(0, total_expected - n) if total_expected else None,
    }
    if "time_s" in df and n:
        t = df["time_s"]
        out["time"] = {
            "mean_s": float(t.mean()), "median_s": float(np.median(t)),
            "p95_s": float(np.quantile(t, 0.95)), "min_s": float(t.min()),
            "max_s": float(t.max()), "total_s": float(t.sum()),
            "puzzles_per_sec": float(n / t.sum()) if t.sum() > 0 else 0.0,
        }
    names = df.get("filename", np.array([], dtype=str))
    correct = df.get("puzzle_correct", np.zeros(0))
    out["examples"] = {"perfect": names[correct == 1][:5].tolist(),
                       "failed": names[correct == 0][:5].tolist()}
    return out


def histogram_image(t: np.ndarray, bins: int = HIST_BINS, size=HIST_SIZE) -> np.ndarray:
    """(H, W, 3) uint8: white, one bar per bin scaled to the fullest bin,
    with a grey baseline."""
    counts, _ = np.histogram(t, bins=bins)
    h, w = size
    img = np.full((h, w, 3), 255, np.uint8)
    margin = 10
    left = margin
    width = (w - 2 * margin) / bins
    top = counts.max() if counts.size and counts.max() > 0 else 1
    for i, c in enumerate(counts):
        height = int(round((h - 2 * margin) * c / top))
        x0, x1 = int(left + i * width), int(left + (i + 1) * width)
        if height:
            img[h - margin - height:h - margin, x0:max(x1 - 1, x0 + 1)] = HIST_BAR
    img[h - margin, margin:w - margin] = 128
    return img


def save_histogram(df: dict[str, np.ndarray], path: str) -> str:
    """Write the solve-time histogram PNG; its title."""
    t = df["time_s"]
    with open(path, "wb") as f:
        f.write(encode_png(histogram_image(t)))
    return f"solve-time distribution (n={len(t)}, mean={t.mean():.2f}s)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("path", help="progress CSV file or logs directory")
    ap.add_argument("--grid", type=int, default=3)
    ap.add_argument("--total-expected", type=int, default=0)
    ap.add_argument("--hist", default="", help="write the time histogram PNG here")
    a = ap.parse_args(argv)
    df = load_journals(a.path)
    rep = report(df, a.grid, a.total_expected)
    if a.hist and "time_s" in df:
        rep["histogram_title"] = save_histogram(df, a.hist)
        rep["histogram"] = a.hist
    print(json.dumps(rep, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
