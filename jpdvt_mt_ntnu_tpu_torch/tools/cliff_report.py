"""An eval journal's failures conditioned on the 20x20 hard region.

Counterpart of ``tools/cliff_report.py``. The round-4 cliff analysis found
a region of wave-draw space that can be told a priori (k = 2 components,
pairwise orientation gap > 1.2 rad mod pi, max frequency > 0.85): ~8.8%
of natural draws, ~30% of the puzzle failures against 3.7% outside. Given
a synthetic-waves journal (``run_eval``'s ``inference_progress.csv``) and
its eval seed, this tool draws each image's wave parameters again from
the same stream (``data/synthetic.py`` ``_wave_params``:
``default_rng(seed * 1000003 + i)``, the JAX package's), classifies each
row in or out of the region and reports the conditional failure rates,
the yardstick of ``data.synthetic_hard_frac`` and ``eval.votes``.

    python -m jpdvt_mt_ntnu_tpu_torch.tools.cliff_report \\
        logs/waves20_r4_eval/inference_progress.csv --seed 11 --grid 20 \\
        [--angle 1.2 --fmax 0.85] [--out cliff.json]

Prints one JSON line. Runs on the host only.
"""

from __future__ import annotations

import argparse
import csv
import functools
import json
import re
import sys

import numpy as np

from ..data import SyntheticPuzzles


def classify_params(th, f, amp, angle: float, fmax: float):
    """The region predicate on padded wave parameters (th, f: (K,), amp:
    (K, 3), as ``_wave_params`` returns them), shared with the tests so that
    the oversampler and this yardstick cannot drift apart.
    -> (in_hard_region, k, min_pairwise_angle, max_frequency)."""
    k = int(np.count_nonzero(np.any(amp != 0, axis=1)))
    th = np.asarray(th)[:k]
    d = np.abs(th[:, None] - th[None, :])
    d = np.minimum(d, np.pi - d)
    pair = d[np.triu_indices(k, 1)]
    min_angle = float(pair.min()) if pair.size else 0.0
    max_gap = float(pair.max()) if pair.size else 0.0
    fm = float(np.asarray(f)[:k].max())
    hard = (k == 2) and (max_gap > angle) and (fm > fmax)
    return hard, k, min_angle, fm


@functools.lru_cache(maxsize=4)
def _stream(seed: int) -> SyntheticPuzzles:
    return SyntheticPuzzles(64, n=1, seed=seed, cues="waves")


def classify(i: int, seed: int, angle: float, fmax: float):
    """:func:`classify_params` of natural draw ``i`` of ``seed``'s stream
    (the eval distribution, no hard oversampling)."""
    th, f, _, amp = _stream(seed)._wave_params(i)
    return classify_params(th, f, amp, angle, fmax)


def cliff(rows, seed: int, angle: float, fmax: float, grid_slots: int) -> dict:
    """The report's counts of (index, puzzle_correct, patch_matches) rows."""
    n_in = fail_in = n_out = fail_out = mis_in = mis_out = 0
    for i, ok, patches in rows:
        mis = grid_slots - patches
        if classify(i, seed, angle, fmax)[0]:
            n_in, fail_in, mis_in = n_in + 1, fail_in + 1 - ok, mis_in + mis
        else:
            n_out, fail_out, mis_out = n_out + 1, fail_out + 1 - ok, mis_out + mis
    return {
        "seed": seed,
        "region": {"k": 2, "angle_gt": angle, "fmax_gt": fmax},
        "grid_slots": grid_slots,
        "n": len(rows),
        "n_in_region": n_in,
        "region_frac": round(n_in / len(rows), 4),
        "fail_rate_in": round(fail_in / max(n_in, 1), 4),
        "fail_rate_out": round(fail_out / max(n_out, 1), 4),
        "puzzle_acc": round(1 - (fail_in + fail_out) / len(rows), 4),
        "misplaced_in": mis_in,
        "misplaced_out": mis_out,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("journal", help="inference_progress.csv from run_eval")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--angle", type=float, default=1.2)
    ap.add_argument("--fmax", type=float, default=0.85)
    ap.add_argument("--grid", type=int, default=0,
                    help="grid size of the run (slots = grid**2); 0 takes "
                         "max(patch_matches) with a warning, which undercounts "
                         "misplacements when no row is fully solved")
    ap.add_argument("--out", default="", help="write the JSON line here too")
    args = ap.parse_args(argv)

    rows = []
    with open(args.journal) as fh:
        for row in csv.DictReader(fh):
            # Anchored to the synthetic names (synthetic_%06d.png): digits of
            # a directory in a path-keyed row must not match.
            m = re.search(r"synthetic_(\d+)", row["filename"])
            if not m:
                print(f"row {row['filename']!r} is not a synthetic-waves journal entry; "
                      "this tool conditions on the regenerated wave draw (seed, index)",
                      file=sys.stderr)
                return 1
            rows.append((int(m.group(1)), int(row["puzzle_correct"]),
                         int(row["patch_matches"])))
    if not rows:
        print("no journal rows", file=sys.stderr)
        return 1
    if args.grid:
        grid_slots = args.grid ** 2
    else:
        grid_slots = max(patches for _, _, patches in rows)
        print(f"warning: --grid not given; assuming {grid_slots} slots from "
              "max(patch_matches), wrong for journals with no fully-solved puzzle",
              file=sys.stderr)
    line = json.dumps({"journal": args.journal,
                       **cliff(rows, args.seed, args.angle, args.fmax, grid_slots)})
    print(line)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
