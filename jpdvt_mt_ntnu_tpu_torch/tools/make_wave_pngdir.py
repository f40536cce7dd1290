"""A folder of waves PNGs for the folder eval (``run_eval data.data_path=<dir>``).

Counterpart of ``tools/make_wave_pngdir.py``. The folder journals run the
whole harness path of the reference's ``inference.py`` (an ImageFolder over
a directory, inference.py:197-204: decode, crop, scramble, solve, journal);
this tool writes their inputs again, deterministically, with
``serve/png.py`` in place of PIL (the same pixels). The uint8 rounding costs
<= 1/255 against wave amplitudes of 0.3-1.0 a channel, well under the
decision margins of a trained solve.

    python -m jpdvt_mt_ntnu_tpu_torch.tools.make_wave_pngdir out/ [--n 1024] \\
        [--size 192] [--seed 777]

Runs on the host only.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..data import SyntheticPuzzles
from ..serve.png import encode_png


def to_uint8(x: np.ndarray) -> np.ndarray:
    """[-1, 1] float -> uint8, rounded half up as the JAX tool rounds."""
    return np.clip((x + 1.0) * 127.5 + 0.5, 0, 255).astype(np.uint8)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("out", help="output directory")
    p.add_argument("--n", type=int, default=1024)
    p.add_argument("--size", type=int, default=192)
    p.add_argument("--seed", type=int, default=777,
                   help="wave-parameter stream seed (777 is disjoint from the "
                        "training stream and the seed-11 eval journals)")
    a = p.parse_args(argv)
    os.makedirs(a.out, exist_ok=True)
    ds = SyntheticPuzzles(a.size, n=a.n, seed=a.seed, cache=False, cues="waves")
    for i in range(a.n):
        with open(os.path.join(a.out, f"wave_{i:05d}.png"), "wb") as f:
            f.write(encode_png(to_uint8(ds[i])))
    print(f"wrote {a.n} {a.size}px wave PNGs to {a.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
