"""Run the in-training validator on an artifact's weights, with two sets of draws.

Prints one JSON line: the accuracies of ``train.validate.Validator`` on the
run's validation set (``SyntheticPuzzles(size, n=128, seed=7)``, 100
images) with the port's own draws (numpy permutations, a torch-generated
noise template) and with the JAX validator's committed draws
(``validate.jax_draws``), and each mix of the two. Where the accuracies
differ, the draws explain the difference; where they agree, the weights
do. The committed draws cover grid 3 at 192 px and grid 20 at 320 px.

    python -m jpdvt_mt_ntnu_tpu_torch.tools.validate_artifact \\
        artifacts/waves3_r5_step10000.manifest.json --image-size 192 --grid 3 \\
        --mode fast --dtype float32 --device cpu

Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..data import SyntheticPuzzles
from ..models import create_model
from ..tools.weights import load_artifact
from ..train.validate import Validator, jax_draws


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("artifact")
    ap.add_argument("--image-size", type=int, default=192)
    ap.add_argument("--grid", type=int, default=3)
    ap.add_argument("--mode", default="fast", choices=("fast", "faithful"))
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    sd, step = load_artifact(args.artifact, device=args.device)
    model, cfg = create_model("JPDVT", args.image_size, device=args.device,
                              dtype=getattr(torch, args.dtype))
    model.load_state_dict(sd)
    del sd
    jax = jax_draws(args.grid, cfg.num_tokens)
    if not jax:
        raise SystemExit(f"no committed JAX draws for grid {args.grid} at "
                         f"{cfg.num_tokens} tokens")
    val = SyntheticPuzzles(args.image_size, n=128, seed=7, cues="waves")
    out = {"artifact": args.artifact, "step": step, "mode": args.mode,
           "dtype": args.dtype}
    for name, draws in (("own_draws", {}), ("jax_draws", jax),
                        ("jax_template_own_perms", {"noise_template": jax["noise_template"]}),
                        ("own_template_jax_perms", {"permutations": jax["permutations"]})):
        out[name] = Validator(cfg, grid_size=args.grid, sampler_mode=args.mode,
                              device=args.device, **draws)(model, val)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
