"""CLI batch evaluation: the reference's inference*.py family as one tool.

Counterpart of ``jpdvt_mt_ntnu_tpu/eval/run_eval.py``, with the same
``section.field=value`` overrides:

    python -m jpdvt_mt_ntnu_tpu_torch.eval.run_eval \\
        eval.checkpoint=artifacts/waves3_r5_step10000.manifest.json \\
        data.dataset=synthetic data.synthetic_cues=waves eval.seed=11 \\
        eval.batch_size=64 diffusion.sampler_mode=fast eval.logs_dir=logs/run

``eval.checkpoint`` takes an artifact manifest (``*.manifest.json``), a
flattened-params ``.npz`` or a checkpoint directory of this package
(``eval.use_ema`` picks the EMA or the raw weights); empty means random
weights. ``eval.assignment`` (greedy | hungarian), ``eval.votes``,
``diffusion.sampler_mode`` (faithful | fast | iterative | ddim) and
``model.attn_impl`` (None | pallas | flash | block, the last putting the
whole attention sublayer on kernel K3) are the solver's options.
``eval.jax_draws=<npz>`` and ``eval.jax_noise=<npy>`` solve the JAX
package's puzzles exactly (its scrambles and noise template, which torch
cannot draw). ``data.data_path=<dir>`` evaluates a folder of images (PIL
decodes them, so on a machine that has PIL); ``eval.texrec_dirs=1`` loops
over its subdirectories with one journal each (inference_texrec.py).

The run is on the card; ``device=cpu`` (an argument without a section)
runs it on the CPU. Not ported yet, and refused by name before any weights
load: the MET and TEXMET datasets, synthetic cue regimes other than
``waves``, an Orbax checkpoint directory, int8 and MoE models, sequence
parallelism, and any geometry no attention kernel takes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

import numpy as np
import torch

from ..core.diffusion import create_diffusion
from ..data import SyntheticPuzzles
from ..models import DIT_CONFIGS, create_model
from ..ops.attention import ATTN_IMPLS, attention_route
from ..tools.weights import load_artifact
from ..utils.config import Config, apply_overrides
from ..utils.device import default_device
from .harness import EvalHarness, find_images, jax_draws
from .solver import ASSIGNMENTS, MODES, PuzzleSolver


def check_metadata_compat(metadata: dict, cfg: Config) -> list[str]:
    """The eval config against the checkpoint's recorded train config
    (``metadata["config"]``): one line per mismatch of model name, image
    size or grid, empty when they agree. The reference journaled 18,128
    images at 0.0000 accuracy with a 3x3 config against a 4x4 checkpoint
    (its ``logs/4_Fail``); a checkpoint trained with ``task.multi_grid``
    is valid at each of its grids."""
    tcfg = (metadata or {}).get("config") or {}
    tm = tcfg.get("model") or {}
    tt = tcfg.get("task") or {}
    trained_grids = [int(g) for g in str(tt.get("multi_grid") or "").split(",")
                     if g] or [tt.get("grid_size")]
    out = []
    for label, trained, using in (
            ("model.name", tm.get("name"), cfg.model.name),
            ("model.image_size", tm.get("image_size"), cfg.model.image_size)):
        if trained is not None and trained != using:
            out.append(f"{label}: checkpoint was trained with {trained!r}, "
                       f"evaluating with {using!r}")
    if trained_grids != [None] and cfg.task.grid_size not in trained_grids:
        out.append(f"task.grid_size: checkpoint was trained with "
                   f"{trained_grids!r}, evaluating with {cfg.task.grid_size!r}")
    return out


def _refuse_mismatch(metadata: dict, cfg: Config) -> None:
    mismatches = check_metadata_compat(metadata, cfg)
    if not mismatches:
        return
    msg = ("checkpoint/eval config mismatch:\n  " + "\n  ".join(mismatches)
           + "\n(the reference's '4_Fail' run journaled 18k images at 0.0000 "
           "accuracy this way; pass eval.allow_mismatch=true to proceed anyway)")
    if not cfg.eval.allow_mismatch:
        raise SystemExit(msg)
    print(f"WARNING: {msg}", file=sys.stderr)


def load_params(cfg: Config, model, device: torch.device) -> None:
    """Load ``eval.checkpoint`` into ``model`` in place: an artifact manifest
    (its ``run_config`` checked as a checkpoint's metadata), a flattened
    params npz, or a checkpoint directory of this package (EMA weights
    unless ``eval.use_ema=false``, the reference's choice). Empty keeps
    the model's random init. Refuses a checkpoint whose recorded config
    conflicts with the eval config, unless ``eval.allow_mismatch``."""
    path = cfg.eval.checkpoint
    if not path:
        return
    if path.endswith((".json", ".npz")):
        if path.endswith(".json"):
            with open(path) as f:
                _refuse_mismatch({"config": json.load(f).get("run_config")}, cfg)
        sd, _ = load_artifact(path, device=device)
        model.load_state_dict(sd, strict=True)
        return
    from ..train import CheckpointManager, create_train_state

    if not os.path.isdir(path):
        raise FileNotFoundError(f"eval.checkpoint={path!r} does not exist")
    mgr = CheckpointManager(path)
    if mgr.latest_step() is None:
        raise NotImplementedError(
            f"eval.checkpoint={path!r} holds no checkpoint of this package (no "
            "<step>/state.pt): an Orbax checkpoint of the JAX package is not read by "
            "the port; export it as an artifact (tools/export_ckpt.py) and pass the "
            "manifest")
    _refuse_mismatch(mgr.metadata(), cfg)
    state = create_train_state(model)
    mgr.restore(state)
    model.load_state_dict((state.ema if cfg.eval.use_ema else state.model).state_dict())


def _folder_mode(cfg: Config) -> bool:
    # data_path with the default or synthetic dataset means "evaluate this
    # folder"; named datasets take dataset mode.
    return bool(cfg.data.data_path) and cfg.data.dataset in ("synthetic", "imagenet",
                                                             "folder")


def check_supported(cfg: Config, texrec: bool = False, on_card: bool = True) -> None:
    """Raise ``NotImplementedError`` for every set key the port's eval
    cannot run, before any weights load."""
    m, d = cfg.model, cfg.data
    refused = []
    if cfg.mesh.seq > 1:
        refused.append("mesh.seq (sequence-parallel ring attention)")
    if m.quant or m.moe_experts or m.moe_capacity or m.name not in DIT_CONFIGS:
        refused.append(f"model {m.name!r} / model.quant / model.moe_* (the dense "
                       "DiT registry is ported)")
    if m.attn_impl not in ATTN_IMPLS:
        refused.append(f"model.attn_impl={m.attn_impl!r} (the port runs {ATTN_IMPLS})")
    elif m.name in DIT_CONFIGS:
        arch = {**DIT_CONFIGS[m.name], **m.overrides()}
        dtype = torch.bfloat16 if m.compute_dtype == "bfloat16" else torch.float32
        try:
            attention_route((m.image_size // arch["patch_size"]) ** 2, dtype, False,
                            m.attn_impl, head_dim=arch["hidden_size"] // arch["num_heads"],
                            on_card=on_card)
        except ValueError as e:
            refused.append(f"the attention of model.image_size={m.image_size}: {e}")
    if cfg.diffusion.sampler_mode not in MODES:
        refused.append(f"diffusion.sampler_mode={cfg.diffusion.sampler_mode!r}")
    if cfg.eval.assignment not in ASSIGNMENTS:
        refused.append(f"eval.assignment={cfg.eval.assignment!r}")
    if texrec or _folder_mode(cfg):
        if importlib.util.find_spec("PIL") is None:
            refused.append("a folder of images without PIL to decode it")
    elif d.dataset in ("met", "texmet", "imagenet", "folder"):
        refused.append(f"data.dataset={d.dataset!r} (only the synthetic waves set and "
                       "image folders through data.data_path are ported)")
    elif (d.synthetic_cues or ("coords" if d.synthetic_position_cues else "none")) != "waves":
        refused.append("synthetic cue regimes other than data.synthetic_cues=waves")
    if cfg.model.matmul_precision not in (None, "highest"):
        refused.append("model.matmul_precision other than 'highest'")
    if refused:
        raise NotImplementedError("not ported yet: " + "; ".join(refused))


def build_dataset(cfg: Config) -> SyntheticPuzzles:
    """The synthetic waves set of 1,024 puzzles at ``eval.seed`` (the JAX
    package's ``build_dataset`` for ``data.dataset=synthetic``)."""
    return SyntheticPuzzles(cfg.model.image_size, n=1024, seed=cfg.eval.seed, cues="waves")


def _split_args(argv) -> tuple[list[str], str | None, bool]:
    device, texrec, rest = None, False, []
    for item in argv:
        key = item.lstrip("-")
        if key.startswith("device="):
            device = key.split("=", 1)[1]
        elif key.startswith("eval.texrec_dirs"):
            texrec = True
        else:
            rest.append(item)
    return rest, device, texrec


def main(argv=None, device: str | torch.device | None = None) -> int:
    argv, cli_device, texrec = _split_args(sys.argv[1:] if argv is None else argv)
    cfg = apply_overrides(Config(), argv)
    device = device if device is not None else cli_device
    check_supported(cfg, texrec, on_card=torch.device(device or "cuda").type == "cuda")
    device = default_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    dtype = torch.bfloat16 if cfg.model.compute_dtype == "bfloat16" else torch.float32
    model, model_cfg = create_model(cfg.model.name, cfg.model.image_size, device=device,
                                    dtype=dtype, attn_impl=cfg.model.attn_impl,
                                    **cfg.model.overrides())
    load_params(cfg, model, device)
    diffusion = create_diffusion(str(cfg.diffusion.sampling_steps),
                                 cfg.diffusion.noise_schedule, cfg.diffusion.predict_xstart,
                                 cfg.diffusion.sigma_small, device=device)
    noise = np.load(cfg.eval.jax_noise) if cfg.eval.jax_noise else None
    solver = PuzzleSolver(model, model_cfg, diffusion, grid_size=cfg.task.grid_size,
                          mode=cfg.diffusion.sampler_mode,
                          assignment_method=cfg.eval.assignment, votes=cfg.eval.votes,
                          seed=cfg.eval.seed, noise_template=noise, device=device)
    draws = (jax_draws(cfg.eval.jax_draws, solver.pieces, solver.votes)
             if cfg.eval.jax_draws else None)
    rank, world = ((torch.distributed.get_rank(), torch.distributed.get_world_size())
                   if torch.distributed.is_initialized() else (0, 1))

    def harness(logs_dir: str, journal_name: str = "inference_progress.csv"):
        return EvalHarness(
            solver, logs_dir=logs_dir, batch_size=cfg.eval.batch_size, seed=cfg.eval.seed,
            results_dir=cfg.eval.results_dir if cfg.eval.save_images else None,
            journal_name=journal_name, process_index=rank, process_count=world,
            draws=draws)

    if texrec:
        # One journal per subdirectory of data_path, '*mask*' files left
        # out, a summary at the end (inference_texrec.py:232-253).
        results = {}
        for sub in sorted(os.listdir(cfg.data.data_path)):
            full = os.path.join(cfg.data.data_path, sub)
            if not os.path.isdir(full):
                continue
            paths = find_images(full, exclude_substr="mask")
            if paths:
                results[sub] = harness(cfg.eval.logs_dir, f"{sub}_inference_progress.csv"
                                       ).run_paths(paths, limit=cfg.eval.limit)
        print("==== OVERALL RESULTS ====")
        for sub, r in results.items():
            print(f"{sub}: puzzle={r.puzzle_accuracy:.4f} patch={r.patch_accuracy:.4f} "
                  f"n={r.count}")
        return 0

    h = harness(cfg.eval.logs_dir)
    if _folder_mode(cfg):
        report = h.run_paths(find_images(cfg.data.data_path), limit=cfg.eval.limit)
    else:
        report = h.run_dataset(build_dataset(cfg), limit=cfg.eval.limit)
    print(f"puzzle_accuracy={report.puzzle_accuracy:.4f} "
          f"patch_accuracy={report.patch_accuracy:.4f} n={report.count} "
          f"({report.puzzles_per_sec:.2f} puzzles/s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
