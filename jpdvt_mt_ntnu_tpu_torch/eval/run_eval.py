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
``diffusion.sampler_mode`` (faithful | fast | iterative | ddim),
``model.attn_impl`` (None | pallas | flash | block, the last putting the
whole attention sublayer on kernel K3) and ``model.quant`` (int8 | int8:K,
w8a8 products in the DiT's blocks, ``ops/quant.py``) are the solver's
options.
``eval.jax_draws=<npz>`` and ``eval.jax_noise=<npy>`` solve the JAX
package's puzzles exactly (its scrambles and noise template, which torch
cannot draw). ``data.data_path=<dir>`` evaluates a folder of images,
decoded and ADM-cropped by the native decoder (``ops/native.py``: PNG
and JPEG, with no libjpeg), as the JAX harness does;
``eval.texrec_dirs=1`` loops over its subdirectories with one journal each
(inference_texrec.py). ``data.dataset`` takes ``met`` and ``texmet`` (their
test splits), ``synthetic`` (every cue regime) or an image folder.

The run is on the card; ``device=cpu`` (an argument without a section)
runs it on the CPU. On N processes (``python -m torch.distributed.run
--nproc_per_node N -m jpdvt_mt_ntnu_tpu_torch.eval.run_eval ...``, or the
launchers and ``mesh.coordinator`` of ``parallel/mesh.py``) rank r takes
``paths[r::N]`` with the draws of ``eval.seed + r`` and writes its own
journal (``inference_progress_host{r}.csv``; rank 0's has no suffix); a
resume merges every host's journal, and each rank prints the summary of
its harness, as the JAX package's hosts do. ``eval.jax_draws`` may hold
``{process_index}``, replaced by the rank, for each host's draws.
``model.matmul_precision`` sets float32 products (``utils/device.py``).
``model.name=JPDVT-MoE`` (and ``model.moe_*``) evaluates the expert-choice
MoE; with ``model.quant`` its attention is int8 and its experts dense.
``mesh.seq=s`` solves each puzzle on s ranks with ring attention
(``parallel/sequence.py``), as the JAX eval does on its (data, seq) mesh:
the ranks of a seq group solve the same puzzles in lockstep, each on its
N/s tokens, the data groups take ``paths[d::D]`` with the draws of
``eval.seed + d``, and each seq group's first rank writes the journal of
data index d. ``mesh.model``, ``mesh.fsdp``, ``mesh.ep``, ``mesh.pipe``
and ``mesh.pipe_microbatches`` are read as the JAX eval reads them: not at
all. Not ported yet, and refused by name before any weights load: an Orbax
checkpoint directory and any geometry no attention kernel takes.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import torch

from ..core.diffusion import create_diffusion
from ..data import ImageFolderDataset, METDataset, SyntheticPuzzles, TEXMETDataset
from ..data.synthetic import CUES
from ..models import DIT_CONFIGS, create_model
from ..ops.attention import ATTN_IMPLS, attention_route
from ..ops.quant import parse_quant_spec
from ..parallel import MeshSpec, maybe_initialize_distributed
from ..parallel.sharding import Mesh, MeshRanks, use_ring
from ..tools.weights import load_artifact
from ..utils.config import Config, apply_overrides, split_device
from ..utils.device import MATMUL_PRECISION, apply_matmul_precision
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


def build_model(cfg: Config, device: torch.device):
    """(model, config) of ``cfg.model`` on ``device`` with ``eval.checkpoint``
    loaded (:func:`load_params`): the model of ``run_eval`` and the tools."""
    dtype = torch.bfloat16 if cfg.model.compute_dtype == "bfloat16" else torch.float32
    model, model_cfg = create_model(cfg.model.name, cfg.model.image_size, device=device,
                                    dtype=dtype, attn_impl=cfg.model.attn_impl,
                                    **cfg.model.overrides())
    load_params(cfg, model, device)
    return model, model_cfg


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
    if m.name not in DIT_CONFIGS:
        refused.append(f"model {m.name!r} (the port's registry is {sorted(DIT_CONFIGS)})")
    try:
        parse_quant_spec(m.quant)
    except ValueError as e:
        refused.append(f"model.quant={m.quant!r} ({e})")
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
    if not (texrec or _folder_mode(cfg)) and d.dataset == "synthetic":
        cues = d.synthetic_cues or ("coords" if d.synthetic_position_cues else "none")
        if cues not in CUES:
            refused.append(f"data.synthetic_cues={cues!r} (the regimes are {CUES})")
    if m.matmul_precision not in MATMUL_PRECISION:
        refused.append(f"model.matmul_precision={m.matmul_precision!r} (the port takes "
                       f"{sorted(k for k in MATMUL_PRECISION if k)})")
    if refused:
        raise NotImplementedError("not ported yet: " + "; ".join(refused))


def build_dataset(cfg: Config):
    """The evaluation set of ``data.dataset`` (JAX ``run_eval.py:104-117``):
    ``met`` and ``texmet`` at their test splits, ``synthetic`` 1,024 puzzles
    at ``eval.seed`` (any cue regime), else an image folder at
    ``data.data_path``."""
    d = cfg.data
    if d.dataset == "met":
        return METDataset(d.data_path, "test")
    if d.dataset == "texmet":
        return TEXMETDataset(d.data_path, "test", cfg.model.image_size)
    if d.dataset == "synthetic":
        return SyntheticPuzzles(cfg.model.image_size, n=1024, seed=cfg.eval.seed,
                                position_cues=d.synthetic_position_cues,
                                cues=d.synthetic_cues or None)
    return ImageFolderDataset(d.data_path, cfg.model.image_size)


def _texrec_paths(data_path: str) -> dict[str, list[str]]:
    """Each subdirectory of ``data_path`` with its images, '*mask*' files
    left out (inference_texrec.py:232-253)."""
    out = {}
    for sub in sorted(os.listdir(data_path)):
        full = os.path.join(data_path, sub)
        if os.path.isdir(full):
            paths = find_images(full, exclude_substr="mask")
            if paths:
                out[sub] = paths
    return out


def _split_args(argv) -> tuple[list[str], str | None, bool]:
    argv, device = split_device(argv)
    rest = [item for item in argv if not item.lstrip("-").startswith("eval.texrec_dirs")]
    return rest, device, len(rest) < len(argv)


def main(argv=None, device: str | torch.device | None = None) -> int:
    argv, cli_device, texrec = _split_args(sys.argv[1:] if argv is None else argv)
    cfg = apply_overrides(Config(), argv)
    device = device if device is not None else cli_device
    check_supported(cfg, texrec, on_card=torch.device(device or "cuda").type == "cuda")
    apply_matmul_precision(cfg.model.matmul_precision)
    # The JAX eval reads only mesh.data and mesh.seq: every rank is a data
    # shard of a (data, seq) mesh.
    dp = maybe_initialize_distributed(
        dataclasses.replace(cfg.mesh, model=1, fsdp=1, ep=1, pipe=1), device)
    device = dp.device
    ranks = MeshRanks.from_spec(MeshSpec(data=cfg.mesh.data, seq=cfg.mesh.seq), dp.world)
    # This rank's data index and the data groups' count, and whether it writes.
    rank, world = ranks.coord(dp.rank, "data"), ranks.data
    writes = ranks.coord(dp.rank, "seq") == 0

    if texrec:
        subdirs = _texrec_paths(cfg.data.data_path)
    elif _folder_mode(cfg):
        paths = find_images(cfg.data.data_path)
    else:
        dataset = build_dataset(cfg)

    model, model_cfg = build_model(cfg, device)
    if ranks.seq > 1:
        use_ring(model, Mesh(ranks, dp))
    diffusion = create_diffusion(str(cfg.diffusion.sampling_steps),
                                 cfg.diffusion.noise_schedule, cfg.diffusion.predict_xstart,
                                 cfg.diffusion.sigma_small, device=device)
    noise = np.load(cfg.eval.jax_noise) if cfg.eval.jax_noise else None
    solver = PuzzleSolver(model, model_cfg, diffusion, grid_size=cfg.task.grid_size,
                          mode=cfg.diffusion.sampler_mode,
                          assignment_method=cfg.eval.assignment, votes=cfg.eval.votes,
                          seed=cfg.eval.seed, noise_template=noise, device=device)
    draws = (jax_draws(cfg.eval.jax_draws.replace("{process_index}", str(rank)),
                       solver.pieces, solver.votes) if cfg.eval.jax_draws else None)

    def harness(logs_dir: str, journal_name: str = "inference_progress.csv"):
        return EvalHarness(
            solver, logs_dir=logs_dir, batch_size=cfg.eval.batch_size, seed=cfg.eval.seed,
            results_dir=cfg.eval.results_dir if cfg.eval.save_images else None,
            journal_name=journal_name, process_index=rank, process_count=world,
            draws=draws, sync=dp.barrier, writes_journal=writes)

    if texrec:
        # One journal per subdirectory of data_path, '*mask*' files left
        # out, a summary at the end (inference_texrec.py:232-253).
        results = {sub: harness(cfg.eval.logs_dir, f"{sub}_inference_progress.csv"
                                ).run_paths(paths, limit=cfg.eval.limit)
                   for sub, paths in subdirs.items()}
        print("==== OVERALL RESULTS ====")
        for sub, r in results.items():
            print(f"{sub}: puzzle={r.puzzle_accuracy:.4f} patch={r.patch_accuracy:.4f} "
                  f"n={r.count}")
        dp.close()
        return 0

    h = harness(cfg.eval.logs_dir)
    if _folder_mode(cfg):
        report = h.run_paths(paths, limit=cfg.eval.limit)
    else:
        report = h.run_dataset(dataset, limit=cfg.eval.limit)
    print(f"puzzle_accuracy={report.puzzle_accuracy:.4f} "
          f"patch_accuracy={report.patch_accuracy:.4f} n={report.count} "
          f"({report.puzzles_per_sec:.2f} puzzles/s)")
    dp.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
