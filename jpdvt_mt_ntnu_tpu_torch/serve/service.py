"""Framework-agnostic puzzle service: the reference API's business logic.

Counterpart of ``jpdvt_mt_ntnu_tpu/serve/service.py``. One object owns the
model and its solver (loaded once at startup, like the reference's global
singletons — reference: api/app.py:115-153) and returns plain dicts
matching the reference JSON contract exactly (api/app.py:188-248
create_puzzle, :250-348 solve_puzzle, :350-451 solve). Both transports
(``serve/app.py``) delegate here.

Images are decoded without PIL: the native decoder does the decode and
the ADM center crop (``ops/native.py``), and responses are PNGs written by
``serve/png.py``. Scrambling and the reconstruction are host-side piece
moves; the solve runs on the service's device, the card unless
``device="cpu"`` is asked for.

Requests are answered on several threads (the stdlib server's handler
threads, the micro-batchers' workers). Grad mode is thread-local in
PyTorch; the solver's entry points run under ``inference_mode`` on
whatever thread calls them. A solver keeps state that two threads must not
interleave (its generator, its compute-type copy, the int8 weight caches),
so every model solve of one service holds one lock.

Difference from the reference: the reconstructed image is reassembled
seamlessly instead of via torchvision ``make_grid`` (which injects 2px
padding lines between pieces).
"""

from __future__ import annotations

import base64
import dataclasses
import logging
import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..core.diffusion import create_diffusion
from ..data import SyntheticPuzzles
from ..eval.solver import PuzzleSolver
from ..models import create_model
from ..ops import jigsaw, native
from ..tools.weights import load_artifact
from ..utils.device import default_device
from .plugins import MicroBatcher, get_solver, list_solvers
from .png import array_to_b64


@dataclasses.dataclass
class ServiceConfig:
    model_name: str = "JPDVT"
    # an artifact manifest (*.manifest.json), a flattened-params .npz, or a
    # checkpoint directory of this package (EMA weights); "" = random init
    checkpoint: str = ""
    image_size: int = 192
    grid_size: int = 3
    sampling_steps: int = 250
    sampler_mode: str = "faithful"
    seed: int = 0
    compute_dtype: str = "bfloat16"
    # "int8" / "int8:K": w8a8 products on the DiT's large projections
    # (ops/quant.py). Checkpoints are unchanged: the int8 weights are made
    # from the float parameters.
    quant: str = ""
    # Per-checkpoint quantization gate: int8's accuracy cost is
    # checkpoint-specific, so a quantized service validates the loaded
    # weights at startup. It solves ``quant_gate_n`` synthetic wave puzzles
    # with the quantized model AND an unquantized twin on the same weights
    # (fast mode, which decides the same permutations as faithful) and
    # compares the permutations: patch disagreement above
    # ``quant_gate_tol`` refuses to serve ("strict"), logs a warning
    # ("warn"), or the gate is skipped ("off").
    quant_gate: str = "strict"        # strict | warn | off
    quant_gate_n: int = 32
    quant_gate_tol: float = 0.02
    # Request micro-batching: >0 enables a MicroBatcher that stacks
    # concurrent solve requests arriving within this window into ONE padded
    # device batch (see serve/plugins.py). 0 = one solve per request.
    batch_window_ms: float = 0.0
    batch_max: int = 8
    # scaled-down overrides for tests
    depth: int = 0
    hidden_size: int = 0
    num_heads: int = 0
    # Request gate (serve/gate.py): optional API-key auth + per-client rate
    # limiting on the mutating /api POSTs, enforced identically by both
    # transports. Defaults come from the environment; empty/0 = open
    # (reference-compatible, api/app.py:49-55 has no auth at all).
    api_key: str = dataclasses.field(
        default_factory=lambda: os.environ.get("JPDVT_API_KEY", ""))
    rate_limit: float = dataclasses.field(
        default_factory=lambda: float(
            os.environ.get("JPDVT_RATE_LIMIT", "0") or 0.0))
    rate_burst: int = dataclasses.field(
        default_factory=lambda: int(
            os.environ.get("JPDVT_RATE_BURST", "0") or 0))


# The quant gate's puzzles and permutations (the JAX service's seeds).
QUANT_GATE_SEED = 20_240_814
# The most pixels an upload may declare: PIL's default decompression-bomb
# limit (twice its MAX_IMAGE_PIXELS). The JAX service takes any size (its
# transforms module lifts PIL's limit), so a few hundred bytes of header
# could make it allocate tens of GB; this service refuses them.
MAX_UPLOAD_PIXELS = 178_956_970


class PuzzleService:
    def __init__(self, cfg: ServiceConfig, device: str | torch.device | None = None):
        self.cfg = cfg
        self.device = default_device(device)
        self._dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        self._overrides = {k: v for k, v in (
            ("depth", cfg.depth), ("hidden_size", cfg.hidden_size),
            ("num_heads", cfg.num_heads), ("quant", cfg.quant)) if v}
        self.model, self.model_cfg = self._create_model(self._overrides)
        self._load_params()
        diffusion = create_diffusion(str(cfg.sampling_steps), device=self.device)
        self.solver = self._solver(self.model, self.model_cfg, cfg.sampler_mode, diffusion)
        # model_id -> solver: fast mode decides the same permutations in one
        # step; a faithful service answers "fast" with a one-step solver on
        # the same model and weights.
        self._solvers = {"default": self.solver, "fast": (
            self.solver if self.solver.mode == "fast"
            else self._solver(self.model, self.model_cfg, "fast"))}
        self._rng = np.random.default_rng(cfg.seed)
        self._lock = threading.Lock()  # held by every model solve
        # solver mode -> MicroBatcher (its worker thread starts on first use)
        by_mode = {s.mode: s for s in self._solvers.values()}
        self._batchers = {mode: MicroBatcher(
            lambda xs, s=s: self._locked_solve(s, xs), max_batch=cfg.batch_max,
            window_ms=cfg.batch_window_ms) for mode, s in by_mode.items()
        } if cfg.batch_window_ms > 0 else {}
        self.quant_gate_report: Optional[dict] = None
        if cfg.quant and cfg.quant_gate != "off":
            self.quant_gate_report = self._run_quant_gate()

    def _create_model(self, overrides: dict):
        return create_model(self.cfg.model_name, self.cfg.image_size, device=self.device,
                            seed=self.cfg.seed, dtype=self._dtype, **overrides)

    def _solver(self, model, model_cfg, mode: str, diffusion=None) -> PuzzleSolver:
        return PuzzleSolver(model, model_cfg, diffusion or self.solver.diffusion,
                            grid_size=self.cfg.grid_size, mode=mode, seed=self.cfg.seed,
                            device=self.device)

    def _load_params(self) -> None:
        """Load ``cfg.checkpoint`` into the model: an artifact manifest or a
        flattened-params npz, or a checkpoint directory of this package (its
        EMA weights). "" keeps the model's initialisation from ``seed``."""
        path = self.cfg.checkpoint
        if not path:
            return
        if path.endswith((".json", ".npz")):
            sd, _ = load_artifact(path, device=self.device)
            self.model.load_state_dict(sd, strict=True)
            return
        from ..train import CheckpointManager, create_train_state

        if not os.path.isdir(path):
            raise FileNotFoundError(f"checkpoint {path!r} does not exist")
        mgr = CheckpointManager(path)
        if mgr.latest_step() is None:
            raise NotImplementedError(
                f"checkpoint {path!r} holds no checkpoint of this package (no "
                "<step>/state.pt): an Orbax checkpoint of the JAX package is not read by "
                "the port; export it as an artifact and pass the manifest")
        state = create_train_state(self.model)
        mgr.restore(state)
        self.model.load_state_dict(state.ema.state_dict())

    def _run_quant_gate(self) -> dict:
        """int8-vs-float solve agreement on the LOADED checkpoint; see
        ``ServiceConfig.quant_gate``. Returns the report; raises
        RuntimeError in strict mode when disagreement exceeds tolerance."""
        cfg = self.cfg
        ref_model, ref_cfg = self._create_model(
            {k: v for k, v in self._overrides.items() if k != "quant"})
        ref_model.load_state_dict(self.model.state_dict())
        q_solver = self._solvers["fast"]
        b_solver = self._solver(ref_model, ref_cfg, "fast")
        n, p = cfg.quant_gate_n, cfg.grid_size ** 2
        imgs = SyntheticPuzzles(cfg.image_size, n=n, seed=QUANT_GATE_SEED,
                                cues="waves").batch()
        rng = np.random.default_rng(QUANT_GATE_SEED)
        perms = np.stack([rng.permutation(p) for _ in range(n)])
        scrambled = jigsaw.scramble(torch.from_numpy(imgs), torch.from_numpy(perms),
                                    cfg.grid_size)
        pred_q = q_solver.solve(scrambled)
        pred_b = b_solver.solve(scrambled)
        patch_dis = float((pred_q != pred_b).mean())
        puzzle_dis = float((pred_q != pred_b).any(axis=1).mean())
        report = {
            "quant": cfg.quant, "n": n, "grid_size": cfg.grid_size,
            "patch_disagreement": patch_dis,
            "puzzle_disagreement": puzzle_dis,
            "tol": cfg.quant_gate_tol, "mode": cfg.quant_gate,
            "passed": patch_dis <= cfg.quant_gate_tol,
        }
        if not report["passed"]:
            msg = (f"quant gate: {cfg.quant} disagrees with the unquantized "
                   f"solve on {patch_dis:.1%} of patches "
                   f"({puzzle_dis:.1%} of {n} puzzles) for THIS checkpoint "
                   f"— above tol {cfg.quant_gate_tol:.1%}. Quantization "
                   f"tolerance is checkpoint-specific; serve the float model, "
                   f"or set quant_gate='warn'/'off' to override.")
            if cfg.quant_gate == "strict":
                raise RuntimeError(msg)
            logging.getLogger("jpdvt.serve").warning(msg)
        return report

    # ------------------------------------------------------------ endpoints

    def models(self) -> list[dict]:
        """GET /api/models: built-ins + every registered plugin
        (api/app.py:172-186; the plugin rows are the FCViT-family analog,
        api/app.py:453-552)."""
        default = {"id": "default", "name": self.cfg.model_name,
                   "description": f"{self.cfg.grid_size}x{self.cfg.grid_size} "
                                  "Grid Jigsaw Puzzle Solver"}
        if self.cfg.quant:
            # A quantized deployment shows its startup gate's verdict.
            default["quant"] = self.cfg.quant
            default["quant_gate"] = self.quant_gate_report
        return [
            default,
            {"id": "fast", "name": f"{self.cfg.model_name} (fast)",
             "description": "Mathematically-equivalent single-step solver"},
        ] + [p.info.to_dict() for p in list_solvers()]

    def _prep(self, image_bytes: bytes) -> np.ndarray:
        """Encoded image -> (S, S, 3) float32 in [-1, 1] (ADM crop); an
        upload above PIL's decompression-bomb limit is refused from its
        header, before any buffer it sizes is allocated."""
        return native.decode_center_crop(image_bytes, self.cfg.image_size,
                                         max_pixels=MAX_UPLOAD_PIXELS)

    def _scramble(self, x: np.ndarray, indices: np.ndarray) -> np.ndarray:
        return jigsaw.scramble(torch.from_numpy(x)[None], torch.from_numpy(indices)[None],
                               self.cfg.grid_size)[0].numpy()

    def _reconstruct(self, scrambled: np.ndarray, pred: np.ndarray) -> np.ndarray:
        return jigsaw.unscramble(torch.from_numpy(scrambled)[None],
                                 torch.from_numpy(np.asarray(pred))[None],
                                 self.cfg.grid_size)[0].numpy()

    def create_puzzle(self, image_bytes: bytes,
                      seed: Optional[int] = None) -> dict:
        """POST /api/create_puzzle (api/app.py:188-248)."""
        rng = np.random.default_rng(seed) if seed is not None else self._rng
        x = self._prep(image_bytes)
        p = self.cfg.grid_size ** 2
        indices = rng.permutation(p)
        scrambled = self._scramble(x, indices)
        patch_matches = int((indices == np.arange(p)).sum())
        return {
            "original_image": array_to_b64(x),
            "puzzle_image": array_to_b64(scrambled),
            "indices": indices.tolist(),
            "initial_metrics": {
                "patch_matches": patch_matches,
                "total_patches": p,
                "patch_accuracy": patch_matches / p,
            },
        }

    def _locked_solve(self, solver: PuzzleSolver, xs: np.ndarray) -> np.ndarray:
        with self._lock:
            return solver.solve(xs)

    def _solve_scrambled(self, scrambled: np.ndarray, mode_id: str) -> np.ndarray:
        plugin = get_solver(mode_id)
        if plugin is not None:
            return plugin.solve_batch(np.asarray(scrambled)[None])[0]
        if mode_id not in self._solvers:
            raise ValueError(f"unknown model_id {mode_id!r}; "
                             f"see GET /api/models")
        solver = self._solvers[mode_id]
        if self._batchers:
            return self._batchers[solver.mode].solve(scrambled)
        return self._locked_solve(solver, np.asarray(scrambled)[None])[0]

    def solve_puzzle(self, image_bytes: bytes, model_id: str = "default") -> dict:
        """POST /api/solve_puzzle: scramble + solve (api/app.py:250-348)."""
        x = self._prep(image_bytes)
        p = self.cfg.grid_size ** 2
        indices = self._rng.permutation(p)
        scrambled = self._scramble(x, indices)
        pred = self._solve_scrambled(scrambled, model_id)
        recon = self._reconstruct(scrambled, pred)
        patch_matches = int((pred == indices).sum())
        return {
            "success": True,
            "original_image": array_to_b64(x),
            "scrambled_image": array_to_b64(scrambled),
            "solution_image": array_to_b64(recon),
            "metrics": {
                "puzzle_correct": int((pred == indices).all()),
                "patch_matches": patch_matches,
                "total_patches": p,
                "patch_accuracy": patch_matches / p,
            },
            "details": {
                "indices": indices.tolist(),
                "predicted_order": pred.tolist(),
            },
        }

    def solve(self, image_data: str, indices: Optional[list[int]] = None,
              model_id: str = "default") -> dict:
        """POST /api/solve: client sends scrambled b64 + ground-truth indices
        (api/app.py:350-451)."""
        start = time.time()
        x_scrambled = self._prep(base64.b64decode(image_data))
        pred = self._solve_scrambled(x_scrambled, model_id)
        recon = self._reconstruct(x_scrambled, pred)
        p = self.cfg.grid_size ** 2
        if indices is not None:
            original = np.asarray(indices)
            puzzle_correct = int((pred == original).all())
            patch_matches = int((pred == original).sum())
        else:
            puzzle_correct, patch_matches = 0, 0
        size = self.cfg.image_size
        g = self.cfg.grid_size
        return {
            "success": True,
            "solution_image": array_to_b64(recon),
            "predicted_order": pred.tolist(),
            "metrics": {
                "puzzle_correct": puzzle_correct,
                "patch_matches": patch_matches,
                "total_patches": p,
                "patch_accuracy": patch_matches / p,
            },
            "image_info": {
                "grid_size": f"{g}x{g}",
                "image_resolution": f"{size}x{size}",
                "patch_size": f"{size // g}x{size // g}",
            },
            "processing_time": round(time.time() - start, 2),
        }

    def shutdown(self) -> None:
        """Stop the micro-batchers' worker threads."""
        for batcher in self._batchers.values():
            batcher.shutdown()
