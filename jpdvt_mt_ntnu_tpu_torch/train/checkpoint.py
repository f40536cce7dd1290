"""Checkpoints of the whole train state, over ``torch.save``.

Counterpart of ``jpdvt_mt_ntnu_tpu/train/checkpoint.py`` (Orbax there):
one directory per step, ``<dir>/<step>/state.pt`` holding
``TrainState.state_dict()`` (step, model, EMA, AdamW count and moments;
parameter names are the ``state_dict`` names that ``tools/weights.py``
maps from the JAX tree), and a ``metadata.json`` beside the step
directories. A step is written to a temporary directory and renamed, so a
reader never sees half of one. Restores are bit-exact. In a data-parallel
run (``dp``) rank 0 writes and the other ranks wait until it has, so that
every rank restores the same file (the reference saves on rank 0 only). A
state sharded over a mesh is gathered first, by every rank, so the file
holds the one-process layout whatever the mesh, and restores into one
process or into another mesh.
"""

from __future__ import annotations

import json
import os
import shutil

import torch

from ..parallel.mesh import DataParallel
from .state import TrainState

STATE_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int | None = None,
                 dp: DataParallel | None = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.dp = dp or DataParallel()
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> list[int]:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.isfile(
                          os.path.join(self.directory, d, STATE_FILE)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState, metadata: dict | None = None) -> bool:
        """Write ``state`` at its step; False (and nothing written) when that
        step is already saved, e.g. the final save right after a periodic
        one at the same step. Every rank calls it (a sharded state is
        gathered on all of them); rank 0 writes, and each rank returns once
        the step is on disk."""
        sd = state.state_dict()
        return self.dp.broadcast(self._write(int(state.step), sd, metadata)
                                 if self.dp.is_main else None)

    def _write(self, step: int, sd: dict, metadata: dict | None) -> bool:
        if step in self.all_steps():
            return False
        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(self.directory, f".{step}.tmp.{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(sd, os.path.join(tmp, STATE_FILE))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        if metadata is not None:
            with open(os.path.join(self.directory, "metadata.json"), "w") as f:
                json.dump(metadata, f, indent=2, default=str)
        if self.max_to_keep:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))
        return True

    def restore(self, state: TrainState, step: int | None = None) -> TrainState:
        """Copy checkpoint ``step`` (default: the latest) into ``state``'s
        tensors, on their devices, and return it."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        sd = torch.load(os.path.join(self.directory, str(step), STATE_FILE),
                        map_location="cpu", weights_only=True)
        state.load_state_dict(sd)
        return state

    def metadata(self) -> dict:
        path = os.path.join(self.directory, "metadata.json")
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            return json.load(f)
