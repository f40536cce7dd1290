"""Batched, resumable evaluation harness.

Counterpart of ``jpdvt_mt_ntnu_tpu/eval/harness.py``, which replaces the
reference's family of eval scripts (inference.py, inference_4x4.py,
inference_ddp*.py, inferencetexmet.py, inference_texrec*.py) with one
engine:

- puzzles are solved in batches (``PuzzleSolver.evaluate_async``);
- hosts take ``paths[process_index::process_count]`` and write their own
  journals; items already in a journal are skipped (resume);
- a prefetch thread loads and stacks batch N+1 while the card solves
  batch N; an ordered writer thread appends the journal rows (and writes
  the optional PNGs);
- the solve is pipelined: batch N+1 is queued on the card before batch
  N's results are brought back, so the card's queue does not drain while
  the host scores and journals.

The scrambles come from ``draws(positions)``: the positions of a batch's
puzzles in this host's list -> ``(indices (B, P), sigmas (votes - 1, B, P)
or None)``. The default draws from a ``torch.Generator`` seeded by
``seed + process_index`` and the batch's first position, so a resumed run
draws what an uninterrupted one would; :func:`jax_draws` reads the JAX
harness's draws committed as a file. Images are decoded by the native
decoder (``ops/native.py``) and written by ``serve/png.py``: no PIL.
"""

from __future__ import annotations

import dataclasses
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..ops import jigsaw, native
from ..serve.png import encode_png
from ..utils.logging import setup_logging
from .journal import ProgressJournal
from .solver import PuzzleSolver

Draws = Callable[[np.ndarray], tuple]


@dataclasses.dataclass
class EvalReport:
    puzzle_accuracy: float
    patch_accuracy: float
    count: int
    total_time_s: float
    puzzles_per_sec: float


def torch_draws(seed: int, pieces: int, votes: int = 1) -> Draws:
    """The default draws: per batch, a CPU ``torch.Generator`` seeded by
    ``seed`` and the batch's first position."""

    def draw(positions: np.ndarray) -> tuple:
        gen = torch.Generator().manual_seed(seed * 1_000_003 + int(positions[0]))
        b = len(positions)
        indices = jigsaw.random_permutations(b, pieces, generator=gen)
        sigmas = (jigsaw.random_permutations((votes - 1) * b, pieces, generator=gen)
                  .reshape(votes - 1, b, pieces) if votes > 1 else None)
        return indices, sigmas

    return draw


def jax_draws(path: str, pieces: int, votes: int = 1) -> Draws:
    """The JAX harness's draws for ``pieces`` pieces and ``votes``, from a
    file of one row per puzzle: ``p{P}_indices`` (votes 1) or
    ``p{P}_votes{V}_indices`` and ``p{P}_votes{V}_sigmas`` (V - 1 rows per
    puzzle). Torch cannot replay ``jax.random``; the tests hold the files
    to it."""
    tag = f"p{pieces}" if votes == 1 else f"p{pieces}_votes{votes}"
    with np.load(path) as z:
        if f"{tag}_indices" not in z.files:
            raise KeyError(f"{path} holds no draws {tag!r}; it has {sorted(z.files)}")
        indices = z[f"{tag}_indices"].astype(np.int64)
        sigmas = z[f"{tag}_sigmas"].astype(np.int64) if votes > 1 else None

    def draw(positions: np.ndarray) -> tuple:
        if positions.max() >= len(indices):
            raise IndexError(f"{path} holds draws for {len(indices)} puzzles; "
                             f"position {positions.max()} asked")
        return indices[positions], (None if sigmas is None else sigmas[:, positions])

    return draw


class EvalHarness:
    def __init__(self, solver: PuzzleSolver, *, logs_dir: str, batch_size: int = 64,
                 seed: int = 0, results_dir: Optional[str] = None,
                 journal_name: str = "inference_progress.csv",
                 process_index: int = 0, process_count: int = 1,
                 draws: Optional[Draws] = None,
                 sync: Optional[Callable[[], None]] = None, writes_journal: bool = True):
        self.solver = solver
        self.batch_size = batch_size
        self.results_dir = results_dir
        self.journal = ProgressJournal(logs_dir, journal_name, host_index=process_index)
        self.process_index = process_index
        self.process_count = process_count
        self.draws = draws or torch_draws(seed + process_index, solver.pieces, solver.votes)
        # Called by every host between reading the journals and writing its
        # first row (a barrier across the hosts), so that what a host skips
        # does not depend on how far the others have got.
        self.sync = sync
        # False on the ranks of a seq group but its first, which solve the
        # same puzzles in lockstep (eval/run_eval.py).
        self.writes_journal = writes_journal
        self.logger, self.err_logger = setup_logging(logs_dir)

    # ----------------------------------------------------------------- util

    def _load_image(self, path: str) -> np.ndarray:
        """Decode, centre-crop to the model's size, scale to [-1, 1] through
        the native decoder (``ops/native.decode_center_crop``), as the JAX
        harness does where its own is built (``harness.py:70-85``): PNG and
        JPEG; a file it refuses raises a ``ValueError`` that the loop logs
        and skips."""
        with open(path, "rb") as f:
            return native.decode_center_crop(f.read(), self.solver.cfg.input_size)

    def _save_images(self, name: str, original, scrambled, reconstructed,
                     puzzle_correct: int, patch_acc: float) -> None:
        """Metric-tagged PNGs in the reference's naming (inference.py:332-344)
        and an original | scrambled | reconstructed panel, written by
        ``serve/png.py``."""
        out_dir = os.path.join(self.results_dir, f"Grid{self.solver.grid}")
        os.makedirs(out_dir, exist_ok=True)
        stem = os.path.splitext(os.path.basename(name))[0]

        def to_u8(arr):
            arr = np.asarray(arr, dtype=np.float32)
            return (np.clip(arr * 0.5 + 0.5, 0.0, 1.0) * 255).astype(np.uint8)

        def save(img, suffix):
            with open(os.path.join(out_dir, f"{stem}_{suffix}.png"), "wb") as f:
                f.write(encode_png(img))

        panels = [to_u8(a) for a in (original, scrambled, reconstructed)]
        save(panels[0], "original")
        save(panels[1], "random")
        save(panels[2], f"reconstructed_pAcc={puzzle_correct}_patchAcc={patch_acc:.2f}")
        spacer = np.full((panels[0].shape[0], 8, 3), 255, np.uint8)
        save(np.concatenate([panels[0], spacer, panels[1], spacer, panels[2]], axis=1),
             "combined")

    # ------------------------------------------------------------------ run

    def run_paths(self, image_paths: Sequence[str],
                  loader: Optional[Callable[[str], object]] = None,
                  limit: int = 0) -> EvalReport:
        """Evaluate a list of image files (resumable). ``loader`` maps a path
        to an (H, W, C) image in [-1, 1], an array or a tensor."""
        loader = loader or self._load_image
        p = self.solver.pieces
        state = self.journal.load()
        if self.sync is not None:
            self.sync()
        my_paths = list(image_paths)[self.process_index::self.process_count]
        # Journal key: the basename where basenames are unique (the
        # reference's schema, inference.py:172), else the whole path.
        basenames = [os.path.basename(q) for q in image_paths]
        key_of = os.path.basename if len(set(basenames)) == len(basenames) else str
        todo = [(i, q) for i, q in enumerate(my_paths) if key_of(q) not in state.processed]
        if limit:
            todo = todo[:max(0, limit - state.count)]
        self.logger.info(f"[host {self.process_index}/{self.process_count}] "
                         f"{len(my_paths)} files assigned, {state.count} already done, "
                         f"{len(todo)} to go")

        def load_chunk(chunk):
            images, names, positions = [], [], []
            for i, q in chunk:
                try:
                    images.append(loader(q))
                except Exception as e:  # a decode failure: skip and log
                    self.err_logger.error(f"Failed on image {key_of(q)}: {e}")
                    self.logger.error(f"Skipping {key_of(q)} due to error.")
                    continue
                names.append(key_of(q))
                positions.append(i)
            if not images:
                return None, names, None
            batch = (torch.stack(images) if isinstance(images[0], torch.Tensor)
                     else torch.from_numpy(np.stack(images)))
            if batch.device.type == "cpu" and self.solver.device.type == "cuda":
                batch = batch.pin_memory()
            return batch, names, np.asarray(positions)

        def write_results(names, batch, res, per_item):
            # The writer thread: rows stay in submission order (resume), PNGs
            # are encoded while the card solves the next batch.
            if not self.writes_journal:
                return
            if self.results_dir:
                scrambled = self.solver.scramble(batch, res.indices)
                recon = self.solver.reconstruct(scrambled, res.pred)
                for i, n in enumerate(names):
                    self._save_images(n, batch[i].float().cpu(), scrambled[i].float().cpu(),
                                      recon[i].float().cpu(), int(res.puzzle_correct[i]),
                                      float(res.patch_matches[i]) / p)
            for i, n in enumerate(names):
                self.journal.append(n, int(res.puzzle_correct[i]), int(res.patch_matches[i]),
                                    per_item)

        chunks = [todo[i:i + self.batch_size] for i in range(0, len(todo), self.batch_size)]
        start = time.time()
        done_this_run = 0
        last_done: list = [None]  # completion time of the previous batch
        writes: list = []

        def finalize(names, batch, thunk, t0):
            # Waits for batch N's results while the card runs batch N+1.
            nonlocal done_this_run
            try:
                res = thunk()
            except Exception as e:
                self.err_logger.error(f"Batch solve failed ({names[0]}...): {e}")
                return
            # Under pipelining (now - t0) spans two batches; the steady rate
            # is the completion-to-completion interval.
            now = time.time()
            elapsed = now - (last_done[0] if last_done[0] is not None else t0)
            last_done[0] = now
            per_item = elapsed / len(names)
            writes.append(writer.submit(write_results, names, batch, res, per_item))
            for i, n in enumerate(names):
                state.processed.add(n)
                state.puzzle_correct += int(res.puzzle_correct[i])
                state.patch_matches += int(res.patch_matches[i])
                state.count += 1
                done_this_run += 1
            pa, ta = state.accuracy(p)
            self.logger.info(f"{state.count} done | batch {len(names)} in {elapsed:.2f}s "
                             f"({len(names) / elapsed:.2f} puzzles/s) | running "
                             f"puzzleAcc={pa:.4f} patchAcc={ta:.4f}")

        with ThreadPoolExecutor(1, "eval-prefetch") as prefetch, \
                ThreadPoolExecutor(1, "eval-writer") as writer:
            pending = prefetch.submit(load_chunk, chunks[0]) if chunks else None
            in_flight = None  # (names, batch, result thunk, t0)
            for ci in range(len(chunks)):
                batch, names, positions = pending.result()
                pending = (prefetch.submit(load_chunk, chunks[ci + 1])
                           if ci + 1 < len(chunks) else None)
                if batch is None:
                    continue
                t0 = time.time()
                indices, sigmas = self.draws(positions)
                try:
                    thunk = self.solver.evaluate_async(batch, indices, sigmas)
                except Exception as e:
                    self.err_logger.error(f"Batch dispatch failed ({names[0]}...): {e}")
                    continue
                if in_flight is not None:
                    finalize(*in_flight)
                in_flight = (names, batch, thunk, t0)
            if in_flight is not None:
                finalize(*in_flight)
            for w in writes:
                w.result()  # surface the writer's exceptions; every row is written

        total = time.time() - start
        pa, ta = state.accuracy(p)
        # The rate counts only this run's puzzles; state.count includes the
        # journal's earlier rows.
        report = EvalReport(pa, ta, state.count, total,
                            done_this_run / total if total > 0 else 0.0)
        self.logger.info("============================================")
        self.logger.info(f"Done. Processed {state.count} images (including resumed ones).")
        self.logger.info(f"Final Puzzle Accuracy: {pa:.4f}")
        self.logger.info(f"Final Patch Accuracy: {ta:.4f}")
        self.logger.info(f"Total inference time: {total:.2f}s")
        self.journal.close()
        return report

    def run_dataset(self, dataset, limit: int = 0) -> EvalReport:
        """Evaluate an indexable dataset of (H, W, C) images in [-1, 1]."""
        names = getattr(dataset, "image_files", None) or [
            f"item_{i:06d}" for i in range(len(dataset))]
        index = {n: i for i, n in enumerate(names)}
        if getattr(dataset, "cues", None) == "waves":
            # The whole set is synthesised on the card up front, bf16 values
            # held in fp32, as the JAX harness does (harness.py:274-281).
            arr = dataset.device_generate_all(self.solver.device).float()

            def loader(path):
                return arr[index[path]]
        else:
            def loader(path):
                return dataset[index[path]]

        return self.run_paths(list(names), loader=loader, limit=limit)


def find_images(data_dir: str, extensions=(".jpg", ".jpeg", ".png"),
                exclude_substr: Optional[str] = None) -> list[str]:
    """Recursive image listing, sorted; files whose lower-cased name holds
    ``exclude_substr`` are left out (texrec skips '*mask*' files, reference
    inference_texrec.py:239-247)."""
    out = []
    for dirpath, _, files in os.walk(data_dir):
        for f in sorted(files):
            if f.lower().endswith(tuple(e.lower() for e in extensions)):
                if exclude_substr and exclude_substr in f.lower():
                    continue
                out.append(os.path.join(dirpath, f))
    return sorted(out)
