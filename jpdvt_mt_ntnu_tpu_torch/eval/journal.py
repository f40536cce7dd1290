"""Resumable CSV progress journal.

Counterpart of ``jpdvt_mt_ntnu_tpu/eval/journal.py``, with the same schema
(filename, puzzle_correct, patch_matches, time_s: the reference's
``inference_progress.csv``, image_model/inference.py:166-181) and the same
files: each host writes its own journal (``inference_progress.csv``,
``inference_progress_host{k}.csv``) and all of them are merged when a run
resumes.
"""

from __future__ import annotations

import csv
import glob
import os
from dataclasses import dataclass, field


@dataclass
class JournalState:
    processed: set[str] = field(default_factory=set)
    puzzle_correct: int = 0
    patch_matches: int = 0
    count: int = 0
    total_time: float = 0.0

    def accuracy(self, pieces_per_puzzle: int) -> tuple[float, float]:
        if self.count == 0:
            return 0.0, 0.0
        return (self.puzzle_correct / self.count,
                self.patch_matches / (self.count * pieces_per_puzzle))


class ProgressJournal:
    FIELDS = ["filename", "puzzle_correct", "patch_matches", "time_s"]

    def __init__(self, logs_dir: str, name: str = "inference_progress.csv",
                 host_index: int = 0):
        os.makedirs(logs_dir, exist_ok=True)
        base, ext = os.path.splitext(name)
        self.pattern = os.path.join(logs_dir, f"{base}*{ext}")
        suffix = f"_host{host_index}" if host_index else ""
        self.path = os.path.join(logs_dir, f"{base}{suffix}{ext}")
        self._fh = None
        self._writer = None

    def load(self) -> JournalState:
        """Merge every host's journal into one resume state
        (inference.py:139-164)."""
        state = JournalState()
        for path in sorted(glob.glob(self.pattern)):
            with open(path, newline="") as f:
                for row in csv.DictReader(f):
                    state.processed.add(row["filename"])
                    state.puzzle_correct += int(row["puzzle_correct"])
                    state.patch_matches += int(row["patch_matches"])
                    state.total_time += float(row.get("time_s", 0) or 0)
                    state.count += 1
        return state

    def append(self, filename: str, puzzle_correct: int, patch_matches: int,
               time_s: float) -> None:
        if self._fh is None:
            exists = os.path.exists(self.path)
            self._fh = open(self.path, "a", newline="")
            self._writer = csv.DictWriter(self._fh, fieldnames=self.FIELDS)
            if not exists:
                self._writer.writeheader()
        self._writer.writerow({
            "filename": filename,
            "puzzle_correct": int(puzzle_correct),
            "patch_matches": int(patch_matches),
            "time_s": f"{time_s:.2f}",
        })
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
