"""Solver plugin registry + request micro-batching for the serving layer.

Counterpart of ``jpdvt_mt_ntnu_tpu/serve/plugins.py`` (numpy and the
standard library only). The reference API serves a SECOND model family
(FCViT) through the same ``model_id`` request field, with its own
checkpoint loading and solve path hardcoded into the app (reference:
api/app.py:453-552). Here that is a
plugin protocol: any object with an ``info`` and a ``solve_batch`` can be
registered and is immediately listed by ``GET /api/models`` and routable by
every solve endpoint — no app changes.

Also here: :class:`MicroBatcher`, the serving-side answer to "one device
program per request wastes the chip". Concurrent requests landing within a
short window are stacked into ONE padded device batch (one batch shape,
so the card runs one set of kernel shapes per mode), solved together, and
fanned back out to their callers.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Optional, Protocol, runtime_checkable

import numpy as np


@dataclasses.dataclass(frozen=True)
class SolverInfo:
    id: str
    name: str
    description: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@runtime_checkable
class SolverPlugin(Protocol):
    """Anything that can turn scrambled images into slot permutations.

    ``solve_batch(scrambled)``: (B, H, W, C) float images in [-1, 1] ->
    (B, P) int permutations, same convention as PuzzleSolver.solve: entry k
    is the original slot of the piece currently at scrambled slot k.
    """

    info: SolverInfo

    def solve_batch(self, scrambled: np.ndarray) -> np.ndarray: ...


_REGISTRY: dict[str, SolverPlugin] = {}
_RESERVED = ("default", "fast")


def register_solver(plugin: SolverPlugin) -> None:
    if plugin.info.id in _RESERVED:
        raise ValueError(f"model id {plugin.info.id!r} is reserved")
    _REGISTRY[plugin.info.id] = plugin


def unregister_solver(solver_id: str) -> None:
    _REGISTRY.pop(solver_id, None)


def get_solver(solver_id: str) -> Optional[SolverPlugin]:
    return _REGISTRY.get(solver_id)


def list_solvers() -> list[SolverPlugin]:
    return list(_REGISTRY.values())


# ---------------------------------------------------------------------------
# A second, genuinely different solver family: classical edge matching.
# Fills the registry slot the reference gives FCViT (api/app.py:453-552) —
# an alternative solver behind the same API — without shipping a second
# 100M-param checkpoint. No learned weights: pieces are placed greedily by
# border continuity (sum-squared difference across adjacent piece edges).
# ---------------------------------------------------------------------------


class EdgeMatchSolver:
    """Greedy border-compatibility jigsaw solver (diffusion-free baseline)."""

    def __init__(self, grid_size: int = 3):
        self.grid = grid_size
        self.info = SolverInfo(
            id="edgematch",
            name=f"EdgeMatch {grid_size}x{grid_size}",
            description="Classical greedy edge-continuity solver "
                        "(no neural network)")

    def _pieces(self, img: np.ndarray) -> np.ndarray:
        h = img.shape[0] // self.grid
        w = img.shape[1] // self.grid
        g = self.grid
        p = img.reshape(g, h, g, w, -1).transpose(0, 2, 1, 3, 4)
        return p.reshape(g * g, h, w, -1)

    def _solve_one(self, img: np.ndarray) -> np.ndarray:
        g, p = self.grid, self.grid * self.grid
        pieces = self._pieces(img.astype(np.float64))
        # Pairwise edge costs: right[a, b] = cost of b sitting right of a,
        # down[a, b] = cost of b sitting below a.
        right_edge = pieces[:, :, -1, :]   # (P, h, C)
        left_edge = pieces[:, :, 0, :]
        bottom_edge = pieces[:, -1, :, :]
        top_edge = pieces[:, 0, :, :]
        right = ((right_edge[:, None] - left_edge[None]) ** 2).sum((-1, -2))
        down = ((bottom_edge[:, None] - top_edge[None]) ** 2).sum((-1, -2))

        best_assign, best_cost = None, np.inf
        for seed in range(p):                      # anchor piece at slot 0
            assign = np.full(p, -1)                # slot -> piece
            used = np.zeros(p, bool)
            assign[0] = seed
            used[seed] = True
            cost = 0.0
            for slot in range(1, p):
                i, j = divmod(slot, g)
                cand = np.zeros(p)
                if j > 0:
                    cand += right[assign[slot - 1]]
                if i > 0:
                    cand += down[assign[slot - g]]
                cand[used] = np.inf
                pick = int(np.argmin(cand))
                cost += cand[pick]
                assign[slot] = pick
                used[pick] = True
            if cost < best_cost:
                best_cost, best_assign = cost, assign
        pred = np.empty(p, np.int64)               # piece -> slot
        pred[best_assign] = np.arange(p)
        return pred

    def solve_batch(self, scrambled: np.ndarray) -> np.ndarray:
        return np.stack([self._solve_one(im) for im in scrambled])


# ---------------------------------------------------------------------------
# Request micro-batching
# ---------------------------------------------------------------------------


class MicroBatcher:
    """Batch concurrent solve requests into one padded device program.

    A single worker thread drains the queue: the first request opens a
    window of ``window_ms``; everything that arrives before it closes (up
    to ``max_batch``) is stacked, padded to exactly ``max_batch`` rows (one
    batch shape, ever, so the kernels see one set of shapes), solved in one
    call, and the per-request results are delivered back through
    per-request events.

    The reference has no equivalent — its FastAPI app runs one
    ``model(...)`` per request (api/app.py:250-348); under concurrency the
    GPU serializes single-image programs. Here n concurrent requests cost
    one batched program.
    """

    def __init__(self, solve_fn: Callable[[np.ndarray], np.ndarray], *,
                 max_batch: int = 8, window_ms: float = 5.0):
        self.solve_fn = solve_fn
        self.max_batch = max_batch
        self.window_s = window_ms / 1000.0
        self._q: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.batches_run = 0
        self.items_run = 0

    def _ensure_worker(self):
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._stop.clear()
                self._thread = threading.Thread(target=self._loop,
                                                daemon=True)
                self._thread.start()

    def _loop(self):
        import time

        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.monotonic() + self.window_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break
            xs = np.stack([item[0] for item in batch])
            n = xs.shape[0]
            if n < self.max_batch:   # pad to the one compiled shape
                pad = np.broadcast_to(xs[:1],
                                      (self.max_batch - n,) + xs.shape[1:])
                xs = np.concatenate([xs, pad])
            try:
                preds = np.asarray(self.solve_fn(xs))[:n]
                for (_, slot), pred in zip(batch, preds):
                    slot["result"] = pred
                    slot["event"].set()
            except Exception as e:  # deliver the failure to every waiter
                for _, slot in batch:
                    slot["error"] = e
                    slot["event"].set()
            self.batches_run += 1
            self.items_run += n

    def solve(self, scrambled: np.ndarray, timeout: float = 120.0) -> np.ndarray:
        """Blocking single-request entry (called from any server thread)."""
        self._ensure_worker()
        slot = {"event": threading.Event(), "result": None, "error": None}
        self._q.put((np.asarray(scrambled), slot))
        if not slot["event"].wait(timeout):
            raise TimeoutError("solve request timed out in the batch queue")
        if slot["error"] is not None:
            raise slot["error"]
        return slot["result"]

    def shutdown(self, timeout: float = 5.0):
        """Stop the worker thread and wait for it to end."""
        self._stop.set()
        with self._lock:
            thread = self._thread
        if thread is not None:
            thread.join(timeout)
