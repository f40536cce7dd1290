"""Logging + metric journaling.

The port's own copy of ``jpdvt_mt_ntnu_tpu/utils/logging.py`` (pure
Python): the reference's rank-0-only training logger (train_JPDVT.py:61-76)
and the metric sink. Scalar metrics always stream to a JSONL
file; wandb is a lazy import reached only when asked for
(``train.wandb=true``), never by default.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Optional


def rank0_logger(is_main: bool, experiment_dir: Optional[str] = None,
                 name: str = "jpdvt.train") -> logging.Logger:
    """Rank-0 logs to stdout+file; other hosts get a null logger
    (train_JPDVT.py:61-76)."""
    logger = logging.getLogger(name)
    logger.handlers.clear()
    if not is_main:
        logger.addHandler(logging.NullHandler())
        logger.setLevel(logging.CRITICAL)
        return logger
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter("[%(asctime)s] %(message)s", datefmt="%Y-%m-%d %H:%M:%S")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if experiment_dir:
        os.makedirs(experiment_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(experiment_dir, "log.txt"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class MetricWriter:
    """Scalar metric sink: JSONL always; wandb too when available+enabled.

    Run naming/config mirrors the reference's wandb setup
    (train_JPDVT.py:133-208) without the hard dependency.
    """

    def __init__(self, directory: str, *, use_wandb: bool = False,
                 run_name: str = "", config: Optional[dict] = None,
                 tags: Optional[list] = None, is_main: bool = True):
        self.is_main = is_main
        self._wandb = None
        self._fh = None
        if not is_main:
            return
        os.makedirs(directory, exist_ok=True)
        self._fh = open(os.path.join(directory, "metrics.jsonl"), "a")
        if config is not None:
            with open(os.path.join(directory, "run_config.json"), "w") as f:
                json.dump(config, f, indent=2, default=str)
        if use_wandb:
            try:
                import wandb  # noqa: PLC0415

                self._wandb = wandb.init(project="JPDVT-TPU", name=run_name or None,
                                         config=config, tags=tags, resume="allow")
            except Exception:
                self._wandb = None

    def log(self, metrics: dict, step: int) -> None:
        if not self.is_main:
            return
        rec = {"step": step, "time": time.time(), **{
            k: (float(v) if hasattr(v, "__float__") else v)
            for k, v in metrics.items()}}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def finish(self, summary: Optional[dict] = None) -> None:
        if not self.is_main:
            return
        if summary:
            self.log({"summary": summary}, step=-1)
        if self._fh:
            self._fh.close()
        if self._wandb is not None:
            self._wandb.finish()


def auto_experiment_dir(results_dir: str, dataset: str, model: str,
                        crop: bool = False, with_mask: bool = False) -> str:
    """Auto-numbered experiment folders, reference naming scheme
    ``{index:03d}-{dataset}-{model}[-crop][-withmask]``
    (train_JPDVT.py:121-127)."""
    os.makedirs(results_dir, exist_ok=True)
    existing = [d for d in os.listdir(results_dir)
                if os.path.isdir(os.path.join(results_dir, d))]
    index = len(existing)
    name = f"{index:03d}-{dataset}-{model.replace('/', '-')}"
    if crop:
        name += "-crop"
    if with_mask:
        name += "-withmask"
    path = os.path.join(results_dir, name)
    os.makedirs(path, exist_ok=True)
    return path
