"""Relaunch ``run_train`` after a preemption, and after a stall.

The port's counterpart of ``scripts/train_autoresume.sh`` and
``scripts/train_watchdog.sh`` in one module:

    python -m jpdvt_mt_ntnu_tpu_torch.train.autoresume EXP_DIR \\
        [--stall-secs S] [--launch-grace G] [--poll-secs P] [run_train overrides...]

It launches ``python -m jpdvt_mt_ntnu_tpu_torch.train.run_train
train.exp_dir=EXP_DIR [overrides]`` as a child process. The child writes
its checkpoint and exits 42 (``run_train.PREEMPTED_EXIT``) on SIGTERM or
SIGINT; the loop then relaunches it with ``train.resume=EXP_DIR/checkpoints``
until it exits with any other code, which it returns. Once the exp dir
holds checkpoints, a ``train.warm_start=`` override is dropped (the warm
start happened on the first attempt, and run_train refuses it beside
``train.resume``).

With ``--stall-secs`` it also watches the run, as the watchdog does: every
``--poll-secs`` (default ``$POLL_SECS`` or 30) it reads the mtimes of the
exp dir's ``log.txt`` and ``metrics.jsonl``. Until this attempt has written
a non-empty ``metrics.jsonl`` (its first step), the clock runs from the
launch against ``--launch-grace`` (default ``$LAUNCH_GRACE`` or 1500 s:
restore and warm-up write no step); after, from the newest mtime against
``--stall-secs``. Past the limit it SIGKILLs the child's recorded PID (no
other process) and relaunches, losing at most ``train.ckpt_every`` steps.

The run goes to the card unless the overrides say ``device=cpu``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

from .run_train import PREEMPTED_EXIT

RUN_TRAIN = [sys.executable, "-m", "jpdvt_mt_ntnu_tpu_torch.train.run_train"]


def has_checkpoints(exp_dir: str) -> bool:
    ckpt = os.path.join(exp_dir, "checkpoints")
    return os.path.isdir(ckpt) and any(
        os.path.isdir(os.path.join(ckpt, e)) for e in os.listdir(ckpt))


def attempt_args(exp_dir: str, overrides: list[str], log=print) -> list[str]:
    """run_train's arguments for the next attempt."""
    args = [f"train.exp_dir={exp_dir}"]
    resume = has_checkpoints(exp_dir)
    if resume:
        args.append(f"train.resume={os.path.join(exp_dir, 'checkpoints')}")
    for a in overrides:
        if resume and a.startswith("train.warm_start="):
            log(f"[autoresume] dropping {a} (resuming from own checkpoints)")
            continue
        args.append(a)
    return args


def newest_mtime(exp_dir: str) -> float:
    times = [os.path.getmtime(p) for p in (os.path.join(exp_dir, "log.txt"),
                                           os.path.join(exp_dir, "metrics.jsonl"))
             if os.path.exists(p)]
    return max(times, default=0.0)


def stall(exp_dir: str, launched: float, now: float, stall_secs: float,
          grace: float) -> tuple[float, float]:
    """(age, limit) of the watchdog's rule: from the launch against the
    grace until metrics.jsonl has a line, then from the newest write."""
    last = newest_mtime(exp_dir)
    metrics = os.path.join(exp_dir, "metrics.jsonl")
    if last < launched or not (os.path.exists(metrics) and os.path.getsize(metrics)):
        return now - launched, grace
    return now - last, stall_secs


def launch(args: list[str]) -> subprocess.Popen:
    """run_train in a child process, of this very package from any cwd."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=root + (os.pathsep + path if path else ""))
    return subprocess.Popen(RUN_TRAIN + args, stdin=subprocess.DEVNULL, env=env)


def supervise(exp_dir: str, overrides: list[str], stall_secs: float | None = None,
              grace: float = 1500.0, poll: float = 30.0, *, launch=launch,
              clock=time.time, sleep=time.sleep, log=print) -> int:
    """The relaunch loop; returns the first exit code other than 42.
    ``launch``, ``clock`` and ``sleep`` are the process and the time."""
    attempt = 0
    while True:
        args = attempt_args(exp_dir, overrides, log)
        log(f"[autoresume] attempt {attempt}: run_train {' '.join(args)}")
        proc = launch(args)
        launched = clock()
        wedged = False
        while stall_secs is not None and proc.poll() is None:
            sleep(poll)
            age, limit = stall(exp_dir, launched, clock(), stall_secs, grace)
            if age > limit and proc.poll() is None:
                log(f"[autoresume] no progress for {age:.0f}s (> {limit:.0f}s); "
                    f"killing {proc.pid}")
                proc.kill()  # SIGKILL to the recorded PID only
                proc.wait()
                wedged = True
                break
        attempt += 1
        if wedged:
            log(f"[autoresume] relaunching after a stall (attempt {attempt})")
            continue
        code = proc.wait()
        if code != PREEMPTED_EXIT:
            log(f"[autoresume] run_train exited {code}; stopping")
            return code
        log(f"[autoresume] preempted; resuming (attempt {attempt})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("exp_dir", help="the experiment dir (also train.exp_dir)")
    ap.add_argument("overrides", nargs="*", help="run_train's overrides")
    ap.add_argument("--stall-secs", type=float, default=None,
                    help="kill and relaunch a run that writes nothing for this long")
    ap.add_argument("--launch-grace", type=float,
                    default=float(os.environ.get("LAUNCH_GRACE", 1500)))
    ap.add_argument("--poll-secs", type=float, default=float(os.environ.get("POLL_SECS", 30)))
    a = ap.parse_intermixed_args(argv)
    return supervise(a.exp_dir, a.overrides, a.stall_secs, a.launch_grace, a.poll_secs)


if __name__ == "__main__":
    raise SystemExit(main())
