"""The port's own user entry points outside the library, on the CPU.

- ``examples/demo_walkthrough`` and ``examples/masked_patches_demo`` (the
  port's copies of ``examples/*.py``) on the tiny trained fixture
  (``tests/fixtures/tiny_jpdvt_48px.npz``, fp32, fast sampler of 10 steps):
  with the JAX examples' draws (the scramble of ``jax.random.key(seed)``
  and the JAX solver's noise template, injected) they predict the JAX
  examples' permutation, masked slots too; their image is the JAX
  examples' synthetic texture; their panel is a valid PNG holding the
  image, the scrambled (or masked) input and the reconstruction.
- ``train/autoresume`` (``scripts/train_autoresume.sh`` and
  ``train_watchdog.sh`` in one module): the relaunch rule on an injected
  launcher (exit 42 relaunches with ``train.resume``, ``train.warm_start``
  dropped once checkpoints exist, another code stops); the stall rule on
  an injected clock (the launch grace until ``metrics.jsonl`` has a line,
  then the stall limit from the newest write, SIGKILL of the recorded
  process only); and one real ``run_train`` on the CPU, SIGTERMed after
  its first checkpoint, relaunched, ending at the uninterrupted run's step
  with its checkpoints.
"""

import functools
import os
import re
import signal
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jpdvt_mt_ntnu_tpu.core.diffusion import create_diffusion as jax_create_diffusion
from jpdvt_mt_ntnu_tpu.data import SyntheticPuzzles as JaxSyntheticPuzzles
from jpdvt_mt_ntnu_tpu.eval.run_eval import load_params as jax_load_params
from jpdvt_mt_ntnu_tpu.eval.solver import PuzzleSolver as JaxPuzzleSolver
from jpdvt_mt_ntnu_tpu.models import create_model as jax_create_model
from jpdvt_mt_ntnu_tpu.ops import jigsaw as jax_jigsaw
from jpdvt_mt_ntnu_tpu.utils.config import Config as JaxConfig
from jpdvt_mt_ntnu_tpu_torch.examples import demo_walkthrough, masked_patches_demo
from jpdvt_mt_ntnu_tpu_torch.ops import native
from jpdvt_mt_ntnu_tpu_torch.train import CheckpointManager, autoresume, run_train
from torch_tools_common import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "tiny_jpdvt_48px.npz")
TINY = dict(depth=2, hidden_size=64, num_heads=4)
SEED, SKIP = 3, [1, 5, 6]


def _jax_example(masked: bool):
    """What the JAX example computes: its image, scramble, input and
    prediction, and its solver's noise template."""
    jmodel, jcfg = jax_create_model("JPDVT", 48, **TINY)
    c = JaxConfig()
    c.eval.checkpoint = FIXTURE
    params = jax_load_params(c, jmodel, jcfg)
    solver = JaxPuzzleSolver(jmodel, jcfg, jax_create_diffusion("10"), grid_size=3,
                             mode="fast", seed=SEED)
    img = JaxSyntheticPuzzles(48, n=1, seed=SEED)[0]
    scrambled, indices = solver.scramble(jnp.asarray(img)[None], jax.random.key(SEED))
    shown = scrambled
    if masked:
        piece_mask = np.ones((1, 9), np.float32)
        piece_mask[0, SKIP] = 0.0
        shown = scrambled * jax_jigsaw.piece_mask_to_image(jnp.asarray(piece_mask), 3, 16, 3)
    pred = solver.solve(params, shown)
    return (img, np.asarray(indices), np.asarray(shown)[0], np.asarray(pred),
            np.asarray(solver.noise_template))


@pytest.mark.parametrize("masked", [False, True], ids=["walkthrough", "masked"])
def test_demo_predicts_the_jax_examples_permutation(masked, tmp_path, monkeypatch, capsys):
    img, indices, shown, pred, template = _jax_example(masked)
    module = masked_patches_demo if masked else demo_walkthrough
    # The JAX example's draws: its scramble and its noise template.
    monkeypatch.setattr(module, "scramble_indices", lambda seed, grid: indices)
    monkeypatch.setattr(demo_walkthrough, "PuzzleSolver",
                        functools.partial(demo_walkthrough.PuzzleSolver,
                                          noise_template=template))
    out = tmp_path / "panel.png"
    argv = ["--device", "cpu", "--image-size", "48", "--depth", "2", "--hidden-size", "64",
            "--num-heads", "4", "--checkpoint", FIXTURE, "--mode", "fast", "--steps", "10",
            "--seed", str(SEED), "--out", str(out)]
    assert module.main(argv + (["--skip", *map(str, SKIP)] if masked else [])) == 0
    text = capsys.readouterr().out
    got = re.search(r"predicted(?: slots)?: +(\[.*\])", text).group(1)
    assert got == str(pred[0].tolist())
    assert (pred[0] == indices[0]).all() != masked  # the full puzzle solves, the masked not
    np.testing.assert_allclose(demo_walkthrough.load_image("", 48, SEED), img,
                               rtol=0, atol=1e-6)
    panel = native.png_pixels(out.read_bytes())
    assert panel.shape == (48, 3 * 48 + 16, 3)
    for col, want in ((0, img), (1, shown)):
        tile = panel[:, col * (48 + 8):col * (48 + 8) + 48]
        level = (np.clip(want * 0.5 + 0.5, 0, 1) * 255).astype(np.uint8)
        assert np.abs(tile.astype(int) - level).max() <= 1, col


class FakeProcess:
    """A child that runs until killed (``code`` None) or exits ``code``."""

    def __init__(self, code, clock=None):
        self.code, self.pid, self.killed_at, self._clock = code, 4242, None, clock

    def poll(self):
        return self.code

    def wait(self):
        return self.code

    def kill(self):
        self.killed_at = self._clock() if self._clock else True
        self.code = -signal.SIGKILL


def test_relaunches_on_preemption_with_resume_and_drops_the_warm_start(tmp_path):
    exp = tmp_path / "exp"
    calls, codes = [], iter([42, 42, 0])

    def launch(args):
        calls.append(args)
        (exp / "checkpoints" / str(10 * len(calls))).mkdir(parents=True, exist_ok=True)
        return FakeProcess(next(codes))

    overrides = ["device=cpu", "train.warm_start=artifacts/a.manifest.json", "train.lr=0.1"]
    assert autoresume.supervise(str(exp), overrides, launch=launch, log=lambda m: None) == 0
    assert calls[0] == [f"train.exp_dir={exp}", *overrides]
    resume = [f"train.exp_dir={exp}", f"train.resume={exp}/checkpoints", "device=cpu",
              "train.lr=0.1"]
    assert calls[1:] == [resume, resume]
    # Any other exit code stops the loop and is returned; with checkpoints
    # in place every attempt resumes.
    calls.clear()
    codes = iter([42, 3])
    assert autoresume.supervise(str(exp), overrides, launch=launch, log=lambda m: None) == 3
    assert calls == [resume, resume]


def test_stall_rule_kills_the_recorded_process_and_relaunches(tmp_path):
    exp = tmp_path / "exp"
    exp.mkdir()
    now = [1000.0]
    procs, kinds = [], iter(["silent", "stalls", "finishes"])

    def touch(name, text):
        path = exp / name
        path.write_text(text)
        os.utime(path, (now[0], now[0]))

    def launch(args):
        kind = next(kinds)
        proc = FakeProcess(0 if kind == "finishes" else None, clock=lambda: now[0])
        proc.kind, proc.start = kind, now[0]
        procs.append(proc)
        if kind == "stalls":
            touch("log.txt", "config\n")  # the config dump alone is no progress
        return proc

    def sleep(dt):
        now[0] += dt
        p = procs[-1]
        if p.kind == "stalls" and now[0] - p.start <= 50:  # a step a poll for 50 s
            touch("log.txt", "step\n")
            touch("metrics.jsonl", '{"train_loss": 1.0}\n')

    logs = []
    assert autoresume.supervise(str(exp), ["device=cpu"], stall_secs=30, grace=100, poll=10,
                                launch=launch, clock=lambda: now[0], sleep=sleep,
                                log=logs.append) == 0
    assert [p.kind for p in procs] == ["silent", "stalls", "finishes"]
    # Nothing written: the grace from the launch (the first poll past 100 s).
    assert procs[0].killed_at - procs[0].start == 110
    # Steps until 50 s, then none: the stall limit from the last write.
    assert procs[1].killed_at - procs[1].start == 90
    assert procs[2].killed_at is None
    assert sum("killing 4242" in m for m in logs) == 2


RUN = ["device=cpu", "data.synthetic_cues=waves", "data.global_batch_size=8",
       "data.num_workers=2", "data.synthetic_n=32", "model.image_size=48", "model.depth=2",
       "model.hidden_size=64", "model.num_heads=4", "model.compute_dtype=float32",
       "train.log_every=4", "train.ckpt_every=4", "train.val_every=1000000",
       "diffusion.sampling_steps=2", "diffusion.sampler_mode=fast", "train.epochs=40"]


def test_a_sigtermed_run_resumes_to_the_uninterrupted_step(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    # The launched run_train processes on one thread too (torch_tools_common).
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    assert run_train.main(RUN + [f"train.exp_dir={tmp_path / 'one'}"]) == 0
    want = CheckpointManager(str(tmp_path / "one" / "checkpoints")).latest_step()
    assert want == 160  # 40 epochs of 4 steps
    exp = tmp_path / "exp"
    procs = []

    def sigterm_after_first_checkpoint(proc):
        deadline = time.time() + 240
        while proc.poll() is None and time.time() < deadline:
            if (exp / "checkpoints").is_dir() and any((exp / "checkpoints").iterdir()):
                proc.send_signal(signal.SIGTERM)
                return
            time.sleep(0.05)

    def launch(args):
        proc = autoresume.launch(args)
        if not procs:
            threading.Thread(target=sigterm_after_first_checkpoint, args=(proc,),
                             daemon=True).start()
        procs.append(proc)
        return proc

    logs = []
    assert autoresume.supervise(str(exp), RUN, launch=launch, log=logs.append) == 0
    assert [p.returncode for p in procs] == [run_train.PREEMPTED_EXIT, 0], logs
    steps = CheckpointManager(str(exp / "checkpoints")).all_steps()
    assert steps[-1] == want and len(steps) >= 2
    log = (exp / "log.txt").read_text()
    assert re.search(r"Preempted: checkpoint saved at step (\d+)", log)
    assert "Resumed from step" in log
