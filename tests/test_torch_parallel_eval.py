"""``run_eval`` on two processes (gloo, CPU) against the JAX package's hosts.

The tiny trained model (``tests/fixtures/tiny_jpdvt_48px.npz``, fp32) on
the 1,024 synthetic waves puzzles of ``eval.seed=11``, fast mode, greedy:

- rank r of a 2-rank ``run_eval`` takes ``paths[r::2]`` with the JAX
  harness's draws of ``seed + r`` (``eval.jax_draws`` with
  ``{process_index}``) and the seed-11 template: its journal
  (``inference_progress.csv`` on rank 0, ``inference_progress_host1.csv``
  on rank 1) equals, row by row, the journal of the JAX
  ``EvalHarness(process_index=r, process_count=2)`` (16 puzzles a host at
  batch 8);
- with the port's own draws, the two journals together hold every puzzle
  once, each equals an in-process port harness run with the same
  ``(process_index, process_count)``, and a run cut at 64 puzzles a host
  and resumed equals the uncut one.

Permutations and scores are compared exactly (fp32 on both sides).
"""

import csv
import os
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np

from torch_parallel_worker import launch, logs, wait_all
from jpdvt_mt_ntnu_tpu.core.diffusion import create_diffusion as jax_create_diffusion
from jpdvt_mt_ntnu_tpu.data import SyntheticPuzzles as JaxSyntheticPuzzles
from jpdvt_mt_ntnu_tpu.eval.harness import EvalHarness as JaxEvalHarness
from jpdvt_mt_ntnu_tpu.eval.solver import PuzzleSolver as JaxPuzzleSolver
from jpdvt_mt_ntnu_tpu.models import create_model as jax_create_model
from jpdvt_mt_ntnu_tpu.ops import jigsaw as jax_jigsaw
from jpdvt_mt_ntnu_tpu.tools.torch_convert import load_npz_params
from jpdvt_mt_ntnu_tpu_torch.core.diffusion import create_diffusion
from jpdvt_mt_ntnu_tpu_torch.data import SyntheticPuzzles
from jpdvt_mt_ntnu_tpu_torch.eval.harness import EvalHarness
from jpdvt_mt_ntnu_tpu_torch.eval.solver import PuzzleSolver
from jpdvt_mt_ntnu_tpu_torch.models import create_model
from jpdvt_mt_ntnu_tpu_torch.tools.weights import load_artifact
from torch_tools_common import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "tiny_jpdvt_48px.npz")
TINY = dict(depth=2, hidden_size=64, num_heads=4)
ARGS = ["device=cpu", "model.image_size=48", "model.depth=2", "model.hidden_size=64",
        "model.num_heads=4", "model.compute_dtype=float32", "data.dataset=synthetic",
        "data.synthetic_cues=waves", f"eval.checkpoint={FIXTURE}", "eval.seed=11",
        "diffusion.sampler_mode=fast"]
CLI = [sys.executable, "-m", "jpdvt_mt_ntnu_tpu_torch.eval.run_eval"]
JOURNALS = ("inference_progress.csv", "inference_progress_host1.csv")


def _run_two(tmp_path, name: str, args: list[str]) -> None:
    """``run_eval`` on 2 ranks (torchrun's environment, gloo on 127.0.0.1)."""
    procs = launch(lambda r: CLI + ARGS + args, tmp_path, name)
    assert wait_all(procs) == [0, 0], logs(procs)


def _rows(path) -> list[tuple]:
    with open(path, newline="") as f:
        return [(r["filename"], int(r["puzzle_correct"]), int(r["patch_matches"]))
                for r in csv.DictReader(f)]


def jax_host_draws(seed: int, n: int, batch: int) -> dict:
    """The JAX harness's scrambles of one host (``harness.py:145,228``)."""
    rng = np.random.default_rng(seed)
    out = [jax_jigsaw.random_permutations(jax.random.key(int(rng.integers(0, 2 ** 31))),
                                          min(batch, n - s), 9)
           for s in range(0, n, batch)]
    return {"p9_indices": np.concatenate([np.asarray(a) for a in out]).astype(np.uint16)}


def test_two_rank_journals_equal_the_jax_hosts(tmp_path):
    jmodel, jcfg = jax_create_model("JPDVT", 48, **TINY)
    params = jax.tree.map(jnp.asarray, load_npz_params(FIXTURE))
    jsolver = JaxPuzzleSolver(jmodel, jcfg, jax_create_diffusion("250"), grid_size=3,
                              mode="fast", assignment_method="greedy", seed=11)
    ds = JaxSyntheticPuzzles(48, n=1024, seed=11, cues="waves")
    for r in range(2):
        np.savez(tmp_path / f"draws_host{r}.npz", **jax_host_draws(11 + r, 16, 8))
        JaxEvalHarness(jsolver, params, logs_dir=str(tmp_path / f"jax{r}"), batch_size=8,
                       seed=11, process_index=r, process_count=2).run_dataset(ds, limit=16)
    np.save(tmp_path / "noise.npy", np.asarray(jsolver.noise_template))
    _run_two(tmp_path, "jax_draws", [
        "eval.batch_size=8", "eval.limit=16", f"eval.logs_dir={tmp_path}/port",
        f"eval.jax_draws={tmp_path}/draws_host{{process_index}}.npz",
        f"eval.jax_noise={tmp_path}/noise.npy"])
    for r, name in enumerate(JOURNALS):
        mine = _rows(tmp_path / "port" / name)
        assert [row[0] for row in mine] == [f"synthetic_{i:06d}.png"
                                            for i in range(r, 32, 2)]
        assert mine == _rows(tmp_path / f"jax{r}" / name)


def _in_process_host(tmp_path, r: int) -> list[tuple]:
    model, cfg = create_model("JPDVT", 48, device="cpu", **TINY)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # a bare npz reads as step 0
        sd, _ = load_artifact(FIXTURE, device="cpu")
    model.load_state_dict(sd, strict=True)
    solver = PuzzleSolver(model, cfg, create_diffusion("250", device="cpu"), grid_size=3,
                          mode="fast", seed=11, device="cpu")
    logs_dir = tmp_path / f"in_process{r}"
    EvalHarness(solver, logs_dir=str(logs_dir), batch_size=64, seed=11, process_index=r,
                process_count=2).run_dataset(SyntheticPuzzles(48, n=1024, seed=11))
    return _rows(logs_dir / JOURNALS[r])


def test_two_rank_run_covers_each_puzzle_once_and_resumes(tmp_path):
    _run_two(tmp_path, "whole", ["eval.batch_size=64", f"eval.logs_dir={tmp_path}/whole"])
    whole = [_rows(tmp_path / "whole" / name) for name in JOURNALS]
    names = [row[0] for rows in whole for row in rows]
    assert sorted(names) == [f"synthetic_{i:06d}.png" for i in range(1024)]
    assert [len(rows) for rows in whole] == [512, 512]
    for r in range(2):
        assert whole[r] == _in_process_host(tmp_path, r)
    _run_two(tmp_path, "cut", ["eval.batch_size=64", "eval.limit=64",
                               f"eval.logs_dir={tmp_path}/cut"])
    assert [len(_rows(tmp_path / "cut" / name)) for name in JOURNALS] == [64, 64]
    _run_two(tmp_path, "resumed", ["eval.batch_size=64", f"eval.logs_dir={tmp_path}/cut"])
    assert [_rows(tmp_path / "cut" / name) for name in JOURNALS] == whole
    assert sum(row[2] for rows in whole for row in rows) > 0  # pieces placed
