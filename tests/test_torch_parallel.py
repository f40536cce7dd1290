"""The port's data parallelism across processes, on the CPU over gloo.

- Start-up: the launch read from torchrun's, Slurm's and Open MPI's
  environments and from ``mesh.coordinator``, ``mesh.distributed`` never
  and force, ``mesh.data`` against the world size, the backend and device
  rule, each rank's rows of the global batch.
- The train step on 2 ranks (``tests/torch_parallel_worker.py``, two
  processes on 127.0.0.1) against the same step in one process, on the
  same global batches and weights (48 px, depth 2, fp32), without and with
  ``grad_accum=2``, with masks, biased timesteps and per-sample
  permutations, and with injected draws; and against the JAX package's
  step on a ``data=2`` mesh of two virtual CPU devices, with the same
  injected draws and weights.
- ``run_train`` on 2 ranks: its losses and final state against one
  process's on the loader, on ``data.device_stream`` and on
  ``data.device_cache`` (with and without its augmentation; the ranks'
  rows of each cached batch are one process's batch), one checkpoint,
  a resume that every rank restores bit-equal, SIGTERM to one rank (both
  stop at one step and exit 42), a killed rank (the other exits non-zero
  at its next step) and the refusals that stay (``data.device_cache``
  across hosts; ``mesh.model`` and
  ``mesh.fsdp``, ported, refused where they do not fit the world;
  ``tests/test_torch_mesh.py`` runs them).

Tolerances:
- 2 ranks against 1 process: loss, code/img MSE and grad norm 1e-6
  relative (measured 2.9e-7 at most); the first step's gradients 1e-6 of
  each one's largest magnitude (measured 4.4e-7). The draws are the same
  (each rank draws the global batch and keeps its rows); the gradient is
  the mean of two half-batch means instead of one batch mean, which moves
  its float32 sums by a few ulp. Parameters and EMA after 3 AdamW steps:
  2e-4 absolute (a tenth of lr 2e-3; measured 7.4e-5), and 99.5% of their
  elements within 1e-7 (measured 99.8%). AdamW divides each gradient by
  its root mean square, so a component whose gradient cancels to ~1e-6 of
  its scale carries the sums' ulps into its update at up to a few percent
  of lr.
- 2 ranks against the JAX mesh: test_torch_port_train.py's 1e-5 relative
  for the losses, and for the grad norm; parameters and EMA after 3 steps
  within the same 2e-4, and 99.9% of their elements within 2e-6 (that
  file's AdamW bound of 1e-6 a step, given equal gradients).
"""

import json
import os
import signal
import socket
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from torch_parallel_worker import launch, logs, wait_all
from jpdvt_mt_ntnu_tpu.core.diffusion import create_diffusion as jax_create_diffusion
from jpdvt_mt_ntnu_tpu.models import create_model as jax_create_model
from jpdvt_mt_ntnu_tpu.parallel import MeshSpec as JaxMeshSpec
from jpdvt_mt_ntnu_tpu.parallel import make_mesh, shard_batch, state_shardings
from jpdvt_mt_ntnu_tpu.train.state import TrainState as JaxTrainState
from jpdvt_mt_ntnu_tpu.train.state import make_optimizer as jax_make_optimizer
from jpdvt_mt_ntnu_tpu.train.steps import TrainTask as JaxTrainTask
from jpdvt_mt_ntnu_tpu.train.steps import make_train_step as jax_make_train_step
from jpdvt_mt_ntnu_tpu.utils.pos_embed import grid_code
from jpdvt_mt_ntnu_tpu_torch.parallel import (DataParallel, backend_and_device,
                                              detect_launch, local_batch_size,
                                              maybe_initialize_distributed, process_count,
                                              process_index, process_shard, rank_rows)
from jpdvt_mt_ntnu_tpu_torch.parallel.mesh import (Launch, MeshSpec, initialize_distributed,
                                                   local_ranks, slurm_tasks_on_node)
from jpdvt_mt_ntnu_tpu_torch.tools.weights import params_to_state_dict
from jpdvt_mt_ntnu_tpu_torch.train import CheckpointManager, run_train
from jpdvt_mt_ntnu_tpu_torch.utils.config import Config, apply_overrides
from jpdvt_mt_ntnu_tpu_torch.utils.device import rank_device
from torch_tools_common import one_torch_thread  # noqa: F401  (autouse)

WORKER = worker.__file__


# ------------------------------------------------------------------ start-up

MESH = apply_overrides(Config(), []).mesh


def _mesh(**kw):
    return apply_overrides(Config(), [f"mesh.{k}={v}" for k, v in kw.items()]).mesh


@pytest.mark.parametrize("env,want", [
    ({"RANK": "1", "WORLD_SIZE": "4", "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2",
      "MASTER_ADDR": "h0", "MASTER_PORT": "29500"},
     (1, 4, 1, 2, "tcp://h0:29500", "torchrun")),
    ({"SLURM_NTASKS": "4", "SLURM_PROCID": "3", "SLURM_LOCALID": "1",
      "SLURM_NTASKS_PER_NODE": "2(x2)", "MASTER_ADDR": "h1", "MASTER_PORT": "1234"},
     (3, 4, 1, 2, "tcp://h1:1234", "Slurm")),
    ({"OMPI_COMM_WORLD_SIZE": "2", "OMPI_COMM_WORLD_RANK": "1",
      "OMPI_COMM_WORLD_LOCAL_RANK": "1", "OMPI_COMM_WORLD_LOCAL_SIZE": "2",
      "MASTER_ADDR": "h2", "MASTER_PORT": "7"},
     (1, 2, 1, 2, "tcp://h2:7", "Open MPI")),
    # Two nodes of 8 tasks with no --ntasks-per-node: Slurm sets only
    # SLURM_TASKS_PER_NODE, whose "8(x2)" names this node's 8.
    ({"SLURM_NTASKS": "16", "SLURM_PROCID": "9", "SLURM_LOCALID": "1", "SLURM_NODEID": "1",
      "SLURM_TASKS_PER_NODE": "8(x2)", "MASTER_ADDR": "h1", "MASTER_PORT": "1234"},
     (9, 16, 1, 8, "tcp://h1:1234", "Slurm")),
], ids=["torchrun", "slurm", "ompi", "slurm-tasks-per-node"])
def test_launch_from_each_launchers_environment(env, want):
    got = detect_launch(MESH, env)
    assert (got.rank, got.world, got.local_rank, got.local_world, got.init_method,
            got.source) == want
    assert detect_launch(_mesh(distributed="never"), env) is None


@pytest.mark.parametrize("launch", ["slurm-tasks-per-node", "coordinator"])
def test_two_hosts_of_eight_cards_get_nccl_at_rank_9(launch):
    """Rank 9 of 2 hosts x 8 cards, where the launcher does not say the
    ranks per host: 8 ranks share this host's 8 cards, so nccl on cuda:1."""
    if launch == "coordinator":
        got = detect_launch(_mesh(coordinator="h0:29500", num_processes=16, process_id=9), {})
        assert (got.local_rank, got.local_world) == (None, None)  # counted at the rendezvous
        local_rank, local_world = local_ranks(["h0"] * 8 + ["h1"] * 8, got.rank)
    else:
        got = detect_launch(MESH, {"SLURM_NTASKS": "16", "SLURM_PROCID": "9",
                                   "SLURM_LOCALID": "1", "SLURM_NODEID": "1",
                                   "SLURM_TASKS_PER_NODE": "8(x2)", "MASTER_ADDR": "h0",
                                   "MASTER_PORT": "29500"})
        local_rank, local_world = got.local_rank, got.local_world
    assert (local_rank, local_world) == (1, 8)
    assert backend_and_device("cuda", local_rank, local_world, 8) == ("nccl",
                                                                      torch.device("cuda", 1))


def test_slurm_tasks_per_node_forms_and_rank_counting():
    assert [slurm_tasks_on_node("8(x2),4", n) for n in range(3)] == [8, 8, 4]
    assert [slurm_tasks_on_node("8,4", n) for n in range(2)] == [8, 4]
    assert slurm_tasks_on_node("3", 0) == 3
    with pytest.raises(ValueError, match="no node 2"):
        slurm_tasks_on_node("8(x2)", 2)
    assert local_ranks(["a", "b", "a", "b", "a"], 4) == (2, 3)
    # A one-rank coordinator run counts itself at the rendezvous.
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dp = initialize_distributed(Launch(0, 1, None, None, f"tcp://127.0.0.1:{port}",
                                       "mesh.coordinator"), "cpu")
    try:
        assert (dp.backend, dp.world, dp.rank) == ("gloo", 1, 0)
    finally:
        dp.close()


def test_launch_from_the_coordinator_and_the_modes():
    got = detect_launch(_mesh(coordinator="10.0.0.1:1234", num_processes=3, process_id=2), {})
    assert (got.rank, got.world, got.init_method) == (2, 3, "tcp://10.0.0.1:1234")
    got = detect_launch(_mesh(coordinator="tcp://h:9", num_processes=2, process_id=0), {})
    assert got.init_method == "tcp://h:9"
    with pytest.raises(ValueError, match="num_processes"):
        detect_launch(_mesh(coordinator="h:9"), {})
    # auto: nothing, one task, or a torchrun world of one start no group.
    assert detect_launch(MESH, {}) is None
    assert detect_launch(MESH, {"SLURM_NTASKS": "1", "OMPI_COMM_WORLD_SIZE": "1"}) is None
    one = {"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "h", "MASTER_PORT": "5"}
    assert detect_launch(MESH, one) is None
    assert detect_launch(_mesh(distributed="force"), one).world == 1
    with pytest.raises(ValueError, match="force"):
        detect_launch(_mesh(distributed="force"), {})
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        detect_launch(MESH, {"SLURM_NTASKS": "2", "SLURM_PROCID": "0"})
    with pytest.raises(ValueError, match="distributed"):
        detect_launch(_mesh(distributed="sometimes"), {})


def test_backend_and_device_rule():
    assert backend_and_device("cpu", 3, 4, 0) == ("gloo", torch.device("cpu"))
    assert backend_and_device("cuda", 3, 8, 8) == ("nccl", torch.device("cuda", 3))
    assert backend_and_device("cuda", 1, 2, 1) == ("gloo", torch.device("cuda", 0))
    assert backend_and_device("cuda", 3, 4, 2) == ("gloo", torch.device("cuda", 1))
    assert rank_device(5, 4) == torch.device("cuda", 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        backend_and_device("cuda", 0, 1, 0)


def test_mesh_data_is_every_rank_or_the_world_size():
    assert MeshSpec().axis_sizes(4) == {"data": 4}
    assert MeshSpec(data=4).axis_sizes(4) == {"data": 4}
    with pytest.raises(ValueError, match="world size"):
        MeshSpec(data=2).axis_sizes(1)
    with pytest.raises(ValueError, match="world size"):
        maybe_initialize_distributed(_mesh(data=2), "cpu", env={})
    assert maybe_initialize_distributed(_mesh(data=1), "cpu", env={}).world == 1
    for axis in ("pipe", "ep", "seq"):  # ported: they take their ranks from the world's
        assert MeshSpec(**{axis: 2}).axis_sizes(2) == {"data": 1, axis: 2}
    # model and fsdp are ported: they take their ranks from the world's.
    assert MeshSpec(model=2).axis_sizes(4) == {"data": 2, "model": 2}
    assert MeshSpec(fsdp=2, data=1).axis_sizes(2) == {"data": 1, "fsdp": 2}
    for axis in ("model", "fsdp"):
        with pytest.raises(ValueError, match=rf"mesh\.{axis}=2 .*world size"):
            MeshSpec(**{axis: 2, "data": 2}).axis_sizes(2)


def test_process_shard_and_local_batch_without_a_group():
    assert (process_index(), process_count()) == (0, 1)
    assert process_shard(list("abcdefg")) == list("abcdefg")
    assert process_shard(list("abcdefg"), 1, 3) == ["b", "e"]
    assert local_batch_size(96, 4) == 24
    with pytest.raises(ValueError, match="divisible"):
        local_batch_size(96, 5)


def test_rank_rows_cut_each_microbatch_across_the_ranks():
    np.testing.assert_array_equal(rank_rows(8, 1, 2), [4, 5, 6, 7])
    np.testing.assert_array_equal(rank_rows(8, 0, 2, grad_accum=2), [0, 1, 4, 5])
    np.testing.assert_array_equal(rank_rows(8, 1, 2, grad_accum=2), [2, 3, 6, 7])
    assert sorted(np.concatenate([rank_rows(12, r, 3, 2) for r in range(3)])) == list(range(12))
    with pytest.raises(ValueError, match="divisible"):
        rank_rows(6, 0, 2, grad_accum=2)


# ------------------------------------------------------- the step on 2 ranks

def _numpy_params(shapes, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (0.05 * rng.standard_normal(a.shape)).astype(np.float32), shapes)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Numpy weights of the tiny DiT, as the JAX tree and the port's state
    dict (written where the workers read it)."""
    jmodel, _ = jax_create_model("JPDVT", worker.SIZE, attn_impl="xla", **worker.MODEL)
    shapes = jmodel.init(jax.random.key(0), jnp.zeros((1, worker.SIZE, worker.SIZE, 3)),
                         jnp.zeros((1,), jnp.int32), jnp.zeros((1, worker.TOKENS, 8)))
    params = _numpy_params(shapes, 0)
    sd, unused = params_to_state_dict(params)
    assert unused == []
    path = tmp_path_factory.mktemp("weights") / "weights.npz"
    np.savez(path, **sd)
    return jmodel, params, {k: np.asarray(v) for k, v in sd.items()}, str(path)


@pytest.fixture(scope="module")
def two_ranks(weights, tmp_path_factory):
    """Every worker case on 2 ranks: each rank's results."""
    tmp = tmp_path_factory.mktemp("two_ranks")
    procs = launch(lambda r: [sys.executable, WORKER, str(tmp / f"rank{r}.npz"), weights[3]],
                   tmp, "steps")
    assert wait_all(procs) == [0, 0], logs(procs)
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]



def test_bucketed_all_reduce_is_the_mean_over_ranks(two_ranks):
    for res in two_ranks:
        assert str(res["backend"]) == "gloo" and str(res["device"]) == "cpu"
        for i, n in enumerate((3, 4, 1, 7)):
            np.testing.assert_array_equal(res[f"bucket{i}"], np.full(n, 1.5 * (i + 1)))


PARAM_ATOL = 2e-4  # 0.1 lr: a cancelled component's Adam update (module docstring)


def assert_adam_close(mine: dict, want: dict, atol: float, close: float, frac: float):
    """Every element within ``atol`` and ``frac`` of them within ``close``."""
    assert sorted(mine) == sorted(want)
    errs = []
    for k, w in want.items():
        np.testing.assert_allclose(mine[k], w, rtol=0, atol=atol, err_msg=k)
        errs.append(np.abs(np.asarray(mine[k], np.float64) - w).ravel())
    share = np.mean(np.concatenate(errs) <= close)
    assert share >= frac, (share, frac)


@pytest.mark.parametrize("case", list(worker.CASES))
def test_two_rank_step_equals_one_process_step(two_ranks, weights, case):
    one = worker.run_case(case, DataParallel(), weights[2])
    r0, r1 = ({k[len(case) + 1:]: v for k, v in res.items() if k.startswith(case + "/")}
              for res in two_ranks)
    assert sorted(r0) == sorted(one)
    for k, want in one.items():
        # Both ranks end every step with the same state and metrics.
        np.testing.assert_array_equal(r1[k], r0[k], err_msg=k)
        if k in ("loss", "code_mse", "img_mse", "grad_norm"):
            np.testing.assert_allclose(r0[k], want, rtol=1e-6, err_msg=k)
        elif k.startswith("grad."):
            np.testing.assert_allclose(r0[k], want, rtol=0,
                                       atol=1e-6 * np.abs(want).max(), err_msg=k)
    for part in ("model", "ema", "mu", "nu"):
        assert_adam_close({k: v for k, v in r0.items() if k.startswith(part + ".")},
                          {k: v for k, v in one.items() if k.startswith(part + ".")},
                          PARAM_ATOL, 1e-7, 0.995)
    assert np.all(one["loss"] > 0) and one["loss"][-1] != one["loss"][0]


class JaxInjected:
    """The JAX ``Diffusion`` with :func:`worker.draws` injected: the
    microbatch is found by matching its key among the steps' keys."""

    def __init__(self, diffusion, accum: int):
        self.diffusion = diffusion
        keys, table = [], {}
        for s in range(worker.STEPS):
            k_loss = jax.random.split(jax.random.fold_in(jax.random.key(0), s))[1]
            keys += list(jax.random.split(k_loss, accum)) if accum > 1 else [k_loss]
            for d in worker.draws(s, accum):
                for name, v in d.items():
                    table.setdefault(name, []).append(v)
        self.keys = jnp.stack([jax.random.key_data(k) for k in keys])
        self.table = {k: jnp.asarray(np.stack(v)) for k, v in table.items()}

    def __getattr__(self, name):
        return getattr(self.diffusion, name)

    def training_losses(self, model_fn, x, t, code, rng, **kw):
        hit = jnp.all(jax.random.key_data(rng)[None] == self.keys, axis=-1)
        i = jnp.argmax(hit)
        inj = {k: v[i] for k, v in self.table.items() if k != "t"}
        return self.diffusion.training_losses(model_fn, x, self.table["t"][i], code, rng,
                                              _inject=inj, **kw)


@pytest.mark.parametrize("accum", [1, 2], ids=["no_accum", "accum2"])
def test_two_rank_step_equals_the_jax_data2_mesh_step(two_ranks, weights, accum):
    jmodel, params, _, _ = weights
    mesh = make_mesh(JaxMeshSpec(data=2), devices=jax.devices()[:2])
    opt = jax_make_optimizer(worker.LR)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          ema_params=jax.tree.map(jnp.copy, params),
                          opt_state=opt.init(params))
    state = jax.device_put(state, state_shardings(state, mesh))
    task = JaxTrainTask(grid_size=worker.GRID, block_size=worker.SIZE // worker.GRID,
                        patch_size=16, ema_warmup=True)
    step = jax_make_train_step(jmodel, JaxInjected(jax_create_diffusion(""), accum), opt,
                               task, jnp.asarray(grid_code(8, worker.GRID)),
                               fused_adamw=dict(lr=worker.LR, weight_decay=0.0),
                               grad_accum=accum, mesh=mesh)
    losses, norms = [], []
    for s in range(worker.STEPS):
        state, m = step(state, shard_batch({"x": jnp.asarray(worker.images(s))}, mesh)["x"],
                        jax.random.key(0))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    case = "injected" if accum == 1 else "injected_accum2"
    mine = {k[len(case) + 1:]: v for k, v in two_ranks[0].items() if k.startswith(case + "/")}
    np.testing.assert_allclose(mine["loss"], losses, rtol=1e-5)
    np.testing.assert_allclose(mine["grad_norm"], norms, rtol=1e-5)
    for part, tree in (("model", state.params), ("ema", state.ema_params)):
        want, _ = params_to_state_dict(jax.tree.map(np.asarray, tree))
        assert_adam_close({k: mine[f"{part}.{k}"] for k in want}, want, PARAM_ATOL, 2e-6, 0.999)


# ------------------------------------------------------- run_train on 2 ranks

TINY = ["device=cpu", "data.synthetic_cues=waves", "data.global_batch_size=8",
        "data.num_workers=2", "data.synthetic_n=32", "model.image_size=48",
        "model.depth=2", "model.hidden_size=64", "model.num_heads=4",
        "model.compute_dtype=float32", "train.log_every=1",
        "train.ckpt_every=1000000", "diffusion.sampling_steps=2",
        "diffusion.sampler_mode=fast", "train.ema_warmup=true", "train.lr=0.003"]
CLI = [sys.executable, "-m", "jpdvt_mt_ntnu_tpu_torch.train.run_train"]


def _losses(exp) -> list[float]:
    rows = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
    return [r["train_loss"] for r in rows if "train_loss" in r]


def _state(exp, step: int) -> dict:
    return torch.load(exp / "checkpoints" / str(step) / "state.pt", weights_only=True)


@pytest.mark.parametrize("data", ["loader", "device_stream"])
def test_two_rank_run_train_equals_one_process_and_resumes(tmp_path, data, monkeypatch):
    extra = TINY + (["data.device_stream=true"] if data == "device_stream" else [])
    monkeypatch.chdir(tmp_path)
    one = tmp_path / "one"
    assert run_train.main(extra + [f"train.exp_dir={one}", "train.epochs=1"]) == 0
    two = tmp_path / "two"
    procs = launch(lambda r: CLI + extra + [f"train.exp_dir={two}", "train.epochs=1",
                                            "mesh.data=2"], tmp_path, "first")
    assert wait_all(procs) == [0, 0], logs(procs)
    np.testing.assert_allclose(_losses(two), _losses(one), rtol=1e-6)
    assert len(_losses(two)) == 4
    # One checkpoint, written by rank 0, holding the state one process trains.
    assert CheckpointManager(str(two / "checkpoints")).all_steps() == [4]
    a, b = _state(two, 4), _state(one, 4)
    for part in ("model", "ema"):
        assert_adam_close({k: v.numpy() for k, v in a[part].items()},
                          {k: v.numpy() for k, v in b[part].items()}, 0.1 * 0.003, 1e-7, 0.995)
    rows = [json.loads(line) for line in (two / "metrics.jsonl").read_text().splitlines()]
    assert rows[0]["process_backend"] == "gloo" and rows[0]["process_world_size"] == 2
    assert rows[-1]["summary"]["loop_images"] == 32
    # A resume: both ranks restore the same bits and train on to step 8.
    procs = launch(lambda r: CLI + extra + [f"train.exp_dir={two}", "train.epochs=2",
                                            f"train.resume={two}/checkpoints"],
                   tmp_path, "resume")
    assert wait_all(procs) == [0, 0], logs(procs)
    log = (two / "log.txt").read_text()
    assert "Resumed from step 4" in log
    assert "The train state is bit-equal on all 2 ranks at step 4" in log
    assert CheckpointManager(str(two / "checkpoints")).all_steps() == [4, 8]
    assert len(_losses(two)) == 8


@pytest.mark.parametrize("augment", [False, True], ids=["cache", "cache_augment"])
def test_two_rank_device_cache_equals_one_process(tmp_path, augment, monkeypatch):
    """``data.device_cache`` on 2 ranks of one host: each stages the whole
    set, draws the order (and the rolls and flips) one process draws and
    trains on its rows of each batch."""
    extra = TINY + ["data.device_cache=true", f"data.device_cache_augment={augment}",
                    "train.epochs=1"]
    monkeypatch.chdir(tmp_path)
    one = tmp_path / "one"
    assert run_train.main(extra + [f"train.exp_dir={one}"]) == 0
    two = tmp_path / "two"
    procs = launch(lambda r: CLI + extra + [f"train.exp_dir={two}"], tmp_path, "cache")
    assert wait_all(procs) == [0, 0], logs(procs)
    np.testing.assert_allclose(_losses(two), _losses(one), rtol=1e-6)
    assert len(_losses(two)) == 4
    a, b = _state(two, 4), _state(one, 4)
    for part in ("model", "ema"):
        assert_adam_close({k: v.numpy() for k, v in a[part].items()},
                          {k: v.numpy() for k, v in b[part].items()}, 0.1 * 0.003, 1e-7, 0.995)
    assert "device-cached dataset: (32, 48, 48, 3)" in (two / "log.txt").read_text()


@pytest.mark.parametrize("accum", [1, 2])
def test_cached_batch_rows_of_the_ranks_make_one_process_batch(accum):
    """Every step, with and without the rolls and flips, the two ranks'
    rows put back in place are one process's batch, bit for bit."""
    data = torch.randn(21, 6, 6, 3)
    for augment in (False, True):
        whole = list(run_train.cached_batches(data, 8, 5, 2, augment))
        rows = [rank_rows(8, r, 2, accum) for r in range(2)]
        parts = [list(run_train.cached_batches(data, 8, 5, 2, augment, rows[r]))
                 for r in range(2)]
        assert len(whole) == len(parts[0]) == len(parts[1]) == 2
        for s, want in enumerate(whole):
            got = torch.empty_like(want)
            for r in range(2):
                got[torch.as_tensor(rows[r])] = parts[r][s]
            assert torch.equal(got, want), (augment, s)


def _start_long_run(tmp_path, name):
    exp = tmp_path / name
    procs = launch(lambda r: CLI + TINY + [f"train.exp_dir={exp}", "train.epochs=100000"],
                   tmp_path, name)
    metrics = exp / "metrics.jsonl"
    deadline = time.time() + 180
    while not (metrics.exists() and "train_loss" in metrics.read_text()):
        if time.time() > deadline or any(p.poll() is not None for p, _ in procs):
            wait_all(procs, timeout=1)
            raise AssertionError("training never reached its first log window:\n"
                                 + logs(procs))
        time.sleep(0.2)
    return exp, procs


def test_sigterm_to_one_rank_stops_both_at_one_step(tmp_path):
    exp, procs = _start_long_run(tmp_path, "sigterm")
    procs[1][0].send_signal(signal.SIGTERM)
    assert wait_all(procs, timeout=120) == [run_train.PREEMPTED_EXIT] * 2, logs(procs)
    step = CheckpointManager(str(exp / "checkpoints")).all_steps()
    assert len(step) == 1 and step[0] >= 1
    log = (exp / "log.txt").read_text()
    assert f"Preempted: checkpoint saved at step {step[0]}" in log
    rows = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
    assert rows[-1]["summary"]["preempted_at_step"] == step[0]


def test_a_killed_rank_fails_the_other(tmp_path):
    _, procs = _start_long_run(tmp_path, "killed")
    procs[1][0].kill()
    t0 = time.time()
    code = wait_all(procs[:1], timeout=120)[0]
    wait_all(procs[1:], timeout=10)
    assert code not in (0, run_train.PREEMPTED_EXIT), logs(procs)
    assert time.time() - t0 < 60


@pytest.mark.parametrize("extra,name", [
    (["mesh.model=2"], "mesh.model"), (["mesh.fsdp=2"], "mesh.fsdp"),
    (["mesh.pipe=2"], "mesh.pipe"), (["mesh.ep=2"], "mesh.ep"), (["mesh.seq=2"], "mesh.seq"),
    (["mesh.pipe_microbatches=4", "mesh.pipe=2", "mesh.model=2"], "mesh.pipe with mesh.model"),
    (["mesh.pipe=2", "mesh.seq=2"], "mesh.pipe with mesh.seq")])
def test_run_train_refuses_the_other_mesh_axes(extra, name):
    """Every axis of the JAX mesh is ported, and so is every composition the
    JAX trainer runs (the pipeline with TP, say): a run of one process
    refuses each for want of ranks. The two the JAX trainer fails on (the
    pipeline with the ring or the experts) are refused by name, with why."""
    if name == "mesh.pipe with mesh.seq":
        with pytest.raises(NotImplementedError, match=r"mesh\.pipe with mesh\.seq \(the JAX "
                           r"trainer's pipeline stage .*AttributeError"):
            run_train.main(TINY + extra)
        return
    named = " x ".join(a.replace(".", r"\.") + "=2" for a in name.split(" with "))
    with pytest.raises(ValueError, match=named + " .*world size"):
        run_train.main(TINY + extra)


def test_run_train_refuses_mesh_data_other_than_the_world_and_cache_across_ranks(tmp_path):
    """``mesh.data`` must be the world; ``data.device_cache`` runs on the
    ranks of one host and is refused across hosts, as the JAX trainer
    refuses it on several."""
    with pytest.raises(ValueError, match="world size"):
        run_train.main(TINY + ["mesh.data=2", f"train.exp_dir={tmp_path}/a"])
    cfg = apply_overrides(Config(), [a for a in TINY if a != "device=cpu"]
                          + ["data.device_cache=true"])
    with pytest.raises(NotImplementedError, match="device_cache across hosts"):
        run_train.train(cfg, DataParallel(rank=0, world=4, local_world=2))
    assert DataParallel(rank=1, world=2).local_world == 2
