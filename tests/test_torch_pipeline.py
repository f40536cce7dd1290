"""The GPipe pipeline (``mesh.pipe``, ``parallel/pipeline.py``) on the CPU over gloo.

- Stages: stage s holds blocks [s D/S, (s+1) D/S), the blocks the JAX
  package's ``pipeline_param_shardings`` puts on the devices of pipe
  index s, at S = 2 and 4 of depth 4.
- The train step (``tests/torch_axes_worker.py``, a DiT of depth 4 at 48
  px, hidden 64, 4 heads, fp32, 3 AdamW steps with injected draws) on
  ``pipe=2`` with 4 microbatches of the batch of 8 (2 blocks a stage) and
  on ``pipe=2 x data=2`` with 2 a rank, against the port's one process,
  and ``pipe=2`` against the JAX package's pipelined step
  (``make_pipeline_apply`` with 4 microbatches) on 2 virtual CPU devices
  with the same weights, batches and draws; the stem's and head's
  gradients are bit-equal on every rank after the sum over the pipe
  group; each mesh's checkpoint restores bit-equal into one process.
- The compositions (4 ranks): ``pipe=2 x model=2`` (each stage's blocks
  cut by TP, 4 microbatches) and ``pipe=2 x fsdp=2`` (2 microbatches of
  the rank's 4 rows) against the port's one process and against the JAX
  pipelined step on the same composition of 4 virtual CPU devices, every
  rank; their checkpoints restore bit-equal into one process; under
  FSDP every fsdp-cut leaf a stage reached is reduce-scattered once a
  step, not once a microbatch; ``pipe=2 x fsdp=2`` warm-started from
  ``tests/fixtures/tiny_jpdvt_48px.npz`` (as ``train.warm_start`` does it)
  against one process warm-started alike.
- ``run_train`` on ``mesh.pipe=2`` (depth 2, one block a stage, the
  default 4 microbatches) with checkpoints interchangeable with one
  process's both ways, as ``tests/test_pipeline.py:152-180`` holds the JAX
  package's; on 4 ranks ``mesh.pipe=2 mesh.model=2`` against one
  process; ``pipe`` with ``ep``
  or ``seq`` refused by name with the JAX trainer's failure, with
  ``model`` or ``fsdp`` in one process for want of ranks only.

Tolerances (fp32; the measured worst in brackets): a mesh against one
process, the loss, MSEs and grad norm 1e-6 relative (2.0e-7), the stem's
and head's first-step gradients within 3e-6 of each leaf's largest
magnitude (3.4e-7), the state after 3 steps within ``PARAM_ATOL`` = 2e-4
(1.2e-5) with 99.9% of the elements within 1e-6 (99.999%); against the
JAX pipeline, the loss and grad norm 1e-5 relative (2.7e-7) and the
params and EMA within ``PARAM_ATOL`` (2.8e-5) with 99.9% within 2e-6
(99.996%); the compositions are held to the same tolerances;
``run_train``'s losses 1e-5 relative, as ``tests/test_torch_mesh.py``'s.
"""

import shutil
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_axes_common as common
import torch_axes_worker as worker
from test_torch_mesh import _losses
from torch_parallel_worker import launch, logs, wait_all
from jpdvt_mt_ntnu_tpu.parallel import MeshSpec as JaxMeshSpec
from jpdvt_mt_ntnu_tpu.parallel import make_mesh
from jpdvt_mt_ntnu_tpu.parallel.pipeline import pipeline_param_shardings, stack_block_params
from jpdvt_mt_ntnu_tpu_torch.models import create_model
from jpdvt_mt_ntnu_tpu_torch.parallel.pipeline import Pipeline
from jpdvt_mt_ntnu_tpu_torch.parallel.sharding import Group
from jpdvt_mt_ntnu_tpu_torch.train import CheckpointManager, create_train_state, run_train

PIPE_MESHES = ("pipe2", "pipe2_data2", "pipe2_tp2", "pipe2_fsdp2")
COMPOSED = ("pipe2_tp2", "pipe2_fsdp2")  # the pipeline with TP, with FSDP


@pytest.mark.parametrize("pipe", [2, 4])
def test_stages_hold_the_blocks_jax_gives_them(pipe):
    jmodel, cfg = common.jax_model("deep")
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, 48, 48, 3)),
                            jnp.zeros((1,), jnp.int32), jnp.zeros((1, 9, 8)))
    params = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    jmesh = make_mesh(JaxMeshSpec(data=8 // pipe, pipe=pipe), devices=jax.devices()[:8])
    stacked = stack_block_params(params)
    leaf = stacked["params"]["blocks"]["adaLN_modulation"]["kernel"]
    sharding = pipeline_param_shardings(stacked, jmesh)["params"]["blocks"][
        "adaLN_modulation"]["kernel"]
    position = {dev.id: idx for idx, dev in np.ndenumerate(jmesh.devices)}
    held = {}
    for dev, index in sharding.devices_indices_map(leaf.shape).items():
        s = position[dev.id][0]  # the device's pipe index
        held.setdefault(s, set()).add(tuple(range(cfg.depth))[index[0]])
    for s in range(pipe):
        mesh = types.SimpleNamespace(pipe=Group(list(range(pipe)), s))
        stage = Pipeline(mesh, cfg.depth, 0)
        assert held[s] == {tuple(stage.blocks)}
        assert stage.micro == 2 * pipe
    with pytest.raises(ValueError, match="depth 4 not divisible by mesh.pipe=3"):
        Pipeline(types.SimpleNamespace(pipe=Group([0, 1, 2], 0)), 4, 0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe_runs")
    params = common.weights(tmp, ["deep"])
    procs = common.start(tmp, ["pipe-2", "pipe-4"])
    one = worker.run_case("pipe2", str(tmp))
    jax_ref = {name: common.jax_steps("deep", params["deep"], {"data": 1, **worker.MESHES[name][1]},
                                      pipe_micro=worker.MESHES[name][2])
               for name in ("pipe2", *COMPOSED)}
    return common.finish(tmp, procs), one, jax_ref, tmp


@pytest.mark.parametrize("mesh", PIPE_MESHES)
def test_mesh_step_equals_one_process_step(runs, mesh):
    ranks, one, _, _ = runs
    common.check_against_one_process(ranks[mesh], one)
    # The stem's and head's first-step gradients, summed over the stages
    # (the worker keeps those of the leaves that no axis cuts).
    for res in ranks[mesh]:
        for k in [k for k in res if k.startswith("grad.") and not k.startswith("grad.blocks.")]:
            np.testing.assert_allclose(res[k], one[k], rtol=0, err_msg=k,
                                       atol=3e-6 * np.abs(one[k]).max())


def test_mesh_step_equals_the_jax_pipeline_step(runs):
    ranks, _, jax_ref, _ = runs
    common.check_against_jax(ranks["pipe2"][0], jax_ref["pipe2"])


@pytest.mark.parametrize("mesh", COMPOSED)
def test_composed_mesh_step_equals_the_jax_step(runs, mesh):
    """pipe x model and pipe x fsdp against the JAX pipelined step on the
    same composition of 4 virtual CPU devices (its stacked blocks cut
    ``P("pipe", *tp_or_fsdp_spec)``), every rank."""
    ranks, _, jax_ref, _ = runs
    for res in ranks[mesh]:
        common.check_against_jax(res, jax_ref[mesh])


def test_pipe_fsdp_reduce_scatters_each_leaf_once_a_step(runs):
    """Each stage's backward runs microbatch by microbatch (2 here); every
    fsdp-cut leaf the stage reached is reduce-scattered once in the step,
    not once a microbatch. Stage 0 runs the stem, the last stage the head."""
    ranks, _, _, _ = runs
    used = [int(res["fsdp_leaves_used"]) for res in ranks["pipe2_fsdp2"]]
    assert [int(res["reduce_scatters"]) for res in ranks["pipe2_fsdp2"]] == used
    assert used[0] == used[1] and used[2] == used[3] and used[0] != used[2]


def test_warm_started_pipe_fsdp_equals_one_process(runs):
    """``train.warm_start`` from the tiny fixture on ``pipe=2 x fsdp=2``:
    every rank builds and warm-starts the whole state before the mesh
    cuts it (the path the JAX trainer gets wrong under its pipeline), and
    trains as one process warm-started alike."""
    ranks, _, _, tmp = runs
    one = worker.run_case("pipe2_fsdp2_warm", str(tmp))
    common.check_against_one_process(ranks["pipe2_fsdp2_warm"], one)


@pytest.mark.parametrize("mesh", PIPE_MESHES)
def test_pipe_checkpoint_restores_bit_equal_into_one_process(runs, mesh):
    ranks, _, _, tmp = runs
    got = ranks[mesh][0]
    suite = "pipe-2" if mesh == "pipe2" else "pipe-4"
    model, _ = create_model("JPDVT", 48, device="cpu", **worker.MODELS["deep"][1])
    state = CheckpointManager(str(tmp / suite / f"{mesh}_ckpt")).restore(
        create_train_state(model))
    assert state.step == 3
    sd = state.state_dict()
    assert len({k.split(".")[1] for k in sd["model"] if k.startswith("blocks.")}) == 4
    for part, tensors in (("model", sd["model"]), ("ema", sd["ema"]), ("mu", sd["opt"]["mu"]),
                          ("nu", sd["opt"]["nu"])):
        for k, v in tensors.items():
            np.testing.assert_array_equal(v.numpy().view(np.int32),
                                          got[f"{part}.{k}"].view(np.int32), err_msg=k)


# ------------------------------------------------------------------ run_train

TINY = ["device=cpu", "data.synthetic_cues=waves", "data.global_batch_size=8",
        "data.num_workers=2", "data.synthetic_n=32", "model.image_size=48",
        "model.depth=2", "model.hidden_size=64", "model.num_heads=4",
        "model.compute_dtype=float32", "train.log_every=1", "train.ckpt_every=1000000",
        "diffusion.sampling_steps=2", "diffusion.sampler_mode=fast", "train.lr=0.003"]
CLI = [sys.executable, "-m", "jpdvt_mt_ntnu_tpu_torch.train.run_train"]


def test_run_train_pipe_checkpoints_are_interchangeable_with_one_process(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    one = tmp_path / "one"  # one process: 4 steps, then 4 more from its checkpoint
    assert run_train.main(TINY + [f"train.exp_dir={one}", "train.epochs=1"]) == 0
    shutil.copytree(one, tmp_path / "three")
    assert run_train.main(TINY + [f"train.exp_dir={one}", "train.epochs=2",
                                  f"train.resume={one}/checkpoints"]) == 0
    # pipe=2 for 4 steps, resumed on one process.
    two = tmp_path / "two"
    procs = launch(lambda r: CLI + TINY + [f"train.exp_dir={two}", "train.epochs=1",
                                            "mesh.pipe=2"], tmp_path, "pipe")
    assert wait_all(procs) == [0, 0], logs(procs)
    assert '"pipe": 2' in (two / "log.txt").read_text()
    np.testing.assert_allclose(_losses(two), _losses(one)[:4], rtol=1e-5)
    assert run_train.main(TINY + [f"train.exp_dir={two}", "train.epochs=2",
                                  f"train.resume={two}/checkpoints"]) == 0
    np.testing.assert_allclose(_losses(two), _losses(one), rtol=1e-5)
    # One process's checkpoint at step 4, resumed on pipe=2.
    three = tmp_path / "three"
    procs = launch(lambda r: CLI + TINY + [f"train.exp_dir={three}", "train.epochs=2",
                                            f"train.resume={three}/checkpoints", "mesh.pipe=2"],
                   tmp_path, "pipe_resume")
    assert wait_all(procs) == [0, 0], logs(procs)
    assert "Resumed from step 4" in (three / "log.txt").read_text()
    np.testing.assert_allclose(_losses(three), _losses(one), rtol=1e-5)
    assert CheckpointManager(str(three / "checkpoints")).all_steps() == [4, 8]


def test_run_train_on_pipe_x_model_equals_one_process(tmp_path, monkeypatch):
    """The CLI on 4 ranks, pipe x model, 4 steps (validating on the blocks
    gathered from both stages and both model ranks), against one process;
    its checkpoint written whole."""
    monkeypatch.chdir(tmp_path)
    one = tmp_path / "one"
    assert run_train.main(TINY + [f"train.exp_dir={one}", "train.epochs=1"]) == 0
    two = tmp_path / "two"
    procs = launch(lambda r: CLI + TINY + [f"train.exp_dir={two}", "train.epochs=1",
                                            "mesh.pipe=2", "mesh.model=2"],
                   tmp_path, "pipe_tp", world=4)
    assert wait_all(procs) == [0] * 4, logs(procs)
    assert '"pipe": 2' in (two / "log.txt").read_text()
    np.testing.assert_allclose(_losses(two), _losses(one), rtol=1e-5)
    assert CheckpointManager(str(two / "checkpoints")).all_steps() == [4]


@pytest.mark.parametrize("axis", ["model", "fsdp", "ep", "seq"])
def test_run_train_refuses_pipe_with_another_axis_than_data(axis):
    """pipe x model and pipe x fsdp are ported: one process refuses them for
    want of ranks only. pipe x ep and pipe x seq are refused by name, with
    the JAX trainer's failure on them."""
    if axis in ("model", "fsdp"):
        with pytest.raises(ValueError, match=rf"mesh\.pipe=2 x mesh\.{axis}=2 .*world size"):
            run_train.main(TINY + ["mesh.pipe=2", f"mesh.{axis}=2"])
        return
    with pytest.raises(NotImplementedError, match=rf"mesh\.pipe with mesh\.{axis} \(the JAX "
                       r"trainer's pipeline stage builds"):
        run_train.main(TINY + ["mesh.pipe=2", f"mesh.{axis}=2"])
