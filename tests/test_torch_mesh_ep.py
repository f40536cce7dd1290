"""Expert parallelism (``mesh.ep``) and TP and FSDP of the MoE's experts, on the CPU over gloo.

- Placement: rank r on the six-axis mesh (pipe, data, fsdp, ep, seq,
  model, ``model`` innermost) where the JAX mesh puts device r, on
  meshes of three axes of the 8 virtual CPU devices, and the JAX order of
  all six.
- The rules: every leaf of a 4-expert MoE (48 px, depth 2, hidden 64, 4
  heads) is cut on the dims the JAX package's ``param_shardings`` gives it
  (``_EP_RULES``: E over ep, the experts' hidden features over model, then
  fsdp's largest free dim), on ep 2, ep 2 x model 2, ep 2 x fsdp 2.
- The train step (``tests/torch_axes_worker.py``, 3 AdamW steps in fp32,
  injected draws) on 2 ranks (``ep=2``, ``model=2`` and ``fsdp=2`` with the
  MoE) and on 4 (``ep=2`` with ``data=2``, ``model=2`` and ``fsdp=2``)
  against the port's one process, and ``ep=2`` against the JAX trainer on
  the same mesh of virtual CPU devices with the same weights, batches and
  draws. The router's gradient is partial on each
  ep rank (each gates only its experts) and summed over the ep group: the
  first step's reduced router gradient is one process's; every leaf that no
  axis cuts has bit-equal gradients on every rank.
- ``run_train`` on ``mesh.ep=2``, resumed on one process from its
  checkpoint; ``mesh.ep`` with ``mesh.pipe`` refused by name, with the JAX
  trainer's failure (``mesh.seq`` with ``mesh.ep`` runs:
  ``tests/test_torch_sequence.py``).

Tolerances (fp32; the measured worst in brackets):
- a mesh against one process: the loss, MSEs and grad norm 1e-6 relative
  (1.6e-7); params, EMA and moments after 3 steps every element within
  ``PARAM_ATOL`` = 2e-4 (a tenth of lr; 1.9e-5) and 99.9% within 1e-6
  (99.999%). The first step's router gradient within 3e-6 of each leaf's
  largest magnitude (2.8e-7); one ep rank's part alone is 33% of it off.
- against the JAX mesh: the loss and grad norm 1e-5 relative (4.7e-7),
  params and EMA within ``PARAM_ATOL`` (1.7e-5), 99.9% within 2e-6
  (99.998%).
"""

import sys

import jax
import numpy as np
import pytest

import torch_axes_common as common
import torch_axes_worker as worker
from test_torch_mesh import _jax_specs
from torch_parallel_worker import launch, logs, wait_all
from jpdvt_mt_ntnu_tpu.models import create_model as jax_create_model
from jpdvt_mt_ntnu_tpu.parallel import MeshSpec as JaxMeshSpec
from jpdvt_mt_ntnu_tpu.parallel import make_mesh
from jpdvt_mt_ntnu_tpu_torch.models import create_model
from jpdvt_mt_ntnu_tpu_torch.parallel import MeshSpec
from jpdvt_mt_ntnu_tpu_torch.parallel.sharding import MeshRanks, leaf_specs
from jpdvt_mt_ntnu_tpu_torch.train import CheckpointManager, create_train_state, run_train

EP_MESHES = ("ep2", "moe_tp2", "moe_fsdp2", "ep2_data2", "ep2_tp2", "ep2_fsdp2")
JAX_MESHES = {"ep2": dict(data=1, ep=2)}


# ----------------------------------------------------------------- placement

@pytest.mark.parametrize("axes", [dict(pipe=2, data=2, ep=2), dict(data=2, fsdp=2, seq=2),
                                  dict(ep=2, seq=2, model=2), dict(pipe=2, fsdp=2, model=2)],
                         ids=["pipe_data_ep", "data_fsdp_seq", "ep_seq_model", "pipe_fsdp_model"])
def test_ranks_are_placed_as_the_jax_mesh_places_devices(axes):
    spec = JaxMeshSpec(**{"data": 1, **axes})
    jmesh = make_mesh(spec, devices=jax.devices()[:8])
    ranks = MeshRanks.from_spec(MeshSpec(**{"data": 1, **axes}), 8)
    ids = np.vectorize(lambda dev: dev.id)(jmesh.devices) - jax.devices()[0].id
    names = [n for n in ranks.names if n in jmesh.axis_names]
    assert tuple(names) == jmesh.axis_names
    for r in range(8):
        assert ids[tuple(ranks.coord(r, a) for a in names)] == r
    # Each group's ranks differ along its axes only; a batch shard is (data, fsdp).
    for axis, letter in (("pipe", "p"), ("ep", "e"), ("seq", "s"), ("model", "m")):
        for members in ranks.groups(letter):
            assert len(members) == getattr(ranks, axis)
            assert len({ranks.batch_index(r) for r in members}) == 1


def test_six_axes_in_the_jax_order():
    sizes = dict(pipe=2, data=2, fsdp=2, ep=2, seq=2, model=2)
    assert list(MeshSpec(**sizes).axis_sizes(64)) == list(JaxMeshSpec(**sizes).axis_sizes(64))
    ranks = MeshRanks.from_spec(MeshSpec(**sizes), 64)
    assert ranks.names == ("pipe", "data", "fsdp", "ep", "seq", "model")
    assert [ranks.coords(r) for r in (0, 1, 2, 63)] == [
        (0,) * 6, (0, 0, 0, 0, 0, 1), (0, 0, 0, 0, 1, 0), (1,) * 6]
    with pytest.raises(ValueError, match=r"mesh\.ep=2 .*world size"):
        MeshSpec(ep=2, data=2).axis_sizes(2)


@pytest.mark.parametrize("data,fsdp,model,ep", [(4, 1, 1, 2), (2, 1, 2, 2), (2, 2, 1, 2),
                                                (1, 2, 2, 2)],
                         ids=["ep2", "ep2_tp2", "ep2_fsdp2", "ep2_fsdp2_tp2"])
def test_expert_leaves_are_cut_on_the_jax_dims(data, fsdp, model, ep):
    kw = dict(depth=2, hidden_size=64, num_heads=4, moe_experts=4)
    jmodel, _ = jax_create_model("JPDVT-MoE", 48, attn_impl="xla", **kw)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), np.zeros((1, 48, 48, 3), np.float32),
                            np.zeros((1,), np.int32), np.zeros((1, 9, 8), np.float32))
    params = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    want = _jax_specs(params, make_mesh(JaxMeshSpec(data=data, fsdp=fsdp, model=model, ep=ep),
                                         devices=jax.devices()[:8]))
    port, _ = create_model("JPDVT-MoE", 48, device="cpu", **kw)
    specs = leaf_specs({n: p.shape for n, p in port.named_parameters()}, model, fsdp, ep)
    assert sorted(specs) == sorted(want)
    for n, spec in specs.items():
        got = [None] * len(want[n])
        for dim, axis in ((spec.tp_dim, "model"), (spec.fsdp_dim, "fsdp"), (spec.ep_dim, "ep")):
            if dim is not None:
                got[dim] = axis
        assert tuple(got) == want[n], n
    assert specs["blocks.0.mlp.wi"].ep_dim == 0 and specs["blocks.0.mlp.router.weight"].ep_dim is None


# ------------------------------------------------------------- the mesh step

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both suites' ranks, with the one process and the JAX meshes computed
    while they run."""
    tmp = tmp_path_factory.mktemp("ep_runs")
    params = common.weights(tmp, ["moe"])
    procs = common.start(tmp, ["ep-2", "ep-4"])
    one = worker.run_case("ep2", str(tmp))
    jax_ref = {name: common.jax_steps("moe", params["moe"], axes)
               for name, axes in JAX_MESHES.items()}
    return common.finish(tmp, procs), one, jax_ref, tmp


@pytest.mark.parametrize("mesh", EP_MESHES)
def test_mesh_step_equals_one_process_step(runs, mesh):
    ranks, one, _, _ = runs
    common.check_against_one_process(ranks[mesh], one)


@pytest.mark.parametrize("mesh", list(JAX_MESHES))
def test_mesh_step_equals_the_jax_mesh_step(runs, mesh):
    ranks, _, jax_ref, _ = runs
    common.check_against_jax(ranks[mesh][0], jax_ref[mesh])


@pytest.mark.parametrize("mesh", ["ep2", "ep2_data2", "ep2_tp2"])
def test_router_gradient_is_summed_over_the_ep_group(runs, mesh):
    """Each ep rank's forward gates only its own experts, so its router
    gradient is a part; the step sums the parts (and the other leaves'
    gradients, which no axis cuts, are bit-equal on every rank: the worker
    holds that with ``check_replicas``)."""
    ranks, one, _, _ = runs
    names = [k for k in one if k.startswith("grad.") and ".mlp.router." in k]
    assert len(names) == 4
    for res in ranks[mesh]:
        for k in names:
            np.testing.assert_allclose(res[k], one[k], rtol=0, err_msg=k,
                                       atol=3e-6 * np.abs(one[k]).max())
    if mesh == "ep2":  # each rank's part before the sum is not the whole; the parts add to it
        for k in names:
            parts = [res["partial" + k[len("grad"):]] for res in ranks[mesh]]
            assert not np.allclose(parts[0], one[k], rtol=1e-2, atol=0)
            np.testing.assert_allclose(parts[0] + parts[1], one[k], rtol=0, err_msg=k,
                                       atol=3e-6 * np.abs(one[k]).max())


@pytest.mark.parametrize("mesh", ["ep2_data2", "ep2_fsdp2"])
def test_ep_mesh_checkpoint_restores_bit_equal_into_one_process(runs, mesh):
    """The checkpoint holds the one-process layout (each ep rank's experts
    gathered in order): it restores bit-equal into one process."""
    ranks, _, _, tmp = runs
    got = ranks[mesh][0]
    model, _ = create_model("JPDVT-MoE", 48, device="cpu", **worker.MODELS["moe"][1])
    state = CheckpointManager(str(tmp / "ep-4" / f"{mesh}_ckpt")).restore(
        create_train_state(model))
    assert state.step == 3 and state.opt.count == 3
    sd = state.state_dict()
    assert sd["model"]["blocks.0.mlp.wi"].shape == (4, 64, 256)
    for part, tensors in (("model", sd["model"]), ("ema", sd["ema"]), ("mu", sd["opt"]["mu"]),
                          ("nu", sd["opt"]["nu"])):
        for k, v in tensors.items():
            np.testing.assert_array_equal(v.numpy().view(np.int32),
                                          got[f"{part}.{k}"].view(np.int32), err_msg=k)


# ------------------------------------------------------------------ run_train

TINY = ["device=cpu", "data.synthetic_cues=waves", "data.global_batch_size=8",
        "data.num_workers=2", "data.synthetic_n=32", "model.image_size=48",
        "model.name=JPDVT-MoE", "model.moe_experts=4", "model.depth=2",
        "model.hidden_size=64", "model.num_heads=4", "model.compute_dtype=float32",
        "train.log_every=1", "train.ckpt_every=1000000", "diffusion.sampling_steps=2",
        "diffusion.sampler_mode=fast", "train.lr=0.003"]
CLI = [sys.executable, "-m", "jpdvt_mt_ntnu_tpu_torch.train.run_train"]


def test_run_train_on_an_ep_mesh_resumes_on_one_process(tmp_path, monkeypatch):
    from test_torch_mesh import _losses

    monkeypatch.chdir(tmp_path)
    one = tmp_path / "one"  # one process, stopped at step 4 and resumed
    assert run_train.main(TINY + [f"train.exp_dir={one}", "train.epochs=1"]) == 0
    assert run_train.main(TINY + [f"train.exp_dir={one}", "train.epochs=2",
                                  f"train.resume={one}/checkpoints"]) == 0
    two = tmp_path / "two"
    procs = launch(lambda r: CLI + TINY + [f"train.exp_dir={two}", "train.epochs=1",
                                            "mesh.ep=2"], tmp_path, "ep")
    assert wait_all(procs) == [0, 0], logs(procs)
    assert '"ep": 2' in (two / "log.txt").read_text()
    np.testing.assert_allclose(_losses(two), _losses(one)[:4], rtol=1e-5)
    assert run_train.main(TINY + [f"train.exp_dir={two}", "train.epochs=2",
                                  f"train.resume={two}/checkpoints"]) == 0
    assert "Resumed from step 4" in (two / "log.txt").read_text()
    np.testing.assert_allclose(_losses(two), _losses(one), rtol=1e-5)
    assert CheckpointManager(str(two / "checkpoints")).all_steps() == [4, 8]


def test_run_train_refuses_ep_with_seq():
    """seq x ep is ported (tests/test_torch_sequence.py): one process refuses
    it for want of ranks only. ep with the pipeline is refused by name, as
    the JAX trainer fails on it."""
    with pytest.raises(ValueError, match=r"mesh\.ep=2 x mesh\.seq=2 .*world size"):
        run_train.main(TINY + ["mesh.ep=2", "mesh.seq=2"])
    with pytest.raises(NotImplementedError, match=r"mesh\.pipe with mesh\.ep \(the JAX "
                       r"trainer's .*ScopeParamNotFoundError"):
        run_train.main(TINY + ["mesh.ep=2", "mesh.pipe=2"])
