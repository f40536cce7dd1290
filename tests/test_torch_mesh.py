"""The port's tensor parallelism and FSDP (``parallel/sharding.py``) on the CPU over gloo.

- Placement: rank r at (d, f, m) with ``model`` innermost, the JAX mesh's
  device order; the model, fsdp, data and data x fsdp groups; a model
  group's ranks take the same rows of the batch.
- The rules: every leaf of a small DiT (and of the MoE's experts under
  fsdp) is cut on the dims the JAX package's ``param_shardings`` gives it,
  on meshes of model 2, fsdp 2, fsdp 4, and fsdp 2 x model 2; qkv's rows are
  cut by heads and joined back.
- The train step on 2 and 4 gloo ranks (``tests/torch_mesh_worker.py``) on
  ``model=2``, ``fsdp=2`` and ``data=1, fsdp=2, model=2``, at a tiny width
  (48 px, depth 2, hidden 64, 4 heads), fp32, against the port's one
  process and against the JAX trainer on the same mesh of virtual CPU
  devices, with the same batches, draws and weights; with a global-norm
  clip that binds and ``grad_accum=2``; each rank's shards; the FSDP
  Linears' weights gathered again for the backward, only shards saved
  (fp32, and bf16 casts); a mesh checkpoint restored bit-equal into one
  process.
- ``run_train`` on ``mesh.model=2`` against one process, resumed on
  ``mesh.fsdp=2`` from its checkpoint; ``run_eval``, which reads neither
  axis, as the JAX eval.

Tolerances (fp32; the measured worst in brackets):
- mesh against one process: the loss, MSEs and grad norm 1e-6 relative
  (1.9e-7): the same draws, the products summed in another order (TP's
  partial sums, fsdp's reduce-scatter). Params, EMA and moments after 3
  AdamW steps: every element within 2e-4 (a tenth of lr; 4.2e-5) and 99.9%
  within 1e-6 (99.999%), as in ``test_torch_parallel.py``: AdamW carries a
  gradient's last ulps into its update where the gradient cancels.
- mesh against the JAX mesh: the 1e-5 relative of ``test_torch_parallel.py``
  for the losses and the grad norm (the JAX package holds its own TP and
  FSDP to DP at 2e-5), and the same parameter bounds.
- bf16 (the FSDP casts' path): the loss, MSEs and grad norm within 5e-3
  of one process's (1.7e-3): bf16 rounds TP's partial products and the
  gathered weights' products in another order.
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_worker as worker
import torch_parallel_worker as dpw
from test_torch_parallel import PARAM_ATOL, JaxInjected, assert_adam_close
from torch_parallel_worker import launch, logs, wait_all
from jpdvt_mt_ntnu_tpu.core.diffusion import create_diffusion as jax_create_diffusion
from jpdvt_mt_ntnu_tpu.models import create_model as jax_create_model
from jpdvt_mt_ntnu_tpu.parallel import MeshSpec as JaxMeshSpec
from jpdvt_mt_ntnu_tpu.parallel import make_mesh, param_shardings, shard_batch, state_shardings
from jpdvt_mt_ntnu_tpu.train.state import TrainState as JaxTrainState
from jpdvt_mt_ntnu_tpu.train.state import make_optimizer as jax_make_optimizer
from jpdvt_mt_ntnu_tpu.train.steps import TrainTask as JaxTrainTask
from jpdvt_mt_ntnu_tpu.train.steps import make_train_step as jax_make_train_step
from jpdvt_mt_ntnu_tpu.utils.pos_embed import grid_code
from jpdvt_mt_ntnu_tpu_torch.models import create_model
from jpdvt_mt_ntnu_tpu_torch.parallel import MeshSpec, rank_rows
from jpdvt_mt_ntnu_tpu_torch.parallel.sharding import (LeafSpec, MeshRanks, leaf_specs, tp_join,
                                                       tp_slice)
from jpdvt_mt_ntnu_tpu_torch.tools.weights import params_to_state_dict
from jpdvt_mt_ntnu_tpu_torch.train import CheckpointManager, create_train_state, run_train
from torch_tools_common import one_torch_thread  # noqa: F401  (autouse)

# (data, fsdp, model) of each mesh the workers run
MESHES = {"tp2": (1, 1, 2), "fsdp2": (1, 2, 1), "fsdp2_tp2": (1, 2, 2)}


# ----------------------------------------------------------------- placement

def test_ranks_are_placed_as_the_jax_mesh_places_devices():
    ranks = MeshRanks(data=2, fsdp=2, model=2)
    jmesh = make_mesh(JaxMeshSpec(data=2, fsdp=2, model=2), devices=jax.devices()[:8])
    assert jmesh.axis_names == ("data", "fsdp", "model")
    ids = np.vectorize(lambda dev: dev.id)(jmesh.devices) - jax.devices()[0].id
    for r in range(8):
        assert ids[ranks.coords(r)] == r
    assert ranks.groups("m") == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert ranks.groups("f") == [[0, 2], [1, 3], [4, 6], [5, 7]]
    assert ranks.groups("d") == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert ranks.groups("df") == [[0, 2, 4, 6], [1, 3, 5, 7]]
    assert [ranks.batch_index(r) for r in range(8)] == [0, 0, 1, 1, 2, 2, 3, 3]
    # A model group's ranks take the same rows; the four batch shards all of them.
    rows = [rank_rows(16, ranks.batch_index(r), ranks.batch_size, 2) for r in range(8)]
    assert all((rows[2 * i] == rows[2 * i + 1]).all() for i in range(4))
    assert sorted(np.concatenate(rows[::2])) == list(range(16))
    assert MeshSpec(model=2, fsdp=2).axis_sizes(8) == {"data": 2, "fsdp": 2, "model": 2}
    with pytest.raises(ValueError, match="world size"):
        MeshSpec(model=2, fsdp=2).axis_sizes(6)


def _path(path) -> str:
    return "/".join(str(getattr(k, "key", k)) for k in path)


def _jax_specs(params, mesh) -> dict[str, tuple]:
    """The JAX package's partition of each leaf, per torch dim of the port's
    leaf of that name (a Flax kernel is the torch weight transposed); a
    size-1 axis cuts nothing."""
    out = {}
    shapes = {_path(p): v.shape for p, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    for path, sharding in jax.tree_util.tree_flatten_with_path(param_shardings(params, mesh))[0]:
        keys = _path(path)
        shape = shapes[keys]
        sd, _ = params_to_state_dict({keys: np.zeros(shape)})
        (name,) = sd
        spec = list(sharding.spec) + [None] * (len(shape) - len(sharding.spec))
        spec = [a if a is not None and mesh.shape[a] > 1 else None for a in spec]
        out[name] = tuple(spec[::-1] if keys.endswith("kernel") and len(shape) == 2 else spec)
    return out


@pytest.mark.parametrize("name,experts,data,fsdp,model", [
    ("JPDVT", 0, 4, 1, 2), ("JPDVT", 0, 4, 2, 1), ("JPDVT", 0, 2, 4, 1), ("JPDVT", 0, 2, 2, 2),
    ("JPDVT-MoE", 2, 4, 2, 1), ("JPDVT-MoE", 2, 2, 4, 1)],
    ids=["tp2", "fsdp2", "fsdp4", "fsdp2_tp2", "moe-fsdp2", "moe-fsdp4"])
def test_leaves_are_cut_on_the_jax_dims(name, experts, data, fsdp, model):
    """(The MoE under mesh.model and mesh.ep: tests/test_torch_mesh_ep.py.)"""
    kw = dict(depth=2, hidden_size=64, num_heads=4, **({"moe_experts": experts} if experts else {}))
    jmodel, _ = jax_create_model(name, 48, attn_impl="xla", **kw)
    params = jmodel.init(jax.random.key(0), jnp.zeros((1, 48, 48, 3)), jnp.zeros((1,), jnp.int32),
                         jnp.zeros((1, 9, 8)))
    want = _jax_specs(params, make_mesh(JaxMeshSpec(data=data, fsdp=fsdp, model=model),
                                         devices=jax.devices()[:8]))
    port, _ = create_model(name, 48, device="cpu", **kw)
    specs = leaf_specs({n: p.shape for n, p in port.named_parameters()}, model, fsdp)
    assert sorted(specs) == sorted(want)
    for n, spec in specs.items():
        got = [None] * len(want[n])
        if spec.tp_dim is not None:
            got[spec.tp_dim] = "model"
        if spec.fsdp_dim is not None:
            got[spec.fsdp_dim] = "fsdp"
        assert tuple(got) == want[n], n


def test_qkv_is_cut_by_heads_and_joined_back():
    c, heads, model = 8, 4, 2
    # row r of qkv is (part, head, dim) = (r // c, r % c // 2, r % 2): head dim 2
    w = torch.arange(3 * c, dtype=torch.float32)[:, None].repeat(1, 5)
    spec = LeafSpec(tp_dim=0, tp_parts=3)
    parts = [tp_slice(w, spec, m, model) for m in range(model)]
    for m, p in enumerate(parts):
        rows = p[:, 0].long()
        assert rows.tolist() == [j * c + h * 2 + d for j in range(3)
                                 for h in range(m * heads // model, (m + 1) * heads // model)
                                 for d in range(2)]
    assert torch.equal(tp_join(torch.stack(parts), spec), w)
    fc2 = torch.arange(24.0).reshape(2, 12)
    cut = LeafSpec(tp_dim=1)
    assert torch.equal(tp_join(torch.stack([tp_slice(fc2, cut, m, 3) for m in range(3)]), cut),
                       fc2)


# ------------------------------------------------------------- the mesh step

@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    jmodel, _ = jax_create_model("JPDVT", dpw.SIZE, attn_impl="xla", **worker.MODEL)
    shapes = jmodel.init(jax.random.key(0), jnp.zeros((1, dpw.SIZE, dpw.SIZE, 3)),
                         jnp.zeros((1,), jnp.int32), jnp.zeros((1, dpw.TOKENS, 8)))
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda a: (0.05 * rng.standard_normal(a.shape)).astype(np.float32),
                          shapes)
    sd, unused = params_to_state_dict(params)
    assert unused == []
    path = tmp_path_factory.mktemp("mesh_weights") / "weights.npz"
    np.savez(path, **sd)
    return jmodel, params, {k: np.asarray(v) for k, v in sd.items()}, str(path)


@pytest.fixture(scope="module")
def mesh_runs(weights, tmp_path_factory):
    """Every mesh's ranks, run together: {mesh: (each rank's results, ckpt dir)}."""
    tmp = tmp_path_factory.mktemp("mesh_runs")
    procs = {}
    for name, (d, f, m) in MESHES.items():
        procs[name] = launch(lambda r, name=name, d=d, f=f, m=m: [
            sys.executable, worker.__file__, str(tmp / f"{name}_{r}.npz"), weights[3],
            str(d), str(f), str(m), str(tmp / f"{name}_ckpt")], tmp, name, world=d * f * m)
    out = {}
    for name, ps in procs.items():
        assert wait_all(ps) == [0] * len(ps), logs(ps)
        out[name] = ([dict(np.load(tmp / f"{name}_{r}.npz")) for r in range(len(ps))],
                     str(tmp / f"{name}_ckpt"))
    return out


@pytest.fixture(scope="module")
def one_process(weights):
    return {case: worker.run_case(case, weights[2]) for case in worker.CASES}


def _case(res: dict, case: str) -> dict:
    return {k[len(case) + 1:]: v for k, v in res.items() if k.startswith(case + "/")}


STATE = ("model.", "ema.", "mu.", "nu.")


@pytest.mark.parametrize("case", list(worker.CASES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_step_equals_one_process_step(mesh_runs, one_process, mesh, case):
    ranks, _ = mesh_runs[mesh]
    one = one_process[case]
    r0 = _case(ranks[0], case)
    for res in ranks[1:]:  # every rank ends every step with the same metrics and state
        other = _case(res, case)
        for k, v in r0.items():
            if k in ("loss", "code_mse", "img_mse", "grad_norm") or k.startswith(STATE):
                np.testing.assert_array_equal(other[k], v, err_msg=k)
    bf16 = worker.CASES[case][3] == torch.bfloat16
    for k in ("loss", "code_mse", "img_mse", "grad_norm"):
        np.testing.assert_allclose(r0[k], one[k], rtol=5e-3 if bf16 else 1e-6, err_msg=k)
    if bf16:
        return
    for part in STATE:
        assert_adam_close({k: v for k, v in r0.items() if k.startswith(part)},
                          {k: v for k, v in one.items() if k.startswith(part)},
                          PARAM_ATOL, 1e-6, 0.999)
    if worker.CASES[case][1] is not None:  # the clip binds at every step
        assert (one["grad_norm"] > worker.CASES[case][1]).all()


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_step_equals_the_jax_mesh_step(mesh_runs, weights, mesh):
    jmodel, params, _, _ = weights
    d, f, m = MESHES[mesh]
    jmesh = make_mesh(JaxMeshSpec(data=d, fsdp=f, model=m), devices=jax.devices()[:d * f * m])
    opt = jax_make_optimizer(dpw.LR)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          ema_params=jax.tree.map(jnp.copy, params), opt_state=opt.init(params))
    state = jax.device_put(state, state_shardings(state, jmesh))
    task = JaxTrainTask(grid_size=dpw.GRID, block_size=dpw.SIZE // dpw.GRID, patch_size=16,
                        ema_warmup=True)
    step = jax_make_train_step(jmodel, JaxInjected(jax_create_diffusion(""), 1), opt, task,
                               jnp.asarray(grid_code(8, dpw.GRID)),
                               fused_adamw=dict(lr=dpw.LR, weight_decay=0.0), mesh=jmesh)
    losses, norms = [], []
    for s in range(dpw.STEPS):
        state, met = step(state, shard_batch({"x": jnp.asarray(dpw.images(s))}, jmesh)["x"],
                          jax.random.key(0))
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    mine = _case(mesh_runs[mesh][0][0], "injected")
    np.testing.assert_allclose(mine["loss"], losses, rtol=1e-5)
    np.testing.assert_allclose(mine["grad_norm"], norms, rtol=1e-5)
    for part, tree in (("model", state.params), ("ema", state.ema_params)):
        want, _ = params_to_state_dict(jax.tree.map(np.asarray, tree))
        assert_adam_close({k: mine[f"{part}.{k}"] for k in want}, want, PARAM_ATOL, 2e-6, 0.999)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_each_rank_holds_the_shard_the_rules_give(mesh_runs, mesh):
    ranks, _ = mesh_runs[mesh]
    d, f, m = MESHES[mesh]
    placement = MeshRanks(d, f, m)
    port, _ = create_model("JPDVT", dpw.SIZE, device="cpu", **worker.MODEL)
    specs = leaf_specs({n: p.shape for n, p in port.named_parameters()}, m, f)
    hidden = worker.MODEL["hidden_size"]
    for r, res in enumerate(ranks):
        _, fi, mi = placement.coords(r)
        got = _case(res, "injected")
        for leaf in worker.SHARD_LEAVES:
            full = torch.from_numpy(got[f"model.{leaf}"])
            spec = specs[leaf]
            want = tp_slice(full, spec, mi, m)
            if spec.fsdp_dim is not None:
                want = want.chunk(f, dim=spec.fsdp_dim)[fi]
            np.testing.assert_array_equal(got[f"shard.{leaf}"], want.numpy(), err_msg=leaf)
        # qkv by heads, counted from the rows: rank mi's heads of q, of k and of v.
        qkv = torch.from_numpy(got["model.blocks.0.attn.qkv.bias"])
        k = hidden // m
        heads = torch.cat([qkv[j * hidden + mi * k:j * hidden + (mi + 1) * k] for j in range(3)])
        np.testing.assert_array_equal(got["shard.blocks.0.attn.qkv.bias"], heads.numpy())


@pytest.mark.parametrize("mesh", list(MESHES))
def test_fsdp_units_pack_the_weights_they_save(mesh_runs, mesh, weights):
    """Under fsdp each Linear saves its weight's shard only (fp32, and for
    the bf16 casts), and gathers the weight again for the backward where
    its input needs a gradient: 15 a step at depth 2 (the blocks' adaLN,
    qkv, proj, fc1 and fc2, and the final layer's and code head's five;
    the three embeddings whose inputs need no gradient gather none)."""
    ranks, _ = mesh_runs[mesh]
    _, fsdp, model = MESHES[mesh]
    # Saved: the largest shard (x_embedder's 64 x 768, cut by fsdp), never a weight whole.
    sd = weights[2]
    specs = leaf_specs({k: v.shape for k, v in sd.items()}, model, fsdp)
    largest = max(sd[k].size // (fsdp * (model if spec.tp_dim is not None else 1))
                  for k, spec in specs.items() if spec.fsdp_dim is not None) if fsdp > 1 else 0
    for res in ranks:
        per_step = {case: int(res[f"{case}/regathered"]) / (dpw.STEPS * worker.CASES[case][0])
                    for case in worker.CASES}
        assert per_step == {case: 15 if fsdp > 1 else 0 for case in worker.CASES}, per_step
        saved = {case: int(res[f"{case}/saved_weight"]) for case in worker.CASES}
        assert saved == {case: largest for case in worker.CASES}, saved


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_checkpoint_restores_bit_equal_into_one_process(mesh_runs, weights, mesh):
    ranks, ckpt = mesh_runs[mesh]
    got = _case(ranks[0], "injected")
    model, _ = create_model("JPDVT", dpw.SIZE, device="cpu", **worker.MODEL)
    state = CheckpointManager(ckpt).restore(create_train_state(model))
    assert state.step == dpw.STEPS and state.opt.count == dpw.STEPS
    sd = state.state_dict()
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


def _losses(exp) -> list[float]:
    rows = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
    return [r["train_loss"] for r in rows if "train_loss" in r]


def test_run_train_on_a_model_mesh_resumes_on_an_fsdp_mesh(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    one = tmp_path / "one"  # one process, stopped at step 4 and resumed as the mesh runs are
    assert run_train.main(TINY + [f"train.exp_dir={one}", "train.epochs=1"]) == 0
    assert run_train.main(TINY + [f"train.exp_dir={one}", "train.epochs=2",
                                  f"train.resume={one}/checkpoints"]) == 0
    two = tmp_path / "two"
    procs = launch(lambda r: CLI + TINY + [f"train.exp_dir={two}", "train.epochs=1",
                                            "mesh.model=2"], tmp_path, "tp")
    assert wait_all(procs) == [0, 0], logs(procs)
    log = (two / "log.txt").read_text()
    assert '"model": 2' in log and "this rank holds" in log
    np.testing.assert_allclose(_losses(two), _losses(one)[:4], rtol=1e-5)
    procs = launch(lambda r: CLI + TINY + [f"train.exp_dir={two}", "train.epochs=2",
                                            f"train.resume={two}/checkpoints", "mesh.fsdp=2"],
                   tmp_path, "fsdp")
    assert wait_all(procs) == [0, 0], logs(procs)
    assert "Resumed from step 4" in (two / "log.txt").read_text()
    assert CheckpointManager(str(two / "checkpoints")).all_steps() == [4, 8]
    np.testing.assert_allclose(_losses(two), _losses(one), rtol=1e-5)
    # Its checkpoint is the one-process layout: it restores into one process.
    model, _ = create_model("JPDVT", 48, device="cpu", depth=2, hidden_size=64, num_heads=4)
    state = CheckpointManager(str(two / "checkpoints")).restore(create_train_state(model))
    assert state.step == 8


def test_run_eval_reads_neither_model_nor_fsdp(tmp_path):
    """As the JAX eval (``run_eval.py:133-147``): ``mesh.model`` and
    ``mesh.fsdp`` leave the evaluation as it is; every rank is a data shard."""
    from jpdvt_mt_ntnu_tpu_torch.eval import run_eval

    fixture = str(Path(__file__).parent / "fixtures" / "tiny_jpdvt_48px.npz")
    args = ["device=cpu", "model.image_size=48", "model.depth=2", "model.hidden_size=64",
            "model.num_heads=4", "model.compute_dtype=float32", "data.synthetic_cues=waves",
            f"eval.checkpoint={fixture}", "eval.seed=11", "eval.batch_size=8",
            "eval.limit=16", "diffusion.sampler_mode=fast"]
    assert run_eval.main(args + [f"eval.logs_dir={tmp_path}/plain"]) == 0
    assert run_eval.main(args + ["mesh.model=2", "mesh.fsdp=2",
                                 f"eval.logs_dir={tmp_path}/mesh"]) == 0
    rows = [(tmp_path / d / "inference_progress.csv").read_text().splitlines()
            for d in ("plain", "mesh")]
    assert len(rows[0]) == 17
    assert [r.split(",")[:3] for r in rows[0]] == [r.split(",")[:3] for r in rows[1]]
