"""What tests/test_torch_mesh_ep.py, test_torch_pipeline.py and test_torch_sequence.py share.

- :func:`weights`: each model of ``torch_axes_worker.MODELS`` with the same
  random weights for the JAX package and the port (N(0, 0.05) on the JAX
  init's shapes), written where the workers read them;
- :func:`start` / :func:`finish`: a suite's ranks of
  ``tests/torch_axes_worker.py``, started together and read back;
- :func:`jax_steps`: the JAX train step on a mesh of the virtual CPU
  devices, with ``torch_axes_worker.draws`` injected, for 3 steps;
- :func:`check_against_one_process`: a mesh's results against the port's
  one process, with the tolerances of ``tests/test_torch_mesh.py``.
"""

from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np

import torch_axes_worker as worker
import torch_parallel_worker as dpw
from test_torch_parallel import PARAM_ATOL, assert_adam_close
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
from jpdvt_mt_ntnu_tpu_torch.tools.weights import params_to_state_dict

METRICS = ("loss", "code_mse", "img_mse", "grad_norm")
STATE = ("model.", "ema.", "mu.", "nu.")


def jax_model(model: str, **kw):
    name, over = worker.MODELS[model]
    return jax_create_model(name, dpw.SIZE, **{"attn_impl": "xla", **over, **kw})


def weights(tmp_dir, models) -> dict:
    """{model: JAX params} of ``models``, each also written as the port's
    state dict to ``tmp_dir/<model>.npz``."""
    out = {}
    for model in models:
        jmodel, cfg = jax_model(model)
        shapes = jax.eval_shape(jmodel.init, jax.random.key(0),
                                jnp.zeros((1, dpw.SIZE, dpw.SIZE, 3)), jnp.zeros((1,), jnp.int32),
                                jnp.zeros((1, cfg.num_tokens, 8)))
        rng = np.random.default_rng(0)
        params = jax.tree.map(lambda a: (0.05 * rng.standard_normal(a.shape)).astype(np.float32),
                              shapes)
        sd, unused = params_to_state_dict(params)
        assert unused == []
        np.savez(tmp_dir / f"{model}.npz", **{k: np.asarray(v) for k, v in sd.items()})
        out[model] = params
    return out


def start(tmp_dir, suites) -> dict:
    """Every suite's ranks, started together: {suite: processes}."""
    procs = {}
    for suite in suites:
        world = worker.SUITES[suite][0]
        (tmp_dir / suite).mkdir()
        procs[suite] = launch(lambda r, suite=suite: [
            sys.executable, worker.__file__, str(tmp_dir / suite / f"rank{r}.npz"),
            str(tmp_dir), suite], tmp_dir, suite, world=world)
    return procs


def finish(tmp_dir, procs: dict) -> dict:
    """{mesh or suite: [each rank's results]} once every rank has ended."""
    out = {}
    for suite, ps in procs.items():
        assert wait_all(ps) == [0] * len(ps), logs(ps)
        ranks = [dict(np.load(tmp_dir / suite / f"rank{r}.npz")) for r in range(len(ps))]
        out[suite] = ranks
        for name in worker.SUITES[suite][1]:
            out[name] = [case(res, name) for res in ranks]
    return out


def case(res: dict, name: str) -> dict:
    return {k[len(name) + 1:]: v for k, v in res.items() if k.startswith(name + "/")}


def check_against_one_process(ranks: list[dict], one: dict) -> None:
    """Every rank ends every step with the same metrics and state; those
    are one process's within 1e-6 relative (metrics) and ``PARAM_ATOL``
    with 99.9% of the elements within 1e-6 (state)."""
    r0 = ranks[0]
    for other in ranks[1:]:
        for k, v in r0.items():
            if k in METRICS or k.startswith(STATE):
                np.testing.assert_array_equal(other[k], v, err_msg=k)
    for k in METRICS:
        np.testing.assert_allclose(r0[k], one[k], rtol=1e-6, err_msg=k)
    for part in STATE:
        assert_adam_close({k: v for k, v in r0.items() if k.startswith(part)},
                          {k: v for k, v in one.items() if k.startswith(part)},
                          PARAM_ATOL, 1e-6, 0.999)


class JaxInjected:
    """The JAX ``Diffusion`` with ``torch_axes_worker.draws`` injected: the
    step is found by matching its key among the steps' keys."""

    def __init__(self, diffusion, n_tokens: int):
        self.diffusion = diffusion
        keys = [jax.random.split(jax.random.fold_in(jax.random.key(0), s))[1]
                for s in range(dpw.STEPS)]
        self.keys = jnp.stack([jax.random.key_data(k) for k in keys])
        table = [worker.draws(s, n_tokens) for s in range(dpw.STEPS)]
        self.table = {k: jnp.asarray(np.stack([d[k] for d in table])) for k in table[0]}

    def __getattr__(self, name):
        return getattr(self.diffusion, name)

    def training_losses(self, model_fn, x, t, code, rng, **kw):
        i = jnp.argmax(jnp.all(jax.random.key_data(rng)[None] == self.keys, axis=-1))
        inj = {k: v[i] for k, v in self.table.items() if k != "t"}
        return self.diffusion.training_losses(model_fn, x, self.table["t"][i], code, rng,
                                              _inject=inj, **kw)


def jax_steps(model: str, params, axes: dict, *, pipe_micro: int = 0, ring: bool = False
              ) -> dict:
    """3 JAX train steps of ``model`` from ``params`` on a mesh of ``axes``
    over the virtual CPU devices (GPipe with ``pipe_micro`` microbatches,
    or ring attention): per-step loss and grad norm, and the final params
    and EMA as the port's state dicts."""
    from jpdvt_mt_ntnu_tpu.parallel.pipeline import (convert_state, make_pipeline_apply,
                                                     pipeline_state_shardings,
                                                     stack_block_params,
                                                     unstack_block_params)

    n = int(np.prod(list(axes.values())))
    jmesh = make_mesh(JaxMeshSpec(**axes), devices=jax.devices()[:n])
    jmodel, cfg = (jax_model(model, attn_impl="ring", seq_mesh=jmesh) if ring
                   else jax_model(model))
    opt = jax_make_optimizer(dpw.LR)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          ema_params=jax.tree.map(jnp.copy, params), opt_state=opt.init(params))
    apply_fn = None
    if pipe_micro:
        apply_fn = make_pipeline_apply(cfg, jmesh, pipe_micro)
        state = convert_state(state, stack_block_params)
        state = jax.device_put(state, pipeline_state_shardings(state, jmesh))
    else:
        state = jax.device_put(state, state_shardings(state, jmesh))
    task = JaxTrainTask(grid_size=dpw.GRID, block_size=dpw.SIZE // dpw.GRID,
                        patch_size=cfg.patch_size, ema_warmup=True)
    step = jax_make_train_step(jmodel, JaxInjected(jax_create_diffusion(""), cfg.num_tokens),
                               opt, task, jnp.asarray(grid_code(8, dpw.GRID)),
                               fused_adamw=dict(lr=dpw.LR, weight_decay=0.0), mesh=jmesh,
                               apply_fn=apply_fn)
    out: dict = {"loss": [], "grad_norm": []}
    for s in range(dpw.STEPS):
        state, met = step(state, shard_batch({"x": jnp.asarray(dpw.images(s))}, jmesh)["x"],
                          jax.random.key(0))
        out["loss"].append(float(met["loss"]))
        out["grad_norm"].append(float(met["grad_norm"]))
    if pipe_micro:
        state = convert_state(state, unstack_block_params)
    for part, tree in (("model", state.params), ("ema", state.ema_params)):
        out[part], _ = params_to_state_dict(jax.tree.map(np.asarray, tree))
    return out


def check_against_jax(mine: dict, theirs: dict) -> None:
    """The port on a mesh against the JAX step on the same mesh: loss and
    grad norm within 1e-5 relative, params and EMA within ``PARAM_ATOL``
    with 99.9% of the elements within 2e-6."""
    np.testing.assert_allclose(mine["loss"], theirs["loss"], rtol=1e-5)
    np.testing.assert_allclose(mine["grad_norm"], theirs["grad_norm"], rtol=1e-5)
    for part in ("model", "ema"):
        want = theirs[part]
        assert_adam_close({k: mine[f"{part}.{k}"] for k in want}, want, PARAM_ATOL, 2e-6, 0.999)
