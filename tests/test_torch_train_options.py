"""The trainer's single-card options against the JAX package's, on the CPU.

- The K3 training route (``model.attn_impl=block``): the loss and every
  parameter gradient of a 2-block DiT (48 px, hidden 128, 2 heads x 64,
  numpy weights, injected draws) through the port's plain K3 against the
  JAX package's ``fused_attention_block`` custom VJP with the Pallas
  forward in interpret mode (``block_interpret``); the ``autograd.Function``
  the card uses (K3 or the composition forward, autograd of the
  composition's plain version backward, as the JAX package's ``_fab_bwd``)
  with its forward stood in by K3's plain version; and ``run_train`` on the
  route, every train step's attention through the block.
- ``task.multi_grid``: 6 steps cycling grids 2, 3 and 6 at 96 px with
  injected draws, the per-step losses and grad norms against the JAX
  package's steps cycled the same way; the ``run_train`` loops of both
  packages (steps and validators stood in by recorders) against each
  other: the grid of every step, the ``_g{g}`` validation keys, and the
  grids in the port's checkpoint metadata, which ``run_eval`` accepts.
- ``data.device_cache_augment``: the batches of two epochs of both
  packages' ``run_train`` loops, recorded the same way.
- ``model.matmul_precision``: the mapping onto torch's names, and both
  entry points taking it.

Tolerances (fp32): losses 1e-5 relative and gradients 2e-4 of each
gradient's largest magnitude, as tests/test_torch_port_train.py; the
grad norm 1e-5 relative; cached batches 2^-7 (the two packages' bf16
waves differ by one bf16 ulp, tests/test_torch_port_train.py).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpdvt_mt_ntnu_tpu.core.diffusion import create_diffusion as jax_create_diffusion
from jpdvt_mt_ntnu_tpu.models import create_model as jax_create_model
from jpdvt_mt_ntnu_tpu.train import run_train as jax_run_train
from jpdvt_mt_ntnu_tpu.train.state import TrainState as JaxTrainState
from jpdvt_mt_ntnu_tpu.train.state import make_optimizer as jax_make_optimizer
from jpdvt_mt_ntnu_tpu.train.steps import TrainTask as JaxTrainTask
from jpdvt_mt_ntnu_tpu.train.steps import make_train_step as jax_make_train_step
from jpdvt_mt_ntnu_tpu.utils.pos_embed import grid_code
from jpdvt_mt_ntnu_tpu_torch.core.diffusion import create_diffusion
from jpdvt_mt_ntnu_tpu_torch.eval import run_eval
from jpdvt_mt_ntnu_tpu_torch.models import create_model, dit
from jpdvt_mt_ntnu_tpu_torch.ops import attention
from jpdvt_mt_ntnu_tpu_torch.tools.weights import params_to_state_dict
from jpdvt_mt_ntnu_tpu_torch.train import (CheckpointManager, TrainTask, create_train_state,
                                           make_optimizer, make_train_step, run_train)
from jpdvt_mt_ntnu_tpu_torch.utils.device import MATMUL_PRECISION, apply_matmul_precision
from torch_tools_common import one_torch_thread  # noqa: F401  (autouse)

SIZE = dict(depth=2, hidden_size=128, num_heads=2)
TINY = ["device=cpu", "data.synthetic_cues=waves", "data.global_batch_size=8",
        "data.num_workers=2", "data.synthetic_n=32", "model.image_size=48",
        "model.depth=2", "model.hidden_size=64", "model.num_heads=4",
        "model.compute_dtype=float32", "train.log_every=1",
        "train.ckpt_every=1000000", "diffusion.sampling_steps=2",
        "diffusion.sampler_mode=fast"]


def _pair(size: int, jax_attn: str, attn_impl=None):
    """The JAX DiT at ``size`` px with numpy weights, and the port's with the same."""
    jmodel, _ = jax_create_model("JPDVT", size, attn_impl=jax_attn, **SIZE)
    n = (size // 16) ** 2
    shapes = jmodel.init(jax.random.key(0), jnp.zeros((1, size, size, 3)),
                         jnp.zeros((1,), jnp.int32), jnp.zeros((1, n, 8)))
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda a: (0.05 * rng.standard_normal(a.shape)).astype(np.float32),
                          shapes)
    model, _ = create_model("JPDVT", size, device="cpu", attn_impl=attn_impl, **SIZE)
    sd, unused = params_to_state_dict(params)
    assert unused == []
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()})
    return jmodel, params, model


def _draws(seed: int, b: int, size: int, grid: int, add_mask: bool = False) -> dict:
    rng = np.random.default_rng(seed)
    n = (size // 16) ** 2
    out = {"t": rng.integers(0, 1000, b),
           "indices": np.stack([rng.permutation(grid * grid) for _ in range(b)]),
           "noise_x": rng.standard_normal((b, size, size, 3)).astype(np.float32),
           "noise_c": rng.standard_normal((b, n, 8)).astype(np.float32)}
    if add_mask:
        out["piece_mask"] = (rng.random((b, grid * grid)) > 0.3).astype(np.float32)
    return out


# ------------------------------------------------------------ the K3 route

@pytest.mark.parametrize("add_mask", [False, True], ids=["no_mask", "mask"])
def test_block_route_gradients_match_jax_custom_vjp(add_mask):
    jmodel, params, model = _pair(48, "block_interpret", "block")
    d = _draws(1, 4, 48, 3, add_mask)
    x = np.random.default_rng(2).uniform(-1, 1, (4, 48, 48, 3)).astype(np.float32)
    code = grid_code(8, 3)
    inject = {k: v for k, v in d.items() if k != "t"}
    jdiff = jax_create_diffusion("")

    def jloss(p):
        out = jdiff.training_losses(
            lambda xx, tt, cc: jmodel.apply(p, xx, tt, cc), jnp.asarray(x),
            jnp.asarray(d["t"]), jnp.asarray(code), jax.random.key(0), block_size=16,
            patch_size=16, add_mask=add_mask, grid_size=3,
            _inject={k: jnp.asarray(v) for k, v in inject.items()})
        return out["loss"].mean()

    jl, jgrads = jax.value_and_grad(jloss)(params)
    calls = []
    kernel = dit.fused_attention_block

    def counted(*args):
        calls.append(torch.is_grad_enabled())
        return kernel(*args)

    dit.fused_attention_block = counted
    try:
        out = create_diffusion("", device="cpu").training_losses(
            model, torch.from_numpy(x), torch.from_numpy(d["t"]), torch.from_numpy(code),
            block_size=16, patch_size=16, add_mask=add_mask, grid_size=3, _inject=inject)
        out["loss"].mean().backward()
    finally:
        dit.fused_attention_block = kernel
    assert calls == [True, True]  # one K3 call per block, with grad
    np.testing.assert_allclose(out["loss"].mean().item(), float(jl), rtol=1e-5)
    want, _ = params_to_state_dict(jax.tree.map(np.asarray, jgrads))
    for k, w in want.items():
        g = dict(model.named_parameters())[k].grad.numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-4 * np.abs(w).max() + 1e-9,
                                   err_msg=k)
    assert dict(model.named_parameters())["blocks.1.attn.qkv.weight"].grad.abs().max() > 0


def test_block_autograd_function_differentiates_the_plain_version():
    """The card's route: ``_PlainBackward`` (K3 or the composition forward,
    autograd of the composition's plain version backward), its forward
    stood in by K3's plain version."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 9, 128, generator=gen)
    w = [torch.randn(s, generator=gen) * 0.1 for s in ((384, 128), (384,), (128, 128), (128,))]
    grads = []
    for fn in (lambda *a: attention._PlainBackward.apply(
                   attention.fused_attention_block_plain,
                   attention.fused_attention_block_xla_plain, a[-1], *a[:-1]),
               attention.fused_attention_block_xla_plain):
        leaves = [t.clone().requires_grad_(True) for t in [x, *w]]
        blocks = attention.dense_to_block_weights(*leaves[1:], num_heads=2)
        out = fn(leaves[0], *blocks, 2)
        (out * torch.linspace(-1, 1, out.numel()).view_as(out)).sum().backward()
        grads.append([t.grad for t in leaves])
    for mine, want in zip(*grads):
        torch.testing.assert_close(mine, want, rtol=1e-6, atol=1e-7)


def test_run_train_takes_the_block_route(tmp_path, monkeypatch):
    calls = []
    kernel = dit.fused_attention_block

    def counted(*args):
        calls.append(torch.is_grad_enabled())
        return kernel(*args)

    monkeypatch.setattr(dit, "fused_attention_block", counted)
    exp = tmp_path / "exp"
    assert run_train.main(TINY + [f"train.exp_dir={exp}", "train.epochs=1",
                                  "model.attn_impl=block"]) == 0
    assert calls.count(True) == 4 * 2  # 4 steps x 2 blocks; the rest validates
    rows = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
    assert all(np.isfinite(r["train_loss"]) for r in rows if "train_loss" in r)


# --------------------------------------------------------------- multi_grid

GRIDS, MG_SIZE, MG_B, MG_STEPS, LR = (2, 3, 6), 96, 4, 6, 2e-3


class _PortInjected:
    """The port's ``Diffusion`` with the draws of each step injected."""

    def __init__(self, diffusion, steps: list[int]):
        self.diffusion, self.steps, self.calls = diffusion, steps, 0

    def __getattr__(self, name):
        return getattr(self.diffusion, name)

    def training_losses(self, model_fn, x, t, code, *, grid_size, **kw):
        s = self.steps[self.calls]
        self.calls += 1
        d = _draws(300 + s, MG_B, MG_SIZE, grid_size)
        return self.diffusion.training_losses(
            model_fn, x, torch.as_tensor(d["t"]), code, grid_size=grid_size,
            _inject={k: v for k, v in d.items() if k != "t"}, **kw)


class _JaxInjected:
    """The JAX ``Diffusion`` with the draws of ``steps`` injected, each
    found by its step's key (``fold_in(key(0), step)``, then the loss key)."""

    def __init__(self, diffusion, steps: list[int], grid: int):
        self.diffusion = diffusion
        keys = [jax.random.split(jax.random.fold_in(jax.random.key(0), s))[1] for s in steps]
        self.keys = jnp.stack([jax.random.key_data(k) for k in keys])
        draws = [_draws(300 + s, MG_B, MG_SIZE, grid) for s in steps]
        self.table = {k: jnp.asarray(np.stack([d[k] for d in draws])) for k in draws[0]}

    def __getattr__(self, name):
        return getattr(self.diffusion, name)

    def training_losses(self, model_fn, x, t, code, rng, **kw):
        i = jnp.argmax(jnp.all(jax.random.key_data(rng)[None] == self.keys, axis=-1))
        inj = {k: v[i] for k, v in self.table.items() if k != "t"}
        return self.diffusion.training_losses(model_fn, x, self.table["t"][i], code, rng,
                                              _inject=inj, **kw)


def test_multi_grid_losses_per_step_match_the_jax_cycle():
    jmodel, params, model = _pair(MG_SIZE, "xla")
    opt = jax_make_optimizer(LR)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           ema_params=jax.tree.map(jnp.copy, params), opt_state=opt.init(params))
    state = create_train_state(model)
    jsteps, steps = [], []
    for i, g in enumerate(GRIDS):
        mine = list(range(i, MG_STEPS, len(GRIDS)))
        jsteps.append(jax_make_train_step(
            jmodel, _JaxInjected(jax_create_diffusion(""), mine, g), opt,
            JaxTrainTask(grid_size=g, block_size=MG_SIZE // g, patch_size=16),
            jnp.asarray(grid_code(8, g)), fused_adamw=dict(lr=LR, weight_decay=0.0)))
        steps.append(make_train_step(
            _PortInjected(create_diffusion("", device="cpu"), mine), make_optimizer(LR),
            TrainTask(grid_size=g, block_size=MG_SIZE // g, patch_size=16),
            torch.as_tensor(grid_code(8, g))))
    rng = np.random.default_rng(4)
    got, want = [], []
    for s in range(MG_STEPS):
        x = (0.5 * rng.standard_normal((MG_B, MG_SIZE, MG_SIZE, 3))).astype(np.float32)
        jstate, jm = jsteps[s % len(GRIDS)](jstate, jnp.asarray(x), jax.random.key(0))
        state, m = steps[s % len(GRIDS)](state, torch.from_numpy(x))
        want.append((float(jm["loss"]), float(jm["grad_norm"])))
        got.append((float(m["loss"]), float(m["grad_norm"])))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert len({round(loss, 6) for loss, _ in got}) == MG_STEPS


class _Recorder:
    """Stands in for a package's ``make_train_step`` and ``Validator``: each
    step records its grid (and batch) and advances the step counter."""

    def __init__(self):
        self.grids, self.batches = [], []

    def make_step(self, *args, **kw):
        task = next(a for a in args if hasattr(a, "grid_size"))

        def step(state, batch, *rng):
            self.grids.append(task.grid_size)
            if rng:  # the JAX loop counts its steps itself
                self.batches.append(np.asarray(batch.astype(jnp.float32)))
                return state, {"loss": jnp.float32(0.5)}
            self.batches.append(batch.float().numpy())
            state.step += 1
            return state, {"loss": torch.tensor(0.5)}

        return step

    @staticmethod
    def validator(*args, grid_size=3, **kw):
        return lambda *a: {"val_puzzle_acc": float(grid_size), "val_n": 1}


def _record(monkeypatch, module, args) -> tuple[_Recorder, list[dict]]:
    rec = _Recorder()
    monkeypatch.setattr(module, "make_train_step", rec.make_step)
    monkeypatch.setattr(module, "Validator", rec.validator)
    assert module.main(args) == 0
    exp = [a.split("=", 1)[1] for a in args if a.startswith("train.exp_dir=")][0]
    with open(f"{exp}/metrics.jsonl") as f:
        return rec, [json.loads(line) for line in f]


def _val_keys(rows) -> list[str]:
    return sorted({k for r in rows for k in r if k.startswith(("val_", "raw_val_"))})


def test_multi_grid_cycle_matches_the_jax_run_train(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = [a for a in TINY if a != "device=cpu" and not a.startswith("model.image_size")]
    args += ["model.image_size=96", "task.multi_grid=2,3,6", "train.epochs=2",
             "train.val_every=4", "data.synthetic_n=24"]
    jrec, jrows = _record(monkeypatch, jax_run_train, args + [f"train.exp_dir={tmp_path}/jax"])
    rec, rows = _record(monkeypatch, run_train,
                        ["device=cpu"] + args + [f"train.exp_dir={tmp_path}/port"])
    assert rec.grids == jrec.grids == [2, 3, 6, 2, 3, 6]
    assert _val_keys(rows) == _val_keys(jrows)
    assert {"val_puzzle_acc_g2", "val_puzzle_acc_g6", "raw_val_puzzle_acc_g3"} <= set(
        _val_keys(rows))
    assert rows[-1]["summary"]["val_puzzle_acc_g6"] == 6.0
    meta = CheckpointManager(str(tmp_path / "port" / "checkpoints")).metadata()
    assert meta["grids"] == [2, 3, 6] and meta["step"] == 6
    cfg = run_eval.apply_overrides(run_eval.Config(), ["model.image_size=96",
                                                       "task.grid_size=6"])
    assert run_eval.check_metadata_compat(meta, cfg) == []
    cfg.task.grid_size = 4
    assert run_eval.check_metadata_compat(meta, cfg)


# --------------------------------------------------------- device_cache

def test_device_cache_augment_batches_match_the_jax_run_train(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = [a for a in TINY if a != "device=cpu" and not a.startswith("data.synthetic_n")]
    args += ["data.synthetic_n=16", "data.device_cache=true", "data.device_cache_augment=true",
             "train.epochs=2", "train.global_seed=3"]
    jrec, _ = _record(monkeypatch, jax_run_train, args + [f"train.exp_dir={tmp_path}/jax"])
    rec, _ = _record(monkeypatch, run_train,
                     ["device=cpu"] + args + [f"train.exp_dir={tmp_path}/port"])
    assert len(rec.batches) == len(jrec.batches) == 4
    for mine, theirs in zip(rec.batches, jrec.batches):
        assert mine.shape == (8, 48, 48, 3)
        np.testing.assert_allclose(mine, theirs, rtol=0, atol=2 ** -7)
    log = (tmp_path / "port" / "log.txt").read_text()
    assert "device-cached dataset: (16, 48, 48, 3)" in log


def test_device_cache_batches_without_augment_are_the_rows_of_the_set():
    data = torch.arange(6 * 2 * 2 * 1, dtype=torch.float32).view(6, 2, 2, 1)
    got = list(run_train.cached_batches(data, 2, 5, 1, augment=False))
    perm = np.random.default_rng(5 * 100003 + 1).permutation(6)
    assert len(got) == 3
    for i, x in enumerate(got):
        torch.testing.assert_close(x, data[torch.as_tensor(perm[2 * i:2 * i + 2])])


# -------------------------------------------------------- matmul_precision

@pytest.fixture
def restore_precision():
    yield
    apply_matmul_precision(None)


@pytest.mark.parametrize("name,want", sorted(
    ((k, v) for k, v in MATMUL_PRECISION.items() if k), key=str) + [(None, "highest")])
def test_matmul_precision_maps_onto_torch(restore_precision, name, want):
    assert apply_matmul_precision(name) == want
    assert torch.get_float32_matmul_precision() == want
    assert torch.backends.cudnn.allow_tf32 == (want != "highest")


def test_entry_points_take_matmul_precision(tmp_path, restore_precision):
    exp = tmp_path / "exp"
    assert run_train.main(TINY + [f"train.exp_dir={exp}", "train.epochs=1",
                                  "model.matmul_precision=tensorfloat32"]) == 0
    assert '"matmul_precision": "high"' in (exp / "log.txt").read_text()
    assert run_eval.main(["device=cpu", "model.image_size=48", "model.depth=2",
                          "model.hidden_size=64", "model.num_heads=4",
                          "model.compute_dtype=float32", "data.synthetic_cues=waves",
                          "eval.limit=8", "eval.batch_size=8", "diffusion.sampler_mode=fast",
                          f"eval.logs_dir={tmp_path}/eval", "model.matmul_precision=high"]) == 0
    assert torch.get_float32_matmul_precision() == "high"
    for main in (run_train.main, run_eval.main):
        with pytest.raises(NotImplementedError, match="model.matmul_precision='fp8'"):
            main(TINY + ["model.matmul_precision=fp8"])
    with pytest.raises(ValueError, match="fp8"):
        apply_matmul_precision("fp8")
