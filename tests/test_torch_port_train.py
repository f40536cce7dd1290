"""The PyTorch port's training path against the JAX package's, on the CPU.

Small sizes: JPDVT at 48 px (9 tokens), depth 2, hidden 128, 2 heads x 64,
with numpy-drawn weights. Inputs and random draws come from numpy and go
through both packages (``training_losses``'s ``_inject`` hook); JAX runs
its attention through the Pallas kernels K1/K2 in interpret mode
(``attn_impl="interpret"``), the port through its plain versions inside
the same ``autograd.Function`` the card uses.

Tolerances:
- loss: 1e-5 relative (fp32, summation order);
- the posterior mean and variance of each diffusion variant: 1e-6
  relative (the same float32 tables and formulas);
- parameter gradients: 2e-4 of each gradient's largest magnitude, plus
  1e-9 (fp32 through two blocks and a backward; the largest difference
  seen is ~1e-5 of scale);
- bf16 on ``model.attn_impl=xla`` against the JAX package's ``xla``: the
  loss 2e-3 relative, gradients 2^-5 of scale (bf16 activations through
  two blocks and a backward, some rounded at other points, a Linear's
  bias add among them; 4.8e-4 and 2^-6.4 here, JAX's side compiled whole);
- AdamW + EMA over 3 steps: 1e-6 absolute (optax's formula in float32 on
  both sides; values of order 1);
- the biased timestep draw: exact;
- device-generated waves: 2^-8 against numpy's float32 fields (one bf16
  rounding of values in [-1, 1]), 2^-7 against JAX's bf16 batch (one
  bf16 ulp when the two float32 fields round to neighbours);
- resume: bit for bit.
"""

import json
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jpdvt_mt_ntnu_tpu.core.diffusion import create_diffusion as jax_create_diffusion
from jpdvt_mt_ntnu_tpu.data.datasets import SyntheticPuzzles as JaxSyntheticPuzzles
from jpdvt_mt_ntnu_tpu.models import create_model as jax_create_model
from jpdvt_mt_ntnu_tpu.train.state import TrainState as JaxTrainState
from jpdvt_mt_ntnu_tpu.train.state import fused_adamw_ema as jax_fused_adamw_ema
from jpdvt_mt_ntnu_tpu.utils.pos_embed import grid_code
from jpdvt_mt_ntnu_tpu_torch.core.diffusion import create_diffusion
from jpdvt_mt_ntnu_tpu_torch.data import SyntheticPuzzles
from jpdvt_mt_ntnu_tpu_torch.models import create_model
from jpdvt_mt_ntnu_tpu_torch.ops import jigsaw
from jpdvt_mt_ntnu_tpu_torch.train import (CheckpointManager, TrainTask,
                                           create_train_state, fused_adamw_ema,
                                           make_optimizer, make_train_step)
from jpdvt_mt_ntnu_tpu_torch.train import run_train, steps
from jpdvt_mt_ntnu_tpu_torch.tools.weights import load_jax_train_state, params_to_state_dict
from torch_tools_common import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = dict(depth=2, hidden_size=128, num_heads=2)
FIXTURE = os.path.join(REPO, "tests", "fixtures", "tiny_jpdvt_48px.npz")
B = 4
BF16_LOSS_RTOL, BF16_GRAD_REL = 2e-3, 2 ** -5


def _numpy_params(shapes, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (0.05 * rng.standard_normal(a.shape)).astype(np.float32), shapes)


def _pair(attn_impl, dtype):
    jmodel, _ = jax_create_model("JPDVT", 48, attn_impl=attn_impl,
                                 dtype=getattr(jnp, dtype), **SIZE)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, 48, 48, 3)),
                            jnp.zeros((1,), jnp.int32), jnp.zeros((1, 9, 8)))
    params = _numpy_params(shapes, 0)
    model, _ = create_model("JPDVT", 48, device="cpu", dtype=getattr(torch, dtype),
                            attn_impl=None if attn_impl == "interpret" else attn_impl, **SIZE)
    sd, unused = params_to_state_dict(params)
    assert unused == []
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in sd.items()}, strict=True)
    return jmodel, params, model


@pytest.fixture(scope="module")
def pair():
    return _pair("interpret", "float32")


@pytest.fixture(scope="module")
def pair_xla_bf16():
    return _pair("xla", "bfloat16")


def _draws(seed, add_mask):
    rng = np.random.default_rng(seed)
    inject = {"indices": np.stack([rng.permutation(9) for _ in range(B)]),
              "noise_x": rng.standard_normal((B, 48, 48, 3)).astype(np.float32),
              "noise_c": rng.standard_normal((B, 9, 8)).astype(np.float32)}
    if add_mask:
        inject["piece_mask"] = (rng.random((B, 9)) > 0.3).astype(np.float32)
    x = rng.uniform(-1, 1, (B, 48, 48, 3)).astype(np.float32)
    t = np.array([0, 17, 500, 999])
    return x, t, inject


@pytest.mark.parametrize("add_mask,predict_xstart,xla_bf16", [
    (False, True, False), (True, True, False), (False, False, False), (False, True, True)],
    ids=["no_mask", "mask", "epsilon", "xla_bf16"])
def test_training_losses_and_gradients_match_jax(pair, add_mask, predict_xstart, xla_bf16,
                                                 request):
    """fp32 on the default route against JAX's ``interpret``; and (the
    ``xla_bf16`` case) bf16 on ``model.attn_impl=xla`` on both sides, the
    flagship's training setting: the loss within ``BF16_LOSS_RTOL``, each
    parameter gradient within ``BF16_GRAD_REL`` of its largest magnitude
    (bf16 activations, rounded at other points in places, through two
    blocks and the backward)."""
    jmodel, params, model = request.getfixturevalue("pair_xla_bf16") if xla_bf16 else pair
    x, t, inject = _draws(1, add_mask)
    code = grid_code(8, 3)
    jdiff = jax_create_diffusion("", predict_xstart=predict_xstart)

    def jloss(p):
        out = jdiff.training_losses(
            lambda xx, tt, cc: jmodel.apply(p, xx, tt, cc), jnp.asarray(x),
            jnp.asarray(t), jnp.asarray(code), jax.random.key(0), block_size=16,
            patch_size=16, add_mask=add_mask, grid_size=3, shared_perm=True,
            _inject={k: jnp.asarray(v) for k, v in inject.items()})
        return out["loss"].mean(), out

    value_and_grad = jax.value_and_grad(jloss, has_aux=True)
    # bf16 on xla: compiled whole (op by op it takes most of a minute); fp32
    # as before, op by op
    (jl, jout), jgrads = (jax.jit(value_and_grad) if xla_bf16 else value_and_grad)(params)
    model.zero_grad(set_to_none=True)
    diff = create_diffusion("", predict_xstart=predict_xstart, device="cpu")
    out = diff.training_losses(model, torch.from_numpy(x), torch.from_numpy(t),
                               torch.from_numpy(code), block_size=16, patch_size=16,
                               add_mask=add_mask, grid_size=3, _inject=inject)
    out["loss"].mean().backward()
    rtol = BF16_LOSS_RTOL if xla_bf16 else 1e-5
    np.testing.assert_allclose(out["loss"].mean().item(), float(jl), rtol=rtol)
    for name in ("code_mse", "img_mse"):
        np.testing.assert_allclose(out[name].detach().float().numpy(),
                                   np.asarray(jout[name], np.float32), rtol=rtol, atol=1e-7)
    want, unused = params_to_state_dict(jax.tree.map(np.asarray, jgrads))
    assert unused == []
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert sorted(grads) == sorted(want)
    assert np.abs(grads["blocks.0.attn.qkv.weight"]).max() > 0
    for k, w in want.items():
        scale = np.abs(w).max()
        rel = BF16_GRAD_REL if xla_bf16 else 2e-4
        np.testing.assert_allclose(grads[k], w, rtol=0, atol=rel * scale + 1e-9, err_msg=k)


@pytest.mark.parametrize("predict_xstart", [True, False], ids=["start_x", "epsilon"])
@pytest.mark.parametrize("sigma_small", [True, False], ids=["fixed_small", "fixed_large"])
def test_mean_and_variance_variants_match_jax(predict_xstart, sigma_small):
    """The variants ``create_diffusion(predict_xstart=, sigma_small=)``
    selects, through ``p_mean_variance`` on a fixed model output."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((4, 9, 8)).astype(np.float32)
    out = rng.standard_normal((4, 9, 8)).astype(np.float32)
    t = np.array([0, 1, 100, 249])
    jdiff = jax_create_diffusion("250", predict_xstart=predict_xstart, sigma_small=sigma_small)
    want = jdiff.p_mean_variance(lambda c, tt, xx: (c, jnp.asarray(out)), None,
                                 jnp.asarray(x), jnp.asarray(t), clip_denoised=True)
    diff = create_diffusion("250", predict_xstart=predict_xstart, sigma_small=sigma_small,
                            device="cpu")
    got = diff.p_mean_variance(lambda c, tt, xx: (c, torch.from_numpy(out)), None,
                               torch.from_numpy(x), torch.from_numpy(t), clip_denoised=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.broadcast_to(g.numpy(), np.shape(w)), np.asarray(w),
                                   rtol=1e-6, atol=1e-7)


def test_shared_and_per_sample_permutations():
    gen = torch.Generator().manual_seed(0)
    shared = jigsaw.random_permutations(5, 9, shared=True, generator=gen)
    assert shared.shape == (5, 9) and (shared == shared[0]).all()
    assert sorted(shared[0].tolist()) == list(range(9))
    per = jigsaw.random_permutations(64, 9, generator=gen)
    assert (per.sort(dim=1).values == torch.arange(9)).all()
    assert len({tuple(r) for r in per.tolist()}) > 32


def test_piece_masks_hide_fewer_than_grid_pieces():
    masks = jigsaw.random_piece_masks(256, 3, generator=torch.Generator().manual_seed(1))
    hidden = (masks == 0).sum(dim=1)
    assert set(hidden.tolist()) == {0, 1, 2}


@pytest.mark.parametrize("fn,args", [
    ("piece_code_to_tokens", lambda r: (r.standard_normal((2, 9, 8)).astype(np.float32), 3, 2)),
    ("piece_mask_to_image", lambda r: ((r.random((2, 9)) > 0.5).astype(np.float32), 3, 4, 3)),
    ("inner_crop_pieces", lambda r: (r.standard_normal((2, 18, 18, 3)).astype(np.float32), 3, 4)),
])
def test_jigsaw_training_ops_match_jax(fn, args):
    from jpdvt_mt_ntnu_tpu.ops import jigsaw as jax_jigsaw

    a = args(np.random.default_rng(2))
    mine = getattr(jigsaw, fn)(torch.from_numpy(a[0]), *a[1:]).numpy()
    np.testing.assert_array_equal(mine, np.asarray(getattr(jax_jigsaw, fn)(jnp.asarray(a[0]), *a[1:])))


def _jax_state(seed):
    """A JAX TrainState with numpy params, EMA and non-zero AdamW moments."""
    rng = np.random.default_rng(seed)
    shapes = {"params": {"block_0": {"attn": {"qkv": {"kernel": (4, 6), "bias": (6,)}}},
                         "x_embedder": {"kernel": (3, 4), "bias": (4,)}}}

    def draw(scale=1.0, positive=False):
        return jax.tree.map(
            lambda s: (np.abs if positive else np.asarray)(
                scale * rng.standard_normal(s)).astype(np.float32),
            shapes, is_leaf=lambda s: isinstance(s, tuple))

    params, ema = draw(), draw()
    opt = optax.adamw(3e-3, weight_decay=0.01)
    adam = opt.init(params)[0]._replace(count=jnp.asarray(5, jnp.int32),
                                        mu=draw(0.1), nu=draw(0.01, positive=True))
    state = JaxTrainState(step=jnp.asarray(5000, jnp.int32), params=params,
                          ema_params=ema, opt_state=(adam,) + opt.init(params)[1:])
    grads = [draw(0.3) for _ in range(3)]
    return state, grads


class _Lin(torch.nn.Module):
    def __init__(self, i, o):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.zeros(o, i))
        self.bias = torch.nn.Parameter(torch.zeros(o))


class _Tiny(torch.nn.Module):
    """The module tree whose state_dict names the JAX tree of ``_jax_state``."""

    def __init__(self):
        super().__init__()
        self.blocks = torch.nn.ModuleList([torch.nn.Module()])
        self.blocks[0].attn = torch.nn.Module()
        self.blocks[0].attn.qkv = _Lin(4, 6)
        self.x_embedder = _Lin(3, 4)


@pytest.mark.parametrize("warmup,anchor", [(False, 0), (True, 0), (True, 4990)],
                         ids=["fixed", "warmup", "warmup_anchor"])
def test_fused_adamw_ema_matches_jax_over_three_steps(warmup, anchor):
    jstate, grads = _jax_state(3)
    state = create_train_state(_Tiny())
    a = jstate.opt_state[0]
    load_jax_train_state(state, step=int(jstate.step), params=jstate.params,
                         ema_params=jstate.ema_params, mu=a.mu, nu=a.nu,
                         count=int(a.count))
    task = TrainTask(ema_warmup=warmup, ema_anchor=anchor)
    params, ema = jstate.params, jstate.ema_params
    opt_state = jstate.opt_state
    for i, g in enumerate(grads):
        step = int(jstate.step) + i
        if warmup:
            s = jnp.asarray(step + 1 - anchor).astype(jnp.float32)
            decay = jnp.minimum(task.ema_decay, (1.0 + s) / (10.0 + s))
        else:
            decay = task.ema_decay
        params, ema, opt_state = jax_fused_adamw_ema(
            params, g, ema, opt_state, lr=3e-3, weight_decay=0.01, ema_decay=decay)
        tg, _ = params_to_state_dict(g)
        named = dict(state.model.named_parameters())
        fused_adamw_ema(list(named.values()),
                        [torch.from_numpy(np.ascontiguousarray(tg[k])) for k in named],
                        list(state.ema.parameters()), state.opt, lr=3e-3,
                        weight_decay=0.01, ema_decay=steps.ema_decay_at(task, step))
    assert state.opt.count == int(opt_state[0].count) == 8
    for mine, theirs in ((state.model.state_dict(), params), (state.ema.state_dict(), ema),
                         (state.opt.mu, opt_state[0].mu), (state.opt.nu, opt_state[0].nu)):
        want, _ = params_to_state_dict(jax.tree.map(np.asarray, theirs))
        for k, w in want.items():
            np.testing.assert_allclose(mine[k].detach().numpy(), w, rtol=0, atol=1e-6,
                                       err_msg=k)


def test_t_bias_draw_matches_jax_given_the_same_u():
    u = np.concatenate([np.random.default_rng(4).random(1000),
                        [0.0, 0.5, np.nextafter(np.float32(1), np.float32(0))]]).astype(np.float32)
    for bias in (0.5, 2.0):
        want = jnp.minimum((1000 * jnp.asarray(u) ** (1.0 / (1.0 + bias))).astype(jnp.int32), 999)
        got = steps.timesteps_from_uniform(torch.from_numpy(u), 1000, bias)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.max() == 999


def test_device_batch_matches_numpy_and_jax():
    idx = [0, 1, 2, 5, 11, 40]
    ds = SyntheticPuzzles(48, n=16, seed=0, hard_frac=0.25)
    mine = ds.device_batch(idx, "cpu")
    assert mine.dtype == torch.bfloat16 and mine.shape == (6, 48, 48, 3)
    host = np.stack([SyntheticPuzzles(48, n=64, seed=0, hard_frac=0.25)[i] for i in idx])
    np.testing.assert_allclose(mine.float().numpy(), host, rtol=0, atol=2 ** -8)
    jds = JaxSyntheticPuzzles(48, n=16, seed=0, cues="waves", hard_frac=0.25)
    jax_batch = np.asarray(jds.device_batcher()(idx).astype(jnp.float32))
    np.testing.assert_allclose(mine.float().numpy(), jax_batch, rtol=0, atol=2 ** -7)


# ---------------------------------------------------------------- train step

def _setup(lr=2e-3, accum=1, seed=0, depth=2, hidden=64, heads=4, **task):
    model, cfg = create_model("JPDVT", 48, device="cpu", seed=seed, depth=depth,
                              hidden_size=hidden, num_heads=heads)
    state = create_train_state(model)
    task = TrainTask(grid_size=3, block_size=16, patch_size=16, **task)
    step = make_train_step(create_diffusion("", device="cpu"), make_optimizer(lr=lr),
                           task, torch.as_tensor(grid_code(8, 3)), grad_accum=accum)
    return state, step


def _images(b=8, seed=2):
    return torch.from_numpy(
        0.5 * np.random.default_rng(seed).standard_normal((b, 48, 48, 3)).astype(np.float32))


def test_loss_decreases():
    state, step = _setup()
    x = _images()
    losses = [float(step(state, x)[1]["loss"]) for _ in range(30)]
    assert state.step == 30
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) * 0.8, losses


def test_grad_accum_is_mean_of_microbatch_grads():
    accum = 2
    state, step = _setup(accum=accum, shared_perm=False)
    before = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    x = _images()
    _, metrics = step(state, x)
    got = {k: p.grad.clone() for k, p in state.model.named_parameters()}
    # Replay the step's draws: t for the batch, then each microbatch's.
    ref, _ = _setup(accum=accum, shared_perm=False)
    ref.model.load_state_dict(before)
    diff = create_diffusion("", device="cpu")
    gen = steps.step_generator(0, 0, "cpu")
    t = steps.draw_timesteps(8, diff.num_timesteps, 0.0, gen)
    micro, losses = [], []
    for i in range(accum):
        ref.model.zero_grad(set_to_none=True)
        out = diff.training_losses(ref.model, x[4 * i:4 * i + 4], t[4 * i:4 * i + 4],
                                   torch.as_tensor(grid_code(8, 3)), block_size=16,
                                   patch_size=16, shared_perm=False, generator=gen)
        out["loss"].mean().backward()
        losses.append(out["loss"].mean().item())
        micro.append({k: p.grad.clone() for k, p in ref.model.named_parameters()})
    np.testing.assert_allclose(float(metrics["loss"]), np.mean(losses), rtol=1e-6)
    for k, g in got.items():
        torch.testing.assert_close(g, (micro[0][k] + micro[1][k]) / accum, rtol=1e-6, atol=1e-9)


def test_grad_accum_must_divide_the_batch():
    state, step = _setup(accum=3)
    with pytest.raises(ValueError, match="grad_accum"):
        step(state, _images())


def _tensors(state):
    return {**{f"model.{k}": v for k, v in state.model.state_dict().items()},
            **{f"ema.{k}": v for k, v in state.ema.state_dict().items()},
            **{f"mu.{k}": v for k, v in state.opt.mu.items()},
            **{f"nu.{k}": v for k, v in state.opt.nu.items()}}


def test_two_plus_two_steps_across_a_checkpoint_equal_four(tmp_path):
    kw = dict(ema_warmup=True, t_bias=2.0, add_mask=True)
    straight, step = _setup(**kw)
    batches = [_images(seed=s) for s in range(4)]
    for x in batches:
        step(straight, x)
    first, step = _setup(**kw)
    for x in batches[:2]:
        step(first, x)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=1)
    assert mgr.save(first) and not mgr.save(first)
    resumed, step = _setup(seed=9, **kw)
    mgr.restore(resumed)
    assert resumed.step == 2 and resumed.opt.count == 2
    for x in batches[2:]:
        step(resumed, x)
    assert resumed.step == straight.step == 4
    a, b = _tensors(resumed), _tensors(straight)
    for k in b:
        assert torch.equal(a[k], b[k]), k
    mgr.save(resumed)
    assert mgr.all_steps() == [4]


def test_ema_warmup_anchor_rearms_the_fast_decay():
    cold, step_c = _setup(ema_warmup=True, ema_anchor=0)
    warm, step_w = _setup(ema_warmup=True, ema_anchor=5000)
    for s in (cold, warm):
        s.step = 5000
        with torch.no_grad():
            for p in s.ema.parameters():
                p.zero_()
    x = _images(4)
    step_c(cold, x)
    step_w(warm, x)

    def gap(s):
        return torch.linalg.vector_norm(torch.stack([
            torch.linalg.vector_norm(e - p) for e, p in
            zip(s.ema.parameters(), s.model.parameters())])).item()

    scale = torch.linalg.vector_norm(torch.stack([
        torch.linalg.vector_norm(p) for p in warm.model.parameters()])).item()
    assert gap(warm) < 0.25 * scale
    assert gap(cold) > 0.9 * scale


# ---------------------------------------------------------------- run_train

TINY = ["device=cpu", "data.synthetic_cues=waves", "data.global_batch_size=8",
        "data.num_workers=2", "data.synthetic_n=32", "model.image_size=48",
        "model.depth=2", "model.hidden_size=64", "model.num_heads=4",
        "model.compute_dtype=float32", "train.log_every=2",
        "train.ckpt_every=1000000", "diffusion.sampling_steps=2",
        "diffusion.sampler_mode=fast"]


def _last_step(exp):
    rows = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
    return max(r["step"] for r in rows)


def test_run_train_budget_resume_and_device_stream(tmp_path, caplog):
    exp = tmp_path / "exp"
    assert run_train.main(TINY + [f"train.exp_dir={exp}", "train.epochs=2",
                                  "data.device_stream=true"]) == 0
    assert _last_step(exp) == 8  # 32 / 8 = 4 steps per epoch
    assert CheckpointManager(str(exp / "checkpoints")).latest_step() == 8
    assert run_train.main(TINY + [f"train.exp_dir={exp}", "train.epochs=3",
                                  f"train.resume={exp}/checkpoints"]) == 0
    assert _last_step(exp) == 12
    assert json.loads((exp / "step_anchor.json").read_text()) == {"start_step": 0,
                                                                  "ema_anchor": 0}
    rows = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
    loops = [r["summary"] for r in rows if "summary" in r]
    # Each run's summary counts the images of its own loop: 8, then 4 steps of 8.
    assert [s["loop_images"] for s in loops] == [64, 32]
    assert all(s["train_images_per_s"] > 0 and s["loop_s"] > 0 for s in loops)


def _manifest(tmp_path, step):
    import hashlib

    blob = open(FIXTURE, "rb").read()
    (tmp_path / "tiny.npz").write_bytes(blob)
    sha = hashlib.sha256(blob).hexdigest()
    path = tmp_path / "tiny.manifest.json"
    path.write_text(json.dumps({"format": 1, "step": step, "npz_sha256": sha, "parts": [
        {"file": "tiny.npz", "bytes": len(blob), "sha256": sha}]}))
    return str(path)


@pytest.mark.parametrize("source", ["npz", "manifest"])
def test_warm_start_resets_ema_and_rearms_warmup(tmp_path, source):
    ws = FIXTURE if source == "npz" else _manifest(tmp_path, 7)
    exp = tmp_path / "exp"
    args = TINY + [f"train.exp_dir={exp}", "train.epochs=1", "train.ema_warmup=true",
                   f"train.warm_start={ws}", "train.lr=0.0"]
    if source == "npz":
        with pytest.warns(UserWarning, match="step 0"):
            assert run_train.main(args) == 0
    else:
        assert run_train.main(args) == 0
    start = 0 if source == "npz" else 7
    assert json.loads((exp / "step_anchor.json").read_text()) == {"start_step": start,
                                                                  "ema_anchor": start}
    assert (f"at step {start} (EMA reset to params, warmup re-armed)"
            in (exp / "log.txt").read_text())
    sd = torch.load(exp / "checkpoints" / str(start + 4) / "state.pt", weights_only=True)
    fixture, _ = params_to_state_dict(dict(np.load(FIXTURE)))
    # lr 0 keeps the params at the fixture's, so an EMA reset to them stays
    # there; without the reset it would sit at the fresh init's weights.
    for k, w in fixture.items():
        np.testing.assert_array_equal(sd["model"][k].numpy(), w)
        np.testing.assert_array_equal(sd["ema"][k].numpy(), w)
    assert sd["opt"]["count"] == 4


def test_run_train_refuses_what_is_not_ported(tmp_path):
    for extra in (["mesh.pipe=2", "mesh.seq=2"],
                  ["mesh.pipe=2", "mesh.pipe_microbatches=2", "mesh.ep=2"],
                  ["model.attn_impl=ring"]):
        with pytest.raises(NotImplementedError):
            run_train.main(TINY + extra)
    # model.attn_impl=xla is ported (tests/test_torch_port_xla.py): it trains.
    exp = tmp_path / "xla"
    assert run_train.main(TINY + ["model.attn_impl=xla", f"train.exp_dir={exp}",
                                  "train.epochs=1"]) == 0
    assert _last_step(exp) == 4
    # mesh.model and mesh.fsdp with the MoE are ported (tests/test_torch_mesh_ep.py),
    # as are mesh.ep and mesh.pipe, and pipe x fsdp and seq x ep
    # (tests/test_torch_pipeline.py, test_torch_sequence.py); one process has no
    # ranks for them.
    for axis in ("model", "fsdp"):
        with pytest.raises(ValueError, match=f"mesh.{axis}=2 .*world size"):
            run_train.main(TINY + ["model.moe_experts=2", f"mesh.{axis}=2"])
    for extra in (["mesh.model=2"], ["mesh.fsdp=2"], ["mesh.ep=2"], ["mesh.pipe=2"],
                  ["mesh.pipe=2", "mesh.fsdp=2"], ["mesh.seq=2", "mesh.ep=2"]):
        with pytest.raises(ValueError, match="world size"):
            run_train.main(TINY + extra)


def test_warm_started_run_resumed_equals_four_straight_steps(tmp_path):
    """Warm start (step 7), 2 steps, resume, 2 steps == 4 straight steps,
    bit for bit: the resume keeps the warm start's EMA warmup anchor."""
    ws = _manifest(tmp_path, 7)
    args = TINY + ["data.synthetic_n=16", "data.device_stream=true",
                   "train.ema_warmup=true", "train.lr=0.01"]
    straight = tmp_path / "straight"
    assert run_train.main(args + [f"train.exp_dir={straight}", "train.epochs=2",
                                  f"train.warm_start={ws}"]) == 0
    split = tmp_path / "split"
    assert run_train.main(args + [f"train.exp_dir={split}", "train.epochs=1",
                                  f"train.warm_start={ws}"]) == 0
    assert run_train.main(args + [f"train.exp_dir={split}", "train.epochs=2",
                                  f"train.resume={split}/checkpoints"]) == 0
    a, b = (torch.load(d / "checkpoints" / "11" / "state.pt", weights_only=True)
            for d in (straight, split))
    assert a["step"] == b["step"] == 11
    for part in ("model", "ema"):
        for k, w in a[part].items():
            assert torch.equal(b[part][k], w), (part, k)
    assert json.loads((split / "step_anchor.json").read_text()) == {"start_step": 7,
                                                                  "ema_anchor": 7}


def test_resume_reads_an_anchor_file_without_the_ema_key_as_zero(tmp_path):
    exp = tmp_path / "exp"
    assert run_train.main(TINY + [f"train.exp_dir={exp}", "train.epochs=1",
                                  "train.ema_warmup=true"]) == 0
    (exp / "step_anchor.json").write_text(json.dumps({"start_step": 0}))
    assert run_train.main(TINY + [f"train.exp_dir={exp}", "train.epochs=2",
                                  "train.ema_warmup=true",
                                  f"train.resume={exp}/checkpoints"]) == 0
    assert _last_step(exp) == 8


def test_sigterm_checkpoints_and_exits_42(tmp_path):
    exp = tmp_path / "exp"
    env = dict(os.environ, PYTHONPATH=REPO)
    out = tmp_path / "out.txt"
    with open(out, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "jpdvt_mt_ntnu_tpu_torch.train.run_train",
             *TINY, f"train.exp_dir={exp}", "train.epochs=100000"],
            env=env, cwd=str(tmp_path), stdout=f, stderr=subprocess.STDOUT,
            stdin=subprocess.DEVNULL)
        metrics = exp / "metrics.jsonl"
        deadline = time.time() + 240
        while time.time() < deadline:
            if metrics.exists() and "train_loss" in metrics.read_text():
                break
            assert proc.poll() is None, out.read_text()
            time.sleep(0.2)
        else:
            proc.kill()
            raise AssertionError("training never reached its first log window")
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == run_train.PREEMPTED_EXIT, out.read_text()
    assert "Preempted: checkpoint saved" in out.read_text()
    step = CheckpointManager(str(exp / "checkpoints")).latest_step()
    assert step and step >= 2
