"""The port's expert-choice MoE against the JAX package's, on the CPU.

Tolerances (fp32 throughout):
- ``ExpertChoiceMoE`` against JAX's ``apply`` on the same numpy weights:
  1e-5 of the output's scale (summation order of the expert products);
- one expert at capacity 1.0 against the port's dense ``Mlp`` on the same
  weights: 1e-6 of scale (the layer computes the dense MLP times a gate of
  exactly 1.0, with other summation order);
- a 2-block JPDVT-MoE (hidden 64, 4 experts, 48 px): the forward to 1e-5 of
  scale; one train step's loss to 1e-5 relative and every parameter's
  gradient to 2e-4 of its largest magnitude plus 1e-9 (as the dense
  train-step parity test, ``test_torch_port_train.py``).
The inputs are random normals: their router probabilities hold no ties,
which ``torch.topk`` and ``jax.lax.top_k`` may order differently (the
tests check that none is at the capacity's boundary).
"""

import io
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpdvt_mt_ntnu_tpu.core.diffusion import create_diffusion as jax_create_diffusion
from jpdvt_mt_ntnu_tpu.eval import run_eval as jax_run_eval
from jpdvt_mt_ntnu_tpu.models import create_model as jax_create_model
from jpdvt_mt_ntnu_tpu.models.moe import ExpertChoiceMoE as JaxMoE
from jpdvt_mt_ntnu_tpu.utils.pos_embed import grid_code
from jpdvt_mt_ntnu_tpu_torch.core.diffusion import create_diffusion
from jpdvt_mt_ntnu_tpu_torch.eval import run_eval
from jpdvt_mt_ntnu_tpu_torch.models import DIT_CONFIGS, create_model
from jpdvt_mt_ntnu_tpu_torch.models.dit import Mlp
from jpdvt_mt_ntnu_tpu_torch.models.moe import ExpertChoiceMoE
from jpdvt_mt_ntnu_tpu_torch.tools.weights import params_to_state_dict
from jpdvt_mt_ntnu_tpu_torch.train import run_train
from torch_tools_common import one_torch_thread  # noqa: F401  (autouse)

SMALL = dict(depth=2, hidden_size=64, num_heads=4, moe_experts=4)


def _numpy_like(tree, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (scale * rng.standard_normal(a.shape)).astype(np.float32), tree)


def _layer_pair(d, h, e, capacity, seed):
    jmoe = JaxMoE(hidden=h, out=d, num_experts=e, capacity_factor=capacity)
    shapes = jmoe.init(jax.random.key(0), jnp.zeros((1, 4, d)))
    params = _numpy_like(shapes, seed, 0.3)
    moe = ExpertChoiceMoE(d, h, d, e, capacity)
    sd, unused = params_to_state_dict({"mlp": params["params"]})
    assert unused == []
    moe.load_state_dict({k[len("mlp."):]: torch.from_numpy(np.ascontiguousarray(v))
                         for k, v in sd.items()}, strict=True)
    return jmoe, params, moe


def _no_boundary_ties(moe, x):
    probs = torch.softmax(moe.router(x.float()), dim=-1).transpose(1, 2)
    top = probs.sort(dim=-1, descending=True).values
    c = moe.capacity(x.shape[1])
    if c < x.shape[1]:
        assert (top[..., c - 1] - top[..., c]).abs().min() > 1e-6


@pytest.mark.parametrize("e,capacity,n", [(4, 2.0, 9), (8, 2.0, 144), (3, 1.25, 17),
                                          (5, 0.1, 12)])
def test_expert_choice_layer_matches_jax(e, capacity, n):
    jmoe, params, moe = _layer_pair(16, 24, e, capacity, seed=e)
    x = np.random.default_rng(1).standard_normal((3, n, 16)).astype(np.float32)
    _no_boundary_ties(moe, torch.from_numpy(x))
    want = np.asarray(jmoe.apply(params, jnp.asarray(x)))
    got = moe(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert moe.capacity(n) == max(1, min(n, int(capacity * n / e)))


def test_each_expert_takes_exactly_c_distinct_tokens():
    moe = ExpertChoiceMoE(32, 64, 32, 8, 2.0)
    moe.initialize_weights(torch.Generator().manual_seed(0))
    x = torch.randn(5, 144, 32, generator=torch.Generator().manual_seed(1))
    gate, idx = moe.route(x)
    c = 2 * 144 // 8
    assert idx.shape == gate.shape == (5, 8, c)
    assert all(len(set(row.tolist())) == c for row in idx.reshape(-1, c))
    # Each expert's gates are its C highest router probabilities.
    probs = torch.softmax(moe.router(x), dim=-1).transpose(1, 2)
    torch.testing.assert_close(gate, probs.sort(dim=-1, descending=True).values[..., :c])
    # E * C slots over N tokens: 2 per token on average, any token 0 to 8.
    per_token = torch.zeros(5, 144).scatter_add_(1, idx.reshape(5, -1),
                                                 torch.ones(5, 8 * c))
    assert (per_token.sum(dim=1) == 8 * c).all() and per_token.max() <= 8


def test_one_expert_at_capacity_one_is_the_dense_mlp():
    d, h = 24, 96
    moe = ExpertChoiceMoE(d, h, d, 1, 1.0)
    moe.initialize_weights(torch.Generator().manual_seed(2))
    with torch.no_grad():
        moe.bi.normal_(0, 0.1)
        moe.bo.normal_(0, 0.1)
    mlp = Mlp(d, h)
    mlp.load_state_dict({"fc1.weight": moe.wi[0].T, "fc1.bias": moe.bi[0],
                         "fc2.weight": moe.wo[0].T, "fc2.bias": moe.bo[0]})
    x = torch.randn(4, 13, d, generator=torch.Generator().manual_seed(3))
    want = mlp(x)
    torch.testing.assert_close(moe(x), want, rtol=0, atol=1e-6 * want.abs().max().item())


def test_init_bound_counts_the_experts_in_both_fans():
    """Flax's xavier_uniform on the (E, d, h) expert kernels: sqrt(6 / (E (d + h))),
    0.013975 at (8, 768, 3072); torch's xavier_uniform_ would count other fans."""
    bound = math.sqrt(6.0 / (8 * (768 + 3072)))
    assert bound == pytest.approx(0.013975, abs=1e-6)
    moe = ExpertChoiceMoE(768, 3072, 768, 8, 2.0)
    moe.initialize_weights(torch.Generator().manual_seed(0))
    for w in (moe.wi, moe.wo):
        assert w.abs().max().item() <= bound
        assert w.abs().max().item() > 0.999 * bound
        assert w.std().item() == pytest.approx(bound / math.sqrt(3), rel=1e-3)
    flax = JaxMoE(hidden=3072, out=768, num_experts=8).init(jax.random.key(0),
                                                           jnp.zeros((1, 2, 768)))["params"]
    for name in ("wi", "wo"):
        assert float(jnp.abs(flax[name]).max()) == pytest.approx(bound, rel=1e-3)
    assert moe.router.weight.std().item() == pytest.approx(0.02, rel=0.05)
    assert not moe.router.bias.any() and not moe.bi.any() and not moe.bo.any()


@pytest.fixture(scope="module")
def moe_pair():
    jmodel, _ = jax_create_model("JPDVT-MoE", 48, attn_impl="interpret", **SMALL)
    shapes = jmodel.init(jax.random.key(0), jnp.zeros((1, 48, 48, 3)),
                         jnp.zeros((1,), jnp.int32), jnp.zeros((1, 9, 8)))
    params = _numpy_like(shapes, 0)
    model, cfg = create_model("JPDVT-MoE", 48, device="cpu", **SMALL)
    assert (cfg.moe_experts, cfg.moe_capacity) == (4, 2.0)
    sd, unused = params_to_state_dict(params)
    assert unused == []
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in sd.items()}, strict=True)
    return jmodel, params, model


def test_jpdvt_moe_registry_and_forward_match_jax(moe_pair):
    assert DIT_CONFIGS["JPDVT-MoE"] == dict(depth=12, hidden_size=768, patch_size=16,
                                            num_heads=12, moe_experts=8)
    jmodel, params, model = moe_pair
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 48, 48, 3)).astype(np.float32)
    t = np.array([3, 400, 999])
    code = rng.standard_normal((3, 9, 8)).astype(np.float32)
    jimg, jcode = jmodel.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(code))
    img, c = model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(code))
    for got, want in ((img, jimg), (c, jcode)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_jpdvt_moe_train_step_loss_and_gradients_match_jax(moe_pair):
    jmodel, params, model = moe_pair
    b = 4
    rng = np.random.default_rng(5)
    inject = {"indices": np.stack([rng.permutation(9) for _ in range(b)]),
              "noise_x": rng.standard_normal((b, 48, 48, 3)).astype(np.float32),
              "noise_c": rng.standard_normal((b, 9, 8)).astype(np.float32)}
    x = rng.uniform(-1, 1, (b, 48, 48, 3)).astype(np.float32)
    t = np.array([0, 17, 500, 999])
    code = grid_code(8, 3)
    jdiff = jax_create_diffusion("")

    def jloss(p):
        out = jdiff.training_losses(
            lambda xx, tt, cc: jmodel.apply(p, xx, tt, cc), jnp.asarray(x), jnp.asarray(t),
            jnp.asarray(code), jax.random.key(0), block_size=16, patch_size=16,
            grid_size=3, _inject={k: jnp.asarray(v) for k, v in inject.items()})
        return out["loss"].mean()

    jl, jgrads = jax.value_and_grad(jloss)(params)
    model.zero_grad(set_to_none=True)
    out = create_diffusion("", device="cpu").training_losses(
        model, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(code),
        block_size=16, patch_size=16, grid_size=3, _inject=inject)
    out["loss"].mean().backward()
    np.testing.assert_allclose(out["loss"].mean().item(), float(jl), rtol=1e-5)
    want, unused = params_to_state_dict(jax.tree.map(np.asarray, jgrads))
    assert unused == []
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert sorted(grads) == sorted(want)
    assert np.abs(grads["blocks.1.mlp.wi"]).max() > 0
    for k, w in want.items():
        np.testing.assert_allclose(grads[k], w, rtol=0, atol=2e-4 * np.abs(w).max() + 1e-9,
                                   err_msg=k)


MOE_ARGS = ["model.name=JPDVT-MoE", "model.image_size=48", "model.depth=2",
            "model.hidden_size=64", "model.num_heads=4", "model.moe_experts=4",
            "model.compute_dtype=float32"]


def test_run_train_with_moe_experts(tmp_path):
    import json

    assert run_train.main(["device=cpu", *MOE_ARGS, "data.synthetic_cues=waves",
                           "data.global_batch_size=4", "data.synthetic_n=8",
                           "data.num_workers=2", "train.epochs=1", "train.log_every=1",
                           "train.ckpt_every=1000000", "diffusion.sampling_steps=2",
                           "diffusion.sampler_mode=fast", f"train.exp_dir={tmp_path}"]) == 0
    rows = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train_loss"] for r in rows if "train_loss" in r]
    assert len(losses) == 2 and np.isfinite(losses).all()
    sd = torch.load(tmp_path / "checkpoints" / "2" / "state.pt", weights_only=True)
    assert sd["model"]["blocks.0.mlp.wi"].shape == (4, 64, 256)


def test_run_eval_with_moe_equals_jax_journal(moe_pair, tmp_path, monkeypatch):
    """Both packages' ``run_eval`` on one flattened-params npz of the MoE,
    16 waves puzzles; the port takes the JAX harness's draws and template."""
    from test_torch_port_eval import _journal, jax_eval_draws, jax_noise

    _, params, _ = moe_pair
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}/{k}")
            else:
                flat[f"{prefix}/{k}"] = np.asarray(v)

    walk(params["params"], "params")
    npz = tmp_path / "moe.npz"
    buf = io.BytesIO()
    np.savez(buf, **flat)
    npz.write_bytes(buf.getvalue())
    np.savez(tmp_path / "draws.npz", **jax_eval_draws(11, 16, 8, 9))
    np.save(tmp_path / "noise.npy", jax_noise(11, 9))
    monkeypatch.chdir(tmp_path)
    args = MOE_ARGS + ["data.synthetic_cues=waves", f"eval.checkpoint={npz}", "eval.seed=11",
                       "eval.batch_size=8", "eval.limit=16", "diffusion.sampler_mode=fast"]
    assert jax_run_eval.main(args + ["model.attn_impl=interpret",
                                     f"eval.logs_dir={tmp_path}/jax"]) == 0
    with pytest.warns(UserWarning, match="step 0"):
        assert run_eval.main(args + ["device=cpu", f"eval.jax_draws={tmp_path}/draws.npz",
                                     f"eval.jax_noise={tmp_path}/noise.npy",
                                     f"eval.logs_dir={tmp_path}/port"]) == 0
    mine = _journal(tmp_path / "port")
    assert len(mine) == 16 and mine == _journal(tmp_path / "jax")


def test_int8_moe_model_quantizes_attention_and_keeps_dense_experts():
    model, _ = create_model("JPDVT-MoE", 48, device="cpu", quant="int8",
                            **{**SMALL, "depth": 1})
    blk = model.blocks[0]
    assert blk.attn.qkv.quant == "int8" and blk.attn.proj.quant == "int8"
    assert isinstance(blk.mlp, ExpertChoiceMoE) and blk.mlp.router.quant is None
    x = torch.randn(2, 48, 48, 3)
    img, code = model(x, torch.tensor([1, 2]), torch.randn(2, 9, 8))
    assert torch.isfinite(img).all() and torch.isfinite(code).all()
