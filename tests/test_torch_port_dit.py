"""The PyTorch port's DiT against the JAX package's, on the same weights.

Weights are drawn with numpy for every JAX parameter (so the adaLN-Zero
gates are not zero and every block matters) and carried into the port by
its converter (``tools/weights.py``). JAX runs in fp32 with
``attn_impl="interpret"``, i.e. through the Pallas attention kernel K1 in
interpret mode. Tolerance: fp32 through two blocks, summation order only,
2e-5 absolute plus 2e-5 relative on outputs of magnitude ~1.

A second check holds the port to the committed torch golden of the
reference's own DiT semantics (``tests/golden/torch_dit_goldens.npz``),
through the JAX package's torch-checkpoint converter: a consistent layout
error (e.g. timm's fused-qkv order) would cancel in a self-round trip but
not there.

DiT-XL's head dim, 72: ``DiT-XL/8`` at 32 px (16 tokens), depth 2, hidden
144, 2 heads, the same draws, against the JAX DiT with its Pallas
attention in interpret mode: fp32 as above; bf16 within 2^-5 of each
output's largest magnitude (the packages round bf16 activations at other
points, a Linear's bias add among them, so outputs move by a few bf16 ulps
through two blocks: 2^-7.4 of scale here, and the same at Dh 64). One
``run_train`` step of the same model on the CPU (bf16, batch 8, the JAX
train step's own draws replayed into the port) against the JAX CLI's:
the loss within 1e-3 relative (bf16 forward and backward through two
blocks; the two differ by 8e-5 here).
"""

import hashlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpdvt_mt_ntnu_tpu.models import create_model as jax_create_model
from jpdvt_mt_ntnu_tpu.models.dit import embed_condition as jax_embed_condition
from jpdvt_mt_ntnu_tpu.ops import jigsaw as jax_jigsaw
from jpdvt_mt_ntnu_tpu.tools.torch_convert import torch_state_dict_to_params
from jpdvt_mt_ntnu_tpu.train import run_train as jax_run_train
from jpdvt_mt_ntnu_tpu_torch.core import diffusion as port_diffusion
from jpdvt_mt_ntnu_tpu_torch.models import DiT, DiTConfig, create_model
from jpdvt_mt_ntnu_tpu_torch.models import dit as port_dit
from jpdvt_mt_ntnu_tpu_torch.models.dit import DIT_CONFIGS, patchify
from jpdvt_mt_ntnu_tpu_torch.ops import attention as port_attention
from jpdvt_mt_ntnu_tpu_torch.tools.weights import _flatten, params_to_state_dict
from jpdvt_mt_ntnu_tpu_torch.train import run_train, steps

ATOL = RTOL = 2e-5
SIZE = dict(depth=2, hidden_size=128, num_heads=2)
XL = dict(depth=2, hidden_size=144, num_heads=2)  # DiT-XL's heads of 72, two of them
XL_TOKENS, XL_GRID = 16, 2  # DiT-XL/8 at 32 px: a 4 x 4 token grid, 2 x 2 pieces
BF16_REL = 2 ** -5


@pytest.fixture(scope="module")
def pair():
    jmodel, jcfg = jax_create_model("JPDVT", 64, attn_impl="interpret", **SIZE)
    shapes = jmodel.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)),
                         jnp.zeros((1,), jnp.int32), jnp.zeros((1, 16, 8)))
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: (0.05 * rng.standard_normal(a.shape)).astype(np.float32), shapes)
    model, cfg = create_model("JPDVT", 64, device="cpu", **SIZE)
    sd, unused = params_to_state_dict(params)
    assert unused == []
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in sd.items()}, strict=True)
    rng = np.random.default_rng(1)
    inputs = (rng.uniform(-1, 1, (3, 64, 64, 3)).astype(np.float32),
              np.array([0, 17, 999]),
              rng.standard_normal((3, 16, 8)).astype(np.float32))
    return jmodel, jcfg, params, model, cfg, inputs


def test_patchify_order_matches_jax_embed(pair):
    jmodel, jcfg, params, model, cfg, (x, _, _) = pair
    np.testing.assert_allclose(
        model.embed_condition(torch.from_numpy(x)).detach().numpy(),
        np.asarray(jax_embed_condition(params, jnp.asarray(x), jcfg)),
        atol=ATOL, rtol=RTOL)
    assert patchify(torch.from_numpy(x), cfg).shape == (3, 16, 16 * 16 * 3)


@pytest.mark.parametrize("x_is_tokens", [False, True], ids=["image", "tokens"])
def test_dit_forward_matches_jax(pair, x_is_tokens):
    jmodel, jcfg, params, model, cfg, (x, t, code) = pair
    jx = (jax_embed_condition(params, jnp.asarray(x), jcfg) if x_is_tokens
          else jnp.asarray(x))
    j_img, j_code = jmodel.apply(params, jx, jnp.asarray(t), jnp.asarray(code),
                                 x_is_tokens=x_is_tokens)
    px = (model.embed_condition(torch.from_numpy(x)) if x_is_tokens
          else torch.from_numpy(x))
    with torch.no_grad():
        img, code_out = model(px, torch.from_numpy(t), torch.from_numpy(code),
                              x_is_tokens=x_is_tokens)
    assert img.shape == (3, 64, 64, 3) and code_out.shape == (3, 16, 8)
    assert float(np.abs(np.asarray(j_code)).max()) > 0.1  # not a trivial output
    np.testing.assert_allclose(code_out.numpy(), np.asarray(j_code), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(img.numpy(), np.asarray(j_img), atol=ATOL, rtol=RTOL)


def test_dit_matches_reference_torch_golden():
    z = np.load("tests/golden/torch_dit_goldens.npz")
    sd = {k[3:]: z[k] for k in z.files if k.startswith("sd.")}
    c = {k[4:]: z[k].item() for k in z.files if k.startswith("cfg.")}
    cfg = DiTConfig(input_size=int(c["input_size"]), patch_size=int(c["patch_size"]),
                    in_channels=int(c["in_channels"]), hidden_size=int(c["hidden_size"]),
                    depth=int(c["depth"]), num_heads=int(c["num_heads"]),
                    mlp_ratio=float(c["mlp_ratio"]), code_dim=int(c["code_dim"]),
                    code_head_hidden=int(c["code_head_hidden"]))
    params, unused = torch_state_dict_to_params(sd, cfg.depth)
    assert unused == []
    port_sd, unused = params_to_state_dict(params)
    assert unused == []
    model = DiT(cfg)
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in port_sd.items()}, strict=True)
    x = torch.from_numpy(np.transpose(z["in_x_nchw"], (0, 2, 3, 1)).copy())
    with torch.no_grad():
        img, code = model(x, torch.from_numpy(z["in_t"]), torch.from_numpy(z["in_code"]))
    np.testing.assert_allclose(code.numpy(), z["out_code"], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(img.permute(0, 3, 1, 2).numpy(), z["out_img_nchw"],
                               atol=1e-4, rtol=1e-4)


def test_dit_builds_every_tensor_on_the_requested_device():
    with torch.device("meta"):
        model = DiT(DiTConfig(input_size=64, **SIZE))
    tensors = list(model.parameters()) + list(model.buffers())
    assert {t.device.type for t in tensors} == {"meta"}


def _numpy_params(shapes, seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (0.05 * rng.standard_normal(a.shape)).astype(np.float32), shapes)


def _xl_params():
    jmodel, _ = jax_create_model("DiT-XL/8", 32, **XL)
    shapes = jmodel.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                         jnp.zeros((1,), jnp.int32), jnp.zeros((1, XL_TOKENS, 8)))
    return _numpy_params(shapes)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dit_xl_forward_matches_jax(dtype):
    """The head dim 72 (hidden 144 over 2 heads) through the attention on
    both sides: the port's plain K1 (16 tokens: the whole-row route) and
    the JAX Pallas kernel in interpret mode."""
    jmodel, jcfg = jax_create_model("DiT-XL/8", 32, attn_impl="interpret",
                                    dtype=getattr(jnp, dtype), **XL)
    params = _xl_params()
    model, cfg = create_model("DiT-XL/8", 32, device="cpu", dtype=getattr(torch, dtype), **XL)
    assert cfg.num_tokens == XL_TOKENS and cfg.hidden_size // cfg.num_heads == 72
    assert port_attention.attention_route(XL_TOKENS, cfg.dtype, False, head_dim=72) == \
        "whole_row"
    sd, unused = params_to_state_dict(params)
    assert unused == []
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in sd.items()}, strict=True)
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    t = np.array([0, 17, 999])
    code = rng.standard_normal((3, XL_TOKENS, 8)).astype(np.float32)
    j_img, j_code = jmodel.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(code))
    with torch.no_grad():
        img, code_out = model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(code))
    assert img.shape == (3, 32, 32, 3) and code_out.shape == (3, XL_TOKENS, 8)
    for mine, theirs in ((code_out, j_code), (img, j_img)):
        mine = mine.float().numpy()
        theirs = np.asarray(jnp.asarray(theirs, jnp.float32))
        scale = np.abs(theirs).max()
        assert scale > 0.1  # not a trivial output
        if dtype == "float32":
            np.testing.assert_allclose(mine, theirs, atol=ATOL, rtol=RTOL)
        else:
            np.testing.assert_allclose(mine, theirs, atol=BF16_REL * scale, rtol=0)


def test_dit_xl8_at_192px_has_the_jax_parameter_count():
    """The full DiT-XL/8 at 192 px (28 blocks, 1,152 wide, 576 tokens),
    counted without allocating a weight: ``jax.eval_shape`` of the JAX
    init, the port's module on the meta device."""
    jmodel, _ = jax_create_model("DiT-XL/8", 192)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, 192, 192, 3)),
                            jnp.zeros((1,), jnp.int32), jnp.zeros((1, 576, 8)))
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    with torch.device("meta"):
        model = DiT(DiTConfig(input_size=192, **DIT_CONFIGS["DiT-XL/8"]))
    assert sum(p.numel() for p in model.parameters()) == want
    assert 660e6 < want < 680e6


def _manifest(tmp_path, params) -> str:
    """A warm-start manifest of ``params`` (one npz part)."""
    buf = io.BytesIO()
    np.savez(buf, **_flatten(params))
    blob = buf.getvalue()
    (tmp_path / "xl.npz").write_bytes(blob)
    sha = hashlib.sha256(blob).hexdigest()
    path = tmp_path / "xl.manifest.json"
    path.write_text(json.dumps({"format": 1, "step": 0, "npz_sha256": sha, "parts": [
        {"file": "xl.npz", "bytes": len(blob), "sha256": sha}]}))
    return str(path)


def _jax_step_draws(b: int):
    """The JAX train step's draws at step 0 (``train/steps.py``: ``fold_in(key(0),
    0)``, split into the timesteps' key and the loss's four)."""
    k_t, k_loss = jax.random.split(jax.random.fold_in(jax.random.key(0), 0))
    t = jax.random.randint(k_t, (b,), 0, 1000)
    k_perm, _, k_nx, k_nc = jax.random.split(k_loss, 4)
    return np.asarray(t), {
        "indices": np.asarray(jax_jigsaw.random_permutations(k_perm, b, XL_GRID ** 2,
                                                             shared=True)),
        "noise_x": np.asarray(jax.random.normal(k_nx, (b, 32, 32, 3), jnp.float32)),
        "noise_c": np.asarray(jax.random.normal(k_nc, (b, XL_TOKENS, 8), jnp.float32))}


def test_run_train_step_of_dit_xl_matches_the_jax_cli(tmp_path, monkeypatch):
    """One bf16 step of the small DiT-XL/8 through both ``run_train`` CLIs
    from the same weights (batch 8: the JAX run shards it over the 8
    virtual CPU devices); the port takes the flash route (grad at Dh 72)."""
    ws = _manifest(tmp_path, _xl_params())
    args = ["model.name=DiT-XL/8", "model.image_size=32", "model.depth=2",
            "model.hidden_size=144", "model.num_heads=2", "model.compute_dtype=bfloat16",
            f"task.grid_size={XL_GRID}", "data.synthetic_cues=waves",
            "data.global_batch_size=8", "data.synthetic_n=8", "data.num_workers=0",
            "train.epochs=1", "train.log_every=1", "train.ckpt_every=1000000",
            "diffusion.sampling_steps=2", "diffusion.sampler_mode=fast",
            f"train.warm_start={ws}"]
    assert jax_run_train.main(args + [f"train.exp_dir={tmp_path}/jax"]) == 0
    t, inject = _jax_step_draws(8)
    monkeypatch.setattr(steps, "draw_timesteps",
                        lambda b, n, t_bias, gen: torch.from_numpy(t).long())
    original = port_diffusion.Diffusion.training_losses
    monkeypatch.setattr(port_diffusion.Diffusion, "training_losses",
                        lambda self, *a, **kw: original(self, *a, **kw, _inject=inject))
    routes = []
    route = port_attention.attention_route
    monkeypatch.setattr(port_dit, "attention_route",
                        lambda *a, **kw: routes.append(route(*a, **kw)) or routes[-1])
    assert run_train.main(["device=cpu", *args, f"train.exp_dir={tmp_path}/port"]) == 0
    assert "flash" in routes

    def losses(exp):
        rows = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
        return [r["train_loss"] for r in rows if "train_loss" in r]

    theirs, mine = losses(tmp_path / "jax"), losses(tmp_path / "port")
    assert len(mine) == len(theirs) == 1
    np.testing.assert_allclose(mine, theirs, rtol=1e-3)
