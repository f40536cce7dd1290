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
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpdvt_mt_ntnu_tpu.models import create_model as jax_create_model
from jpdvt_mt_ntnu_tpu.models.dit import embed_condition as jax_embed_condition
from jpdvt_mt_ntnu_tpu.tools.torch_convert import torch_state_dict_to_params
from jpdvt_mt_ntnu_tpu_torch.models import DiT, DiTConfig, create_model
from jpdvt_mt_ntnu_tpu_torch.models.dit import patchify
from jpdvt_mt_ntnu_tpu_torch.tools.weights import params_to_state_dict

ATOL = RTOL = 2e-5
SIZE = dict(depth=2, hidden_size=128, num_heads=2)


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
