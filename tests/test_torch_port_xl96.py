"""DiT-XL/8 at 96 px (144 tokens, heads of 72) on the ``block`` and
``pallas`` routes of the PyTorch port, against the JAX package on the CPU.

The geometry where the JAX package runs its own Pallas K3 at DiT-XL's head
dim: ``DiT-XL/8`` at 96 px is a 12 x 12 token grid, cut here to 2 blocks
of hidden 144 (2 heads of 72). Weights are numpy draws for every JAX
parameter, carried into the port by its converter (``tools/weights.py``).

- The ``block`` route: the port's DiT calls ``fused_attention_block`` (on
  the CPU, K3's plain version) in each block; JAX runs its
  ``"block_interpret"`` route (the Pallas kernel ``_attn_block_kernel`` in
  interpret mode). fp32: 2e-5 of each output's largest magnitude
  (summation order only, through two blocks); bf16: 2^-5 of it (the
  packages round bf16 activations at other points, a Linear's bias add
  among them, as the DiT-XL test of ``test_torch_port_dit.py`` states).
- The ``pallas`` route with grad: every parameter's gradient of one fixed
  linear function of both outputs, the port's through K1 and K2's plain
  versions (its ``torch.autograd.Function``, the train step's path) and
  JAX's ``jax.grad`` through its ``"interpret"`` route (K1 forward, K2
  backward, both Pallas kernels in interpret mode), in fp32: 1e-4 of each
  gradient's largest magnitude (summation order through two blocks of
  forward and backward).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpdvt_mt_ntnu_tpu.models import create_model as jax_create_model
from jpdvt_mt_ntnu_tpu_torch.models import create_model
from jpdvt_mt_ntnu_tpu_torch.models import dit as port_dit
from jpdvt_mt_ntnu_tpu_torch.ops import attention as port_attention
from jpdvt_mt_ntnu_tpu_torch.tools.weights import params_to_state_dict

XL = dict(depth=2, hidden_size=144, num_heads=2)  # DiT-XL's heads of 72, two of them
SIZE, TOKENS = 96, 144  # DiT-XL/8 at 96 px: a 12 x 12 token grid
FWD_TOL = {"float32": 2e-5, "bfloat16": 2 ** -5}
GRAD_TOL = 1e-4


@pytest.fixture(scope="module")
def params():
    jmodel, _ = jax_create_model("DiT-XL/8", SIZE, **XL)
    shapes = jmodel.init(jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)),
                         jnp.zeros((1,), jnp.int32), jnp.zeros((1, TOKENS, 8)))
    rng = np.random.default_rng(0)
    return jax.tree.map(lambda a: (0.05 * rng.standard_normal(a.shape)).astype(np.float32),
                        shapes)


def _port(params, attn_impl: str, dtype: torch.dtype = torch.float32):
    model, cfg = create_model("DiT-XL/8", SIZE, device="cpu", attn_impl=attn_impl,
                              dtype=dtype, **XL)
    assert cfg.num_tokens == TOKENS and cfg.hidden_size // cfg.num_heads == 72
    sd, unused = params_to_state_dict(params)
    assert unused == []
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in sd.items()}, strict=True)
    return model, cfg


def _inputs(seed: int, b: int = 2):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (b, SIZE, SIZE, 3)).astype(np.float32),
            np.array([3, 870][:b]),
            rng.standard_normal((b, TOKENS, 8)).astype(np.float32))


def _counting(monkeypatch, name: str) -> list:
    calls, fn = [], getattr(port_dit, name)
    monkeypatch.setattr(port_dit, name, lambda *a: calls.append(1) or fn(*a))
    return calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dit_xl8_at_96px_block_route_matches_jax_block_interpret(params, dtype, monkeypatch):
    assert port_attention.attention_route(TOKENS, getattr(torch, dtype), False, "block",
                                          head_dim=72) == "block"  # on the card too
    jmodel, _ = jax_create_model("DiT-XL/8", SIZE, attn_impl="block_interpret",
                                 dtype=getattr(jnp, dtype), **XL)
    model, cfg = _port(params, "block", getattr(torch, dtype))
    x, t, code = _inputs(1)
    j_img, j_code = jmodel.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(code))
    calls = _counting(monkeypatch, "fused_attention_block")
    with torch.no_grad():
        img, code_out = model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(code))
    assert len(calls) == cfg.depth
    for mine, theirs in ((code_out, j_code), (img, j_img)):
        mine = mine.float().numpy()
        theirs = np.asarray(jnp.asarray(theirs, jnp.float32))
        scale = np.abs(theirs).max()
        assert scale > 0.1  # not a trivial output
        np.testing.assert_allclose(mine, theirs, rtol=0, atol=FWD_TOL[dtype] * scale)


def test_dit_xl8_at_96px_pallas_route_gradients_match_jax_interpret(params, monkeypatch):
    assert port_attention.attention_route(TOKENS, torch.bfloat16, True, "pallas",
                                          head_dim=72) == "whole_row"  # K1 + K2 on the card
    jmodel, _ = jax_create_model("DiT-XL/8", SIZE, attn_impl="interpret", **XL)
    model, cfg = _port(params, "pallas")
    x, t, code = _inputs(2)
    rng = np.random.default_rng(3)
    g_img = rng.standard_normal(x.shape).astype(np.float32)
    g_code = rng.standard_normal(code.shape).astype(np.float32)

    def jax_loss(p):
        img, c = jmodel.apply(p, jnp.asarray(x), jnp.asarray(t), jnp.asarray(code))
        return jnp.sum(img * g_img) + jnp.sum(c * g_code)

    want, _ = params_to_state_dict(jax.tree.map(np.asarray, jax.grad(jax_loss)(params)))
    calls = _counting(monkeypatch, "fused_qkv_attention")
    bwd = port_attention.attention_bwd
    bwd_calls = []
    monkeypatch.setattr(port_attention, "attention_bwd",
                        lambda *a, **k: bwd_calls.append(1) or bwd(*a, **k))
    img, c = model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(code))
    (torch.sum(img * torch.from_numpy(g_img)) + torch.sum(c * torch.from_numpy(g_code))).backward()
    assert len(calls) == len(bwd_calls) == cfg.depth  # K1 forward, K2 backward, each block
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(want)
    for name, ref in want.items():
        scale = np.abs(ref).max()
        assert scale > 0, name
        err = np.abs(got[name].grad.numpy() - ref).max()
        assert err <= GRAD_TOL * scale, (name, err, scale)
