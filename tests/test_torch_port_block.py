"""Kernel K3 (the whole attention sublayer) of the PyTorch port against the
JAX package's ``fused_attention_block``.

The port's plain version (``fused_attention_block_plain``, the path its
wrapper takes for CPU tensors) is held against the Pallas kernel
``_attn_block_kernel`` run in interpret mode and against the XLA reference
``fused_attention_block_xla``, on the same numpy inputs, at small widths
(H = 4, Dh = 16 and 64). The CUDA kernel itself runs only on a card:
``tests/test_torch_port_cuda.py``.

Tolerances, relative to the output's largest magnitude: fp32 1e-5
(summation order). bf16: 2^-7 against the interpret kernel, which rounds
q, k, v, P, o and the output at the same points (a summation order that
flips one rounding moves the output by about one bf16 ulp of its scale);
2e-2 against the XLA reference, which rounds elsewhere (q is scaled
after its cast, the output projection is one einsum). The gradient (torch
autograd of the plain version) is held to ``jax.vjp`` of the JAX function
in fp32, 1e-5 of each gradient's scale; ``dense_to_block_weights`` to the
JAX layout exactly. Also the tiny trained DiT on the block route against
JAX's ``"block_interpret"`` (fp32, 1e-4 absolute on codes of ~1), the
route table and the training refusal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpdvt_mt_ntnu_tpu.models import create_model as jax_create_model
from jpdvt_mt_ntnu_tpu.ops import attention as jattn
from jpdvt_mt_ntnu_tpu.tools.torch_convert import load_npz_params
from jpdvt_mt_ntnu_tpu_torch.models import create_model
from jpdvt_mt_ntnu_tpu_torch.ops import attention as port
from jpdvt_mt_ntnu_tpu_torch.tools.weights import load_artifact
from jpdvt_mt_ntnu_tpu_torch.train import run_train
from jpdvt_mt_ntnu_tpu_torch.utils.config import Config, apply_overrides

FIXTURE = "tests/fixtures/tiny_jpdvt_48px.npz"
TINY = dict(depth=2, hidden_size=64, num_heads=4)
INTERPRET_TOL = {"float32": 1e-5, "bfloat16": 2 ** -7}
XLA_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _dense(seed: int, b: int, n: int, heads: int, d: int):
    """x and timm-order Dense parameters (kernels (in, out)), numpy fp32."""
    rng = np.random.default_rng(seed)
    hidden = heads * d
    return (rng.standard_normal((b, n, hidden)).astype(np.float32),
            (rng.standard_normal((hidden, 3 * hidden)) / np.sqrt(hidden)).astype(np.float32),
            (0.1 * rng.standard_normal(3 * hidden)).astype(np.float32),
            (rng.standard_normal((hidden, hidden)) / np.sqrt(hidden)).astype(np.float32),
            (0.1 * rng.standard_normal(hidden)).astype(np.float32))


def _both(dense, heads: int, dtype: str):
    """The same operands for JAX (its layouts) and the port (from its
    Linear layout), weights in ``dtype``, biases fp32."""
    x, qk, qb, pk, pb = dense
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jops = (jnp.asarray(x).astype(jdt), *jattn.dense_to_block_weights(
        jnp.asarray(qk).astype(jdt), jnp.asarray(qb), jnp.asarray(pk).astype(jdt),
        jnp.asarray(pb), heads))
    tops = (torch.from_numpy(x).to(tdt), *port.dense_to_block_weights(
        torch.from_numpy(qk.T.copy()).to(tdt), torch.from_numpy(qb),
        torch.from_numpy(pk.T.copy()).to(tdt), torch.from_numpy(pb), heads))
    return jops, tops


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d", [(9, 16), (77, 16), (144, 64), (77, 64)])
def test_k3_plain_matches_pallas_interpret_and_xla(n, d, dtype):
    jops, tops = _both(_dense(n + d, 2, n, 4, d), 4, dtype)
    interp = _f32(jattn.fused_attention_block(*jops, 4, True))
    xla = _f32(jattn.fused_attention_block_xla(*jops, 4))
    before = port.fused_attention_block.launches
    mine = _f32(port.fused_attention_block(*tops, 4))
    assert port.fused_attention_block.launches == before  # the CPU counts no launch
    scale = np.abs(interp).max()
    assert scale > 0.1
    assert np.abs(mine - interp).max() <= INTERPRET_TOL[dtype] * scale
    assert np.abs(mine - xla).max() <= XLA_TOL[dtype] * scale


def test_k3_plain_keeps_the_kernels_rounding_points_in_bf16():
    """Equal to the interpret kernel bit for bit on this input, where the
    XLA reference (other rounding points) is not."""
    jops, tops = _both(_dense(3, 2, 37, 4, 16), 4, "bfloat16")
    interp = _f32(jattn.fused_attention_block(*jops, 4, True))
    xla = _f32(jattn.fused_attention_block_xla(*jops, 4))
    mine = _f32(port.fused_attention_block_plain(*tops, 4))
    np.testing.assert_array_equal(mine, interp)
    assert np.abs(mine - xla).max() > 0


def test_dense_to_block_weights_matches_jax_layout():
    dense = _dense(1, 1, 5, 3, 16)
    jops, tops = _both(dense, 3, "float32")
    for j, t in zip(jops[1:], tops[1:]):
        np.testing.assert_array_equal(_f32(t), _f32(j))
        assert t.is_contiguous() or t.dim() < 3


def test_k3_gradient_matches_jax_vjp():
    jops, tops = _both(_dense(7, 2, 21, 4, 16), 4, "float32")
    g = np.random.default_rng(8).standard_normal((2, 21, 64)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jattn.fused_attention_block(*a, 4, True), *jops)
    want = vjp(jnp.asarray(g))
    leaves = [t.clone().requires_grad_(True) for t in tops]
    got = torch.autograd.grad(port.fused_attention_block(*leaves, 4), leaves,
                              torch.from_numpy(g))
    for a, b in zip(got, want):
        b = _f32(b).reshape(a.shape)
        assert np.abs(_f32(a) - b).max() <= 1e-5 * np.abs(b).max()


def test_dit_block_route_matches_jax_block_interpret():
    params = jax.tree.map(jnp.asarray, load_npz_params(FIXTURE))
    jmodel, _ = jax_create_model("JPDVT", 48, attn_impl="block_interpret", **TINY)
    with pytest.warns(UserWarning, match="step 0"):
        sd, _ = load_artifact(FIXTURE, device="cpu")
    model, cfg = create_model("JPDVT", 48, device="cpu", attn_impl="block", **TINY)
    model.load_state_dict(sd, strict=True)
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (3, 48, 48, 3)).astype(np.float32)
    t = np.array([0, 40, 999])
    code = rng.standard_normal((3, 9, 8)).astype(np.float32)
    j_img, j_code = jmodel.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(code))
    calls = []
    block = port.fused_attention_block_plain
    with torch.no_grad():
        import jpdvt_mt_ntnu_tpu_torch.models.dit as dit
        orig = dit.fused_attention_block
        dit.fused_attention_block = lambda *a: calls.append(1) or block(*a)
        try:
            img, code_out = model(torch.from_numpy(x), torch.from_numpy(t),
                                  torch.from_numpy(code))
        finally:
            dit.fused_attention_block = orig
    assert len(calls) == cfg.depth
    np.testing.assert_allclose(code_out.numpy(), np.asarray(j_code), atol=1e-4, rtol=0)
    np.testing.assert_allclose(img.numpy(), np.asarray(j_img), atol=1e-4, rtol=0)


@pytest.mark.parametrize("n,dtype,ok", [(144, torch.bfloat16, True), (400, torch.bfloat16, True),
                                        (443, torch.bfloat16, True), (444, torch.bfloat16, False),
                                        (252, torch.float32, True), (253, torch.float32, False)])
def test_block_route_table(n, dtype, ok):
    if ok:
        assert port.attention_route(n, dtype, False, "block") == "block"
    else:
        with pytest.raises(ValueError, match="attn_impl='block'.*shared memory"):
            port.attention_route(n, dtype, False, "block")
    assert port.attention_route(n, dtype, False, "block", on_card=False) == "block"
    assert port.attention_route(n, dtype, False) != "block"  # never picked unasked
    with pytest.raises(ValueError, match="head dim 16"):
        port.attention_route(n, dtype, False, "block", head_dim=16)


def test_training_refuses_the_block_route_by_name():
    cfg = apply_overrides(Config(), ["data.synthetic_cues=waves", "model.attn_impl=block"])
    with pytest.raises(NotImplementedError, match="attn_impl='block' for training"):
        run_train.check_supported(cfg)
