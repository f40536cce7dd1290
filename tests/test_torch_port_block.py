"""Kernel K3 (the whole attention sublayer) of the PyTorch port against the
JAX package's ``fused_attention_block``.

The port's plain version (``fused_attention_block_plain``, the path its
wrapper takes for CPU tensors) is held against the Pallas kernel
``_attn_block_kernel`` run in interpret mode and against the XLA reference
``fused_attention_block_xla``, on the same numpy inputs, at small widths
(H = 4, Dh = 16, 64 and DiT-XL's 72). The CUDA kernel itself runs only on a card:
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
route table (K3's short-row limits at Dh 64 and 72, and what the JAX
rule computes there) and the training route at every geometry.
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
@pytest.mark.parametrize("n,d", [(9, 16), (77, 16), (144, 64), (77, 64), (144, 72), (77, 72)])
def test_k3_plain_matches_pallas_interpret_and_xla(n, d, dtype):
    jops, tops = _both(_dense(n + d, 2, n, 4, d), 4, dtype)
    interp = _f32(jattn.fused_attention_block(*jops, 4, True))
    xla = _f32(jattn.fused_attention_block_xla(*jops, 4))
    before = port.fused_attention_block_k3.launches
    mine = _f32(port.fused_attention_block(*tops, 4))
    assert port.fused_attention_block_k3.launches == before  # the CPU counts no launch
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


def _shares_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def test_dense_to_block_weights_matches_jax_layout():
    dense = _dense(1, 1, 5, 3, 16)
    jops, tops = _both(dense, 3, "float32")
    for j, t in zip(jops[1:], tops[1:]):
        np.testing.assert_array_equal(_f32(t), _f32(j))
    # Views of the Linear parameters, never copies.
    params = [torch.from_numpy(a) for a in (dense[1].T.copy(), dense[2], dense[3].T.copy(),
                                            dense[4])]
    for p, t in zip(params, port.dense_to_block_weights(*params, 3)):
        assert _shares_storage(t, p)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dit_block_route_passes_views_of_the_weights(dtype):
    """The block route hands K3 the qkv and proj weights as they lie: no
    per-call copy (the kernel reads the Linear layout)."""
    model, cfg = create_model("JPDVT", 48, device="cpu", attn_impl="block", dtype=dtype,
                              **TINY)
    model.to(dtype)  # as the solver casts its kept copy
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 48, 48, 3)).astype(np.float32))
    code = torch.from_numpy(rng.standard_normal((2, 9, 8)).astype(np.float32))
    seen = []
    import jpdvt_mt_ntnu_tpu_torch.models.dit as dit
    orig = dit.fused_attention_block
    dit.fused_attention_block = lambda *a: seen.append(a) or orig(*a)
    try:
        with torch.no_grad():
            model(x, torch.tensor([0, 999]), code)
    finally:
        dit.fused_attention_block = orig
    assert len(seen) == cfg.depth
    for blk, (_, w_qkv, _, w_proj, _, _) in zip(model.blocks, seen):
        assert w_qkv.dtype == w_proj.dtype == dtype
        assert _shares_storage(w_qkv, blk.attn.qkv.weight)
        assert _shares_storage(w_proj, blk.attn.proj.weight)


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


# (N, dtype, Dh, fits, takes): whether K3's short-row instance fits a
# Hopper block, and what ``block`` computes at the width of Dh's registry
# model (the JPDVT flagship, D 768, at 64; DiT-XL, D 1152, at 72) by the
# JAX rule: "k3" (the short- or long-row instance) or "xla".
@pytest.mark.parametrize("n,dtype,ok,d,takes", [
    (144, torch.bfloat16, True, 64, "k3"), (400, torch.bfloat16, True, 64, "k3"),
    (416, torch.bfloat16, True, 64, "k3"), (417, torch.bfloat16, False, 64, "k3"),
    (252, torch.float32, True, 64, "k3"), (253, torch.float32, False, 64, "k3"),
    (144, torch.bfloat16, True, 72, "k3"), (336, torch.bfloat16, True, 72, "xla"),
    (337, torch.bfloat16, False, 72, "xla"), (576, torch.bfloat16, False, 72, "xla"),
    (223, torch.float32, True, 72, "xla"), (224, torch.float32, False, 72, "xla")])
def test_block_route_table(n, dtype, ok, d, takes):
    """``block`` is taken at every N, on the card too. K3's short-row
    instance holds q, k, v in shared memory up to bf16 N = 416 at Dh 64 and
    336 at 72, fp32 252 and 223; past them the long-row one runs. Which of
    K3 and the XLA composition runs is the JAX rule's: DiT-XL (D 1152) takes
    K3 in bf16 up to N = 173 and never in fp32; the flagship up to 593 and
    256."""
    for grad in (False, True):
        for on_card in (True, False):
            assert port.attention_route(n, dtype, grad, "block", head_dim=d,
                                        on_card=on_card) == "block"
    assert (port.k3_smem_bytes(n, torch.empty((), dtype=dtype).element_size(), d)
            <= port.HOPPER_MAX_SMEM) == ok
    heads = 12 if d == 64 else 16
    x = torch.empty((1, n, heads * d), dtype=dtype)
    assert port.block_takes_k3(x, torch.empty((3 * heads, heads * d, d), dtype=dtype),
                               heads) == (takes == "k3")
    assert port.attention_route(n, dtype, False, head_dim=d) != "block"  # never picked unasked
    with pytest.raises(ValueError, match="head dim 16"):
        port.attention_route(n, dtype, False, "block", head_dim=16)


def test_training_refuses_the_block_route_by_name():
    """Training takes the block route at every geometry: at 192 px in bf16
    (the flagship's, K3), at 320 px in fp32 (N = 400: the XLA composition,
    as the JAX rule computes there) and at 384 px, grid 24 (N = 576, K3's
    long-row instance)."""
    for extra in ([], ["model.image_size=320", "model.compute_dtype=float32"],
                  ["model.image_size=384", "task.grid_size=24"]):
        cfg = apply_overrides(Config(), ["data.synthetic_cues=waves", "model.attn_impl=block",
                                         *extra])
        run_train.check_supported(cfg)
    x = torch.empty((1, 400, 768))
    assert not port.block_takes_k3(x, torch.empty((36, 768, 64)), 12)
    assert port.block_takes_k3(x.bfloat16(), torch.empty((36, 768, 64), dtype=torch.bfloat16),
                               12)
