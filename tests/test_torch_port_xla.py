"""The attention settings ``xla``, ``xla2`` and ``xla_split`` of the PyTorch
port, and ``pallas`` in fp32 past the whole-row kernels' shared memory,
against the JAX package on the same numpy inputs, on the CPU.

- Op level: ``fused_qkv_attention_xla`` against the JAX package's
  ``fused_qkv_attention_xla`` and ``fused_qkv_attention_xla2`` (one
  function), ``split_qkv_attention_xla`` against its namesake, forward and
  ``jax.vjp`` gradients on the same bf16 inputs at Dh 64 and 72, N = 144
  and 400. Tolerances (bf16): the forward within 2e-2 absolute with at most
  ``FLIP_SHARE`` (1%) of the outputs differing at all (summation order and
  exp flip a few bf16 roundings; 0.005-0.07% here); each gradient with at
  most 1% of its elements differing and its largest difference at most
  2^-6 of its largest magnitude (one bf16 rounding flipped moves a value by
  2^-8 of its scale; 0.02-0.05% of elements differ here), except two of
  ``xla_split``'s: its weight's gradient, a sum over the B N rows of the
  projection's cotangent times x, in which each cotangent element that
  differs (0.3-0.4% of x's gradient here) moves many sums, with at most
  ``WEIGHT_SHARE`` (5%) of its elements differing (0.6-2.1% here), and its
  bias's, which XLA on the CPU sums in bf16, where torch sums in fp32
  (83% of the elements differ; only the 2^-6 bound holds: 2^-6.5 to
  2^-7.6 of scale here). fp32: 1e-5 of each output's and gradient's
  largest magnitude (summation order).
- The default route's bf16 gradient (K1 + K2's function) is JAX's
  ``pallas`` gradient (``interpret``): at most ``FLIP_SHARE`` of elements
  differ. Against JAX's ``xla`` gradient it differs as JAX's own two
  routes differ from each other (about a third of the elements): by no
  more than that share plus one percentage point.
- Model level: a two-block DiT in bf16 with grad on each ``xla*`` setting
  against the JAX DiT on the same setting: outputs within 2^-5 of their
  largest magnitude (bf16 activations through two blocks, a Linear's bias
  add rounded at another point), parameter gradients within 2^-4 of each
  gradient's largest magnitude (the same, through the backward).
- ``pallas`` in fp32 past K1's and K2's whole-row shared memory: a
  one-block DiT at N = 400 (Dh 64) and N = 324 (Dh 72) with grad on
  ``pallas``, against the JAX DiT on ``interpret`` (its Pallas K1 and K2 in
  interpret mode): outputs and gradients within 2e-4 of each one's largest
  magnitude (fp32, summation order, through a backward). The plain versions
  of the streaming instances (``attention_reference``,
  ``attention_bwd_reference``) against the Pallas kernels in interpret mode
  at N from 310 to 576: 1e-5 of scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpdvt_mt_ntnu_tpu.models import create_model as jax_create_model
from jpdvt_mt_ntnu_tpu.ops.attention import (
    _attention_pallas_bwd, _attention_pallas_fwd_only, fused_qkv_attention,
    fused_qkv_attention_xla, fused_qkv_attention_xla2, split_qkv_attention_xla)
from jpdvt_mt_ntnu_tpu_torch.models import create_model
from jpdvt_mt_ntnu_tpu_torch.ops import attention as port
from jpdvt_mt_ntnu_tpu_torch.tools.weights import params_to_state_dict
from torch_tools_common import one_torch_thread  # noqa: F401  (autouse)

FLIP_SHARE = 0.01
WEIGHT_SHARE = 0.05
FWD_TOL = 2e-2
GRAD_REL = 2 ** -6
FP32_REL = 1e-5
MODEL_REL, MODEL_GRAD_REL = 2 ** -5, 2 ** -4
PALLAS32_REL = 2e-4
BF16 = torch.bfloat16


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _jax(a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _torch(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))


def _diff(mine, want):
    """(share of elements that differ, largest difference / largest |want|)."""
    mine, want = _np(mine), _np(want)
    assert mine.shape == want.shape
    return (mine != want).mean(), np.abs(mine - want).max() / np.abs(want).max()


def _op_inputs(n, d, heads=2, b=2, seed=0):
    rng = np.random.default_rng(seed + n + d)
    hidden = heads * d
    x = rng.standard_normal((b, n, hidden)).astype(np.float32)
    w = (rng.standard_normal((hidden, 3 * hidden)) * hidden ** -0.5).astype(np.float32)
    bias = (0.1 * rng.standard_normal(3 * hidden)).astype(np.float32)
    qkv = rng.standard_normal((b, n, 3 * hidden)).astype(np.float32)
    g = rng.standard_normal((b, n, hidden)).astype(np.float32)
    return qkv, x, w, bias, g


def _jax_and_port(impl, n, d, dtype, heads=2):
    """(JAX outputs and gradients, the port's) of one op on the same inputs."""
    qkv, x, w, bias, g = _op_inputs(n, d, heads)
    if impl == "split":
        jargs = (_jax(x, dtype), _jax(w, dtype), _jax(bias, dtype))
        out, vjp = jax.vjp(lambda a, k, c: split_qkv_attention_xla(a, k, c, heads), *jargs)
        jgrads = vjp(_jax(g, dtype))
        leaves = [_torch(x, dtype), _torch(w.T, dtype), _torch(bias, dtype)]
        fn = port.split_qkv_attention_xla
    else:
        jfn = {"xla": fused_qkv_attention_xla, "xla2": fused_qkv_attention_xla2}[impl]
        out, vjp = jax.vjp(lambda a: jfn(a, heads), _jax(qkv, dtype))
        jgrads = vjp(_jax(g, dtype))
        leaves = [_torch(qkv, dtype)]
        fn = port.fused_qkv_attention_xla
    leaves = [t.requires_grad_(True) for t in leaves]
    mine = fn(*leaves, heads)
    assert mine.grad_fn is not None and "PlainBackward" in type(mine.grad_fn).__name__
    mine.backward(_torch(g, dtype))
    grads = [t.grad for t in leaves]
    if impl == "split":
        grads[1] = grads[1].t()  # the Linear's (3D, D) against JAX's (D, 3D) kernel
    return (out, jgrads), (mine, grads)


@pytest.mark.parametrize("impl", ["xla", "xla2", "split"])
@pytest.mark.parametrize("n,d", [(144, 64), (144, 72), (400, 64), (400, 72)],
                         ids=["144", "144-d72", "400", "400-d72"])
def test_xla_settings_match_jax_vjp_in_bf16(impl, n, d):
    (jout, jgrads), (mine, grads) = _jax_and_port(impl, n, d, "bfloat16")
    assert mine.dtype == BF16
    np.testing.assert_allclose(_np(mine), _np(jout), rtol=0, atol=FWD_TOL)
    assert _diff(mine, jout)[0] <= FLIP_SHARE
    for i, (m, w) in enumerate(zip(grads, jgrads)):
        share, rel = _diff(m, w)
        assert rel <= GRAD_REL, (i, share, rel)
        # xla_split's weight and bias gradients are sums over B N rows (the
        # projection's cotangent times x, and the cotangent alone). In the
        # weight's, every cotangent element that differs moves many sums:
        # WEIGHT_SHARE. The bias's XLA sums in bf16 on the CPU (83% of its
        # elements differ from the fp32 sum rounded once), torch in fp32:
        # only the scale-relative bound holds.
        if impl == "split" and i == 1:
            assert share <= WEIGHT_SHARE, (i, share, rel)
        elif not (impl == "split" and i == 2):
            assert share <= FLIP_SHARE, (i, share, rel)


@pytest.mark.parametrize("impl", ["xla", "xla2", "split"])
def test_xla_settings_match_jax_vjp_in_fp32(impl):
    (jout, jgrads), (mine, grads) = _jax_and_port(impl, 144, 64, "float32")
    assert _diff(mine, jout)[1] <= FP32_REL
    for m, w in zip(grads, jgrads):
        assert _diff(m, w)[1] <= FP32_REL


@pytest.mark.parametrize("n", [144, 400])
def test_default_route_bf16_gradient_is_jax_pallas_gradient(n):
    """The queue-3 record: the port's default route (K1 + K2) computes the
    JAX package's ``pallas`` gradient, which differs from its ``xla``
    gradient as JAX's own two routes do."""
    qkv, _, _, _, g = _op_inputs(n, 64)
    jq, jg = _jax(qkv, "bfloat16"), _jax(g, "bfloat16")
    _, vjp = jax.vjp(lambda a: fused_qkv_attention(a, 2, True), jq)
    (interp,) = vjp(jg)
    _, vjp = jax.vjp(lambda a: fused_qkv_attention_xla(a, 2), jq)
    (xla,) = vjp(jg)
    leaf = _torch(qkv, "bfloat16").requires_grad_(True)
    out = port.fused_qkv_attention(leaf, 2)
    assert "FusedQKVAttention" in type(out.grad_fn).__name__  # K1 + K2's function
    out.backward(_torch(g, "bfloat16"))
    share_interp, rel = _diff(leaf.grad, interp)
    assert share_interp <= FLIP_SHARE and rel <= GRAD_REL
    jax_routes = _diff(interp, xla)[0]
    assert jax_routes > 0.2  # the two JAX routes round dS at other points
    assert _diff(leaf.grad, xla)[0] <= jax_routes + 0.01


@pytest.mark.parametrize("impl,route", [
    ("xla", "xla"), ("xla2", "xla"), ("xla_split", "xla_split"), ("interpret", "whole_row"),
    ("block_interpret", "block"), ("pallas", "whole_row")])
@pytest.mark.parametrize("n,dtype,d", [(144, BF16, 64), (400, torch.float32, 64),
                                       (576, torch.float32, 72)],
                         ids=["144-bf16", "400-fp32", "576-fp32-d72"])
def test_route_takes_every_jax_setting(impl, route, n, dtype, d):
    for grad in (False, True):
        assert port.attention_route(n, dtype, grad, impl, head_dim=d) == route


def test_route_refuses_ring_by_its_mesh_and_keeps_the_kernels_limits():
    with pytest.raises(ValueError, match="mesh.seq"):
        port.attention_route(144, BF16, False, "ring")
    for impl in ("xla", "xla_split", "interpret"):
        with pytest.raises(ValueError, match="head dim 16"):
            port.attention_route(9, BF16, True, impl, head_dim=16)
        with pytest.raises(ValueError, match="float16"):
            port.attention_route(144, torch.float16, True, impl)
    assert port.attn_impl_refusal("xla2") is None and "mesh.seq" in port.attn_impl_refusal("ring")


@pytest.mark.parametrize("grad,d,last_whole", [(False, 64, 341), (True, 64, 164),
                                               (False, 72, 309), (True, 72, 148)])
def test_fp32_instance_streams_where_the_whole_row_instance_ends(grad, d, last_whole):
    assert port.fp32_instance(last_whole, d, grad) == "whole"
    for n in (last_whole + 1, 576, 1296, 4096):
        assert port.fp32_instance(n, d, grad) == "streaming"
    # the default route keeps the whole-row limits: flash past them
    assert port.attention_route(last_whole + 1, torch.float32, grad, head_dim=d) == "flash"


def test_instance_keyword_is_checked_before_any_launch():
    q = torch.empty((1, 2, 9, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        port.attention(q, q, q, instance="streaming")
    q = torch.zeros((1, 2, 9, 64))  # the CPU: the plain version, whatever the instance
    assert torch.equal(port.attention(q, q, q, instance="streaming"),
                       port.attention_reference(q, q, q))


@pytest.mark.parametrize("n,d", [(342, 64), (400, 64), (576, 64), (310, 72), (576, 72)],
                         ids=["342", "400", "576", "310-d72", "576-d72"])
def test_k1_streaming_plain_version_matches_pallas_interpret(n, d):
    rng = np.random.default_rng(n + d)
    q, k, v = (rng.standard_normal((1, 2, n, d)).astype(np.float32) for _ in range(3))
    mine = port.attention(*(torch.from_numpy(a) for a in (q, k, v)))
    want = _attention_pallas_fwd_only(*(jnp.asarray(a) for a in (q, k, v)), interpret=True)
    assert port.fp32_instance(n, d) == "streaming"
    assert _diff(mine, want)[1] <= FP32_REL


@pytest.mark.parametrize("n,d", [(165, 64), (400, 64), (576, 64), (149, 72), (576, 72)],
                         ids=["165", "400", "576", "149-d72", "576-d72"])
def test_k2_streaming_plain_version_matches_pallas_interpret(n, d):
    rng = np.random.default_rng(n + d + 1)
    arrays = [rng.standard_normal((1, 2, n, d)).astype(np.float32) for _ in range(4)]
    mine = port.attention_bwd_reference(*(torch.from_numpy(a) for a in arrays))
    want = _attention_pallas_bwd(*(jnp.asarray(a) for a in arrays), interpret=True)
    assert port.fp32_instance(n, d, grad=True) == "streaming"
    for name, m, w in zip(("dq", "dk", "dv"), mine, want):
        assert _diff(m, w)[1] <= FP32_REL, name


def _dit_pair(impl, size, patch, hidden, heads, depth, dtype, jax_impl=None, seed=0):
    """The JAX DiT on ``jax_impl`` (default ``impl``) and the port's on
    ``impl``, on the same numpy-drawn weights."""
    jdt = {torch.float32: jnp.float32, BF16: jnp.bfloat16}[dtype]
    arch = dict(depth=depth, hidden_size=hidden, num_heads=heads, patch_size=patch)
    jmodel, _ = jax_create_model("JPDVT", size, attn_impl=jax_impl or impl, dtype=jdt, **arch)
    n = (size // patch) ** 2
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, size, size, 3)),
                            jnp.zeros((1,), jnp.int32), jnp.zeros((1, n, 8)))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: (0.05 * rng.standard_normal(a.shape)).astype(np.float32), shapes)
    model, cfg = create_model("JPDVT", size, device="cpu", attn_impl=impl, dtype=dtype, **arch)
    sd, unused = params_to_state_dict(params)
    assert unused == []
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in sd.items()}, strict=True)
    rng = np.random.default_rng(seed + 1)
    inputs = (rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32), np.array([3, 900]),
              rng.standard_normal((2, n, 8)).astype(np.float32))
    return jmodel, params, model, inputs


def _dit_outputs_and_grads(jmodel, params, model, inputs):
    """Both models' (image, code) outputs and the gradients of one scalar
    of them (a fixed weighting of each output) by parameter name."""
    x, t, code = inputs
    rng = np.random.default_rng(7)
    wi = rng.standard_normal(x.shape).astype(np.float32)
    wc = rng.standard_normal(code.shape).astype(np.float32)

    def jloss(p):
        img, c = jmodel.apply(p, jnp.asarray(x), jnp.asarray(t), jnp.asarray(code))
        return ((img.astype(jnp.float32) * wi).sum() + (c.astype(jnp.float32) * wc).sum(),
                (img, c))

    (_, jouts), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    want, _ = params_to_state_dict(jax.tree.map(np.asarray, jgrads))
    model.zero_grad(set_to_none=True)
    img, c = model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(code))
    ((img.float() * torch.from_numpy(wi)).sum()
     + (c.float() * torch.from_numpy(wc)).sum()).backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    return jouts, (img, c), want, grads


@pytest.mark.parametrize("impl", ["xla", "xla2", "xla_split"])
def test_two_block_dit_on_xla_settings_matches_jax_in_bf16(impl):
    jmodel, params, model, inputs = _dit_pair(impl, 64, 16, 128, 2, 2, BF16)
    jouts, outs, want, grads = _dit_outputs_and_grads(jmodel, params, model, inputs)
    for mine, theirs in zip(outs, jouts):
        assert _diff(mine, theirs)[1] <= MODEL_REL
    assert sorted(grads) == sorted(want)
    assert grads["blocks.0.attn.qkv.weight"].abs().max() > 0
    for k, w in want.items():
        assert _diff(grads[k], w)[1] <= MODEL_GRAD_REL, k


@pytest.mark.parametrize("size,patch,hidden,heads", [(320, 16, 128, 2), (144, 8, 144, 2)],
                         ids=["n400", "n324-d72"])
def test_one_block_dit_on_pallas_in_fp32_past_shared_memory_matches_jax(size, patch, hidden,
                                                                       heads):
    """N = 400 at Dh 64 and N = 324 at Dh 72: past K1's and K2's whole-row
    fp32 instances, where the card takes their streaming instances."""
    jmodel, params, model, inputs = _dit_pair("pallas", size, patch, hidden, heads, 1,
                                              torch.float32, jax_impl="interpret")
    n, d = (size // patch) ** 2, hidden // heads
    assert port.attention_route(n, torch.float32, True, "pallas", head_dim=d) == "whole_row"
    assert port.fp32_instance(n, d) == port.fp32_instance(n, d, grad=True) == "streaming"
    jouts, outs, want, grads = _dit_outputs_and_grads(jmodel, params, model, inputs)
    for mine, theirs in zip(outs, jouts):
        assert _diff(mine, theirs)[1] <= PALLAS32_REL
    for k, w in want.items():
        assert _diff(grads[k], w)[1] <= PALLAS32_REL, k
