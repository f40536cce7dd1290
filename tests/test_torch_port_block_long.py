"""``attn_impl="block"`` at every geometry the JAX package runs it, on the CPU.

The JAX package's ``fused_attention_block`` runs its Pallas kernel K3
where ``_block_bb`` finds a VMEM budget for one program, and
``fused_attention_block_xla`` (other rounding points) where it does not;
its backward always differentiates ``fused_attention_block_xla``. The
port's ``fused_attention_block`` follows the same rule (its copy of
``_block_bb``) and the same backward. Held here, on the same numpy inputs:

- the port's ``_block_bb`` is None exactly where JAX's is, for the
  registry's four widths, bf16 and fp32, N = 1-2000;
- the forward against JAX's ``fused_attention_block`` in bf16 at a kernel
  geometry (N = 144 at DiT-XL's width, the Pallas kernel in interpret
  mode) and at composition geometries (DiT-XL's width at N = 225, DiT-B's
  at N = 600). The composition is held to JAX run op by op
  (``jax.disable_jit``), the rounding points of its jaxpr, which the TPU
  keeps (its MXU takes q Dh^-1/2 in bf16): XLA's CPU compiler, under jit,
  keeps q Dh^-1/2 in fp32 where a dot reads it (excess precision), which
  moves 45% of the outputs by one ulp at Dh 72 (s_q is no power of two
  there) and 0.2% at Dh 64. Tolerance: at most 15% of the elements differ
  (summation order flips the rounding of some: 3-8% here), none by more
  than 2^-7 of the output's largest magnitude (one bf16 ulp at its
  scale). K3's rounding points where JAX composes differ on about 70%;
- the bf16 gradients (x, W_qkv, W_proj) against JAX's custom VJP: at most
  15% of the elements differ, none by more than 2^-7 of that gradient's
  largest magnitude; the biases' (fp32 sums) within 1e-3 of theirs. Torch
  autograd of K3's plain version differs on about 70%;
- K3's instance (``k3_instance``): the long-row one, the faster as
  measured, at every N (its crossover with the short-row one is at N = 0),
  at both head dims and dtypes, N = 1-2000;
- the mirrors of the long-row instance's shared memory and of its switch
  from k and v whole to a ring (``k3_long_smem_bytes``,
  ``k3_long_kv_whole``) at their boundaries, and that it takes every bf16
  N up to 4096;
- a 1-block DiT at the flagship's width at 384 px, grid 24 (N = 576, the
  grid ladder's rung after grid 20) on ``block`` against JAX's
  ``block_interpret``: bf16 (K3 on both sides: JAX's kernel, the port's
  plain K3), 2^-5 of the output's largest magnitude (bf16 through the
  block and the heads); fp32 (the composition on both sides), 1e-4. One
  block, for the CPU's time: the block is the part that takes K3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpdvt_mt_ntnu_tpu.models import create_model as jax_create_model
from jpdvt_mt_ntnu_tpu.ops import attention as jattn
from jpdvt_mt_ntnu_tpu_torch.models import create_model, dit
from jpdvt_mt_ntnu_tpu_torch.ops import attention as port
from jpdvt_mt_ntnu_tpu_torch.tools.weights import params_to_state_dict
from torch_tools_common import one_torch_thread  # noqa: F401  (autouse)

# (hidden, heads) of the registry: DiT-S, JPDVT / DiT-B, DiT-L, DiT-XL.
WIDTHS = [(384, 6), (768, 12), (1024, 16), (1152, 16)]
ULP_FRACTION = 2 ** -7


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


def _assert_close_in_ulps(mine: np.ndarray, theirs: np.ndarray, frac: float, what: str):
    scale = np.abs(theirs).max()
    assert scale > 0, what
    off = mine != theirs
    err = np.abs(mine - theirs).max()
    assert off.mean() <= frac, f"{what}: {off.mean():.3f} of the elements differ"
    assert err <= ULP_FRACTION * scale, f"{what}: max |diff| {err} at scale {scale}"


@pytest.mark.parametrize("hidden,heads", WIDTHS)
@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "fp32"])
def test_block_rule_is_the_jax_packages(hidden, heads, itemsize):
    d = hidden // heads
    for n in range(1, 2001):
        for b in (1, 32):
            want = jattn._block_bb(b, n, heads, d, hidden, itemsize, None)
            assert port._block_bb(b, n, heads, d, hidden, itemsize) == want, (n, b)


@pytest.mark.parametrize("d", [64, 72])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_k3_instance_is_short_up_to_its_crossover(d, dtype):
    for n in range(1, 2001):
        assert port.k3_instance(n, dtype, d) == "long", n


# (N, element bytes, Dh, k and v whole in L.2, the long-row instance's most
# shared memory a block): bf16 L.1's ring is 197,696 B at Dh 64 and 177,216
# at 72; L.2's whole k and v 16,400 and 19,472 B a 64-key chunk (896 and 704
# the last N that fits), its ring four chunks past that; fp32 1,617 and
# 1,593 the last N that fits a Hopper block.
@pytest.mark.parametrize("n,elem,d,whole,need", [
    (1, 2, 64, True, 197696), (576, 2, 64, True, 197696), (770, 2, 64, True, 213200),
    (896, 2, 64, True, 229600), (897, 2, 64, False, 197696), (144, 2, 72, True, 177216),
    (704, 2, 72, True, 214192), (705, 2, 72, False, 177216), (1617, 4, 64, None, 232448),
    (1618, 4, 64, None, 232576), (1593, 4, 72, None, 232448)])
def test_k3_long_smem_mirror_at_its_boundaries(n, elem, d, whole, need):
    if whole is not None:
        assert port.k3_long_kv_whole(n, d) == whole
    assert port.k3_long_smem_bytes(n, elem, d) == need


def test_k3_long_instance_takes_every_bf16_n():
    for d in (64, 72):
        assert all(port.k3_long_smem_bytes(n, 2, d) <= port.HOPPER_MAX_SMEM
                   for n in range(1, 4097))
        assert [n for n in range(1, 4097) if port.k3_long_kv_whole(n, d)][-1] == \
            {64: 896, 72: 704}[d]


@pytest.mark.parametrize("b,n,heads,d,takes", [
    (1, 144, 16, 72, "k3"),      # DiT-XL/8 at 96 px: JAX runs its kernel
    (1, 225, 16, 72, "xla"),     # DiT-XL at N = 225: JAX composes
    (1, 600, 12, 64, "xla")])    # DiT-B past N = 593: JAX composes
def test_block_forward_matches_jax_in_bf16(b, n, heads, d, takes):
    jops, tops = _both(_dense(n + d, b, n, heads, d), heads, "bfloat16")
    assert port.block_takes_k3(tops[0], tops[1], heads) == (takes == "k3")
    if takes == "k3":
        want = _f32(jattn.fused_attention_block(*jops, heads, True))
    else:
        with jax.disable_jit():
            want = _f32(jattn.fused_attention_block(*jops, heads))
    mine = _f32(port.fused_attention_block(*tops, heads))
    _assert_close_in_ulps(mine, want, 0.15, f"N={n}, Dh {d}")


@pytest.mark.parametrize("b,n,heads,d", [(2, 36, 2, 64)])
def test_block_gradients_match_jax_custom_vjp_in_bf16(b, n, heads, d):
    jops, tops = _both(_dense(7 + d, b, n, heads, d), heads, "bfloat16")
    g = np.random.default_rng(8).standard_normal((b, n, heads * d)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jattn.fused_attention_block(*a, heads, True), *jops)
    want = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    leaves = [t.clone().requires_grad_(True) for t in tops]
    got = torch.autograd.grad(port.fused_attention_block(*leaves, heads), leaves,
                              torch.from_numpy(g).bfloat16())
    for name, mine, theirs in zip(("x", "w_qkv", "b_qkv", "w_proj", "b_proj"), got, want):
        mine, theirs = _f32(mine), _f32(theirs).reshape(mine.shape)
        if name.startswith("b_"):
            assert np.abs(mine - theirs).max() <= 1e-3 * np.abs(theirs).max(), name
        else:
            _assert_close_in_ulps(mine, theirs, 0.15, f"d{name}")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_one_block_dit_at_grid24_on_block_matches_jax(dtype):
    size, n = 384, 576
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jmodel, _ = jax_create_model("JPDVT", size, attn_impl="block_interpret", depth=1,
                                 dtype=jdt)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, size, size, 3)),
                            jnp.zeros((1,), jnp.int32), jnp.zeros((1, n, 8)))
    rng = np.random.default_rng(24)
    params = jax.tree.map(lambda a: (0.02 * rng.standard_normal(a.shape)).astype(np.float32),
                          shapes)
    model, cfg = create_model("JPDVT", size, device="cpu", attn_impl="block", depth=1,
                              dtype=tdt)
    sd, unused = params_to_state_dict(params)
    assert unused == [] and cfg.num_tokens == n
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()})
    x = rng.uniform(-1, 1, (1, size, size, 3)).astype(np.float32)
    t = np.array([700])
    code = rng.standard_normal((1, n, 8)).astype(np.float32)
    j_img, j_code = jmodel.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(code))
    calls = []
    sublayer = dit.fused_attention_block
    dit.fused_attention_block = lambda *a: calls.append(port.block_takes_k3(a[0], a[1], a[5])) \
        or sublayer(*a)
    try:
        with torch.no_grad():
            img, code_out = model(torch.from_numpy(x), torch.from_numpy(t),
                                  torch.from_numpy(code))
    finally:
        dit.fused_attention_block = sublayer
    # bf16: K3 (JAX's kernel takes N = 576 up to 593); fp32: the composition.
    assert calls == [dtype == "bfloat16"] * cfg.depth
    tol = 2 ** -5 if dtype == "bfloat16" else 1e-4
    for mine, theirs in ((code_out, j_code), (img, j_img)):
        theirs = _f32(theirs)
        scale = np.abs(theirs).max()
        assert scale > 0.05  # not vacuous: the heads carry the block's output
        np.testing.assert_allclose(_f32(mine), theirs, rtol=0, atol=tol * scale)
