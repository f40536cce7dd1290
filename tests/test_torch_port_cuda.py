"""Kernels K1-K6 on the card against their plain versions, and
the DiT's gradients through them against plain autograd.

Skips without a CUDA card. This file imports no JAX, so it also runs on a
GPU machine that has none; there ``tests/conftest.py`` (which imports JAX)
must be left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

Tolerances as in ``chip_smoke.py``: K1 bf16 2e-2 absolute (one bf16 ulp of
an output of magnitude ~2 if exp or summation order flips a rounding),
fp32 1e-4 (summation order); two calls bit-equal, and strided views of the
fused qkv bit-equal to contiguous copies. K2, relative to each gradient's largest
magnitude: bf16 2^-6 (a summation order that flips the bf16 rounding of dS
or of an output moves it by one ulp, 2^-8 of its scale), fp32 1e-5; two calls
bit-equal, and views off 16-byte alignment bit-equal to aligned copies.
The DiT's gradients with K1/K2 against plain autograd in fp32: 1e-4 of
each gradient's largest magnitude (K2 rounds nothing in fp32; the two
differ by summation order through twelve blocks).

K4 against its plain version at the kernel's own key tile (``BLOCK_K``):
as K1, 2e-2 absolute in bf16 (both round exp(S - m) per tile at the same
points; exp or summation order can flip one rounding by one ulp), 1e-4 in
fp32; the LSE 1e-4 absolute (fp32, summation order); two calls bit-equal,
and views off 16-byte alignment bit-equal to aligned copies. K5 and K6 as K2
(they round dS and the outputs where the plain version does), two calls
bit-equal, and views off 16-byte alignment bit-equal to aligned copies. The
DiT's gradients through K4-K6 as through K1/K2.

K1-K6 also run at DiT-XL's head dim, 72 (16 heads), under the same
tolerances: the kernels built with ``-DHEAD_DIM=72``, held to the plain
versions, which scale q by Dh^-1/2 rounded to the input type. The DiT's
gradients at Dh 72 run through K4-K6 (the default route) and through K1
and K2 (``attn_impl="pallas"``).

K3 against its plain version, relative to the output's largest magnitude:
bf16 2e-2 (both round q, k, v, P, o and the output at the same points;
exp, the reciprocal of the row sum or summation order can flip one
rounding by one bf16 ulp), fp32 1e-5 (summation order); two calls
bit-equal, also with the weights as views of Linear weights. Its
long-row instance (any N) under the same tolerances, and bit-equal to the
short-row one wherever both fit; on both sides of its switch from k and
v whole in shared memory to a ring, an item alone bit-equal to the
item inside a batch of 32, and each call's output its own operands' where
the instance's tensor-map cache holds another call's. ``block``'s XLA composition (cuBLAS
projections around K1 or K4) against its plain version as K1 against its
own: 2e-2 and 1e-4 of the output's largest magnitude.
"""

import numpy as np
import pytest
import torch

from jpdvt_mt_ntnu_tpu_torch.core.diffusion import create_diffusion
from jpdvt_mt_ntnu_tpu_torch.models import create_model, dit
from jpdvt_mt_ntnu_tpu_torch.ops import attention as port
from jpdvt_mt_ntnu_tpu_torch.ops import flash_attention as flash
from jpdvt_mt_ntnu_tpu_torch.utils.pos_embed import grid_code

K2_TOL = {torch.bfloat16: 2 ** -6, torch.float32: 1e-5}
HEADS = {64: 12, 72: 16}  # the JPDVT flagship's heads; DiT-XL's at Dh 72

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 and K2 are CUDA kernels with no CPU mode")


def _k1_views(b, n, dtype, gen, offset=0, d=64):
    """q, k, v as the DiT hands them to K1: strided views of a fused (B, N,
    3*H*Dh) qkv, starting ``offset`` elements into their buffer."""
    h = HEADS[d]
    f = 3 * h * d
    buf = torch.randn(offset + b * n * f, generator=gen, device="cuda").to(dtype)
    qkv = buf[offset:].view(b, n, f)
    return qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)


@pytest.mark.parametrize("b,n,dtype,d", [(16, 144, torch.bfloat16, 64),
                                         (32, 400, torch.bfloat16, 64),
                                         (3, 77, torch.bfloat16, 64),
                                         (2, 9, torch.bfloat16, 64),
                                         (2, 144, torch.float32, 64),
                                         (8, 576, torch.bfloat16, 72),
                                         (3, 77, torch.bfloat16, 72),
                                         (2, 9, torch.bfloat16, 72),
                                         (2, 144, torch.float32, 72),
                                         (2, 309, torch.float32, 72)])
def test_k1_cuda_kernel_matches_plain(cuda, b, n, dtype, d):
    """N = 9 (the tiny fixture's grid) and 77 leave the last 64-key chunk
    and the last query tile ragged; 400 is the grid-20 solve's; 576
    DiT-XL/8's at 192 px; 309 the most fp32 takes at Dh 72."""
    gen = torch.Generator("cuda").manual_seed(n)
    q, k, v = _k1_views(b, n, dtype, gen, d=d)
    before = port.attention.launches
    out = port.attention(q, k, v)
    torch.cuda.synchronize()
    assert port.attention.launches == before + 1
    err = (out.float() - port.attention_reference(q, k, v).float()).abs().max().item()
    assert err <= (2e-2 if dtype == torch.bfloat16 else 1e-4)


@pytest.mark.parametrize("b,n,dtype,d", [(32, 144, torch.bfloat16, 64),
                                         (32, 400, torch.bfloat16, 64),
                                         (2, 144, torch.float32, 64),
                                         (8, 576, torch.bfloat16, 72),
                                         (2, 144, torch.float32, 72)])
def test_k1_cuda_kernel_is_bit_equal_across_calls(cuda, b, n, dtype, d):
    """One owning accumulator per output, keys in a fixed order, no atomics."""
    q, k, v = _k1_views(b, n, dtype, torch.Generator("cuda").manual_seed(n + 2), d=d)
    out = port.attention(q, k, v)
    assert torch.equal(out, port.attention(q, k, v))


@pytest.mark.parametrize("b,n,dtype,offset,d", [(4, 144, torch.bfloat16, 0, 64),
                                                (3, 77, torch.bfloat16, 0, 64),
                                                (3, 77, torch.bfloat16, 2, 64),
                                                (2, 77, torch.float32, 0, 64),
                                                (3, 77, torch.bfloat16, 0, 72),
                                                (3, 77, torch.bfloat16, 2, 72)])
def test_k1_cuda_kernel_reads_strided_views_of_the_fused_qkv(cuda, b, n, dtype, offset, d):
    """The same bits from strided views of the fused qkv as from contiguous
    (B, H, N, Dh) copies. ``offset`` 2 puts the bf16 rows off 16-byte
    alignment, where the kernel stages K and V without cp.async."""
    q, k, v = _k1_views(b, n, dtype, torch.Generator("cuda").manual_seed(n + 3), offset, d)
    f = 3 * HEADS[d] * d
    assert q.stride()[:3] == (n * f, d, f)
    out = port.attention(q, k, v)
    assert torch.equal(out, port.attention(q.contiguous(), k.contiguous(), v.contiguous()))


def test_k1_cuda_wrapper_refuses_what_the_kernel_cannot_take(cuda):
    q = torch.zeros((1, 2, 9, 32), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"Dh in \(64, 72\)"):
        port.attention(q, q, q)
    q = torch.zeros((1, 2, 9, 64), device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        port.attention(q, q, q)
    q = torch.zeros((1, 2, 342, 64), device="cuda", dtype=torch.float32)
    with pytest.raises(ValueError, match="shared memory"):
        port.attention(q, q, q, instance="whole")  # fp32 whole score rows: N <= 341
    port.attention(q, q, q)  # the streaming instance takes it
    q = torch.zeros((1, 2, 310, 72), device="cuda", dtype=torch.float32)
    with pytest.raises(ValueError, match="shared memory"):
        port.attention(q, q, q, instance="whole")  # at Dh 72: N <= 309
    q = torch.zeros((1, 2, 9, 64), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="one .* instance"):
        port.attention(q, q, q, instance="streaming")
    for d in port.HEAD_DIMS:
        for n, elem in ((9, 2), (4096, 2), (309, 4), (310, 4), (341, 4), (342, 4)):
            assert port.k1_smem_bytes(n, elem, d) == \
                port._kernel(d).k1_attention_smem_bytes(n, elem)


@pytest.mark.parametrize("b,n,dtype,d", [(32, 144, torch.bfloat16, 64),
                                         (3, 77, torch.bfloat16, 64),
                                         (2, 200, torch.bfloat16, 64),
                                         (2, 144, torch.float32, 64),
                                         (2, 9, torch.bfloat16, 64),
                                         (2, 64, torch.bfloat16, 64),
                                         (2, 65, torch.bfloat16, 64),
                                         (2, 205, torch.bfloat16, 64),
                                         (2, 400, torch.bfloat16, 64),
                                         (8, 576, torch.bfloat16, 72),
                                         (3, 77, torch.bfloat16, 72),
                                         (2, 9, torch.bfloat16, 72),
                                         (2, 65, torch.bfloat16, 72),
                                         (2, 144, torch.float32, 72),
                                         (2, 148, torch.float32, 72)])
def test_k2_cuda_kernel_matches_plain(cuda, b, n, dtype, d):
    """N = 9, 65, 77, 144, 200 and 205 leave the last 64-row chunk and the
    last 64-row tile ragged; 64 is one whole tile; 400 is past the old
    shared-memory limit of 205; 576 is DiT-XL/8's at 192 px (Dh 72); 148
    the most fp32 takes at Dh 72."""
    gen = torch.Generator("cuda").manual_seed(n + 1)
    h = HEADS[d]
    qkv = torch.randn((b, n, 3 * h * d), generator=gen, device="cuda").to(dtype)
    do = torch.randn((b, n, h * d), generator=gen, device="cuda").to(dtype)
    heads = qkv.reshape(b, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
    dov = do.view(b, n, h, d).transpose(1, 2)
    buf = torch.empty_like(qkv)
    out = buf.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
    before = port.attention_bwd.launches
    port.attention_bwd(*heads, dov, out=out)
    torch.cuda.synchronize()
    assert port.attention_bwd.launches == before + 1
    for got, want in zip(out, port.attention_bwd_reference(*heads, dov)):
        scale = want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= K2_TOL[dtype] * scale, (err, scale)


def _k2_inputs(b, n, dtype, gen, offset=0, d=64):
    """q, k, v as strided views of a fused qkv ``offset`` elements into its
    buffer, dO as a view of a (B, N, H*Dh) gradient."""
    q, k, v = _k1_views(b, n, dtype, gen, offset, d)
    h = HEADS[d]
    do = torch.randn((b, n, h * d), generator=gen, device="cuda").to(dtype)
    return q, k, v, do.view(b, n, h, d).transpose(1, 2)


@pytest.mark.parametrize("b,n,dtype,d", [(32, 144, torch.bfloat16, 64),
                                         (3, 77, torch.bfloat16, 64),
                                         (2, 400, torch.bfloat16, 64),
                                         (2, 144, torch.float32, 64),
                                         (8, 576, torch.bfloat16, 72),
                                         (2, 144, torch.float32, 72)])
def test_k2_cuda_kernel_is_bit_equal_across_calls(cuda, b, n, dtype, d):
    """One owning accumulator per output, chunks in a fixed order, no
    atomics: a resumed train run repeats the uninterrupted one."""
    args = _k2_inputs(b, n, dtype, torch.Generator("cuda").manual_seed(n + 9), d=d)
    first = port.attention_bwd(*args, out=_fused_grads(b, n, dtype, d))
    second = port.attention_bwd(*args, out=_fused_grads(b, n, dtype, d))
    for a, c in zip(first, second):
        assert torch.equal(a, c)


@pytest.mark.parametrize("b,n,d", [(3, 77, 64), (2, 144, 64), (2, 400, 64), (3, 77, 72)])
def test_k2_cuda_kernel_reads_views_off_16_byte_alignment(cuda, b, n, d):
    """q, k, v rows that do not start on 16 bytes (pair-aligned views the
    wrapper admits) are staged without cp.async: the same bits as from
    aligned copies, and within the tolerance of the plain version."""
    q, k, v, do = _k2_inputs(b, n, torch.bfloat16, torch.Generator("cuda").manual_seed(n + 10),
                             2, d)
    f = 3 * HEADS[d] * d
    assert q.data_ptr() % 16 and q.stride()[:3] == (n * f, d, f)
    got = port.attention_bwd(q, k, v, do, out=_fused_grads(b, n, q.dtype, d))
    aligned = [t.contiguous() for t in (q, k, v)]
    want = port.attention_bwd(*aligned, do, out=_fused_grads(b, n, q.dtype, d))
    for g, w, ref in zip(got, want, port.attention_bwd_reference(q, k, v, do)):
        assert torch.equal(g, w)
        scale = ref.float().abs().max().item()
        assert (g.float() - ref.float()).abs().max().item() <= K2_TOL[q.dtype] * scale


def test_dit_gradients_through_k1_k2_match_plain_autograd(cuda):
    """The check that fails when attention's backward drops the gradient
    (an output written by a kernel outside autograd has no grad_fn)."""
    model, cfg = create_model("JPDVT", 48, seed=0, depth=2, hidden_size=128,
                              num_heads=2)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(0.05 * rng.standard_normal(p.shape).astype(np.float32)))
    diff = create_diffusion("")
    x = torch.from_numpy(rng.uniform(-1, 1, (4, 48, 48, 3)).astype(np.float32)).cuda()
    t = torch.tensor([0, 250, 500, 999], device="cuda")
    code = torch.as_tensor(grid_code(8, 3), device="cuda")
    inject = {"indices": np.stack([rng.permutation(9) for _ in range(4)]),
              "noise_x": rng.standard_normal((4, 48, 48, 3)).astype(np.float32),
              "noise_c": rng.standard_normal((4, 9, 8)).astype(np.float32)}

    def grads():
        model.zero_grad(set_to_none=True)
        out = diff.training_losses(model, x, t, code, block_size=16, patch_size=16,
                                   _inject=inject)
        out["loss"].mean().backward()
        return {k: p.grad.clone() for k, p in model.named_parameters()}

    launches = port.attention_bwd.launches
    mine = grads()
    assert port.attention_bwd.launches == launches + cfg.depth
    kernel_route = dit.fused_qkv_attention
    dit.fused_qkv_attention = port.fused_qkv_attention_reference
    try:
        plain = grads()
    finally:
        dit.fused_qkv_attention = kernel_route
    assert mine["blocks.0.attn.qkv.weight"].abs().max() > 0
    for k, want in plain.items():
        scale = want.abs().max().item()
        err = (mine[k] - want).abs().max().item()
        assert err <= 1e-4 * scale + 1e-12, (k, err, scale)


def test_k2_cuda_wrapper_refuses_what_the_kernel_cannot_take(cuda):
    def call(n=9, dtype=torch.bfloat16, do_dtype=None, out_stride_mismatch=False,
             instance=None):
        qkv = torch.zeros((1, n, 3 * 2 * 64), device="cuda", dtype=dtype)
        heads = qkv.reshape(1, n, 3, 2, 64).permute(2, 0, 3, 1, 4).unbind(0)
        do = torch.zeros((1, 2, n, 64), device="cuda", dtype=do_dtype or dtype)
        out = [torch.empty_like(qkv).reshape(1, n, 3, 2, 64).permute(2, 0, 3, 1, 4)[i]
               for i in range(3)]
        if out_stride_mismatch:
            out[2] = torch.empty((1, 2, n, 64), device="cuda", dtype=dtype)
        port.attention_bwd(*heads, do, out=out, instance=instance)

    q96 = torch.zeros((1, 2, 9, 96), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"Dh in \(64, 72\)"):
        port.attention_bwd(q96, q96, q96, q96, out=(q96, q96, q96))
    with pytest.raises(ValueError, match="dtype"):
        call(do_dtype=torch.float32)
    with pytest.raises(ValueError, match="share strides"):
        call(out_stride_mismatch=True)
    with pytest.raises(ValueError, match="shared memory"):
        # the fp32 whole-row instance keeps dK, dV in shared memory: N <= 164
        call(n=165, dtype=torch.float32, instance="whole")
    call(n=165, dtype=torch.float32)  # the streaming instance takes it
    call(n=164, dtype=torch.float32)
    call(n=206)  # bf16 streams through fixed rings: no limit of N
    call(n=400)
    q = torch.zeros((1, 2, 149, 72), device="cuda", dtype=torch.float32)
    with pytest.raises(ValueError, match="shared memory"):
        port.attention_bwd(q, q, q, q, out=(q.clone(), q.clone(), q.clone()),
                           instance="whole")  # Dh 72: N <= 148
    for d in port.HEAD_DIMS:
        for n, elem in ((9, 2), (400, 2), (148, 4), (149, 4), (164, 4), (165, 4)):
            assert port.k2_smem_bytes(n, elem, d) == \
                port._bwd_kernel(d).k2_attention_bwd_smem_bytes(n, elem)


def _fused(b, n, dtype, gen, d=64):
    heads = HEADS[d]
    qkv = torch.randn((b, n, 3 * heads * d), generator=gen, device="cuda").to(dtype)
    return qkv.reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4).unbind(0)


# (B, N, dtype, Dh): N = 9, 63, 65, 77 and 401 leave the last 64-row chunk
# and the last 64-row tile ragged; 64 is one whole tile; 400 the grid-20
# step's; 576 DiT-XL/8's at 192 px (Dh 72).
_FLASH_CASES = [(4, 400, torch.bfloat16, 64), (3, 77, torch.bfloat16, 64),
                (2, 401, torch.bfloat16, 64), (2, 200, torch.float32, 64),
                (2, 9, torch.bfloat16, 64), (2, 63, torch.bfloat16, 64),
                (2, 64, torch.bfloat16, 64), (2, 65, torch.bfloat16, 64),
                (8, 576, torch.bfloat16, 72), (3, 77, torch.bfloat16, 72),
                (2, 65, torch.bfloat16, 72), (2, 9, torch.bfloat16, 72),
                (2, 200, torch.float32, 72)]


@pytest.mark.parametrize("b,n,dtype,d", _FLASH_CASES)
def test_k4_cuda_kernel_matches_plain(cuda, b, n, dtype, d):
    """The output also holds to the plain version over the whole row (the
    tiles round exp(S - m) against the running max: within the same
    tolerance)."""
    gen = torch.Generator("cuda").manual_seed(n + 2)
    q, k, v = _fused(b, n, dtype, gen, d)
    before = flash.flash_attention_fwd.launches
    o, lse = flash.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert flash.flash_attention_fwd.launches == before + 1
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    ref_o, ref_lse = flash.flash_attention_fwd_reference(q, k, v, flash.BLOCK_K)
    assert (o.float() - ref_o.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    row_o, _ = flash.flash_attention_fwd_reference(q, k, v)
    assert (o.float() - row_o.float()).abs().max().item() <= tol


@pytest.mark.parametrize("b,n,dtype,d", [(4, 400, torch.bfloat16, 64),
                                         (3, 77, torch.bfloat16, 64),
                                         (2, 200, torch.float32, 64),
                                         (8, 576, torch.bfloat16, 72),
                                         (2, 200, torch.float32, 72)])
def test_k4_cuda_kernel_is_bit_equal_across_calls(cuda, b, n, dtype, d):
    """One owning accumulator per output, chunks in a fixed order, no
    atomics: the train step's forward repeats itself bit for bit."""
    q, k, v = _fused(b, n, dtype, torch.Generator("cuda").manual_seed(n + 7), d)
    o1, lse1 = flash.flash_attention_fwd(q, k, v)
    o2, lse2 = flash.flash_attention_fwd(q, k, v)
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)


@pytest.mark.parametrize("b,n,d", [(3, 77, 64), (2, 400, 64), (3, 77, 72)])
def test_k4_cuda_kernel_reads_views_off_16_byte_alignment(cuda, b, n, d):
    """q, k, v rows that do not start on 16 bytes (pair-aligned views the
    wrapper admits) are read without cp.async: the same bits as from
    aligned copies, and within the tolerance of the plain version."""
    q, k, v = _k1_views(b, n, torch.bfloat16, torch.Generator("cuda").manual_seed(n + 8), 2, d)
    f = 3 * HEADS[d] * d
    assert q.data_ptr() % 16 and q.stride()[:3] == (n * f, d, f)
    o, lse = flash.flash_attention_fwd(q, k, v)
    o_al, lse_al = flash.flash_attention_fwd(*(t.contiguous() for t in (q, k, v)))
    assert torch.equal(o, o_al) and torch.equal(lse, lse_al)
    ref_o, ref_lse = flash.flash_attention_fwd_reference(q, k, v, flash.BLOCK_K)
    assert (o.float() - ref_o.float()).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-4


@pytest.mark.parametrize("b,n,dtype,d", _FLASH_CASES)
def test_k5_k6_cuda_kernels_match_plain(cuda, b, n, dtype, d):
    """The cases of K4's test."""
    gen = torch.Generator("cuda").manual_seed(n + 3)
    q, k, v = _fused(b, n, dtype, gen, d)
    o, lse = flash.flash_attention_fwd_reference(q, k, v, flash.BLOCK_K)
    h = HEADS[d]
    do = torch.randn((b, n, h * d), generator=gen, device="cuda").to(dtype)
    do = do.view(b, n, h, d).transpose(1, 2)
    out = _fused_grads(b, n, dtype, d)
    before = (flash.flash_dq.launches, flash.flash_dkv.launches)
    flash.flash_attention_bwd(q, k, v, o, lse, do, out=out)
    torch.cuda.synchronize()
    assert (flash.flash_dq.launches, flash.flash_dkv.launches) == (before[0] + 1,
                                                                   before[1] + 1)
    for got, want in zip(out, flash.flash_attention_bwd_reference(q, k, v, o, lse, do)):
        scale = want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= K2_TOL[dtype] * scale, (err, scale)


def _flash_bwd_inputs(b, n, dtype, gen, offset=0, d=64):
    """q, k, v as strided views of a fused qkv ``offset`` elements into its
    buffer, O and the LSE of the plain forward, dO as a view of a
    (B, N, H*Dh) gradient."""
    q, k, v = _k1_views(b, n, dtype, gen, offset, d)
    o, lse = flash.flash_attention_fwd_reference(q, k, v, flash.BLOCK_K)
    h = HEADS[d]
    do = torch.randn((b, n, h * d), generator=gen, device="cuda").to(dtype)
    return q, k, v, o, lse, do.view(b, n, h, d).transpose(1, 2)


def _fused_grads(b, n, dtype, d=64):
    """dq, dk, dv as the slots of one fused (B, N, 3*H*Dh) gradient buffer."""
    h = HEADS[d]
    buf = torch.empty((b, n, 3 * h * d), dtype=dtype, device="cuda")
    return buf.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)


@pytest.mark.parametrize("b,n,dtype,d", [(4, 400, torch.bfloat16, 64),
                                         (3, 77, torch.bfloat16, 64),
                                         (2, 200, torch.float32, 64),
                                         (8, 576, torch.bfloat16, 72),
                                         (3, 77, torch.bfloat16, 72),
                                         (2, 200, torch.float32, 72)])
def test_k5_k6_cuda_kernels_are_bit_equal_across_calls(cuda, b, n, dtype, d):
    """One owning accumulator per output, chunks in a fixed order, no
    atomics: a resumed train run repeats the uninterrupted one."""
    args = _flash_bwd_inputs(b, n, dtype, torch.Generator("cuda").manual_seed(n + 5), d=d)
    first = flash.flash_attention_bwd(*args, out=_fused_grads(b, n, dtype, d))
    second = flash.flash_attention_bwd(*args, out=_fused_grads(b, n, dtype, d))
    for a, c in zip(first, second):
        assert torch.equal(a, c)


@pytest.mark.parametrize("b,n,d", [(3, 77, 64), (2, 400, 64), (3, 77, 72)])
def test_k5_k6_cuda_kernels_read_views_off_16_byte_alignment(cuda, b, n, d):
    """q, k, v rows that do not start on 16 bytes (pair-aligned views the
    wrappers admit) are staged without cp.async: the same bits as from
    aligned copies, and within the tolerance of the plain version."""
    q, k, v, o, lse, do = _flash_bwd_inputs(b, n, torch.bfloat16,
                                            torch.Generator("cuda").manual_seed(n + 6), 2, d)
    f = 3 * HEADS[d] * d
    assert q.data_ptr() % 16 and q.stride()[:3] == (n * f, d, f)
    got = flash.flash_attention_bwd(q, k, v, o, lse, do, out=_fused_grads(b, n, q.dtype, d))
    aligned = [t.contiguous() for t in (q, k, v)]
    want = flash.flash_attention_bwd(*aligned, o, lse, do, out=_fused_grads(b, n, q.dtype, d))
    for g, w, ref in zip(got, want, flash.flash_attention_bwd_reference(q, k, v, o, lse, do)):
        assert torch.equal(g, w)
        scale = ref.float().abs().max().item()
        assert (g.float() - ref.float()).abs().max().item() <= K2_TOL[q.dtype] * scale


def test_flash_cuda_wrappers_refuse_what_the_kernels_cannot_take(cuda):
    q = torch.zeros((1, 2, 9, 32), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"Dh in \(64, 72\)"):
        flash.flash_attention_fwd(q, q, q)
    q = torch.zeros((1, 2, 9, 64), device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash.flash_attention_fwd(q, q, q)
    q = torch.zeros((1, 2, 9, 64), device="cuda", dtype=torch.bfloat16)
    lse = torch.zeros((1, 2, 9), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="lse"):
        flash.flash_attention_bwd(q, q, q, q, lse, q, out=(q.clone(), q.clone(), q.clone()))
    long = torch.zeros((1, 2, 4096, 64), device="cuda", dtype=torch.bfloat16)
    o, lse = flash.flash_attention_fwd(long, long, long)  # no length limit
    assert o.shape == long.shape and lse.shape == (1, 2, 4096)


@pytest.mark.parametrize("hidden,attn_impl", [(128, "flash"), (144, None), (144, "pallas")],
                         ids=["dh64-flash", "dh72-auto", "dh72-pallas"])
def test_dit_gradients_through_k4_k5_k6_match_plain_autograd(cuda, hidden, attn_impl):
    """At Dh 72 the default route with grad is flash
    (``WHOLE_ROW_GRAD_MAX_N[72]``); ``"pallas"`` takes K1 forward and K2
    backward instead, held to the same plain autograd."""
    model, cfg = create_model("JPDVT", 96, seed=0, depth=2, hidden_size=hidden,
                              num_heads=2, attn_impl=attn_impl)
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(0.05 * rng.standard_normal(p.shape).astype(np.float32)))
    diff = create_diffusion("")
    x = torch.from_numpy(rng.uniform(-1, 1, (4, 96, 96, 3)).astype(np.float32)).cuda()
    t = torch.tensor([0, 250, 500, 999], device="cuda")
    code = torch.as_tensor(grid_code(8, 6), device="cuda")
    inject = {"indices": np.stack([rng.permutation(36) for _ in range(4)]),
              "noise_x": rng.standard_normal((4, 96, 96, 3)).astype(np.float32),
              "noise_c": rng.standard_normal((4, 36, 8)).astype(np.float32)}

    def grads():
        model.zero_grad(set_to_none=True)
        out = diff.training_losses(model, x, t, code, block_size=16, patch_size=16,
                                   grid_size=6, _inject=inject)
        out["loss"].mean().backward()
        return {k: p.grad.clone() for k, p in model.named_parameters()}

    pallas = attn_impl == "pallas"
    counters = ((port.attention, port.attention_bwd) if pallas else
                (flash.flash_attention_fwd, flash.flash_dq, flash.flash_dkv))
    launches = tuple(fn.launches for fn in counters)
    mine = grads()
    assert tuple(fn.launches for fn in counters) == tuple(x + cfg.depth for x in launches)
    route = "fused_qkv_attention" if pallas else "fused_qkv_flash_attention"
    kernel_route = getattr(dit, route)
    setattr(dit, route, port.fused_qkv_attention_reference)
    try:
        plain = grads()
    finally:
        setattr(dit, route, kernel_route)
    assert mine["blocks.0.attn.qkv.weight"].abs().max() > 0
    for k, want in plain.items():
        scale = want.abs().max().item()
        err = (mine[k] - want).abs().max().item()
        assert err <= 1e-4 * scale + 1e-12, (k, err, scale)


def _block_operands(b, n, dtype, gen, heads=12, hidden=768, d=64):
    x = torch.randn((b, n, hidden), generator=gen, device="cuda").to(dtype)
    w_qkv = (torch.randn((3 * heads, hidden, d), generator=gen, device="cuda")
             * hidden ** -0.5).to(dtype)
    b_qkv = 0.1 * torch.randn((3 * heads, 1, d), generator=gen, device="cuda")
    w_proj = (torch.randn((heads, d, hidden), generator=gen, device="cuda")
              * (heads * d) ** -0.5).to(dtype)
    b_proj = 0.1 * torch.randn((1, hidden), generator=gen, device="cuda")
    return x, w_qkv, b_qkv, w_proj, b_proj


@pytest.mark.parametrize("b,n,dtype,d", [(4, 144, torch.bfloat16, 64),
                                         (2, 400, torch.bfloat16, 64),
                                         (3, 77, torch.bfloat16, 64),
                                         (2, 401, torch.bfloat16, 64),
                                         (3, 17, torch.bfloat16, 64),
                                         (5, 17, torch.bfloat16, 64),
                                         (2, 416, torch.bfloat16, 64),
                                         (2, 144, torch.float32, 64),
                                         (2, 200, torch.float32, 64),
                                         (32, 144, torch.bfloat16, 72),
                                         (3, 77, torch.bfloat16, 72),
                                         (5, 17, torch.bfloat16, 72),
                                         (2, 336, torch.bfloat16, 72),
                                         (2, 144, torch.float32, 72),
                                         (2, 223, torch.float32, 72)])
def test_k3_cuda_kernel_matches_plain(cuda, b, n, dtype, d):
    """N not a multiple of the 16-row tiles (17, 77, 401); B N not a
    multiple of A.2's 128-row tile (85, 231, 802); the short-row instance's
    bf16 limit (416 at Dh 64, 336 at 72) and fp32's at 72 (223); at Dh 72
    DiT-XL's width (16 heads, D = 1152), its 96 px solve at B = 32, N =
    144. The instance ``k3_instance`` takes (the long-row one at every N
    since its ``wgmma`` design), and the short-row one, which takes each N
    here."""
    gen = torch.Generator("cuda").manual_seed(n + 4)
    heads, hidden = (12, 768) if d == 64 else (16, 1152)
    ops = _block_operands(b, n, dtype, gen, heads, hidden, d)
    want = port.fused_attention_block_plain(*ops, heads).float()
    scale = want.abs().max().item()
    for instance in (None, "short"):
        before = port.fused_attention_block_k3.launches
        out = port.fused_attention_block_k3(*ops, heads, instance=instance)
        torch.cuda.synchronize()
        assert port.fused_attention_block_k3.launches == before + 1
        err = (out.float() - want).abs().max().item()
        assert err <= (2e-2 if dtype == torch.bfloat16 else 1e-5) * scale, (instance, err, scale)
        again = port.fused_attention_block_k3(*ops, heads, instance=instance)
        assert torch.equal(out, again)  # deterministic: no atomics


# (B, N, dtype, Dh, heads, hidden): past the short-row instance's shared
# memory, where the JAX rule runs its kernel (the flagship's grid 24, N =
# 576; DiT-S and DiT-B to their rule's ends, 855 and 593; fp32 750 and 256),
# ragged N, and DiT-XL's width past 336.
@pytest.mark.parametrize("b,n,dtype,d,heads,hidden", [
    (8, 576, torch.bfloat16, 64, 12, 768), (4, 855, torch.bfloat16, 64, 6, 384),
    (2, 593, torch.bfloat16, 64, 12, 768), (3, 417, torch.bfloat16, 64, 12, 768),
    (2, 750, torch.float32, 64, 6, 384), (2, 256, torch.float32, 64, 12, 768),
    (2, 337, torch.bfloat16, 72, 16, 1152), (2, 577, torch.bfloat16, 72, 16, 1152),
    (2, 300, torch.float32, 72, 16, 1152)])
def test_k3_long_cuda_kernel_matches_plain(cuda, b, n, dtype, d, heads, hidden):
    gen = torch.Generator("cuda").manual_seed(n + 5)
    ops = _block_operands(b, n, dtype, gen, heads, hidden, d)
    elem = torch.empty((), dtype=dtype).element_size()
    assert port.k3_smem_bytes(n, elem, d) > port.HOPPER_MAX_SMEM  # the long-row instance
    before = port.fused_attention_block_k3.launches
    out = port.fused_attention_block_k3(*ops, heads)
    assert port.fused_attention_block_k3.launches == before + 1
    want = port.fused_attention_block_plain(*ops, heads).float()
    scale = want.abs().max().item()
    err = (out.float() - want).abs().max().item()
    assert err <= (2e-2 if dtype == torch.bfloat16 else 1e-5) * scale, (err, scale)
    assert torch.equal(out, port.fused_attention_block_k3(*ops, heads))


@pytest.mark.parametrize("b,n,dtype,d", [(4, 144, torch.bfloat16, 64),
                                         (2, 400, torch.bfloat16, 64),
                                         (3, 77, torch.bfloat16, 64),
                                         (2, 416, torch.bfloat16, 64),
                                         (5, 17, torch.bfloat16, 72),
                                         (2, 144, torch.bfloat16, 72),
                                         (2, 336, torch.bfloat16, 72),
                                         (2, 144, torch.float32, 64),
                                         (2, 252, torch.float32, 64),
                                         (2, 223, torch.float32, 72)])
def test_k3_long_instance_is_bit_equal_to_the_short_one(cuda, b, n, dtype, d):
    """Where both fit: the same arithmetic in the same order."""
    gen = torch.Generator("cuda").manual_seed(n + 6)
    heads, hidden = (12, 768) if d == 64 else (16, 1152)
    ops = _block_operands(b, n, dtype, gen, heads, hidden, d)
    short = port.fused_attention_block_k3(*ops, heads, instance="short")
    long = port.fused_attention_block_k3(*ops, heads, instance="long")
    assert torch.equal(short, long)


# Both sides of the bf16 long-row instance's switch from k and v whole in
# shared memory to k and v streamed through a ring (N 896 | 897 at Dh 64,
# 704 | 705 at Dh 72).
@pytest.mark.parametrize("b,n,d,heads,hidden", [
    (2, 896, 64, 6, 384), (2, 897, 64, 6, 384), (2, 704, 72, 16, 1152),
    (2, 705, 72, 16, 1152)])
def test_k3_long_cuda_kernel_matches_plain_across_its_kv_switch(cuda, b, n, d, heads, hidden):
    assert port.k3_long_kv_whole(n, d) == (n in (896, 704))
    gen = torch.Generator("cuda").manual_seed(n + 8)
    ops = _block_operands(b, n, torch.bfloat16, gen, heads, hidden, d)
    out = port.fused_attention_block_k3(*ops, heads)
    assert port.k3_instance(n, torch.bfloat16, d) == "long"
    want = port.fused_attention_block_plain(*ops, heads).float()
    scale = want.abs().max().item()
    err = (out.float() - want).abs().max().item()
    assert err <= 2e-2 * scale, (err, scale)
    assert torch.equal(out, port.fused_attention_block_k3(*ops, heads))


@pytest.mark.parametrize("n,d,heads,hidden", [(576, 64, 12, 768), (144, 72, 16, 1152)])
def test_k3_long_item_alone_equals_the_item_in_a_batch(cuda, n, d, heads, hidden):
    """No step's arithmetic depends on B or on the block that computes it:
    an item alone gives the bits it gets inside a batch of 32 (L.1 takes
    rows across items)."""
    gen = torch.Generator("cuda").manual_seed(n + 10)
    x, *weights = _block_operands(32, n, torch.bfloat16, gen, heads, hidden, d)
    batch = port.fused_attention_block_k3(x, *weights, heads, instance="long")
    for i in (0, 13, 31):
        alone = port.fused_attention_block_k3(x[i:i + 1].contiguous(), *weights, heads,
                                              instance="long")
        assert torch.equal(alone[0], batch[i]), i


def test_k3_long_operands_are_never_taken_from_its_caches(cuda):
    """The long-row instance keeps its tensor maps by address and shape: two
    layers' weights taken in turn, fewer rows of x at x's address, and new
    weights written over a layer's give each call its own operands' output."""
    gen = torch.Generator("cuda").manual_seed(11)

    def laid_out(w_qkv, b_qkv, w_proj, b_proj):  # K3's layout: no copy a call
        qkv_strides, proj_strides = port._weight_strides(w_qkv, w_proj)
        return (port._as_laid_out(w_qkv, qkv_strides), b_qkv,
                port._as_laid_out(w_proj, proj_strides), b_proj)

    x, *first = _block_operands(4, 576, torch.bfloat16, gen, 12, 768, 64)
    first = laid_out(*first)
    second = laid_out(*_block_operands(4, 576, torch.bfloat16, gen, 12, 768, 64)[1:])
    a = port.fused_attention_block_k3(x, *first, 12)
    b = port.fused_attention_block_k3(x, *second, 12)
    assert not torch.equal(a, b)
    assert torch.equal(port.fused_attention_block_k3(x, *first, 12), a)
    assert torch.equal(port.fused_attention_block_k3(x, *second, 12), b)
    assert torch.equal(port.fused_attention_block_k3(x[:2], *first, 12), a[:2])
    for mine, theirs in zip(first, second):
        mine.copy_(theirs)
    assert torch.equal(port.fused_attention_block_k3(x, *first, 12), b)


def test_k3_long_smem_mirror_is_the_kernels(cuda):
    """The route table's mirrors of the long-row instance's shared memory,
    of its k-and-v switch and of its scratch, at their boundaries, against
    the C functions."""
    for d, last_whole in ((64, 896), (72, 704)):
        lib = port._block_kernel(d)
        for n in (1, 16, 17, 144, 576, last_whole - 16, last_whole - 1, last_whole,
                  last_whole + 1, last_whole + 16, 1593, 1617, 4000):
            assert port.k3_long_kv_whole(n, d) == bool(lib.k3_attention_block_long_kv_whole(n))
            for elem in (2, 4):
                assert port.k3_long_smem_bytes(n, elem, d) == \
                    lib.k3_attention_block_long_smem_bytes(n, elem), (d, n, elem)
                assert port.k3_long_scratch_elems(3, n, 5, elem, d) == \
                    lib.k3_attention_block_long_scratch_elems(3, n, 5, elem)


@pytest.mark.parametrize("b,n,dtype,heads,hidden,core", [
    (2, 576, torch.bfloat16, 16, 1152, "k1"), (2, 600, torch.bfloat16, 12, 768, "k1"),
    (2, 300, torch.float32, 16, 1152, "k1"), (2, 400, torch.float32, 12, 768, "k4")])
def test_block_composition_cuda_matches_plain(cuda, b, n, dtype, heads, hidden, core):
    """Where the JAX rule composes: cuBLAS projections around K1 (K4 where
    K1's fp32 shared memory ends), no K3."""
    gen = torch.Generator("cuda").manual_seed(n + 9)
    ops = _block_operands(b, n, dtype, gen, heads, hidden, hidden // heads)
    assert not port.block_takes_k3(ops[0], ops[1], heads)
    counters = {"k1": port.attention, "k3": port.fused_attention_block_k3,
                "k4": flash.flash_attention_fwd}
    before = {k: f.launches for k, f in counters.items()}
    out = port.fused_attention_block(*ops, heads)
    launched = {k: f.launches - before[k] for k, f in counters.items()}
    assert launched == {"k1": 0, "k3": 0, "k4": 0, core: 1}, launched
    want = port.fused_attention_block_xla_plain(*ops, heads).float()
    scale = want.abs().max().item()
    err = (out.float() - want).abs().max().item()
    assert err <= (2e-2 if dtype == torch.bfloat16 else 1e-4) * scale, (err, scale)


@pytest.mark.parametrize("b,n,dtype,heads,hidden", [(2, 144, torch.bfloat16, 12, 768),
                                                    (3, 77, torch.bfloat16, 12, 768),
                                                    (2, 77, torch.float32, 12, 768),
                                                    (2, 144, torch.bfloat16, 16, 1152),
                                                    (2, 77, torch.float32, 16, 1152)])
def test_k3_cuda_kernel_takes_the_linear_weights_as_views(cuda, b, n, dtype, heads, hidden):
    """The DiT's operands: dense_to_block_weights' views of (out, in) Linear
    weights (the flagship's heads of 64, DiT-XL's of 72). The same result,
    bit for bit, as from contiguous copies of them, and two calls
    bit-equal."""
    gen = torch.Generator("cuda").manual_seed(n + 7)
    x = torch.randn((b, n, hidden), generator=gen, device="cuda").to(dtype)
    wq = (torch.randn((3 * hidden, hidden), generator=gen, device="cuda")
          * hidden ** -0.5).to(dtype)
    wp = (torch.randn((hidden, hidden), generator=gen, device="cuda") * hidden ** -0.5).to(dtype)
    bq = 0.1 * torch.randn(3 * hidden, generator=gen, device="cuda")
    bp = 0.1 * torch.randn(hidden, generator=gen, device="cuda")
    views = port.dense_to_block_weights(wq, bq, wp, bp, heads)
    assert views[0].data_ptr() == wq.data_ptr() and views[2].data_ptr() == wp.data_ptr()
    copies = [t.contiguous() for t in views]
    want = port.fused_attention_block_plain(x, *views, heads).float()
    scale = want.abs().max().item()
    for instance in ("short", "long"):
        out = port.fused_attention_block_k3(x, *views, heads, instance=instance)
        assert torch.equal(out, port.fused_attention_block_k3(x, *views, heads, instance=instance))
        assert torch.equal(out, port.fused_attention_block_k3(x, *copies, heads,
                                                              instance=instance))
        err = (out.float() - want).abs().max().item()
        assert err <= (2e-2 if dtype == torch.bfloat16 else 1e-5) * scale, (instance, err, scale)


def test_k3_gradient_is_autograd_of_the_plain_version(cuda):
    gen = torch.Generator("cuda").manual_seed(5)
    ops = [t.requires_grad_(True) for t in _block_operands(2, 77, torch.float32, gen,
                                                           heads=2, hidden=128)]
    g = torch.randn((2, 77, 128), generator=gen, device="cuda")
    before = port.fused_attention_block_k3.launches
    mine = torch.autograd.grad(port.fused_attention_block(*ops, 2), ops, g)
    assert port.fused_attention_block_k3.launches == before + 1
    want = torch.autograd.grad(port.fused_attention_block_xla_plain(*ops, 2), ops, g)
    for got, ref in zip(mine, want):
        scale = ref.abs().max().item()
        assert (got - ref).abs().max().item() <= 1e-5 * scale


def test_k3_cuda_wrapper_refuses_what_the_kernel_cannot_take(cuda):
    """Past the short-row instance's shared memory the long-row one takes N
    (bf16 at any N; fp32 while a query tile's score rows fit)."""
    gen = torch.Generator("cuda").manual_seed(6)
    for n, dtype, d in ((253, torch.float32, 64), (252, torch.float32, 64),
                        (417, torch.bfloat16, 64), (337, torch.bfloat16, 72),
                        (224, torch.float32, 72), (4000, torch.bfloat16, 64)):
        port.fused_attention_block_k3(*_block_operands(1, n, dtype, gen, heads=2, hidden=128,
                                                       d=d), 2)
    with pytest.raises(ValueError, match="long-row instance at N=1618 .*shared memory"):
        port.fused_attention_block_k3(*_block_operands(1, 1618, torch.float32, gen, heads=2,
                                                       hidden=128), 2)
    x, w_qkv, b_qkv, w_proj, b_proj = _block_operands(1, 9, torch.bfloat16, gen, heads=2,
                                                      hidden=128)
    with pytest.raises(ValueError, match="float32 biases"):
        port.fused_attention_block_k3(x, w_qkv, b_qkv.bfloat16(), w_proj, b_proj, 2)
    with pytest.raises(ValueError, match=r"Dh in \(64, 72\)"):
        port.fused_attention_block_k3(x, w_qkv[:, :, :32].contiguous(), b_qkv, w_proj, b_proj,
                                      2)
    with pytest.raises(ValueError, match="w_proj of shape"):
        port.fused_attention_block_k3(*_block_operands(1, 9, torch.bfloat16, gen, heads=2,
                                                       hidden=128, d=72)[:3], w_proj, b_proj, 2)
    for d, limits in ((64, (416, 252)), (72, (336, 223))):
        for n, dtype in ((limits[0], torch.bfloat16), (limits[0] + 1, torch.bfloat16),
                         (limits[1], torch.float32), (limits[1] + 1, torch.float32)):
            elem = torch.empty((), dtype=dtype).element_size()
            assert port.k3_smem_bytes(n, elem, d) == \
                port._block_kernel(d).k3_attention_block_smem_bytes(n, elem)


def test_dit_block_route_launches_k3_and_matches_the_default_route(cuda):
    model, cfg = create_model("JPDVT", 96, seed=0, depth=2, hidden_size=128,
                              num_heads=2, dtype=torch.bfloat16)
    block, _ = create_model("JPDVT", 96, seed=0, depth=2, hidden_size=128,
                            num_heads=2, dtype=torch.bfloat16, attn_impl="block")
    rng = np.random.default_rng(2)
    with torch.no_grad():
        for p, q in zip(model.parameters(), block.parameters()):
            w = torch.from_numpy(0.05 * rng.standard_normal(p.shape).astype(np.float32))
            p.copy_(w)
            q.copy_(w)
    x = torch.from_numpy(rng.uniform(-1, 1, (4, 96, 96, 3)).astype(np.float32)).cuda()
    t = torch.tensor([0, 250, 500, 999], device="cuda")
    code = torch.from_numpy(rng.standard_normal((4, 36, 8)).astype(np.float32)).cuda()
    with torch.no_grad():
        k1 = port.attention.launches
        _, want = model(x, t, code)
        launches = port.fused_attention_block_k3.launches
        _, got = block(x, t, code)
    assert port.fused_attention_block_k3.launches == launches + cfg.depth
    assert port.attention.launches == k1 + cfg.depth
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 3e-2 * scale


# --------------------------------------------- K1 and K2's fp32 streaming instances

@pytest.mark.parametrize("b,n,d", [(2, 342, 64), (2, 400, 64), (2, 576, 64), (1, 1296, 64),
                                   (3, 77, 64), (2, 9, 64), (2, 310, 72), (2, 576, 72),
                                   (3, 77, 72)])
def test_k1_streaming_instance_matches_plain(cuda, b, n, d):
    """fp32 past the whole-row instance's shared memory (342 at Dh 64, 310
    at 72) up to N = 1,296, and forced at N = 9 and 77 (ragged last chunk
    and tile): 1e-4 of the plain version, two calls bit-equal, each launch
    counted as the streaming instance's."""
    q, k, v = _k1_views(b, n, torch.float32, torch.Generator("cuda").manual_seed(n + 20), d=d)
    before = port.attention.streaming.launches, port.attention.launches
    out = port.attention(q, k, v, instance="streaming")
    torch.cuda.synchronize()
    assert (port.attention.streaming.launches, port.attention.launches) == (
        before[0] + 1, before[1])
    assert (out.float() - port.attention_reference(q, k, v)).abs().max().item() <= 1e-4
    assert torch.equal(out, port.attention(q, k, v, instance="streaming"))
    if port.fp32_instance(n, d) == "streaming":
        assert torch.equal(out, port.attention(q, k, v))


@pytest.mark.parametrize("n,d", [(144, 64), (341, 64), (144, 72), (309, 72)])
def test_k1_streaming_instance_matches_the_whole_row_one(cuda, n, d):
    """Where both fit: the same function, 1e-4 apart (the streaming
    instance rescales its row sums online)."""
    q, k, v = _k1_views(2, n, torch.float32, torch.Generator("cuda").manual_seed(n + 21), d=d)
    whole = port.attention(q, k, v, instance="whole")
    stream = port.attention(q, k, v, instance="streaming")
    assert (whole - stream).abs().max().item() <= 1e-4


@pytest.mark.parametrize("b,n,d", [(2, 165, 64), (2, 400, 64), (2, 576, 64), (3, 77, 64),
                                   (2, 9, 64), (2, 149, 72), (2, 576, 72), (3, 77, 72)])
def test_k2_streaming_instance_matches_plain(cuda, b, n, d):
    """fp32 past the whole-row instance's shared memory (165 at Dh 64, 149
    at 72), and forced at N = 9 and 77: 1e-5 of each gradient's largest
    magnitude, two calls bit-equal, views off nothing (fp32 pairs), each
    call counted as the streaming instance's."""
    args = _k2_inputs(b, n, torch.float32, torch.Generator("cuda").manual_seed(n + 22), d=d)
    before = port.attention_bwd.streaming.launches, port.attention_bwd.launches
    got = port.attention_bwd(*args, out=_fused_grads(b, n, torch.float32, d),
                             instance="streaming")
    torch.cuda.synchronize()
    assert (port.attention_bwd.streaming.launches, port.attention_bwd.launches) == (
        before[0] + 1, before[1])
    for g, want in zip(got, port.attention_bwd_reference(*args)):
        scale = want.abs().max().item()
        assert (g - want).abs().max().item() <= K2_TOL[torch.float32] * scale
    again = port.attention_bwd(*args, out=_fused_grads(b, n, torch.float32, d),
                               instance="streaming")
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("n,d", [(144, 64), (164, 64), (148, 72)])
def test_k2_streaming_instance_matches_the_whole_row_one(cuda, n, d):
    args = _k2_inputs(2, n, torch.float32, torch.Generator("cuda").manual_seed(n + 23), d=d)
    whole = port.attention_bwd(*args, out=_fused_grads(2, n, torch.float32, d), instance="whole")
    stream = port.attention_bwd(*args, out=_fused_grads(2, n, torch.float32, d),
                                instance="streaming")
    for w, s_ in zip(whole, stream):
        assert (w - s_).abs().max().item() <= K2_TOL[torch.float32] * w.abs().max().item()


def test_dit_gradients_on_pallas_in_fp32_at_n400_take_the_streaming_instances(cuda):
    """A 2-block DiT at 320 px (N = 400) in fp32 on ``pallas``: K1 and K2's
    streaming instances, 2 launches of each, its gradients within 1e-4 of
    plain autograd's (summation order through two blocks)."""
    model, cfg = create_model("JPDVT", 320, seed=0, depth=2, hidden_size=128, num_heads=2,
                              attn_impl="pallas")
    gen = torch.Generator("cuda").manual_seed(5)
    x = torch.rand((2, 320, 320, 3), generator=gen, device="cuda") * 2 - 1
    t = torch.tensor([3, 900], device="cuda")
    code = torch.randn((2, 400, 8), generator=gen, device="cuda")

    def grads():
        model.zero_grad(set_to_none=True)
        img, c = model(x, t, code)
        (img.square().mean() + c.square().mean()).backward()
        return {k: p.grad.clone() for k, p in model.named_parameters()}

    before = port.attention.streaming.launches, port.attention_bwd.streaming.launches
    mine = grads()
    assert (port.attention.streaming.launches - before[0],
            port.attention_bwd.streaming.launches - before[1]) == (cfg.depth, cfg.depth)
    kernel_route = dit.fused_qkv_attention
    dit.fused_qkv_attention = port.fused_qkv_attention_reference
    try:
        plain = grads()
    finally:
        dit.fused_qkv_attention = kernel_route
    for k, want in plain.items():
        assert (mine[k] - want).abs().max().item() <= 1e-4 * want.abs().max().item() + 1e-12, k


@pytest.mark.parametrize("impl", ["xla", "xla_split"])
def test_xla_settings_forward_on_k1_and_backward_on_plain_autograd(cuda, impl):
    """``xla`` and ``xla_split`` on the card in bf16: 2 K1 a forward of a
    2-block DiT and no K2; its gradients those of the same model on the CPU
    within 2^-4 of each gradient's largest magnitude (K1 and the plain
    forward round P at other points, and bf16 activations carry that
    through two blocks and the backward)."""
    model, cfg = create_model("JPDVT", 48, seed=0, depth=2, hidden_size=128, num_heads=2,
                              attn_impl=impl, dtype=torch.bfloat16, device="cpu")
    gen = torch.Generator().manual_seed(6)
    x = torch.rand((2, 48, 48, 3), generator=gen) * 2 - 1
    t = torch.tensor([3, 900])
    code = torch.randn((2, 9, 8), generator=gen)

    def grads(m, device):
        m.zero_grad(set_to_none=True)
        img, c = m(x.to(device), t.to(device), code.to(device))
        (img.float().square().mean() + c.float().square().mean()).backward()
        # copies: moving the model moves its gradients' storage in place
        return {k: p.grad.float().cpu().clone() for k, p in m.named_parameters()}

    cpu = grads(model, "cpu")
    model.cuda()
    before = port.attention.launches, port.attention_bwd.launches
    card = grads(model, "cuda")
    assert (port.attention.launches - before[0], port.attention_bwd.launches - before[1]) == (
        cfg.depth, 0)
    for k, want in cpu.items():
        assert (card[k] - want).abs().max().item() <= 2 ** -4 * want.abs().max().item() + 1e-12, k


@pytest.mark.parametrize("d", [64, 72])
def test_xla_backward_runs_no_tf32(cuda, d):
    """The ``xla`` backward recomputes its plain version from qkv, so on the
    card under ``matmul_precision=high`` (TF32 for fp32 products) its bf16
    gradient is the CPU's but for summation order: at most 1% of elements
    differ, by at most 2^-6 of scale. TF32 would round dS to 10 bits before
    dS K and dS^T q and move about a tenth of them."""
    gen = torch.Generator().manual_seed(d)
    qkv = torch.randn((2, 144, 3 * 2 * d), generator=gen).bfloat16()
    g = torch.randn((2, 144, 2 * d), generator=gen).bfloat16()
    grads = []
    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        for device in ("cpu", "cuda"):
            leaf = qkv.to(device).detach().requires_grad_(True)
            port.fused_qkv_attention_xla(leaf, 2).backward(g.to(device))
            grads.append(leaf.grad.float().cpu())
    finally:
        torch.set_float32_matmul_precision(precision)
    assert torch.get_float32_matmul_precision() == precision
    cpu, card = grads
    assert (cpu != card).float().mean().item() <= 0.01
    assert (cpu - card).abs().max().item() <= 2 ** -6 * cpu.abs().max().item()
