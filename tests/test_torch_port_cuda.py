"""Kernels K1-K6 on the card against their plain versions, and
the DiT's gradients through them against plain autograd.

Skips without a CUDA card. This file imports no JAX, so it also runs on a
GPU machine that has none; there ``tests/conftest.py`` (which imports JAX)
must be left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

Tolerances as in ``chip_smoke.py``: K1 bf16 2e-2 absolute (one bf16 ulp of
an output of magnitude ~2 if exp or summation order flips a rounding),
fp32 1e-4 (summation order). K2, relative to each gradient's largest
magnitude: bf16 2^-6 (a summation order that flips the bf16 rounding of dS
or of an output moves it by one ulp, 2^-8 of its scale), fp32 1e-5.
The DiT's gradients with K1/K2 against plain autograd in fp32: 1e-4 of
each gradient's largest magnitude (K2 rounds nothing in fp32; the two
differ by summation order through twelve blocks).

K4 against its plain version at the kernel's own key tile (``BLOCK_K``):
as K1, 2e-2 absolute in bf16 (both round exp(S - m) per tile at the same
points; exp or summation order can flip one rounding by one ulp), 1e-4 in
fp32; the LSE 1e-4 absolute (fp32, summation order). K5 and K6 as K2. The
DiT's gradients through K4-K6 as through K1/K2.
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

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 and K2 are CUDA kernels with no CPU mode")


@pytest.mark.parametrize("b,n,dtype", [(16, 144, torch.bfloat16),
                                       (3, 77, torch.bfloat16),
                                       (2, 144, torch.float32)])
def test_k1_cuda_kernel_matches_plain(cuda, b, n, dtype):
    gen = torch.Generator("cuda").manual_seed(n)
    qkv = torch.randn((b, n, 3 * 12 * 64), generator=gen, device="cuda").to(dtype)
    q, k, v = qkv.reshape(b, n, 3, 12, 64).permute(2, 0, 3, 1, 4).unbind(0)
    before = port.attention.launches
    out = port.attention(q, k, v)
    torch.cuda.synchronize()
    assert port.attention.launches == before + 1
    err = (out.float() - port.attention_reference(q, k, v).float()).abs().max().item()
    assert err <= (2e-2 if dtype == torch.bfloat16 else 1e-4)


def test_k1_cuda_wrapper_refuses_what_the_kernel_cannot_take(cuda):
    q = torch.zeros((1, 2, 9, 32), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="Dh == 64"):
        port.attention(q, q, q)
    q = torch.zeros((1, 2, 9, 64), device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        port.attention(q, q, q)
    q = torch.zeros((1, 2, 4096, 64), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shared memory"):
        port.attention(q, q, q)


@pytest.mark.parametrize("b,n,dtype", [(32, 144, torch.bfloat16),
                                       (3, 77, torch.bfloat16),
                                       (2, 200, torch.bfloat16),
                                       (2, 144, torch.float32)])
def test_k2_cuda_kernel_matches_plain(cuda, b, n, dtype):
    gen = torch.Generator("cuda").manual_seed(n + 1)
    qkv = torch.randn((b, n, 3 * 12 * 64), generator=gen, device="cuda").to(dtype)
    do = torch.randn((b, n, 12 * 64), generator=gen, device="cuda").to(dtype)
    heads = qkv.reshape(b, n, 3, 12, 64).permute(2, 0, 3, 1, 4).unbind(0)
    dov = do.view(b, n, 12, 64).transpose(1, 2)
    buf = torch.empty_like(qkv)
    out = buf.view(b, n, 3, 12, 64).permute(2, 0, 3, 1, 4).unbind(0)
    before = port.attention_bwd.launches
    port.attention_bwd(*heads, dov, out=out)
    torch.cuda.synchronize()
    assert port.attention_bwd.launches == before + 1
    for got, want in zip(out, port.attention_bwd_reference(*heads, dov)):
        scale = want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= K2_TOL[dtype] * scale, (err, scale)


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
    def call(n=9, do_dtype=torch.bfloat16, out_stride_mismatch=False):
        qkv = torch.zeros((1, n, 3 * 2 * 64), device="cuda", dtype=torch.bfloat16)
        heads = qkv.reshape(1, n, 3, 2, 64).permute(2, 0, 3, 1, 4).unbind(0)
        do = torch.zeros((1, 2, n, 64), device="cuda", dtype=do_dtype)
        out = [torch.empty_like(qkv).reshape(1, n, 3, 2, 64).permute(2, 0, 3, 1, 4)[i]
               for i in range(3)]
        if out_stride_mismatch:
            out[2] = torch.empty((1, 2, n, 64), device="cuda", dtype=torch.bfloat16)
        port.attention_bwd(*heads, do, out=out)

    with pytest.raises(ValueError, match="dtype"):
        call(do_dtype=torch.float32)
    with pytest.raises(ValueError, match="share strides"):
        call(out_stride_mismatch=True)
    with pytest.raises(ValueError, match="shared memory"):
        call(n=206)
    call(n=205)


def _fused(b, n, dtype, gen, heads=12):
    qkv = torch.randn((b, n, 3 * heads * 64), generator=gen, device="cuda").to(dtype)
    return qkv.reshape(b, n, 3, heads, 64).permute(2, 0, 3, 1, 4).unbind(0)


@pytest.mark.parametrize("b,n,dtype", [(4, 400, torch.bfloat16),
                                       (3, 77, torch.bfloat16),
                                       (2, 401, torch.bfloat16),
                                       (2, 200, torch.float32)])
def test_k4_cuda_kernel_matches_plain(cuda, b, n, dtype):
    gen = torch.Generator("cuda").manual_seed(n + 2)
    q, k, v = _fused(b, n, dtype, gen)
    before = flash.flash_attention_fwd.launches
    o, lse = flash.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert flash.flash_attention_fwd.launches == before + 1
    ref_o, ref_lse = flash.flash_attention_fwd_reference(q, k, v, flash.BLOCK_K)
    assert (o.float() - ref_o.float()).abs().max().item() <= (
        2e-2 if dtype == torch.bfloat16 else 1e-4)
    assert (lse - ref_lse).abs().max().item() <= 1e-4


@pytest.mark.parametrize("b,n,dtype", [(4, 400, torch.bfloat16),
                                       (3, 77, torch.bfloat16),
                                       (2, 401, torch.bfloat16),
                                       (2, 200, torch.float32)])
def test_k5_k6_cuda_kernels_match_plain(cuda, b, n, dtype):
    gen = torch.Generator("cuda").manual_seed(n + 3)
    q, k, v = _fused(b, n, dtype, gen)
    o, lse = flash.flash_attention_fwd_reference(q, k, v, flash.BLOCK_K)
    do = torch.randn((b, n, 12 * 64), generator=gen, device="cuda").to(dtype)
    do = do.view(b, n, 12, 64).transpose(1, 2)
    buf = torch.empty((b, n, 3 * 12 * 64), dtype=dtype, device="cuda")
    out = buf.view(b, n, 3, 12, 64).permute(2, 0, 3, 1, 4).unbind(0)
    before = (flash.flash_dq.launches, flash.flash_dkv.launches)
    flash.flash_attention_bwd(q, k, v, o, lse, do, out=out)
    torch.cuda.synchronize()
    assert (flash.flash_dq.launches, flash.flash_dkv.launches) == (before[0] + 1,
                                                                   before[1] + 1)
    for got, want in zip(out, flash.flash_attention_bwd_reference(q, k, v, o, lse, do)):
        scale = want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= K2_TOL[dtype] * scale, (err, scale)


def test_flash_cuda_wrappers_refuse_what_the_kernels_cannot_take(cuda):
    q = torch.zeros((1, 2, 9, 32), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="Dh == 64"):
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


def test_dit_gradients_through_k4_k5_k6_match_plain_autograd(cuda):
    model, cfg = create_model("JPDVT", 96, seed=0, depth=2, hidden_size=128,
                              num_heads=2, attn_impl="flash")
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

    launches = (flash.flash_attention_fwd.launches, flash.flash_dq.launches,
                flash.flash_dkv.launches)
    mine = grads()
    assert (flash.flash_attention_fwd.launches, flash.flash_dq.launches,
            flash.flash_dkv.launches) == tuple(x + cfg.depth for x in launches)
    kernel_route = dit.fused_qkv_flash_attention
    dit.fused_qkv_flash_attention = port.fused_qkv_attention_reference
    try:
        plain = grads()
    finally:
        dit.fused_qkv_flash_attention = kernel_route
    assert mine["blocks.0.attn.qkv.weight"].abs().max() > 0
    for k, want in plain.items():
        scale = want.abs().max().item()
        err = (mine[k] - want).abs().max().item()
        assert err <= 1e-4 * scale + 1e-12, (k, err, scale)


def _block_operands(b, n, dtype, gen, heads=12, hidden=768):
    x = torch.randn((b, n, hidden), generator=gen, device="cuda").to(dtype)
    w_qkv = (torch.randn((3 * heads, hidden, 64), generator=gen, device="cuda")
             * hidden ** -0.5).to(dtype)
    b_qkv = 0.1 * torch.randn((3 * heads, 1, 64), generator=gen, device="cuda")
    w_proj = (torch.randn((heads, 64, hidden), generator=gen, device="cuda")
              * (heads * 64) ** -0.5).to(dtype)
    b_proj = 0.1 * torch.randn((1, hidden), generator=gen, device="cuda")
    return x, w_qkv, b_qkv, w_proj, b_proj


@pytest.mark.parametrize("b,n,dtype", [(4, 144, torch.bfloat16),
                                       (2, 400, torch.bfloat16),
                                       (3, 77, torch.bfloat16),
                                       (2, 401, torch.bfloat16),
                                       (2, 144, torch.float32),
                                       (2, 200, torch.float32)])
def test_k3_cuda_kernel_matches_plain(cuda, b, n, dtype):
    gen = torch.Generator("cuda").manual_seed(n + 4)
    ops = _block_operands(b, n, dtype, gen)
    before = port.fused_attention_block.launches
    out = port.fused_attention_block(*ops, 12)
    torch.cuda.synchronize()
    assert port.fused_attention_block.launches == before + 1
    want = port.fused_attention_block_plain(*ops, 12).float()
    scale = want.abs().max().item()
    err = (out.float() - want).abs().max().item()
    assert err <= (2e-2 if dtype == torch.bfloat16 else 1e-5) * scale, (err, scale)
    again = port.fused_attention_block(*ops, 12)
    assert torch.equal(out, again)  # deterministic: no atomics


def test_k3_gradient_is_autograd_of_the_plain_version(cuda):
    gen = torch.Generator("cuda").manual_seed(5)
    ops = [t.requires_grad_(True) for t in _block_operands(2, 77, torch.float32, gen,
                                                           heads=2, hidden=128)]
    g = torch.randn((2, 77, 128), generator=gen, device="cuda")
    before = port.fused_attention_block.launches
    mine = torch.autograd.grad(port.fused_attention_block(*ops, 2), ops, g)
    assert port.fused_attention_block.launches == before + 1
    want = torch.autograd.grad(port.fused_attention_block_plain(*ops, 2), ops, g)
    for got, ref in zip(mine, want):
        scale = ref.abs().max().item()
        assert (got - ref).abs().max().item() <= 1e-5 * scale


def test_k3_cuda_wrapper_refuses_what_the_kernel_cannot_take(cuda):
    gen = torch.Generator("cuda").manual_seed(6)
    ops = _block_operands(1, 253, torch.float32, gen, heads=2, hidden=128)
    with pytest.raises(ValueError, match="shared memory"):
        port.fused_attention_block(*ops, 2)
    ops = _block_operands(1, 252, torch.float32, gen, heads=2, hidden=128)
    port.fused_attention_block(*ops, 2)
    x, w_qkv, b_qkv, w_proj, b_proj = _block_operands(1, 9, torch.bfloat16, gen, heads=2,
                                                      hidden=128)
    with pytest.raises(ValueError, match="float32 biases"):
        port.fused_attention_block(x, w_qkv, b_qkv.bfloat16(), w_proj, b_proj, 2)
    with pytest.raises(ValueError, match="Dh == 64"):
        port.fused_attention_block(x, w_qkv[:, :, :32].contiguous(), b_qkv, w_proj, b_proj, 2)
    for n, dtype in ((443, torch.bfloat16), (444, torch.bfloat16), (252, torch.float32),
                     (253, torch.float32)):
        elem = torch.empty((), dtype=dtype).element_size()
        assert port.k3_smem_bytes(n, elem) == \
            port._block_kernel().k3_attention_block_smem_bytes(n, elem)


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
        launches = port.fused_attention_block.launches
        _, got = block(x, t, code)
    assert port.fused_attention_block.launches == launches + cfg.depth
    assert port.attention.launches == k1 + cfg.depth
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 3e-2 * scale
