"""Kernel K1 on the card against its plain version.

Skips without a CUDA card. This file imports no JAX, so it also runs on a
GPU machine that has none; there ``tests/conftest.py`` (which imports JAX)
must be left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

Tolerances as in ``chip_smoke.py``: bf16 2e-2 absolute (one bf16 ulp of an
output of magnitude ~2 if exp or summation order flips a rounding), fp32
1e-4 (summation order).
"""

import pytest
import torch

from jpdvt_mt_ntnu_tpu_torch.ops import attention as port


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 is a CUDA kernel with no CPU mode")


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
