"""Device selection for the port's entry points.

Counterpart of ``jpdvt_mt_ntnu_tpu/utils/platform.py``: there JAX picks the
platform; here every entry point resolves its ``device=`` argument through
:func:`default_device`. The port runs on the card; the CPU is used only
when the caller asks for it, so a missing card is an error and never a
quiet fallback. A rank of a multi-process run takes :func:`rank_device`;
:func:`apply_matmul_precision` is ``model.matmul_precision``.
"""

from __future__ import annotations

import torch


def default_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> the current CUDA device (raises without a card); anything
    else as given, with a CUDA device's index made explicit."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but no CUDA device is available; pass "
            "device='cpu' to run the port's plain PyTorch path on the CPU")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def rank_device(local_rank: int, device_count: int | None = None) -> torch.device:
    """The card of the process with ``local_rank`` on its host:
    ``cuda:(local_rank % device_count)``, so ranks share cards where the
    host has fewer cards than ranks (raises without a card)."""
    count = torch.cuda.device_count() if device_count is None else device_count
    if count < 1:
        raise RuntimeError("the cards were asked for but no CUDA device is available; "
                           "pass device=cpu to run on the CPU")
    return torch.device("cuda", local_rank % count)


# JAX's precision names -> torch.set_float32_matmul_precision.
MATMUL_PRECISION = {None: "highest", "highest": "highest", "float32": "highest",
                    "high": "high", "tensorfloat32": "high",
                    "default": "medium", "bfloat16": "medium"}


def apply_matmul_precision(precision: str | None) -> str:
    """Set the precision of float32 matrix products, the counterpart of
    ``jpdvt_mt_ntnu_tpu/utils/platform.py:15-21`` (``model.matmul_precision``),
    and return torch's name for it:

    ===============================  ===========  ===============================
    ``model.matmul_precision``       torch        fp32 products on the card
    ===============================  ===========  ===============================
    None, ``highest``, ``float32``   ``highest``  fp32 (TF32 off)
    ``high``, ``tensorfloat32``      ``high``     TF32 tensor cores
    ``default``, ``bfloat16``        ``medium``   TF32 tensor cores, as ``high``
    ===============================  ===========  ===============================

    torch runs ``medium`` in bf16 only where it has a bf16 algorithm for
    an fp32 product, and cuBLAS has none: on an H100 (80GB HBM3, 700 W)
    ``default`` ran the same ``tf32`` GEMM kernels as ``high``
    (``chip_smoke.py`` phase 16 names them). None keeps the port's rule of
    exact fp32 products. It touches only float32 compute: bf16 products
    are bf16 at every setting. cuDNN's TF32 follows (``high`` and
    ``medium`` allow it)."""
    if precision not in MATMUL_PRECISION:
        raise ValueError(f"model.matmul_precision={precision!r}: one of "
                         f"{sorted(k for k in MATMUL_PRECISION if k)} or None")
    name = MATMUL_PRECISION[precision]
    torch.set_float32_matmul_precision(name)
    torch.backends.cudnn.allow_tf32 = name != "highest"
    return name
