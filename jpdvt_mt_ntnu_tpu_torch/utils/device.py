"""Device selection for the port's entry points.

Counterpart of ``jpdvt_mt_ntnu_tpu/utils/platform.py``: there JAX picks the
platform; here every entry point resolves its ``device=`` argument through
:func:`default_device`. The port runs on the card; the CPU is used only
when the caller asks for it, so a missing card is an error and never a
quiet fallback.
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
