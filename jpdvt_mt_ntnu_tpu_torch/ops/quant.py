"""Int8 (w8a8) quantized matmuls for the solve and serving path.

Counterpart of ``jpdvt_mt_ntnu_tpu/ops/quant.py``. The scheme is symmetric
and scale-only:

- Weights: a scale per output channel, ``s_w = max|w| / 127`` over the
  input dim, ``w_q = round(w / s_w)`` in int8, from the fp32 parameters.
  The JAX package leaves the hoisting of this pass out of the sampler's
  loop to XLA; here the DiT's quantized ``Linear`` caches ``(w_q, s_w)``
  per parameter version (``models/dit.py``), so a solve quantizes each
  weight once.
- Activations: a dynamic scale per token, ``s_x = max|x| / 127`` over the
  feature dim (an all-zero row gets 1e-30 and quantizes to 0).
- Product: int8 x int8 -> int32 through ``torch._int_mm`` (cuBLASLt on
  the card), then ``out = acc * s_x * s_w + bias`` in fp32, cast to the
  output type.

Weights keep the port's ``Linear`` layout, (out, in), where the JAX
kernel is (in, out): the amax of an output channel is over ``dim=1``, and
``int8_matmul`` hands ``w_q.t()`` (column-major, no copy) to
``torch._int_mm``, the layout cuBLASLt's int8 path takes fastest. On the
card ``torch._int_mm`` needs more than 16 rows and inner and output dims
that are multiples of 8; the DiT's shapes (rows = batch x tokens, dims 768,
2304, 3072) meet them.

Rounding is ``torch.round`` (half to even, as ``jnp.round``) of a true
division, so the int8 values are the JAX package's.
"""

from __future__ import annotations

import torch

_QMAX = 127.0


def parse_quant_spec(spec) -> tuple:
    """A quantization spec -> (mode, depth_limit).

    - ``""`` / ``None`` -> ``(None, None)``: no quantization;
    - ``"int8"`` -> ``("int8", None)``: every block quantized;
    - ``"int8:K"`` -> ``("int8", K)``: only the first K blocks; the rest
      (and, as always, the final layer and code head) stay in the compute
      type.
    """
    if not spec:
        return None, None
    spec = str(spec)
    if ":" in spec:
        mode, _, k = spec.partition(":")
        try:
            limit = int(k)
        except ValueError:
            raise ValueError(f"bad quant spec {spec!r} (want e.g. 'int8:8')")
    else:
        mode, limit = spec, None
    if mode != "int8":
        raise ValueError(f"unknown quant mode {mode!r} (supported: int8)")
    return mode, limit


def quantize_channelwise(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 weight quantization per output channel.

    w: (d_out, d_in) float, a ``Linear`` weight. Returns (w_q int8
    (d_out, d_in), s_w float32 (d_out,)) with w ~= w_q * s_w[:, None]."""
    w = w.float()
    s_w = w.abs().amax(dim=1).clamp_min(1e-30) / _QMAX
    w_q = torch.round(w / s_w[:, None]).clamp(-_QMAX, _QMAX).to(torch.int8)
    return w_q, s_w


def quantize_rowwise(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 activation quantization per row (token).

    x: (..., d) float. Returns (x_q int8, s_x float32 (..., 1)) with
    x ~= x_q * s_x."""
    xf = x.float()
    s_x = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30) / _QMAX
    x_q = torch.round(xf / s_x).clamp(-_QMAX, _QMAX).to(torch.int8)
    return x_q, s_x


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """int8 (..., d_in) x int8 (d_out, d_in) -> int32 (..., d_out)."""
    out = torch._int_mm(x_q.reshape(-1, x_q.shape[-1]), w_q.t())
    return out.reshape(*x_q.shape[:-1], w_q.shape[0])


def int8_dense(x: torch.Tensor, w_q: torch.Tensor, s_w: torch.Tensor,
               bias: torch.Tensor, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Quantized ``x @ w.T + bias`` from a weight quantized by
    :func:`quantize_channelwise`. x (..., d_in) in any float type; output
    in ``out_dtype`` (default: x's type)."""
    out_dtype = out_dtype or x.dtype
    x_q, s_x = quantize_rowwise(x)
    acc = int8_matmul(x_q, w_q).float()
    return (acc * s_x * s_w + bias.float()).to(out_dtype)
