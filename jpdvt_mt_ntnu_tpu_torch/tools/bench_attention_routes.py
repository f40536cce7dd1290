"""The whole-row kernels against the flash kernels on the card, by sequence length.

For each N and batch, bf16, the JPDVT flagship's H = 12, Dh = 64 (or,
with ``--head-dim 72``, DiT-XL's H = 16, Dh = 72), q/k/v as strided views
of a fused (B, N, 3*H*Dh) projection (the DiT's layout): microseconds per
call by CUDA events of K1 against K4 (the no-grad forward), and of K1 + K2
against K4 + K5 + K6 (forward and backward, the train step's attention).
A route whose shared memory does not fit a block at that N is "n/a". The
table ``ops.attention.attention_route`` applies is printed beside each
row; ``WHOLE_ROW_GRAD_MAX_N`` of the head dim is set from these rows.
Prints one JSON line per (N, batch).

``--k3`` times K3's two instances instead (``ops.attention.
fused_attention_block_k3``: the short-row one where its shared memory
takes N, and the long-row one), on random weights at each registry width
(``--widths``: D 384, 768, 1024 with heads of 64, D 1152 with heads of 72),
in bf16 and fp32, the instances alternating over three rounds (the least
of each), with the instance ``ops.attention.k3_instance`` takes beside
them; ``k3_instance``'s rule is set from these rows. Its ``--n`` defaults run
from 64 to the short-row instance's last N.

    python -m jpdvt_mt_ntnu_tpu_torch.tools.bench_attention_routes \\
        [--n 144 205 324 400 576] [--batch 32 96] [--head-dim 64|72]
        [--k3 [--widths 384 768 1024 1152]]

Needs a CUDA card; it fails without one.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..ops import attention as attn_ops
from ..ops import flash_attention as flash_ops

HEADS = {64: 12, 72: 16}  # the JPDVT flagship's heads; DiT-XL's at Dh 72
# The registry's widths: DiT-S, DiT-B and the JPDVT flagship, DiT-L, DiT-XL.
K3_WIDTHS = {384: 6, 768: 12, 1024: 16, 1152: 16}
K3_N = (64, 100, 144, 196, 223, 252, 289, 336, 361, 400, 416)


def _us(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return 1e3 * start.elapsed_time(stop) / reps


def bench(n: int, b: int, gen: torch.Generator, d: int = 64) -> dict:
    dtype, h = torch.bfloat16, HEADS[d]
    shape = (b, n, 3, h, d)
    qkv = torch.randn((b, n, 3 * h * d), generator=gen, device="cuda").to(dtype)
    q, k, v = qkv.view(shape).permute(2, 0, 3, 1, 4).unbind(0)
    do = torch.randn((b, n, h * d), generator=gen, device="cuda").to(dtype)
    do = do.view(b, n, h, d).transpose(1, 2)
    grads = torch.empty_like(qkv).view(shape).permute(2, 0, 3, 1, 4).unbind(0)
    elem = qkv.element_size()
    fits_k1 = attn_ops.k1_smem_bytes(n, elem, d) <= attn_ops.HOPPER_MAX_SMEM
    fits_k2 = attn_ops.k2_smem_bytes(n, elem, d) <= attn_ops.HOPPER_MAX_SMEM
    row = {"n": n, "batch": b, "heads": h, "head_dim": d, "dtype": "bfloat16",
           "route_no_grad": attn_ops.attention_route(n, dtype, False, head_dim=d),
           "route_grad": attn_ops.attention_route(n, dtype, True, head_dim=d)}
    o, lse = flash_ops.flash_attention_fwd(q, k, v)
    row["k4_us"] = _us(lambda: flash_ops.flash_attention_fwd(q, k, v))
    row["k5_us"] = _us(lambda: flash_ops.flash_dq(q, k, v, o, lse, do, grads[0]))
    row["k6_us"] = _us(lambda: flash_ops.flash_dkv(q, k, v, o, lse, do, *grads[1:]))
    row["flash_fwd_bwd_us"] = row["k4_us"] + row["k5_us"] + row["k6_us"]
    row["k1_us"] = _us(lambda: attn_ops.attention(q, k, v)) if fits_k1 else "n/a"
    row["k2_us"] = (_us(lambda: attn_ops.attention_bwd(q, k, v, do, out=grads))
                    if fits_k2 else "n/a")
    row["whole_row_fwd_bwd_us"] = (row["k1_us"] + row["k2_us"] if fits_k1 and fits_k2
                                   else "n/a")
    return row


def bench_k3(n: int, b: int, hidden: int, dtype: torch.dtype, gen: torch.Generator) -> dict:
    """K3's instances at (b, n, hidden) in ``dtype``: µs per call of each
    that runs there."""
    heads = K3_WIDTHS[hidden]
    d = hidden // heads
    x = torch.randn((b, n, hidden), generator=gen, device="cuda").to(dtype)
    wq = (torch.randn((3 * hidden, hidden), generator=gen, device="cuda")
          * hidden ** -0.5).to(dtype)
    wp = (torch.randn((hidden, hidden), generator=gen, device="cuda") * hidden ** -0.5).to(dtype)
    bq, bp = (0.1 * torch.randn(m, generator=gen, device="cuda") for m in (3 * hidden, hidden))
    ops = attn_ops.dense_to_block_weights(wq, bq, wp, bp, heads)
    if dtype == torch.float32:  # the fp32 kernel reads contiguous weights: time no copy
        ops = tuple(t.contiguous() for t in ops)
    elem = x.element_size()
    names = ["long"]
    if attn_ops.k3_smem_bytes(n, elem, d) <= attn_ops.HOPPER_MAX_SMEM:
        names.insert(0, "short")
    us: dict = {name: [] for name in names}
    for _ in range(3):
        for name in [*names, *reversed(names)]:
            us[name].append(_us(lambda: attn_ops.fused_attention_block_k3(
                x, *ops, heads, instance=name)))
    return {"n": n, "batch": b, "hidden": hidden, "heads": heads, "head_dim": d,
            "dtype": str(dtype).split(".")[-1],
            **{f"{name}_us": min(v) for name, v in us.items()},
            "takes": attn_ops.k3_instance(n, dtype, d)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, nargs="+")
    ap.add_argument("--batch", type=int, nargs="+", default=[32, 96])
    ap.add_argument("--head-dim", type=int, choices=attn_ops.HEAD_DIMS, default=64)
    ap.add_argument("--k3", action="store_true", help="time K3's two instances instead")
    ap.add_argument("--widths", type=int, nargs="+", choices=sorted(K3_WIDTHS),
                    default=sorted(K3_WIDTHS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_attention_routes needs a CUDA card")
    gen = torch.Generator("cuda").manual_seed(0)
    if args.k3:
        for hidden in args.widths:
            d = hidden // K3_WIDTHS[hidden]
            for dtype in (torch.bfloat16, torch.float32):
                elem = torch.empty((), dtype=dtype).element_size()
                last = max(m for m in range(1, 1024)
                           if attn_ops.k3_smem_bytes(m, elem, d) <= attn_ops.HOPPER_MAX_SMEM)
                for n in args.n or [m for m in K3_N if m < last] + [last]:
                    for b in args.batch:
                        print(json.dumps({"device": torch.cuda.get_device_name(0),
                                          **bench_k3(n, b, hidden, dtype, gen)}), flush=True)
        return 0
    for n in args.n or [144, 205, 324, 400, 576]:
        for b in args.batch:
            print(json.dumps({"device": torch.cuda.get_device_name(0),
                              **bench(n, b, gen, args.head_dim)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
