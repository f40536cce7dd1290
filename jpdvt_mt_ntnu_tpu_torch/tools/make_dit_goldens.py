"""The reference's DiT written out in torch, and its activation golden.

Counterpart of ``jpdvt_mt_ntnu_tpu/tools/make_dit_goldens.py``. The golden
``tests/golden/torch_dit_goldens.npz`` holds a random reference-format DiT
(its state dict under the reference's names), inputs and the outputs of
its forward: a checkpoint conversion that computes another function (timm's
fused qkv heads put in another order, say) is caught only by such a
golden, not by a round trip. :func:`build_torch_dit` is a short torch
version of the reference model's semantics (reference
image_model/models.py:101-293 and the timm ``Attention``, ``Mlp`` and
``PatchEmbed`` it builds; timm itself is not needed):

- the fused qkv Linear's 3 D outputs in (q|k|v, head, head dim) order,
  read by ``reshape(B, N, 3, H, hd).permute(2, 0, 3, 1, 4)`` as timm does;
- the GELU(tanh) MLP, pre-LN (no affine) adaLN-Zero blocks, the final
  layer, a conv patch embed;
- the reference's dual head: the positional-code head reads the final
  layer's image output (models.py:288-290), 16 * 16 * 3 wide for the
  flagship (models.py:177);
- the frozen 2-D sin-cos ``pos_embed`` (the port's ``utils/pos_embed``)
  and the cos-first timestep embedding.

The weights are random, without the reference's zero inits (zero adaLN
and final layers would hide conversion faults), and the biases are moved
off zero.

    python -m jpdvt_mt_ntnu_tpu_torch.tools.make_dit_goldens --out DIR

writes ``DIR/torch_dit_goldens.npz`` (the committed one is
``tests/golden/torch_dit_goldens.npz``).
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np

# Small but complete: head_dim != num_heads, two blocks, a patch grid > 1.
GOLDEN_CFG = dict(input_size=32, patch_size=8, in_channels=3, hidden_size=64,
                  depth=2, num_heads=4, mlp_ratio=4.0, code_dim=8,
                  code_head_hidden=16)


def build_torch_dit(cfg: dict, seed: int = 0):
    """The reference-semantics DiT of ``cfg`` with random weights from
    ``seed``, in eval mode, on the CPU."""
    import torch
    import torch.nn as nn

    from ..utils.pos_embed import get_2d_sincos_pos_embed

    D, heads, p = cfg["hidden_size"], cfg["num_heads"], cfg["patch_size"]
    cin = cfg["in_channels"]
    patch_dim = p * p * cin
    hidden = int(D * cfg["mlp_ratio"])

    class Attention(nn.Module):  # timm's vision_transformer.Attention
        def __init__(self):
            super().__init__()
            self.qkv = nn.Linear(D, 3 * D, bias=True)
            self.proj = nn.Linear(D, D, bias=True)

        def forward(self, x):
            B, N, C = x.shape
            hd = C // heads
            q, k, v = self.qkv(x).reshape(B, N, 3, heads, hd).permute(2, 0, 3, 1, 4).unbind(0)
            attn = (q @ k.transpose(-2, -1)) * hd ** -0.5
            return self.proj((attn.softmax(dim=-1) @ v).transpose(1, 2).reshape(B, N, C))

    class Mlp(nn.Module):  # timm's Mlp with GELU(tanh), models.py:112-114
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(D, hidden)
            self.fc2 = nn.Linear(hidden, D)

        def forward(self, x):
            return self.fc2(nn.functional.gelu(self.fc1(x), approximate="tanh"))

    def modulate(y, shift, scale):
        return y * (1 + scale.unsqueeze(1)) + shift.unsqueeze(1)

    class Block(nn.Module):  # models.py:101-122
        def __init__(self):
            super().__init__()
            self.norm1 = nn.LayerNorm(D, elementwise_affine=False, eps=1e-6)
            self.norm2 = nn.LayerNorm(D, elementwise_affine=False, eps=1e-6)
            self.attn = Attention()
            self.mlp = Mlp()
            self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(D, 6 * D, bias=True))

        def forward(self, x, c):
            sa, ca, ga, sm, cm, gm = self.adaLN_modulation(c).chunk(6, dim=1)
            x = x + ga.unsqueeze(1) * self.attn(modulate(self.norm1(x), sa, ca))
            return x + gm.unsqueeze(1) * self.mlp(modulate(self.norm2(x), sm, cm))

    class FinalLayer(nn.Module):  # models.py:125-142
        def __init__(self):
            super().__init__()
            self.norm_final = nn.LayerNorm(D, elementwise_affine=False, eps=1e-6)
            self.linear = nn.Linear(D, patch_dim, bias=True)
            self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(D, 2 * D, bias=True))

        def forward(self, x, c):
            shift, scale = self.adaLN_modulation(c).chunk(2, dim=1)
            return self.linear(modulate(self.norm_final(x), shift, scale))

    class TimestepEmbedder(nn.Module):  # models.py:27-64, cos first
        def __init__(self):
            super().__init__()
            self.mlp = nn.Sequential(nn.Linear(256, D), nn.SiLU(), nn.Linear(D, D))

        def forward(self, t):
            half = 128
            freqs = torch.exp(-math.log(10000) * torch.arange(half, dtype=torch.float32) / half)
            args = t[:, None].float() * freqs[None]
            return self.mlp(torch.cat([torch.cos(args), torch.sin(args)], -1))

    class RefDiT(nn.Module):  # models.py:145-293
        def __init__(self):
            super().__init__()
            self.x_embedder = nn.Conv2d(cin, D, kernel_size=p, stride=p, bias=True)
            self.t_embedder = TimestepEmbedder()
            self.time_emb_in = nn.Linear(cfg["code_dim"], D)
            self.time_emb_out1 = nn.Linear(patch_dim, cfg["code_head_hidden"])
            self.time_emb_out2 = nn.Linear(cfg["code_head_hidden"], cfg["code_dim"])
            self.blocks = nn.ModuleList([Block() for _ in range(cfg["depth"])])
            self.final_layer = FinalLayer()
            pos = get_2d_sincos_pos_embed(D, cfg["input_size"] // p)
            self.register_buffer("pos_embed", torch.from_numpy(pos).float().unsqueeze(0))

        def forward(self, x, t, code):
            x = self.x_embedder(x).flatten(2).transpose(1, 2)  # timm's PatchEmbed
            x = x + self.time_emb_in(code) + self.pos_embed
            c = self.t_embedder(t)
            for block in self.blocks:
                x = block(x, c)
            x = self.final_layer(x, c)  # (B, N, p * p * C)
            emb = self.time_emb_out2(nn.functional.silu(self.time_emb_out1(x)))  # the dual head
            B, N, _ = x.shape  # unpatchify, models.py:227-240 (NCHW)
            h = int(N ** 0.5)
            img = torch.einsum("nhwpqc->nchpwq", x.reshape(B, h, h, p, p, cin))
            return img.reshape(B, cin, h * p, h * p), emb

    torch.manual_seed(seed)
    model = RefDiT()
    with torch.no_grad():  # biases off zero, so that their conversion shows too
        for name, tensor in model.named_parameters():
            if name.endswith("bias"):
                tensor.add_(torch.randn_like(tensor) * 0.05)
    return model.eval()


def torch_state_dict_for_convert(model) -> dict[str, np.ndarray]:
    """The state dict under the names of the reference's checkpoints
    (``x_embedder.proj.*`` for the conv, ``t_embedder.mlp.{0,2}.*``)."""
    sd = {}
    for k, v in model.state_dict().items():
        k = k.replace("x_embedder.weight", "x_embedder.proj.weight")
        k = k.replace("x_embedder.bias", "x_embedder.proj.bias")
        sd[k] = v.detach().cpu().numpy().astype(np.float32)
    return sd


def run_torch_forward(model, x_nchw: np.ndarray, t: np.ndarray, code: np.ndarray):
    """(image NCHW, code) of ``model`` as numpy, on the CPU."""
    import torch

    with torch.no_grad():
        img, emb = model(torch.from_numpy(x_nchw), torch.from_numpy(t), torch.from_numpy(code))
    return img.numpy(), emb.numpy()


def golden() -> dict[str, np.ndarray]:
    """The golden's arrays: ``in_*``, ``out_*``, ``sd.<name>``, ``cfg.<key>``
    (the seed-0 model of :data:`GOLDEN_CFG` on ``RandomState(123)`` inputs)."""
    cfg = GOLDEN_CFG
    rng = np.random.RandomState(123)
    model = build_torch_dit(cfg, seed=0)
    b = 2
    x = rng.randn(b, cfg["in_channels"], cfg["input_size"], cfg["input_size"]).astype(np.float32)
    t = np.array([17, 842], dtype=np.int64)
    n_tokens = (cfg["input_size"] // cfg["patch_size"]) ** 2
    code = rng.randn(b, n_tokens, cfg["code_dim"]).astype(np.float32)
    img, emb = run_torch_forward(model, x, t, code)
    rec = {"in_x_nchw": x, "in_t": t, "in_code": code, "out_img_nchw": img, "out_code": emb}
    rec.update({f"sd.{k}": v for k, v in torch_state_dict_for_convert(model).items()})
    rec.update({f"cfg.{k}": np.asarray(v) for k, v in cfg.items()})
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="results/dit_goldens")
    args = ap.parse_args(argv)
    rec = golden()
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "torch_dit_goldens.npz")
    np.savez_compressed(path, **rec)
    print(f"wrote {path} ({os.path.getsize(path)} bytes, {len(rec)} arrays)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
