"""Diffusion Vision Transformer (DiT) with adaLN-Zero, dual-headed for JPDVT.

Counterpart of ``jpdvt_mt_ntnu_tpu/models/dit.py`` (the reference's
``image_model/models.py:145-293``), with the same parameter names so that
the JAX parameters carry over one to one (``tools/weights.py``):

- the patch embed is a Linear over (row, col, channel)-ordered patches;
- attention is timm's fused qkv (``[q|k|v][head][dim]``) on the route that
  ``ops.attention.attention_route`` picks from ``attn_impl``, the sequence
  length, the type and whether grad is on: the whole-row kernels K1/K2
  (``ops/attention.py``), the flash kernels K4-K6
  (``ops/flash_attention.py``), or with ``attn_impl="block"`` the whole
  sublayer as K3 (``ops/attention.py:fused_attention_block``), its biases
  in fp32 as in the JAX package (``models/dit.py:211-218``), or with
  ``attn_impl="xla"`` / ``"xla2"`` / ``"xla_split"`` the JAX package's
  plain-XLA attention (``fused_qkv_attention_xla``, and for ``xla_split``
  the qkv projection's product rounded before its bias is added,
  ``split_qkv_attention_xla``), its backward autograd of the plain version
  (``models/dit.py:227-245``); the weights keep their layout on every
  setting, so checkpoints carry over;
- the MLP's GELU is the tanh approximation, LayerNorms have eps 1e-6, no
  affine, and compute their statistics in fp32 as Flax's do in bf16;
- two heads: the unpatchified image and an 8-dim positional code per token,
  read from the final layer's output (``models.py:288``);
- ``quant="int8"`` (or ``"int8:K"``, the first K blocks) runs each
  quantized block's qkv, output and MLP projections as w8a8 int8 products
  (``ops/quant.py``, JAX ``models/dit.py:129-138,195-202``) around the
  attention core on its default route; the parameter names do not change;
- ``moe_experts=E`` replaces each block's MLP by an expert-choice
  mixture of E experts (``models/moe.py``, JAX ``models/dit.py:276-286``);
  with ``quant`` its attention is int8 and its experts stay dense, as there;
- on a mesh (``parallel/sharding.py``'s layout sets the hooks) a block
  runs its rank's part: TP's heads and hidden features, FSDP's gathered
  weights, EP's experts, or under ``mesh.seq`` its rank's tokens with
  ``Attention.ring`` for the attention core (``parallel/sequence.py``);
  the outputs are gathered whole.

Parameters are float32; ``DiTConfig.dtype`` is the compute type. Every
Linear casts its parameters to the type of its input, so a model whose
parameters were cast once (``PuzzleSolver``) pays no cast per step.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import (attention_route, dense_to_block_weights,
                             fused_attention_block, fused_qkv_attention,
                             fused_qkv_attention_xla, split_qkv_projection)
from ..ops.flash_attention import fused_qkv_flash_attention
from ..ops.quant import int8_dense, parse_quant_spec, quantize_channelwise
from ..utils.device import default_device
from ..utils.pos_embed import get_2d_sincos_pos_embed, timestep_embedding
from .moe import ExpertChoiceMoE


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    input_size: int = 192
    patch_size: int = 16
    in_channels: int = 3
    hidden_size: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    code_dim: int = 8
    code_head_hidden: int = 64
    dtype: torch.dtype = torch.float32  # compute type
    attn_impl: str | None = None  # ops.attention.ATTN_IMPLS: None (auto), "pallas", "block", ...
    quant: str | None = None  # None, "int8" (every block) or "int8:K" (the first K)
    moe_experts: int = 0  # > 0: each block's MLP is an ExpertChoiceMoE of this many experts
    moe_capacity: float = 2.0

    @property
    def tokens_per_side(self) -> int:
        return self.input_size // self.patch_size

    @property
    def num_tokens(self) -> int:
        return self.tokens_per_side ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * self.in_channels


class Linear(nn.Linear):
    """A Linear computing in its input's type (Flax ``Dense(dtype=...)``),
    or with ``quant="int8"`` through :func:`int8_dense` on its fp32
    parameters, quantized once per parameter version.

    Under tensor parallelism (``parallel/sharding.py`` sets ``tp_mode`` and
    ``tp``, the mesh) it holds this model rank's part: "column" its output
    features (the input passes Megatron's identity, whose backward sums
    the gradient over the model group), "row" its input features (the
    partial products are summed over the model group in fp32, then the
    bias is added once and the sum rounded to the compute type). Under
    FSDP (``fsdp``, the mesh and the cut dim) its weight is this rank's
    shard, gathered for each product (``Mesh.gathered_linear``)."""

    def __init__(self, in_features: int, out_features: int, quant: str | None = None):
        super().__init__(in_features, out_features)
        self.quant = quant
        self._int8: tuple | None = None  # (parameter versions, (w_q, s_w, fp32 bias))
        self.tp_mode: str | None = None
        self.tp = None
        self.fsdp: tuple | None = None

    @torch.no_grad()
    def int8_weights(self) -> tuple:
        """(w_q, s_w, bias) from the fp32 parameters, made anew only when
        one of them changed. A copy whose parameters were cast to the
        compute type (``PuzzleSolver``'s) keeps the triple it was copied
        with: bf16-rounded weights would quantize to other int8 values."""
        w, b = self.weight, self.bias
        if w.dtype != torch.float32:
            if self._int8 is None:
                raise RuntimeError("an int8 Linear whose parameters are not float32 "
                                   "must carry the quantized fp32 weights "
                                   "(DiT.prepare_int8 before the cast)")
            return self._int8[1]
        key = (w.data_ptr(), w._version, b.data_ptr(), b._version)
        if self._int8 is None or self._int8[0] != key:
            self._int8 = (key, (*quantize_channelwise(w), b.float()))
        return self._int8[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant:
            return int8_dense(x, *self.int8_weights())
        if self.tp_mode == "row":
            y = self.tp.reduce_from(self._linear(x, None), self.tp.model)
            return (y + self.bias.float()).to(x.dtype)
        if self.tp_mode == "column":
            x = self.tp.copy_to(x, self.tp.model)
        return self._linear(x, self.bias.to(x.dtype))

    def split_qkv(self, x: torch.Tensor) -> torch.Tensor:
        """The qkv Linear as the JAX package's ``split_qkv_attention_xla``
        projects (:func:`split_qkv_projection`): q's, k's and v's products
        each rounded to x's type, then the bias added in it (``forward``
        adds the bias before its one rounding). A column-cut Linear takes x
        as ``forward`` does (its thirds are its heads' q, k and v); an FSDP
        one gathers its weight whole (its gradient reduce-scattered)."""
        if self.tp_mode == "column":
            x = self.tp.copy_to(x, self.tp.model)
        w = self.weight
        if self.fsdp is not None:
            mesh, dim = self.fsdp
            w = mesh.gathered(w, dim)
        return split_qkv_projection(x, w, self.bias)

    def _linear(self, x: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
        if self.fsdp is not None:
            mesh, dim = self.fsdp
            return mesh.gathered_linear(x, self.weight, bias, dim)
        return F.linear(x, self.weight.to(x.dtype), bias)


def layer_norm(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm, eps 1e-6, no affine, statistics in fp32."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=1e-6).to(x.dtype)


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * (1 + scale[:, None]) + shift[:, None]


def patchify(x: torch.Tensor, cfg: DiTConfig) -> torch.Tensor:
    """(B, H, W, C) -> (B, N, p*p*C) in (row, col, channel) patch order."""
    b = x.shape[0]
    n, p = cfg.tokens_per_side, cfg.patch_size
    x = x.reshape(b, n, p, n, p, cfg.in_channels)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, cfg.num_tokens, -1)


class Mlp(nn.Module):
    def __init__(self, features: int, hidden: int, quant: str | None = None):
        super().__init__()
        self.fc1 = Linear(features, hidden, quant)
        self.fc2 = Linear(hidden, features, quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class Attention(nn.Module):
    """timm-compatible MHA: fused qkv projection, attention on the route
    :func:`attention_route` picks, output projection; on the ``"block"``
    route all three in one K3 call; on ``"xla_split"`` the qkv projection
    rounded as ``split_qkv_attention_xla``'s (:meth:`Linear.split_qkv`). A
    quantized block ignores ``attn_impl`` (as in the JAX package) and
    takes the default route between its int8 projections. Under a mesh
    the ``xla*`` settings run as the default route does, on this rank's
    heads through the Linears' own cuts."""

    def __init__(self, hidden_size: int, num_heads: int, attn_impl: str | None = None,
                 quant: str | None = None):
        super().__init__()
        self.num_heads = num_heads  # this model rank's heads under TP
        self.head_dim = hidden_size // num_heads
        self.attn_impl = None if quant else attn_impl
        self.qkv = Linear(hidden_size, 3 * hidden_size, quant)
        self.proj = Linear(hidden_size, hidden_size, quant)
        self.ring = None  # the mesh under sequence parallelism (parallel/sequence.py)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.ring is not None:
            return self.proj(self.ring.ring_attention(self.qkv(x), self.num_heads))
        grad = torch.is_grad_enabled() and (
            x.requires_grad or self.qkv.weight.requires_grad or self.qkv.bias.requires_grad)
        route = attention_route(
            x.shape[1], x.dtype, grad, self.attn_impl,
            head_dim=self.head_dim, on_card=x.is_cuda)
        if route == "block":
            # Views of the parameters: K3 reads the Linear weights as they lie.
            dt = x.dtype
            weights = dense_to_block_weights(
                self.qkv.weight.to(dt), self.qkv.bias.float(), self.proj.weight.to(dt),
                self.proj.bias.float(), self.num_heads)
            return fused_attention_block(x, *weights, self.num_heads)
        if route == "xla_split":
            # split_qkv_attention_xla, with the Linear's cut of the weights
            return self.proj(fused_qkv_attention_xla(self.qkv.split_qkv(x), self.num_heads))
        attend = {"flash": fused_qkv_flash_attention, "xla": fused_qkv_attention_xla}.get(
            route, fused_qkv_attention)
        return self.proj(attend(self.qkv(x), self.num_heads))


class DiTBlock(nn.Module):
    """Pre-LN transformer block with adaLN-Zero conditioning (models.py:101-122)."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float,
                 attn_impl: str | None = None, quant: str | None = None,
                 moe_experts: int = 0, moe_capacity: float = 2.0):
        super().__init__()
        self.adaLN_modulation = Linear(hidden_size, 6 * hidden_size)
        self.attn = Attention(hidden_size, num_heads, attn_impl, quant)
        hidden = int(hidden_size * mlp_ratio)
        self.mlp = (ExpertChoiceMoE(hidden_size, hidden, hidden_size, moe_experts, moe_capacity)
                    if moe_experts else Mlp(hidden_size, hidden, quant))

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        (shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp,
         gate_mlp) = self.adaLN_modulation(F.silu(c)).chunk(6, dim=-1)
        x = x + gate_msa[:, None] * self.attn(
            modulate(layer_norm(x), shift_msa, scale_msa))
        return x + gate_mlp[:, None] * self.mlp(
            modulate(layer_norm(x), shift_mlp, scale_mlp))


class FinalLayer(nn.Module):
    """adaLN-modulated projection to patch pixels (models.py:125-142)."""

    def __init__(self, hidden_size: int, patch_dim: int):
        super().__init__()
        self.adaLN_modulation = Linear(hidden_size, 2 * hidden_size)
        self.linear = Linear(hidden_size, patch_dim)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        shift, scale = self.adaLN_modulation(F.silu(c)).chunk(2, dim=-1)
        return self.linear(modulate(layer_norm(x), shift, scale))


class TimestepEmbedder(nn.Module):
    """Sinusoidal timestep -> MLP embedding (models.py:27-64)."""

    def __init__(self, hidden_size: int, freq_size: int = 256):
        super().__init__()
        self.freq_size = freq_size
        self.fc1 = Linear(freq_size, hidden_size)
        self.fc2 = Linear(hidden_size, hidden_size)

    def forward(self, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        emb = timestep_embedding(t, self.freq_size).to(dtype)
        return self.fc2(F.silu(self.fc1(emb)))


class DiT(nn.Module):
    """Dual-headed DiT for jigsaw diffusion.

    ``forward(x, t, code)``: x (B, H, W, C) scrambled image, NHWC, or with
    ``x_is_tokens`` its (B, N, hidden) :meth:`embed_condition`; t (B,)
    original-chain timesteps; code (B, N, code_dim) noisy positional code.
    Returns (image (B, H, W, C), code (B, N, code_dim)), both float32. The
    JAX package's ``learn_sigma`` (a doubled image head) has no user yet.
    """

    def __init__(self, config: DiTConfig):
        super().__init__()
        cfg = self.config = config
        self.x_embedder = Linear(cfg.patch_size ** 2 * cfg.in_channels,
                                 cfg.hidden_size)
        self.code_in = Linear(cfg.code_dim, cfg.hidden_size)
        self.t_embedder = TimestepEmbedder(cfg.hidden_size)
        qmode, qlimit = parse_quant_spec(cfg.quant)
        self.blocks = nn.ModuleList(
            DiTBlock(cfg.hidden_size, cfg.num_heads, cfg.mlp_ratio, cfg.attn_impl,
                     qmode if qlimit is None or i < qlimit else None,
                     cfg.moe_experts, cfg.moe_capacity)
            for i in range(cfg.depth))
        self.final_layer = FinalLayer(cfg.hidden_size, cfg.patch_dim)
        self.code_out1 = Linear(cfg.patch_dim, cfg.code_head_hidden)
        self.code_out2 = Linear(cfg.code_head_hidden, cfg.code_dim)
        pos = get_2d_sincos_pos_embed(cfg.hidden_size, cfg.tokens_per_side)
        self.register_buffer("pos_embed", torch.tensor(pos, dtype=torch.float32),
                             persistent=False)
        self.seq = None  # the mesh under sequence parallelism (parallel/sequence.py)

    @torch.no_grad()
    def initialize_weights(self, generator: torch.Generator | None = None) -> None:
        """The JAX package's init (models.py:187-225): xavier-uniform
        Linears with zero bias; N(0, 0.02) timestep and code-head weights;
        zero adaLN modulations and final linear; the experts' own
        (:meth:`ExpertChoiceMoE.initialize_weights`)."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                fan_out, fan_in = m.weight.shape
                bound = math.sqrt(6.0 / (fan_in + fan_out))
                m.weight.uniform_(-bound, bound, generator=generator)
                m.bias.zero_()
        for m in (self.t_embedder.fc1, self.t_embedder.fc2, self.code_in,
                  self.code_out1, self.code_out2):
            m.weight.normal_(0.0, 0.02, generator=generator)
        zeros = [blk.adaLN_modulation for blk in self.blocks]
        zeros += [self.final_layer.adaLN_modulation, self.final_layer.linear]
        for m in zeros:
            m.weight.zero_()
        for m in self.modules():
            if isinstance(m, ExpertChoiceMoE):
                m.initialize_weights(generator)

    def prepare_int8(self) -> None:
        """Quantize every int8 Linear's fp32 parameters now (cached per
        parameter version), so that a copy cast to the compute type
        carries them."""
        for m in self.modules():
            if isinstance(m, Linear) and m.quant:
                m.int8_weights()

    def embed_condition(self, x: torch.Tensor) -> torch.Tensor:
        """Patch embed + position table of the condition image
        (``models/dit.py:105``): computed once per solve, fed to every
        sampler step with ``x_is_tokens=True``."""
        dt = self.config.dtype
        return self.x_embedder(patchify(x.to(dt), self.config)) + self.pos_embed.to(dt)

    def forward(self, x: torch.Tensor, t: torch.Tensor, code: torch.Tensor,
                x_is_tokens: bool = False):
        cfg = self.config
        dt = cfg.dtype
        x = x.to(dt) if x_is_tokens else self.embed_condition(x)
        x = x + self.code_in(code.to(dt))
        c = self.t_embedder(t, dt)
        if self.seq is not None:  # this rank's tokens of the sequence
            x = self.seq.local_tokens(x)
        for block in self.blocks:
            x = block(x, c)
        return self.head(x, c)

    def head(self, x: torch.Tensor, c: torch.Tensor):
        """The final layer, the code head and unpatchify: (image, code),
        float32; under sequence parallelism per token, then gathered."""
        cfg = self.config
        x = self.final_layer(x, c)
        code_out = self.code_out2(F.silu(self.code_out1(x)))
        if self.seq is not None:
            x, code_out = self.seq.gather_tokens(x), self.seq.gather_tokens(code_out)
        b, n_side, p = x.shape[0], cfg.tokens_per_side, cfg.patch_size
        img = x.reshape(b, n_side, n_side, p, p, cfg.in_channels)
        img = img.permute(0, 1, 3, 2, 4, 5).reshape(
            b, cfg.input_size, cfg.input_size, cfg.in_channels)
        return img.float(), code_out.float()


def _cfg(depth, hidden, patch, heads):
    return dict(depth=depth, hidden_size=hidden, patch_size=patch, num_heads=heads)


# The JAX registry (reference models.py:373-424, and JPDVT-MoE).
DIT_CONFIGS: dict[str, dict] = {
    "DiT-XL/2": _cfg(28, 1152, 2, 16), "DiT-XL/4": _cfg(28, 1152, 4, 16),
    "DiT-XL/8": _cfg(28, 1152, 8, 16),
    "DiT-L/2": _cfg(24, 1024, 2, 16), "DiT-L/4": _cfg(24, 1024, 4, 16),
    "DiT-L/8": _cfg(24, 1024, 8, 16),
    "DiT-B/2": _cfg(12, 768, 2, 12), "DiT-B/4": _cfg(12, 768, 4, 12),
    "DiT-B/8": _cfg(12, 768, 8, 12),
    "DiT-S/2": _cfg(12, 384, 2, 6), "DiT-S/4": _cfg(12, 384, 4, 6),
    "DiT-S/8": _cfg(12, 384, 8, 6),
    "JPDVT": _cfg(12, 768, 16, 12),
    "JPDVT-S": _cfg(12, 768, 32, 12),
    "JPDVT-T": _cfg(12, 768, 64, 12),
    # 8 expert-choice experts per block MLP (models/moe.py), capacity 2.0:
    # 8x the dense flagship's MLP parameters, each token refined by ~2.
    "JPDVT-MoE": dict(_cfg(12, 768, 16, 12), moe_experts=8),
}


def create_model(name: str, input_size: int, *,
                 device: str | torch.device | None = None, seed: int = 0,
                 **overrides) -> tuple[DiT, DiTConfig]:
    """Build a registered configuration with float32 parameters on
    ``device`` (default: the card; raises without one), initialised from
    ``seed``. ``overrides`` replace config fields, e.g. ``dtype=torch.bfloat16``
    or ``attn_impl="flash"``."""
    if name not in DIT_CONFIGS:
        raise KeyError(f"unknown model {name!r}; choose from {sorted(DIT_CONFIGS)}")
    device = default_device(device)
    cfg = DiTConfig(input_size=input_size, **{**DIT_CONFIGS[name], **overrides})
    with torch.device(device):
        model = DiT(cfg)
    model.initialize_weights(torch.Generator(device).manual_seed(seed))
    return model, cfg
