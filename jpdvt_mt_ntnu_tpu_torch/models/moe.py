"""Mixture-of-Experts MLP with expert-choice routing, for the DiT blocks.

Counterpart of ``jpdvt_mt_ntnu_tpu/models/moe.py`` (a beyond-reference
extension: ``model.moe_experts=E`` swaps every block's MLP for E experts).
Each expert takes its own top-C tokens (Zhou et al. 2022, "Mixture-of-
Experts with Expert Choice Routing"), so every expert processes exactly
``C = max(1, min(N, int(capacity * N / E)))`` tokens and no balancing
loss is needed. The router's logits and softmax are fp32; the expert FFNs
(fc1, gelu with the tanh approximation, fc2) run in the compute type; the
output is each expert's result weighted by its gate and summed over the
experts that chose the token. A token no expert chose gives zero and
passes through the block's residual. With one expert and capacity 1.0
the layer is the dense ``Mlp`` exactly.

The JAX package writes dispatch and combine as one-hot einsums, with no
Pallas kernel, so this is plain torch in its idiomatic form: the dispatch
is a ``gather`` of each expert's tokens, the combine a ``scatter`` of
each expert's gated outputs into its own (B, E, N, out) rows, summed over
E in fp32 and cast to the compute type (the einsum's fp32 accumulation).
Neither direction adds into one place from two threads, so the forward
and the backward are deterministic on the card (``index_add_`` would
add with atomics). ``torch.topk`` does not promise JAX's order among
tied probabilities; the result sums over the C slots, so only a tie at
the C-th place can change it.

Parameters keep the JAX names and layouts (``router`` a Linear, ``wi``
(E, d, h), ``bi`` (E, h), ``wo`` (E, h, out), ``bo`` (E, out)), which
``tools/weights.py`` carries over as they are. The expert parallelism of
the JAX package's ``ep`` mesh axis is not ported (``mesh.ep`` is refused).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class ExpertChoiceMoE(nn.Module):
    """(B, N, features) -> (B, N, out): ``num_experts`` fc1/gelu/fc2 FFNs,
    expert e on the C tokens of highest router probability for it."""

    def __init__(self, features: int, hidden: int, out: int, num_experts: int,
                 capacity_factor: float = 2.0):
        super().__init__()
        from .dit import Linear  # the DiT's Linear: casts its parameters to its input's type

        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.router = Linear(features, num_experts)
        self.wi = nn.Parameter(torch.empty(num_experts, features, hidden))
        self.bi = nn.Parameter(torch.zeros(num_experts, hidden))
        self.wo = nn.Parameter(torch.empty(num_experts, hidden, out))
        self.bo = nn.Parameter(torch.zeros(num_experts, out))

    def capacity(self, n: int) -> int:
        """C, the tokens each expert takes of a sequence of ``n``."""
        return max(1, min(n, int(self.capacity_factor * n / self.num_experts)))

    @torch.no_grad()
    def initialize_weights(self, generator: torch.Generator | None = None) -> None:
        """Flax's init: the router N(0, 0.02) with zero bias; ``wi`` and
        ``wo`` xavier-uniform with E counted in both fans (Flax's
        ``variance_scaling`` on a 3-D kernel: bound sqrt(6 / (E (d + h)))),
        zero biases."""
        self.router.weight.normal_(0.0, 0.02, generator=generator)
        self.router.bias.zero_()
        for w in (self.wi, self.wo):
            e, fan_in, fan_out = w.shape
            bound = math.sqrt(6.0 / (e * fan_in + e * fan_out))
            w.uniform_(-bound, bound, generator=generator)
        self.bi.zero_()
        self.bo.zero_()

    def route(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(gate, idx), each (B, E, C): each expert's top-C router
        probabilities (fp32) and the tokens they belong to."""
        probs = torch.softmax(self.router(x.float()), dim=-1)        # (B, N, E)
        return torch.topk(probs.transpose(1, 2), self.capacity(x.shape[1]), dim=-1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        e = self.num_experts
        dt = x.dtype
        gate, idx = self.route(x)
        c = idx.shape[-1]
        # Dispatch: (B, E, C, d), each expert's tokens.
        xe = torch.gather(x[:, None].expand(b, e, n, d), 2, idx[..., None].expand(b, e, c, d))
        h = torch.einsum("becd,edh->bech", xe, self.wi.to(dt)) + self.bi.to(dt)[None, :, None]
        h = F.gelu(h, approximate="tanh")
        y = torch.einsum("bech,eho->beco", h, self.wo.to(dt)) + self.bo.to(dt)[None, :, None]
        o = y.shape[-1]
        # Combine: gated outputs into each expert's rows, summed over E.
        gated = y.float() * gate.to(dt).float()[..., None]
        rows = torch.zeros(b, e, n, o, dtype=torch.float32, device=x.device)
        rows = rows.scatter(2, idx[..., None].expand(b, e, c, o), gated)
        return rows.sum(dim=1).to(dt)
