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
``tools/weights.py`` carries over as they are.

On a mesh (``parallel/sharding.py`` sets ``mesh``, ``first_expert`` and
``fsdp_dims``), as the JAX package's ``_EP_RULES`` lay the experts out:

- **Expert parallelism** (``mesh.ep``): this rank holds E/ep of the
  experts, from ``first_expert`` on. The ranks of an ep group see the same
  rows, so each computes the fp32 router over all E experts, takes the
  top-C of its own (C counted from the global E) and scatters their gated
  outputs into fp32 rows, which are summed over the group. The input
  passes Megatron's identity, whose backward sums its gradient over the
  group; the router's own gradient is partial on each rank (it gates only
  its experts), and the layout sums it.
- **Tensor parallelism** (``mesh.model``): each expert's hidden features
  are cut over the model group; fc2's partial products are summed in fp32,
  then ``bo`` is added once, as ``dit.Linear``'s "row" mode does.
- **FSDP** (``mesh.fsdp``): a stacked leaf is this rank's shard, gathered
  for its einsum and again for the backward (``Mesh.gathered_einsum``).
- **Sequence parallelism** (``mesh.seq``): the top-C spans the sequence,
  so the tokens are gathered first, and the input's gradient is summed and
  scattered back over the seq group.
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
        self.mesh = None  # parallel.sharding.Mesh, where the experts or tokens are cut
        self.first_expert = 0  # the global index of this rank's first expert
        self.fsdp_dims: dict[str, int] = {}  # stacked leaf -> its dim cut over fsdp

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
        """(gate, idx), each (B, E, C) for this rank's E experts: each
        expert's top-C router probabilities (fp32) and the tokens they
        belong to."""
        probs = torch.softmax(self.router(x.float()), dim=-1)        # (B, N, E)
        local = self.wi.shape[0]
        if local != self.num_experts:
            probs = probs[..., self.first_expert:self.first_expert + local]
        return torch.topk(probs.transpose(1, 2), self.capacity(x.shape[1]), dim=-1)

    def _leaf(self, name: str, dtype: torch.dtype) -> torch.Tensor:
        p = getattr(self, name)
        if name in self.fsdp_dims:
            p = self.mesh.gathered(p, self.fsdp_dims[name])
        return p.to(dtype)

    def _product(self, eq: str, x: torch.Tensor, name: str) -> torch.Tensor:
        if name in self.fsdp_dims:
            return self.mesh.gathered_einsum(eq, x, getattr(self, name), self.fsdp_dims[name])
        return torch.einsum(eq, x, getattr(self, name).to(x.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mesh = self.mesh
        if mesh is None or mesh.seq.size == 1:
            return self._experts(x)
        return mesh.local_tokens(self._experts(mesh.gather_tokens_summed(x)))

    def _experts(self, x: torch.Tensor) -> torch.Tensor:
        mesh = self.mesh
        ep = mesh is not None and mesh.ep.size > 1
        tp = mesh is not None and mesh.model.size > 1
        if ep:
            x = mesh.copy_to(x, mesh.ep)
        b, n, d = x.shape
        dt = x.dtype
        gate, idx = self.route(x)
        e, c = idx.shape[1], idx.shape[-1]
        xd = mesh.copy_to(x, mesh.model) if tp else x
        # Dispatch: (B, E, C, d), each expert's tokens.
        xe = torch.gather(xd[:, None].expand(b, e, n, d), 2, idx[..., None].expand(b, e, c, d))
        h = self._product("becd,edh->bech", xe, "wi") + self._leaf("bi", dt)[None, :, None]
        h = F.gelu(h, approximate="tanh")
        y = self._product("bech,eho->beco", h, "wo")
        if tp:
            y = (mesh.reduce_from(y, mesh.model)
                 + self._leaf("bo", torch.float32)[None, :, None]).to(dt)
        else:
            y = y + self._leaf("bo", dt)[None, :, None]
        o = y.shape[-1]
        # Combine: gated outputs into each expert's rows, summed over E.
        gated = y.float() * gate.to(dt).float()[..., None]
        rows = torch.zeros(b, e, n, o, dtype=torch.float32, device=x.device)
        rows = rows.scatter(2, idx[..., None].expand(b, e, c, o), gated)
        out = rows.sum(dim=1)
        if ep:
            out = mesh.reduce_from(out, mesh.ep)
        return out.to(dt)
