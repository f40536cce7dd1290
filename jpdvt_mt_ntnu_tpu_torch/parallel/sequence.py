"""Sequence (context) parallelism: ring attention over the mesh's ``seq`` axis.

Counterpart of ``jpdvt_mt_ntnu_tpu/parallel/sequence.py``. There a
``shard_map`` cuts the tokens over ``seq`` and a ``lax.scan`` rotates the K
and V blocks by ``ppermute`` while each device folds the visiting block
into an fp32 online softmax (``_ring_core``); autodiff of the scan is the
backward ring. Here each rank of a seq group holds N/s tokens of every
puzzle and the ring is written out (:class:`_Ring`):

- **Forward.** Rank i attends its queries to its own K and V block, then to
  the block of rank i-1, i-2, ... as they arrive: K and V go to the next
  rank by point-to-point sends (``Mesh.exchange``), s - 1 times. The
  running max m, the sum l and the unnormalised output o are fp32 whatever
  the input type (``sequence.py:48-86``); the result is o / l, and the
  rank keeps the log-sum-exp m + log l. q is scaled as everywhere in the
  port (``ops.attention.scaled_q``: q * Dh^-1/2 rounded to q's type, the
  scale rounded to it first, as JAX's ``(q * scale).astype(q.dtype)``).
- **Backward**, the standard ring backward (Liu et al. 2023, "Ring
  Attention with Blockwise Transformers"): each block's P is recomputed
  from the saved LSE and the scaled q, with delta = rowsum(dO o); dK sums
  dS^T qs and dQ sums dS K times the fp32 scale; dQ accumulates on the
  rank, and the dK and dV accumulators travel around the ring with their K
  and V blocks, arriving home after s hops. ``torch.distributed``'s sends
  are not autograd-aware, so plain autograd through the forward would give
  a wrong gradient with no error; this is why the ring is one
  ``autograd.Function``.

The JAX ring is plain ``jnp`` (einsums, exp and ``ppermute``), not a
Pallas kernel, so this one is plain torch, its products ``torch.matmul``.
The model's side (``models/dit.py``): each seq rank embeds the whole input
and keeps its tokens (:func:`local_tokens`), every block runs on them, the
final layer and the code head per token, and the outputs are gathered
(:func:`gather_tokens`), so the loss and every sampler see the whole
sequence; the expert-choice MoE, whose top-C spans the sequence, gathers
its input (:func:`gather_tokens_summed`).
"""

from __future__ import annotations

import torch

from ..ops.attention import scaled_q


def local_tokens(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's N/s tokens of (B, N, ...) ``x`` (its gradient, the
    whole sequence's with zeros elsewhere, as slicing gives it)."""
    n = x.shape[1]
    if n % group.size:
        raise ValueError(f"tokens {n} not divisible by seq={group.size}")
    nl = n // group.size
    return x[:, group.index * nl:(group.index + 1) * nl]


def gather_tokens(mesh, x: torch.Tensor, group) -> torch.Tensor:
    """(B, N, ...) from every rank's (B, N/s, ...). The backward takes this
    rank's slice: what reads the gathered tensor (the loss, a sampler) is
    the same on every rank of the group."""
    return _GatherTokens.apply(x, mesh, group) if group.size > 1 else x


def gather_tokens_summed(mesh, x: torch.Tensor, group) -> torch.Tensor:
    """(B, N, ...) from every rank's (B, N/s, ...). The backward sums the
    ranks' gradients and scatters them back: each rank's use of the whole
    sequence (the MoE's, of which it keeps its own tokens) is partial."""
    return _GatherSummed.apply(x, mesh, group) if group.size > 1 else x


class _GatherTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, group):
        ctx.group = group
        return mesh.gather(x.contiguous(), group, 1)

    @staticmethod
    def backward(ctx, g):
        return local_tokens(g, ctx.group), None, None


class _GatherSummed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, group):
        ctx.mesh, ctx.group = mesh, group
        return mesh.gather(x.contiguous(), group, 1)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.scatter_sum(g.contiguous(), ctx.group, 1), None, None


def ring_attention(mesh, qkv: torch.Tensor, num_heads: int, group) -> torch.Tensor:
    """The attention core of (B, N/s, 3C) fused qkv (``[q|k|v][head][dim]``)
    on this rank's tokens against the whole sequence of ``group``:
    (B, N/s, C) in qkv's type."""
    b, nl, c3 = qkv.shape
    c = c3 // 3
    q, k, v = qkv.reshape(b, nl, 3, num_heads, c // num_heads).permute(2, 0, 3, 1, 4).unbind(0)
    o = _Ring.apply(q, k, v, mesh, group)
    return o.transpose(1, 2).reshape(b, nl, c)


def _rotate(mesh, group, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """Each tensor to the next rank of the ring; the previous rank's in
    their place."""
    n, i = group.size, group.index
    out = [torch.empty_like(t) for t in tensors]
    mesh.exchange([(t, (i + 1) % n) for t in tensors], [(t, (i - 1) % n) for t in out], group)
    return out


class _Ring(torch.autograd.Function):
    """Ring attention on (B, H, N/s, D) q, k, v, fp32 inside."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, group):
        qf = scaled_q(q).float()  # JAX's (q * scale).astype(q.dtype)
        kb, vb = k.contiguous(), v.contiguous()
        m = l = o = None
        for step in range(group.size):
            s = torch.matmul(qf, kb.float().transpose(-1, -2))
            m_new = s.amax(-1) if m is None else torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            pv = torch.matmul(p, vb.float())
            if m is None:
                l, o = p.sum(-1), pv
            else:
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(-1)
                o = o * corr[..., None] + pv
            m = m_new
            if step < group.size - 1:
                kb, vb = _rotate(mesh, group, [kb, vb])
        out = o / l[..., None]
        ctx.save_for_backward(q, k, v, out, m + torch.log(l))
        ctx.mesh, ctx.group = mesh, group
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        mesh, group = ctx.mesh, ctx.group
        scale = q.shape[-1] ** -0.5  # dQ's, in fp32
        qs, gf = scaled_q(q).float(), g.float()
        delta = (gf * out).sum(-1, keepdim=True)
        dq = torch.zeros_like(qs)
        kb, vb = k.contiguous(), v.contiguous()
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        for step in range(group.size):
            kf, vf = kb.float(), vb.float()
            p = torch.exp(torch.matmul(qs, kf.transpose(-1, -2)) - lse[..., None])
            dv += torch.matmul(p.transpose(-1, -2), gf)
            ds = p * (torch.matmul(gf, vf.transpose(-1, -2)) - delta)
            dq += torch.matmul(ds, kf) * scale
            dk += torch.matmul(ds.transpose(-1, -2), qs)
            # The accumulators travel with their block and are home after s hops.
            if step < group.size - 1:
                kb, vb, dk, dv = _rotate(mesh, group, [kb, vb, dk, dv])
            else:
                dk, dv = _rotate(mesh, group, [dk, dv])
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None
