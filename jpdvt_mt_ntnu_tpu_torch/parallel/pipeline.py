"""Pipeline parallelism (GPipe) over the mesh's ``pipe`` axis.

Counterpart of ``jpdvt_mt_ntnu_tpu/parallel/pipeline.py``. There a
``shard_map`` over ``pipe`` runs a tick scan in which stage s computes
microbatch tau - s at tick tau and hands its activations on by
``ppermute``; autodiff of the scan is the backward. Here each rank of a
pipe group is one stage and the schedule is written out (:class:`Pipeline`):

- **Stages.** Stage s holds blocks [s D/S, (s+1) D/S) (D must divide by S),
  under their one-process names (``blocks.{i}``; ``parallel/sharding.py``
  puts an ``nn.Identity`` in the others' places), with their params, EMA
  and AdamW moments. The stem (patch and code embeds, the timestep MLP)
  and the head (final layer, code head, unpatchify) are on every stage,
  as the JAX package replicates them over ``pipe``.
- **Microbatches.** M = ``mesh.pipe_microbatches``, or 2 S when it is 0;
  the rank's batch must divide by M.
- **Forward.** Stage 0 runs the stem on the rank's batch and each
  microbatch through its blocks, sending the activations on to stage 1,
  and so on; every stage computes the conditioning c from its own copy of
  the timestep MLP. The last stage runs the head on the whole batch, as
  the JAX package does, and its outputs feed the loss; the other stages
  return zeros of the outputs' shapes.
- **Backward**: all forwards first, then all backwards (GPipe). The last
  stage runs autograd from the loss; each stage then sends its inputs'
  gradients upstream, microbatch by microbatch, and each stage upstream
  runs ``torch.autograd.backward`` on its kept outputs with the gradients
  it received. The microbatches' inputs and conditioning are leaves of
  their stage's graph, so one microbatch's backward never runs another's
  twice; the stem's graph runs once, after them.
- The transfers are point-to-point sends and receives outside autograd
  (``Mesh.exchange``), in one order on every stage: a stage receives
  before it computes and sends after, so a send waits only for the next
  stage's receive, which that stage posts before any send of its own, and
  no two sends wait on each other.

The gradients that this leaves partial are the layout's to sum
(``Layout.reduce_grads_``): the stem's and the head's over the pipe group
(a stage that did not use a leaf holds zeros), then the batch's mean; the
metrics come from the last stage.
"""

from __future__ import annotations

import torch


class Pipeline:
    """This rank's stage of the GPipe schedule over ``mesh.pipe``."""

    def __init__(self, mesh, depth: int, microbatches: int = 0):
        group = mesh.pipe
        if depth % group.size:
            raise ValueError(f"depth {depth} not divisible by mesh.pipe={group.size}")
        self.mesh, self.group = mesh, group
        per = depth // group.size
        self.blocks = range(group.index * per, (group.index + 1) * per)
        self.micro = microbatches or 2 * group.size
        self.first, self.last = group.index == 0, group.index == group.size - 1
        self._kept = None

    def forward(self, model, x: torch.Tensor, t: torch.Tensor, code: torch.Tensor):
        """``model(x, t, code)`` through the schedule: (image, code) on the
        last stage, zeros of their shapes on the others. Keeps what
        :meth:`backward` needs."""
        cfg = model.config
        b, mb = x.shape[0], x.shape[0] // self.micro
        if b % self.micro:
            raise ValueError(f"batch {b} not divisible by mesh.pipe_microbatches={self.micro}")
        c = model.t_embedder(t, cfg.dtype)
        cs = [part.detach().requires_grad_() for part in c.split(mb)]
        stem = None
        if self.first:
            stem = model.embed_condition(x) + model.code_in(code.to(cfg.dtype))
            inputs = [part.detach().requires_grad_() for part in stem.split(mb)]
        else:
            inputs = []
        outs = []
        shape = (mb, cfg.num_tokens, cfg.hidden_size)
        for i in range(self.micro):
            if not self.first:
                h = torch.empty(shape, dtype=cfg.dtype, device=x.device)
                self.mesh.exchange([], [(h, self.group.index - 1)], self.group)
                inputs.append(h.requires_grad_())
            h = inputs[i]
            for j in self.blocks:
                h = model.blocks[j](h, cs[i])
            outs.append(h)
            if not self.last:
                self.mesh.exchange([(h.detach(), self.group.index + 1)], [], self.group)
        c_head = None
        if self.last:
            c_head = c.detach().requires_grad_()
            result = model.head(torch.cat(outs), c_head)
        else:
            result = (torch.zeros(b, cfg.input_size, cfg.input_size, cfg.in_channels,
                                  device=x.device),
                      torch.zeros(b, cfg.num_tokens, cfg.code_dim, device=x.device))
        self._kept = (c, cs, c_head, stem, inputs, outs)
        return result

    def backward(self, loss: torch.Tensor) -> None:
        """The backward of the last :meth:`forward`: from ``loss`` on the
        last stage, from the gradients sent upstream on the others."""
        c, cs, c_head, stem, inputs, outs = self._kept
        self._kept = None
        up, down = self.group.index - 1, self.group.index + 1
        if self.last:
            loss.backward()
        for i in range(self.micro):
            if not self.last:
                g = torch.empty_like(outs[i])
                self.mesh.exchange([], [(g, down)], self.group)
                torch.autograd.backward(outs[i], g)
            if not self.first:
                self.mesh.exchange([(_grad(inputs[i]), up)], [], self.group)
        gc = torch.cat([_grad(part) for part in cs])
        if c_head is not None:
            gc = gc + _grad(c_head)
        torch.autograd.backward(c, gc)
        if stem is not None:
            torch.autograd.backward(stem, torch.cat([_grad(h) for h in inputs]))


def _grad(t: torch.Tensor) -> torch.Tensor:
    return t.grad if t.grad is not None else torch.zeros_like(t)
