"""Train state: model, EMA model and AdamW state, updated in place.

Counterpart of ``jpdvt_mt_ntnu_tpu/train/state.py``. The JAX package keeps
params, EMA and the optax state as one immutable pytree and replaces it
every step; here the parameters live in two ``DiT`` modules (float32) and
the AdamW moments in dicts keyed by the ``state_dict`` names, and the
update writes into them in place. EMA covers all parameters
(train_JPDVT.py:37-46). On a mesh with more axes than data each tensor is
this rank's shard (``layout``, ``parallel/sharding.py``; under the
pipeline only this stage's blocks), and :meth:`TrainState.state_dict`
gathers the whole state.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class AdamW:
    """AdamW hyperparameters (``optax.adamw``) with an optional global-norm
    clip of the gradients before it (``optax.clip_by_global_norm``)."""

    lr: float = 1e-4
    weight_decay: float = 0.0
    grad_clip: float | None = None


@dataclasses.dataclass
class AdamState:
    """optax's ``ScaleByAdamState``: update count and the two moments."""

    count: int
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    ema: nn.Module
    opt: AdamState
    layout: object = None  # parallel.sharding.Layout, where the tensors are shards

    def state_dict(self) -> dict:
        """The whole state in the one-process layout; where it is sharded,
        gathered from every rank (collective: every rank calls it)."""
        if self.layout is not None:
            return self.layout.full_state_dict(self)
        return {"step": self.step, "model": self.model.state_dict(),
                "ema": self.ema.state_dict(),
                "opt": {"count": self.opt.count, "mu": dict(self.opt.mu),
                        "nu": dict(self.opt.nu)}}

    def tensors(self) -> list[torch.Tensor]:
        """Every tensor of :meth:`state_dict`, the step and count as one."""
        return [torch.tensor([self.step, self.opt.count]),
                *self.model.state_dict().values(), *self.ema.state_dict().values(),
                *self.opt.mu.values(), *self.opt.nu.values()]

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """Copy a :meth:`state_dict` into this state's tensors, bit for bit
        (a whole state: a sharded one is restored before it is cut)."""
        self.model.load_state_dict(sd["model"], strict=True)
        self.ema.load_state_dict(sd["ema"], strict=True)
        for mine, theirs in ((self.opt.mu, sd["opt"]["mu"]),
                             (self.opt.nu, sd["opt"]["nu"])):
            if sorted(mine) != sorted(theirs):
                raise KeyError(f"optimizer state names differ: {sorted(set(mine) ^ set(theirs))}")
            for name, t in mine.items():
                t.copy_(theirs[name])
        self.opt.count = int(sd["opt"]["count"])
        self.step = int(sd["step"])


def make_optimizer(lr: float = 1e-4, weight_decay: float = 0.0,
                   grad_clip: float | None = None) -> AdamW:
    """AdamW(lr=1e-4, wd=0) per reference train_JPDVT.py:281, plus an
    optional global-norm clip the reference lacks (off by default)."""
    return AdamW(lr=lr, weight_decay=weight_decay, grad_clip=grad_clip)


def create_train_state(model: nn.Module) -> TrainState:
    """Step 0: the EMA a copy of the (initialised) model, zero moments."""
    ema = copy.deepcopy(model).requires_grad_(False)
    params = dict(model.named_parameters())
    return TrainState(step=0, model=model, ema=ema, opt=AdamState(
        count=0, mu={k: torch.zeros_like(p) for k, p in params.items()},
        nu={k: torch.zeros_like(p) for k, p in params.items()}))


def _f32(x: float) -> np.float32:
    return np.float32(x)


@torch.no_grad()
def fused_adamw_ema(params, grads, ema, opt: AdamState, *, lr: float,
                    b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                    weight_decay: float = 0.0, ema_decay: float = 0.9999) -> None:
    """One AdamW step and the EMA update, in place, as multi-tensor
    (``torch._foreach_*``) passes over every parameter at once.

    ``params``, ``grads`` and ``ema`` are lists of tensors in one order,
    ``opt.mu``/``opt.nu`` dicts in that same order. Semantics of
    ``optax.adamw`` + ``optax.incremental_update`` as the JAX package's
    ``fused_adamw_ema`` computes them: bias correction with count + 1, eps
    outside the square root, weight decay added to the update, the
    bias-correction scalars in float32."""
    count = opt.count + 1
    c1 = float(_f32(1.0) - _f32(b1) ** _f32(count))
    c2 = float(_f32(1.0) - _f32(b2) ** _f32(count))
    mu, nu = list(opt.mu.values()), list(opt.nu.values())
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - b1))
    torch._foreach_mul_(nu, b2)
    torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2))
    den = torch._foreach_div(nu, c2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    upd = torch._foreach_div(mu, c1)
    torch._foreach_div_(upd, den)
    del den
    if weight_decay:
        torch._foreach_add_(upd, torch._foreach_mul(params, weight_decay))
    torch._foreach_mul_(upd, lr)
    torch._foreach_sub_(params, upd)
    del upd
    diff = torch._foreach_sub(params, ema)
    # A Python-float decay steps by 1 - decay in double, a float32 one (the
    # warmup ramp's) in float32, as the JAX package's weak typing does.
    torch._foreach_mul_(diff, float(_f32(1.0) - ema_decay)
                        if isinstance(ema_decay, np.float32) else 1.0 - ema_decay)
    torch._foreach_add_(ema, diff)
    opt.count = count
