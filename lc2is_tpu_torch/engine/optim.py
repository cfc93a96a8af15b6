"""Optimizer and learning-rate schedules with frozen-prefix masking,
counterpart of ``lc2is_tpu/engine/optim.py`` (``frozen_mask`` :18,
``make_schedule`` :32, ``make_optimizer`` :56).

``torch.optim.AdamW`` (betas (0.9, 0.999), eps 1e-8, decoupled weight decay)
computes optax's ``adamw`` update; the schedule is evaluated at the count of
updates already applied, as optax does, and an optional global-norm clip
runs first, as ``optax.clip_by_global_norm``.  Frozen parameters are left out
of the optimizer and get ``requires_grad_(False)``, so autograd computes no
gradient for them while still carrying gradients THROUGH them (the prompt
contexts learn through the frozen text tower, as ``stop_gradient`` on the
frozen leaves lets them in JAX).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn


def frozen_mask(model: nn.Module, frozen_prefixes: Sequence[str]) -> Dict[str, bool]:
    """{parameter name: trainable}; a prefix is a dotted path that matches
    a name or the start of one at a dot."""
    return {name: not any(name == fp or name.startswith(fp + ".") for fp in frozen_prefixes)
            for name, _ in model.named_parameters()}


def make_schedule(kind: str, lr: float, total_steps: int, warmup: int = 0
                  ) -> Callable[[int], float]:
    """Learning rate at update ``count``, in optax's semantics:
    ``constant_schedule``, ``warmup_cosine_decay_schedule(0, lr, warmup,
    max(total, 1))`` and ``linear_schedule(lr, 0, max(total - warmup, 1),
    warmup)``."""
    if kind == "constant":
        return lambda count: lr
    if kind == "cosine":
        decay = max(total_steps, 1) - warmup

        def cosine(count: int) -> float:
            if count < warmup:
                return lr * count / warmup
            t = min(count - warmup, decay)
            return lr * 0.5 * (1.0 + math.cos(math.pi * t / decay))

        return cosine
    if kind == "linear":
        span = max(total_steps - warmup, 1)
        return lambda count: lr * (1.0 - min(max(count - warmup, 0), span) / span)
    raise ValueError(kind)


class Optimizer:
    """AdamW over the trainable parameters with a schedule and an optional
    global-norm clip: ``zero_grad()``, then ``step()`` after the backward."""

    def __init__(self, params: Sequence[nn.Parameter], schedule: Callable[[int], float],
                 weight_decay: float = 0.0, grad_clip: Optional[float] = None):
        self.params = list(params)
        self.schedule, self.grad_clip = schedule, grad_clip
        self.count = 0
        self.adamw = torch.optim.AdamW(self.params, lr=schedule(0), betas=(0.9, 0.999),
                                       eps=1e-8, weight_decay=weight_decay)

    def state_dict(self) -> Dict:
        """The AdamW moments and step counts, the count of updates the
        schedule reads, and the clip (a native checkpoint's ``optimizer``)."""
        return dict(count=self.count, grad_clip=self.grad_clip, adamw=self.adamw.state_dict())

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        self.grad_clip = state["grad_clip"]
        self.adamw.load_state_dict(state["adamw"])

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad for p in self.params if p.grad is not None]
        if self.grad_clip and grads:
            norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
            # optax.clip_by_global_norm: g · max / ‖g‖ unless ‖g‖ < max
            scale = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                                self.grad_clip / norm)
            torch._foreach_mul_(grads, scale)
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.count += 1


def make_optimizer(model: nn.Module, lr: float = 1e-5, weight_decay: float = 0.0,
                   schedule: str = "constant", total_steps: int = 100, warmup: int = 0,
                   frozen_prefixes: Sequence[str] = (),
                   grad_clip: Optional[float] = None) -> Optimizer:
    """AdamW (lr 1e-5, wd 0 by default, ``all_args.sh:14-16`` of the
    reference) over ``model``'s parameters outside ``frozen_prefixes``; the
    frozen ones get ``requires_grad_(False)``."""
    mask = frozen_mask(model, frozen_prefixes)
    trainable = []
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
        if mask[name]:
            trainable.append(p)
    return Optimizer(trainable, make_schedule(schedule, lr, total_steps, warmup), weight_decay,
                     grad_clip)
