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

On a mesh with a model axis (``core/mesh.py``, ``--tp``) the optimizer steps
each trainable parameter that ``parallel/sharding.py::infer_param_specs``
shards on this rank's shard only, with AdamW moments of the shard's shape
(JAX's ``infer_opt_specs``): the step cuts the shard from the module's
weight and from the whole gradient (already reduced over the ranks, and
clipped by the global norm of the whole gradients), steps AdamW on the
shard, and all-gathers the shards over the model group into the module's
whole weight, which the next forward and any evaluation read, as GSPMD
gathers a weight for a ``pallas_call``.  The module is the only copy of
the weights: what is written to it between steps (a load, an
initialisation) is what the next step updates.  Frozen parameters (the
text towers, the token embedding among them) have no moments and never
change, so they stay whole on every rank.
:meth:`Optimizer.state_dict` gathers whole moments and
:meth:`Optimizer.load_state_dict` re-slices them, so a checkpoint does not
depend on the mesh.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn

from lc2is_tpu_torch.core.mesh import Mesh
from lc2is_tpu_torch.parallel.sharding import (REPLICATED, gather, infer_opt_specs,
                                               infer_param_specs, shard)


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
    global-norm clip: ``zero_grad()``, then ``step()`` after the backward.

    ``params`` are the module's parameters (whole: their gradients are what
    the step reduces, measures and clips), ``names`` their names in the
    module.  With a ``mesh`` whose model axis is larger than 1, AdamW steps
    this rank's shard of each parameter that ``infer_param_specs`` shards,
    and the step gathers the whole parameter back (module docstring)."""

    def __init__(self, params: Sequence[nn.Parameter], schedule: Callable[[int], float],
                 weight_decay: float = 0.0, grad_clip: Optional[float] = None,
                 names: Optional[Sequence[str]] = None, mesh: Optional[Mesh] = None):
        self.params = list(params)
        self.names = list(names) if names is not None else [str(i) for i in
                                                             range(len(self.params))]
        self.schedule, self.grad_clip = schedule, grad_clip
        self.count = 0
        sharded = mesh is not None and mesh.model > 1 and mesh.group is not None
        self.mesh = mesh if sharded else None
        specs = infer_param_specs(dict(zip(self.names, self.params)), mesh) if sharded else {}
        self.specs = {n: s for n, s in specs.items() if s != REPLICATED}
        # (the module's whole parameter, this rank's shard of it, its spec)
        self.shards = []
        stepped = []
        for name, p in zip(self.names, self.params):
            if name in self.specs:
                s = shard(p.detach(), self.specs[name], mesh.model_index, mesh.model)
                self.shards.append((p, s, self.specs[name]))
                stepped.append(s)
            else:
                stepped.append(p)
        self.adamw = torch.optim.AdamW(stepped, lr=schedule(0), betas=(0.9, 0.999),
                                       eps=1e-8, weight_decay=weight_decay)

    def _moment_specs(self, adamw_state: Dict) -> Dict[int, Dict[str, tuple]]:
        return infer_opt_specs(adamw_state, self.names, self.specs)

    def state_dict(self) -> Dict:
        """The AdamW moments and step counts, the count of updates the
        schedule reads, and the clip (a native checkpoint's ``optimizer``).
        Sharded moments are gathered whole, as one device holds them: on a
        model axis a collective, which every rank calls."""
        adamw = self.adamw.state_dict()
        if self.shards:
            specs = self._moment_specs(adamw)
            adamw = dict(adamw, state={
                i: {k: v if specs[i][k] == REPLICATED else gather(self.mesh, v, specs[i][k])
                    for k, v in entry.items()}
                for i, entry in adamw["state"].items()})
        return dict(count=self.count, grad_clip=self.grad_clip, adamw=adamw)

    def load_state_dict(self, state: Dict) -> None:
        """A :meth:`state_dict` (whole moments, from a mesh of any shape):
        the moments of sharded parameters re-sliced to this rank's shard."""
        self.count = int(state["count"])
        self.grad_clip = state["grad_clip"]
        adamw = state["adamw"]
        if self.shards:
            specs, mesh = self._moment_specs(adamw), self.mesh
            adamw = dict(adamw, state={
                i: {k: shard(v, specs[i][k], mesh.model_index, mesh.model)
                    for k, v in entry.items()}
                for i, entry in adamw["state"].items()})
        self.adamw.load_state_dict(adamw)

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)
        for p, _, _ in self.shards:
            p.grad = None

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
        mesh = self.mesh
        for p, s, spec in self.shards:  # the shard of the module's weight as it is now
            s.copy_(shard(p.detach(), spec, mesh.model_index, mesh.model))
            s.grad = None if p.grad is None else shard(p.grad, spec, mesh.model_index,
                                                       mesh.model)
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        for p, s, spec in self.shards:  # the module's whole weight for the next forward
            gather(mesh, s, spec, out=p.data)
        self.count += 1


def make_optimizer(model: nn.Module, lr: float = 1e-5, weight_decay: float = 0.0,
                   schedule: str = "constant", total_steps: int = 100, warmup: int = 0,
                   frozen_prefixes: Sequence[str] = (),
                   grad_clip: Optional[float] = None,
                   mesh: Optional[Mesh] = None) -> Optimizer:
    """AdamW (lr 1e-5, wd 0 by default, ``all_args.sh:14-16`` of the
    reference) over ``model``'s parameters outside ``frozen_prefixes``; the
    frozen ones get ``requires_grad_(False)``.  On a ``mesh`` with a model
    axis, the parameters ``infer_param_specs`` shards are held as shards."""
    mask = frozen_mask(model, frozen_prefixes)
    trainable, names = [], []
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
        if mask[name]:
            trainable.append(p)
            names.append(name)
    return Optimizer(trainable, make_schedule(schedule, lr, total_steps, warmup), weight_decay,
                     grad_clip, names=names, mesh=mesh)
