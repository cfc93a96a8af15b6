"""The training step, counterpart of ``train_step`` in
``lc2is_tpu/engine/engine.py`` (:236-313) on its fused-loss branch, which
``bench_train.py:58-73`` times: the model emits its low-res score maps
(``return_score_map=True``), the main loss is the fused upsample-CE at
r = labels / outputs and the auxiliary loss the same at r = labels /
low_score_map, times ``aux_weight`` (0.4).  The labels must be an integer
multiple of both maps (``upsampled_cross_entropy`` raises otherwise); the
reference's resize + CE fallback for other label sizes is not ported.

The ``Engine`` class around it (hooks, resume, checkpoints) is not ported
yet (ROADMAP.md §1 item 10).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from lc2is_tpu_torch.engine.optim import Optimizer
from lc2is_tpu_torch.ops.fused_ce import upsampled_cross_entropy


def train_step(model: nn.Module, optimizer: Optimizer, inputs: Dict[str, torch.Tensor],
               labels: torch.Tensor, aux_weight: float = 0.4,
               generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """One optimizer step on one batch; returns the detached losses
    (``train_loss``, and ``train_aux_loss`` already times ``aux_weight``).
    ``generator`` draws the drop-path masks.  Frozen parameters are the
    optimizer's business (:func:`~lc2is_tpu_torch.engine.optim.make_optimizer`
    sets ``requires_grad_(False)`` on them)."""
    model.train()
    out = model(inputs, generator=generator)
    r = labels.shape[-1] // out["outputs"].shape[-1]
    losses = {"train_loss": upsampled_cross_entropy(out["outputs"], labels, r)}
    if "low_score_map" in out:
        r = labels.shape[-1] // out["low_score_map"].shape[-1]
        losses["train_aux_loss"] = upsampled_cross_entropy(out["low_score_map"], labels,
                                                           r) * aux_weight
    optimizer.zero_grad()
    sum(losses.values()).backward()
    optimizer.step()
    return {k: v.detach() for k, v in losses.items()}
