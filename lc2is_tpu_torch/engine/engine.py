"""The training step, counterpart of ``train_step`` in
``lc2is_tpu/engine/engine.py`` (:236-313), with its branch rule (:246-250):

- a model with ``return_score_map`` (the v4 family; ``bench_train.py:58-73``
  times the flagship) emits its low-res score maps, and each loss is the
  fused upsample-CE at r = labels / map (main, and the auxiliary one on
  ``low_score_map`` times ``aux_weight``, 0.4); labels that are no integer
  multiple of a map take the reference's fallback, a bilinear resize of the
  map to the labels and the plain CE (``_fused_or_plain_ce`` :271-281);
- any other model (the v1 family: ``BaseModelWithText`` returns a tuple,
  adapted by :func:`_normalize_output`) takes the plain cross-entropy of
  ``outputs`` against the labels (:297), plus the auxiliary loss when the
  model returns ``low_score_map`` (:299).

The ``Engine`` class around it (hooks, resume, checkpoints) is not ported
yet (ROADMAP.md §1).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from lc2is_tpu_torch.engine.optim import Optimizer
from lc2is_tpu_torch.nn.losses import auxiliary_loss, cross_entropy
from lc2is_tpu_torch.ops.fused_ce import upsampled_cross_entropy
from lc2is_tpu_torch.ops.resize import resize


def _normalize_output(out) -> Dict[str, torch.Tensor]:
    """A tuple-returning model's output as the dict the step consumes: the
    last non-None item is ``outputs`` (``engine.py:46-53``)."""
    if isinstance(out, dict):
        return out
    return dict(outputs=[o for o in out if o is not None][-1])


def _fused_or_plain_ce(score_map: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The fused upsample-CE at the integer ratio r of labels to map, or,
    when there is none, CE of the map resized to the labels (bilinear)."""
    r = labels.shape[-1] // score_map.shape[-1]
    if r >= 1 and r * score_map.shape[-1] == labels.shape[-1] \
            and r * score_map.shape[-2] == labels.shape[-2]:
        return upsampled_cross_entropy(score_map, labels, r)
    return cross_entropy(resize(score_map, size=tuple(labels.shape[-2:]), method="bilinear"),
                         labels)


def train_step(model: nn.Module, optimizer: Optimizer, inputs: Dict[str, torch.Tensor],
               labels: torch.Tensor, aux_weight: float = 0.4,
               generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """One optimizer step on one batch; returns the detached losses
    (``train_loss``, and ``train_aux_loss`` already times ``aux_weight``).
    ``generator`` draws the drop-path and dropout masks.  Frozen parameters
    are the optimizer's business (:func:`~lc2is_tpu_torch.engine.optim.make_optimizer`
    sets ``requires_grad_(False)`` on them)."""
    model.train()
    out = _normalize_output(model(inputs, generator=generator))
    if getattr(model, "return_score_map", None) is not None:
        losses = {"train_loss": _fused_or_plain_ce(out["outputs"], labels)}
        if "low_score_map" in out:
            losses["train_aux_loss"] = _fused_or_plain_ce(out["low_score_map"],
                                                          labels) * aux_weight
    else:
        losses = {"train_loss": cross_entropy(out["outputs"], labels)}
        if "low_score_map" in out:
            losses["train_aux_loss"] = auxiliary_loss(out["low_score_map"], labels) * aux_weight
    optimizer.zero_grad()
    sum(losses.values()).backward()
    optimizer.step()
    return {k: v.detach() for k, v in losses.items()}
