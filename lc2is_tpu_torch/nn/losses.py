"""Losses with torch-CE semantics, counterpart of ``lc2is_tpu/nn/losses.py``
(``cross_entropy`` :13, ``auxiliary_loss`` :39; the unused label smoothing
is not ported).  Plain torch: they are the reference the fused upsample-CE
kernel (``ops/fused_ce.py``) is held to."""

from __future__ import annotations

from typing import Optional

import torch

from lc2is_tpu_torch.ops.resize import resize


def cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                  ignore_index: Optional[int] = None) -> torch.Tensor:
    """torch ``nn.CrossEntropyLoss`` (mean reduction) on (B, K, *spatial)
    logits: f32 log-softmax over dim 1, NLL of the target clipped to [0, K),
    averaged over the non-ignored elements (denominator at least 1).  A
    target whose shape is not the logits' without dim 1 raises, as JAX's
    ``take_along_axis`` does (no resize)."""
    if tuple(target.shape) != tuple(logits.shape[:1] + logits.shape[2:]):
        raise ValueError(f"cross_entropy: target {tuple(target.shape)} does not match logits "
                         f"{tuple(logits.shape)} without their class dim")
    k = logits.shape[1]
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=1)
    tgt = target.long().clamp(0, k - 1)
    nll = lse - lf.gather(1, tgt.unsqueeze(1)).squeeze(1)
    if ignore_index is None:
        return nll.mean()
    valid = target != ignore_index
    return torch.where(valid, nll, 0.0).sum() / valid.sum().clamp_min(1)


def auxiliary_loss(low_score_map: torch.Tensor, target: torch.Tensor,
                   ignore_index: Optional[int] = None) -> torch.Tensor:
    """``AuxiliaryLoss``: bilinear-resize the logits to the label's H (square,
    as the reference does ``size=H``), then CE.  The 0.4 weight is the
    training step's."""
    h = target.shape[-2]
    return cross_entropy(resize(low_score_map, size=(h, h), method="bilinear"), target,
                         ignore_index=ignore_index)
