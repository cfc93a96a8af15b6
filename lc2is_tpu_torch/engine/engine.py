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

The evaluation, counterpart of the engine's ``eval_step`` (:315-324) and of
``Engine.eval_loop`` / ``Engine.evaluate`` (:404-476): :func:`eval_step` runs
the model in eval mode without gradients and returns its losses (the plain
CE of ``outputs``, the auxiliary loss times ``aux_weight``), the batch's
per-image mIoU, its confusion counts and the f32 logits; :func:`evaluate`
runs it over batches as the JAX loaders give them and reduces as the JAX
engine does.

The ``Engine`` class around them (hooks, resume, checkpoints) is not ported
yet (ROADMAP.md §1).
"""

from __future__ import annotations

import inspect
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
from torch import nn

from lc2is_tpu_torch.engine.optim import Optimizer
from lc2is_tpu_torch.metrics.miou import batch_confusion, dataset_miou, per_image_miou
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


def eval_step(model: nn.Module, inputs: Dict[str, torch.Tensor], labels: torch.Tensor,
              aux_weight: float = 0.4, num_classes: int = 151):
    """One batch in eval mode, without gradients: ``(losses, miou, cm,
    logits)``: ``eval_loss`` (the plain CE of ``outputs``) and, where the
    model returns ``low_score_map``, ``eval_aux_loss`` (the auxiliary loss
    times ``aux_weight``); the batch's mean per-image mIoU (logits bicubic ×4,
    labels nearest ×4); the (K, K) confusion counts at the logits' size; the
    logits in f32."""
    model.eval()
    with torch.no_grad():
        out = _normalize_output(model(inputs))
        losses = {"eval_loss": cross_entropy(out["outputs"], labels)}
        if "low_score_map" in out:
            losses["eval_aux_loss"] = auxiliary_loss(out["low_score_map"], labels) * aux_weight
        logits = out["outputs"].float()
        miou = per_image_miou(logits, labels, num_classes=num_classes)
        cm = batch_confusion(logits, labels, num_classes=num_classes)
    return losses, miou, cm, logits


def on_device(x, device: torch.device) -> torch.Tensor:
    """A batch entry on ``device``; integer arrays as int64."""
    x = torch.as_tensor(x)
    return (x if x.is_floating_point() else x.long()).to(device)


def model_device(model: nn.Module) -> torch.device:
    """Where the model's parameters live."""
    return next(model.parameters()).device


def evaluate(model: nn.Module, batches: Iterable, aux_weight: float = 0.4,
             num_classes: int = 151, keep_eval_outputs: bool = False,
             compute_metrics: Optional[Callable] = None) -> Dict[str, float]:
    """:func:`eval_step` over ``batches`` (each a dict with ``pixel_values``
    and ``label``, or ``(dict, metas)``), on the model's device.  Returns the
    mean of each loss, ``eval_mIOU_label`` (the per-image mIoU weighted by
    batch size) and ``eval_mIOU_dataset`` (from the summed confusion counts).
    With ``keep_eval_outputs`` the logits and labels are kept on the host,
    with ``gt_list`` and ``sizes`` where every image's metas carry them, and
    ``compute_metrics(**kept)``'s results are added, prefixed ``eval_``."""
    device = model_device(model)
    all_metrics: Dict[str, list] = {}
    miou_sum, n_img = 0.0, 0
    cm_total = torch.zeros((num_classes, num_classes), dtype=torch.int64, device=device)
    all_outputs, all_labels, gt_list, sizes = [], [], [], []
    for data in batches:
        inputs = dict(data[0]) if isinstance(data, tuple) else dict(data)
        metas = data[1] if isinstance(data, tuple) and len(data) > 1 else None
        labels = on_device(inputs.pop("label"), device)
        inputs = {k: on_device(v, device) for k, v in inputs.items() if k != "size"}
        losses, miou, cm, logits = eval_step(model, inputs, labels, aux_weight, num_classes)
        b = int(labels.shape[0])
        miou_sum += float(miou) * b
        n_img += b
        cm_total += cm
        for k, v in losses.items():
            all_metrics.setdefault(k, []).append(float(v))
        if keep_eval_outputs:
            all_outputs.append(logits.cpu().numpy())
            all_labels.append(labels.cpu().numpy())
            for m in metas if isinstance(metas, list) else ():
                if isinstance(m, dict) and "size" in m:
                    sizes.append(m["size"])
                if isinstance(m, dict) and "gt" in m:
                    gt_list.append(np.asarray(m["gt"]))
    eval_metrics = {k: float(np.mean(v)) for k, v in all_metrics.items()}
    eval_metrics["eval_mIOU_label"] = miou_sum / max(n_img, 1)
    eval_metrics["eval_mIOU_dataset"] = float(dataset_miou(cm_total))
    if compute_metrics is None or not all_outputs:
        return eval_metrics
    kept = dict(outputs=np.concatenate(all_outputs), labels=np.concatenate(all_labels))
    if gt_list and sizes and len(gt_list) == len(kept["outputs"]) == len(sizes):
        kept.update(gt_list=gt_list, sizes=sizes)
    params = inspect.signature(compute_metrics).parameters
    if not any(p.kind == p.VAR_KEYWORD for p in params.values()):
        kept = {k: v for k, v in kept.items() if k in params}
    metrics = compute_metrics(**kept)
    return {**eval_metrics, **{"eval_" + k: v for k, v in metrics.items()}}
