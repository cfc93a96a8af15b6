"""Segmentation metrics, counterpart of ``lc2is_tpu/metrics/miou.py`` (:28-113):
the per-image present-class mIoU, the confusion matrix and the dataset mIoU
from it, and pixel accuracy.

Semantics, as the JAX package's:
- ``per_image_miou`` resizes the logits bicubically ×4 and the labels by
  nearest ×4 (torch semantics), takes the argmax over the classes (ties to
  the lowest class), and averages per image the IoU of the classes present
  in that image's label, class ``ignore_index`` excluded (an all-ignore
  image scores 0), then over the images;
- confusion counts are laid out [pred, label], from one ``bincount`` of
  ``pred · K + label``; IoU is 0 where the union is 0, counts divided in f32.

Plain PyTorch: the JAX package computes these in XLA, outside any Pallas
kernel.  Each image is resized and counted on its own, its rows in chunks,
so the memory stays a few chunks whatever the batch (one image's ×4 map is
2.5 GB at 512² and 151 classes).  The resize here is the sum of each
output's taps (``ops/resize.py::resize_taps``) in a fixed order,
elementwise: the card and the CPU give the same resized values, so the same
argmax maps, where a matrix product's order differs.

A function given tensors computes where they lie; given numpy arrays, on the
card unless ``device`` names another.  Without a card that default raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from lc2is_tpu_torch.core.mesh import DATA_AXIS, all_reduce_sum
from lc2is_tpu_torch.ops.resize import resize, resize_taps

# elements of one chunk of rows of a resized map (64 MB of f32; the bits do
# not depend on it: a CPU takes an image at 2048² in 4.5 s in such chunks, in
# 12 s in chunks four times larger)
CHUNK_ELEMENTS = 1 << 24


def as_tensor(x, device=None) -> torch.Tensor:
    """``x`` on ``device``: by default a tensor stays where it lies and a
    numpy array goes to the card, which must be there."""
    if device is None:
        device = x.device if isinstance(x, torch.Tensor) else "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the metrics run on the card by default; pass "
                           "device='cpu' to compute them on the CPU")
    return torch.as_tensor(x, device=device)


def _tap_sum(x: torch.Tensor, cols: torch.Tensor, wts: torch.Tensor) -> torch.Tensor:
    """Σ_t wts[:, t] · x[..., cols[:, t], :] along dim -2, each product and sum
    its own rounded op, in tap order."""
    acc = None
    for t in range(cols.shape[1]):
        term = x.index_select(-2, cols[:, t]).mul_(wts[:, t, None])
        acc = term if acc is None else acc.add_(term)
    return acc


def resized_argmax(logits: torch.Tensor, size=None, scale_factor: Optional[float] = None
                   ) -> torch.Tensor:
    """argmax over the classes of (K, h, w) f32 ``logits`` resized bicubically
    to ``size`` (or by ``scale_factor``) with torch semantics: rows first, then columns,
    as ``ops/resize.py::resize``.  Returns (H, W) int64.  The column pass runs
    on each chunk of rows transposed, so both passes gather whole rows."""
    k, h, w = logits.shape
    if size is not None:
        (out_h, out_w), scale = size, None
    else:
        out_h, out_w = math.floor(h * scale_factor), math.floor(w * scale_factor)
        scale = 1.0 / scale_factor
    dev = logits.device
    ch, wh = (torch.from_numpy(a).to(dev) for a in resize_taps(h, int(out_h), scale, "bicubic"))
    cw, ww = (torch.from_numpy(a).to(dev) for a in resize_taps(w, int(out_w), scale, "bicubic"))
    rows = max(1, CHUNK_ELEMENTS // (k * int(out_w)))
    pred = []
    for r0 in range(0, int(out_h), rows):
        up = _tap_sum(logits, ch[r0:r0 + rows], wh[r0:r0 + rows])  # (K, rows, w)
        up = _tap_sum(up.transpose(1, 2).contiguous(), cw, ww)  # (K, W, rows)
        pred.append(up.argmax(0).T)
    return torch.cat(pred)


def confusion_matrix(pred: torch.Tensor, label: torch.Tensor, num_classes: int) -> torch.Tensor:
    """int preds and labels of one shape -> (K, K) int32 counts [pred, label]."""
    idx = pred.reshape(-1).long() * num_classes + label.reshape(-1).long()
    k2 = num_classes * num_classes
    return torch.bincount(idx, minlength=k2)[:k2].reshape(num_classes, num_classes).int()


def iou_from_confusion(cm: torch.Tensor) -> torch.Tensor:
    """Per-class IoU in f32; a class with union 0 scores 0."""
    inter = cm.diagonal()
    union = cm.sum(0) + cm.sum(1) - inter
    return torch.where(union > 0, inter.float() / union.clamp_min(1).float(), 0.0)


def _mean_iou(cm: torch.Tensor, present: torch.Tensor, ignore_index: Optional[int]
              ) -> torch.Tensor:
    """Mean IoU over the ``present`` classes, ``ignore_index`` excluded; 0
    when none is."""
    if ignore_index is not None:
        present &= torch.arange(cm.shape[0], device=cm.device) != ignore_index
    iou = torch.where(present, iou_from_confusion(cm), 0.0)
    return iou.sum() / present.sum().clamp_min(1).float()


def present_class_miou(cm: torch.Tensor, ignore_index: Optional[int]) -> torch.Tensor:
    """Mean IoU over the classes present in the label (columns of ``cm``)."""
    return _mean_iou(cm, cm.sum(0) > 0, ignore_index)


def per_image_miou(logits, labels, num_classes: int = 151, ignore_index: Optional[int] = 0,
                   upsample_logits_to_label: bool = True, reduce: bool = True,
                   device=None) -> torch.Tensor:
    """(B, K, h, w) logits, (B, H, W) int labels -> the mean over images of
    each image's present-class mIoU (``reduce=False``: the (B,) values), in
    f32.  With ``upsample_logits_to_label`` the logits go bicubic ×4 and the
    labels nearest ×4 first.  One image at a time (numpy inputs move to the
    device an image at a time)."""
    vals = []
    for i in range(len(labels)):
        lg = as_tensor(logits[i], device).float()
        lab = as_tensor(labels[i], lg.device)
        if upsample_logits_to_label:
            pred = resized_argmax(lg, scale_factor=4)
            lab = resize(lab, scale_factor=4, method="nearest")
        else:
            pred = lg.argmax(0)
        vals.append(present_class_miou(confusion_matrix(pred, lab, num_classes), ignore_index))
    vals = torch.stack(vals)
    return vals.mean() if reduce else vals


def _labels_at(labels: torch.Tensor, hw) -> torch.Tensor:
    """Labels resized by nearest to ``hw`` where they differ from it."""
    if tuple(labels.shape[-2:]) != tuple(hw):
        return resize(labels[:, None], size=tuple(hw), method="nearest")[:, 0]
    return labels


def pixel_accuracy(logits, labels, ignore_index: Optional[int] = 0, device=None
                   ) -> torch.Tensor:
    """Share of the pixels (those not ``ignore_index``) whose argmax is the label."""
    lg = as_tensor(logits, device)
    pred = lg.argmax(1)
    labels = _labels_at(as_tensor(labels, lg.device), pred.shape[-2:])
    correct = pred == labels
    if ignore_index is None:
        return correct.float().mean()
    valid = labels != ignore_index
    return (correct & valid).sum().float() / valid.sum().clamp_min(1).float()


def batch_confusion(logits, labels, num_classes: int = 151, device=None) -> torch.Tensor:
    """The (K, K) confusion counts of a batch's argmax against its labels
    (nearest-resized to the logits), for the dataset mIoU."""
    lg = as_tensor(logits, device)
    pred = lg.argmax(1)
    return confusion_matrix(pred, _labels_at(as_tensor(labels, lg.device), pred.shape[-2:]),
                            num_classes)


def psum_confusion(cm: torch.Tensor, mesh=None) -> torch.Tensor:
    """The confusion counts summed over the ranks of ``mesh``'s data axis, in
    place (JAX ``psum_confusion`` :102; the counts as they are on one
    device): the ranks of this rank's data group, which hold each row once."""
    return all_reduce_sum(mesh, cm, DATA_AXIS)


def dataset_miou(cm, ignore_index: Optional[int] = 0, device=None) -> torch.Tensor:
    """Mean IoU over the classes present in the predictions or the labels of
    a summed confusion matrix, ``ignore_index`` excluded."""
    cm = as_tensor(cm, device)
    return _mean_iou(cm, (cm.sum(0) + cm.sum(1)) > 0, ignore_index)
