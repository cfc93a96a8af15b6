"""Ground-truth-resolution mIoU, counterpart of ``lc2is_tpu/metrics/gt.py``
(``compute_gt_miou`` :118, ``segmentation_metrics`` :163): each image's
logits resized bicubically to that image's original size, argmax, and the
present-class mIoU there, averaged over the images.

The JAX package groups images by size, or with ``bucket=N`` by canvases of
N-multiples, to bound its number of XLA compiles; both give the same
per-image values (``gt.py:11-17``).  Here nothing is compiled: each image is
resized to its own size, and ``bucket`` is accepted and changes nothing.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from lc2is_tpu_torch.metrics.miou import (as_tensor, confusion_matrix, per_image_miou,
                                          present_class_miou, resized_argmax)


def gt_miou_per_image(logits, gt_list: Sequence, sizes: Sequence[Tuple[int, int]],
                      num_classes: int = 151, ignore_index: Optional[int] = 0,
                      device=None) -> np.ndarray:
    """(N,) f32 present-class mIoU of each image at its original size."""
    vals = []
    for lg, gt, size in zip(logits, gt_list, sizes):
        lg = as_tensor(lg, device).float()
        pred = resized_argmax(lg, size=tuple(int(s) for s in size))
        cm = confusion_matrix(pred, as_tensor(gt, lg.device), num_classes)
        vals.append(present_class_miou(cm, ignore_index).item())
    return np.asarray(vals, np.float32)


def compute_gt_miou(logits, gt_list: Sequence, sizes: Sequence[Tuple[int, int]],
                    num_classes: int = 151, ignore_index: Optional[int] = 0,
                    bucket: Optional[int] = None, device=None) -> Dict[str, float]:
    """``dict(mIOU_gt=...)``: the mean over images of the present-class IoU at
    each image's original resolution.  ``bucket`` is the JAX package's
    compile bound; the values do not depend on it."""
    per_image = gt_miou_per_image(logits, gt_list, sizes, num_classes, ignore_index, device)
    return dict(mIOU_gt=float(per_image.astype(np.float64).mean()))


def segmentation_metrics(outputs, labels, gt_list: Optional[Sequence] = None,
                         sizes: Optional[Sequence[Tuple[int, int]]] = None, n_clas: int = 151,
                         ignore_index: Optional[int] = 0, bucket: Optional[int] = None,
                         device=None) -> Dict[str, float]:
    """The label-path mIoU always (``mIOU_label``), and the GT-path one
    (``mIOU_gt``) when ``gt_list`` and ``sizes`` are given."""
    out = {"mIOU_label": float(per_image_miou(outputs, labels, num_classes=n_clas,
                                              ignore_index=ignore_index, device=device))}
    if gt_list is not None and sizes is not None:
        out.update(compute_gt_miou(outputs, gt_list, sizes, n_clas, ignore_index, bucket=bucket,
                                   device=device))
    return out
