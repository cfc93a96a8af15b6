"""Preprocessing of a decoded batch on the device, counterpart of
``lc2is_tpu/data/preprocess.py``: the collator's resize, normalisation and
label remap as one stage on the tensors' device.

- shortest-edge antialiased bicubic resize and centre crop, PIL's semantics
  (the HF ``CLIPFeatureExtractor`` path, ``ops/resize.py`` with
  ``semantics="pil"``);
- scale 1/255 and the CLIP or ImageNet statistics;
- labels by PIL's nearest resize to ``label_size`` and the same crop
  (``collator.py:89-91``);
- :func:`compact_ids`: the batch's class ids onto 0 .. n-1
  (``OldCollator.change_ids``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from lc2is_tpu_torch.data.ade20k import CLIP_MEAN, CLIP_STD, IMAGENET_MEAN, IMAGENET_STD
from lc2is_tpu_torch.ops.resize import resize


def _shortest_edge_dims(h: int, w: int, size: int) -> Tuple[int, int]:
    if h < w:
        return size, max(1, int(round(w * size / h)))
    return max(1, int(round(h * size / w))), size


def _center_crop(x: torch.Tensor, size: int) -> torch.Tensor:
    top, left = (x.shape[-2] - size) // 2, (x.shape[-1] - size) // 2
    return x[..., top:top + size, left:left + size]


def preprocess_batch(images: torch.Tensor, labels: torch.Tensor, img_size: int = 512,
                     label_size: int = 128, stats: str = "clip"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """images (B, 3, H, W) uint8 or float in [0, 255], labels (B, H, W)
    ints -> ((B, 3, img_size, img_size) f32 normalised, (B, label_size,
    label_size) int32)."""
    h, w = images.shape[-2:]
    x = resize(images.float(), size=_shortest_edge_dims(h, w, img_size), method="bicubic",
               semantics="pil")
    x = _center_crop(x, img_size) / 255.0
    mean, std = (CLIP_MEAN, CLIP_STD) if stats == "clip" else (IMAGENET_MEAN, IMAGENET_STD)
    mean = torch.as_tensor(mean, device=x.device)[None, :, None, None]
    std = torch.as_tensor(std, device=x.device)[None, :, None, None]
    x = (x - mean) / std
    y = resize(labels[:, None].float(), size=_shortest_edge_dims(h, w, label_size),
               method="nearest", semantics="pil")
    return x, _center_crop(y, label_size)[:, 0].to(torch.int32)


def compact_ids(labels: torch.Tensor, num_classes: int = 151):
    """The batch's present class ids mapped onto 0 .. n-1 in increasing
    order: (remapped labels, the (K,) table whose row i is the original id of
    compact id i (its first n rows; ``table[remapped]`` restores the
    labels), n as a 0-d tensor)."""
    present = torch.zeros(num_classes, dtype=torch.int32, device=labels.device)
    present[labels.reshape(-1).long()] = 1
    new_of_old = torch.cumsum(present, 0) - 1
    remapped = new_of_old[labels.long()]
    ids = torch.arange(num_classes, device=labels.device)
    old_of_new = torch.argsort(torch.where(present == 1, ids, num_classes), stable=True)
    return remapped, old_of_new, present.sum()
