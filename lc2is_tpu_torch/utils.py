"""Tensor utilities, counterpart of ``lc2is_tpu/utils.py`` (:14-87): the
evaluation's outputs at each image's original size (masks, colours,
padding) and the parameter count.  Tensors in, tensors out, on their device."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lc2is_tpu_torch.ops.resize import resize


def count_params(module: nn.Module, trainable_only: bool = False) -> float:
    """The module's parameter count in millions; ``trainable_only``: only
    those with ``requires_grad``."""
    return sum(p.numel() for p in module.parameters()
               if p.requires_grad or not trainable_only) / 1e6


def original_size_interpolate(tensor: torch.Tensor, ori_sizes) -> List[torch.Tensor]:
    """Each (K, h, w) map resized bicubically to its original size."""
    return [resize(t[None], size=tuple(int(x) for x in s), method="bicubic")[0]
            for t, s in zip(tensor, ori_sizes)]


def generate_masks(preds: torch.Tensor, sizes: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """Each logit map resized bicubically to its original size, then argmax."""
    return [up.argmax(0) for up in original_size_interpolate(preds, sizes)]


def apply_color(mask: torch.Tensor, colors: torch.Tensor) -> torch.Tensor:
    """Colour an (H, W) id mask with an (N, 4) [class id, r, g, b] table:
    (3, H, W); an id the table lacks keeps its value on all three channels."""
    num = int(colors[:, 0].max()) + 1
    lut = torch.zeros((num, 3), dtype=colors.dtype, device=colors.device)
    lut[colors[:, 0].long()] = colors[:, 1:]
    mapped = lut[mask.long().clamp(0, num - 1)]  # (H, W, 3)
    covered = torch.isin(mask, colors[:, 0])
    fallback = mask[..., None].expand(mapped.shape).to(mapped.dtype)
    return torch.where(covered[..., None], mapped, fallback).permute(2, 0, 1)


def pad_and_concat(tensor_list: List[torch.Tensor], ori_sizes, pad: str = "max",
                   value: int = 0) -> torch.Tensor:
    """Pad each tensor right and bottom to the largest size (``pad="max"``, else
    1024²) with ``value``, and stack them."""
    sizes = np.asarray([[int(x) for x in s] for s in ori_sizes])
    max_h, max_w = sizes.max(0) if pad == "max" else (1024, 1024)
    return torch.stack([F.pad(t, (0, int(max_w - w), 0, int(max_h - h)), value=value)
                        for t, (h, w) in zip(tensor_list, sizes)])


def unpad(tensor: torch.Tensor, sizes) -> List[torch.Tensor]:
    """Each (H, W) entry cropped to its size."""
    return [t[:int(s[0]), :int(s[1])] for t, s in zip(tensor, sizes)]


def save_img(file: str, img, size=None) -> None:
    """An image tensor (C, H, W) or (H, W) to a PNG, cropped to ``size``;
    float values in [0, 1] scaled to 0-255."""
    from PIL import Image

    arr = img.detach().cpu().numpy() if isinstance(img, torch.Tensor) else np.asarray(img)
    if size is not None:
        arr = arr[..., :int(size[0]), :int(size[1])]
    if arr.ndim == 3:  # (C, H, W) -> (H, W, C)
        arr = arr.transpose(1, 2, 0)
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0 if arr.max() <= 1.0 else arr, 0, 255).astype(np.uint8)
    Image.fromarray(arr.squeeze()).save(file)
