"""Host-side image/label transforms with the reference's semantics, a copy of
``lc2is_tpu/data/transforms.py``.

Two preprocessing families coexist in the reference (SURVEY.md §9 item 4):
- dataset-side (``ADE20K``): ImageNet normalization + user transform under a
  shared RNG (``dataset.py:145-149``);
- collator-side (HF ``CLIPFeatureExtractor``): shortest-edge PIL-bicubic
  antialiased resize + center crop + CLIP normalization for images;
  PIL-NEAREST, mean 0 / std 1, ``×255 → long`` for labels
  (``evaluate.py:58-60``, ``collator.py:89-91``).

Transforms take (C, H, W) numpy arrays and a ``seed`` so image and label
apply identical randomness (``is_label`` switches interpolation to nearest).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def _pil_resize(arr: np.ndarray, size_hw: Tuple[int, int], nearest: bool) -> np.ndarray:
    """(C,H,W) resize via PIL per channel (exact HF/PIL semantics)."""
    from PIL import Image

    c, h, w = arr.shape
    out = np.empty((c, size_hw[0], size_hw[1]), dtype=np.float32)
    resample = Image.NEAREST if nearest else Image.BICUBIC
    for i in range(c):
        im = Image.fromarray(arr[i].astype(np.float32), mode="F")
        out[i] = np.asarray(im.resize((size_hw[1], size_hw[0]), resample))
    return out


class Resize:
    """Square resize (the reference drives HF extractors with size=crop)."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, x: np.ndarray, seed: int = 0, is_label: bool = False) -> np.ndarray:
        return _pil_resize(x, (self.size, self.size), nearest=is_label)


class ShortestEdgeResizeCenterCrop:
    """HF CLIPFeatureExtractor: resize shortest edge then center crop."""

    def __init__(self, size: int, crop_size: Optional[int] = None):
        self.size = size
        self.crop = crop_size or size

    def __call__(self, x: np.ndarray, seed: int = 0, is_label: bool = False) -> np.ndarray:
        c, h, w = x.shape
        if h < w:
            nh, nw = self.size, max(1, int(round(w * self.size / h)))
        else:
            nh, nw = max(1, int(round(h * self.size / w))), self.size
        y = _pil_resize(x, (nh, nw), nearest=is_label)
        top = (nh - self.crop) // 2
        left = (nw - self.crop) // 2
        return y[:, top : top + self.crop, left : left + self.crop]


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, x: np.ndarray, seed: int = 0, is_label: bool = False) -> np.ndarray:
        if np.random.RandomState(seed).rand() < self.p:
            return x[:, :, ::-1].copy()
        return x


class RandomCrop:
    def __init__(self, size: int):
        self.size = size

    def __call__(self, x: np.ndarray, seed: int = 0, is_label: bool = False) -> np.ndarray:
        c, h, w = x.shape
        rng = np.random.RandomState(seed + 1)
        top = rng.randint(0, max(1, h - self.size + 1))
        left = rng.randint(0, max(1, w - self.size + 1))
        return x[:, top : top + self.size, left : left + self.size]


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, x: np.ndarray, seed: int = 0, is_label: bool = False) -> np.ndarray:
        for i, t in enumerate(self.transforms):
            x = t(x, seed=seed + i * 7919, is_label=is_label)
        return x
