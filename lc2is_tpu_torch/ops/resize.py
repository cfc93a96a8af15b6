"""Torch-semantics bilinear and bicubic resize as two matrix products,
nearest as an index gather, and the channels-last token-grid resize.

Counterpart of the ``semantics="torch"`` path of ``lc2is_tpu/ops/resize.py``
(``_torch_resize_matrix`` :49-78, ``_nearest_indices`` :198, ``resize``
:225, ``resize_tokens`` :287):
``F.interpolate(mode="bilinear" | "bicubic", align_corners=False)`` without
antialias (bicubic: a = -0.75, clamped taps), written as an [out, in] weight
matrix per axis (rows then columns).  Plain PyTorch: the JAX package computes
it outside any Pallas kernel.  In bf16
each pass accumulates in f32 and rounds to bf16, as ``resize.py:275-279``
does; f32 runs in full f32.

``resize_tokens`` sends integer factors >= 2 to ``ops/upsample.py``'s
``upsample_tokens`` (the Hopper kernel on CUDA, its plain version on CPU),
as the JAX package sends them to its Pallas kernel.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from lc2is_tpu_torch.ops.upsample import upsample_tokens


def _cubic(x: np.ndarray) -> np.ndarray:
    """torch's cubic convolution kernel (a = -0.75)."""
    a = -0.75
    ax = np.abs(x)
    return np.where(ax <= 1.0, (a + 2.0) * ax ** 3 - (a + 3.0) * ax ** 2 + 1.0,
                    np.where(ax < 2.0, a * ax ** 3 - 5.0 * a * ax ** 2 + 8.0 * a * ax - 4.0 * a,
                             0.0))


@functools.lru_cache(maxsize=64)
def _resize_matrix(in_size: int, out_size: int, scale: Optional[float],
                   method: str) -> np.ndarray:
    """[out, in] matrix of torch bilinear or bicubic, half-pixel centres,
    clamped taps.  ``scale`` is in/out (1/scale_factor when a factor was given)."""
    s = scale if scale is not None else in_size / out_size
    m = np.zeros((out_size, in_size), dtype=np.float64)
    src = (np.arange(out_size, dtype=np.float64) + 0.5) * s - 0.5
    i0 = np.floor(src).astype(np.int64)
    frac = src - i0
    if method == "bilinear":
        taps = ((i0, 1.0 - frac), (i0 + 1, frac))
    else:
        taps = tuple((i0 + t, _cubic(t - frac)) for t in range(-1, 3))
    for tap, wt in taps:
        np.add.at(m, (np.arange(out_size), np.clip(tap, 0, in_size - 1)), wt)
    return m.astype(np.float32)


@functools.lru_cache(maxsize=64)
def resize_taps(in_size: int, out_size: int, scale: Optional[float],
                method: str) -> Tuple[np.ndarray, np.ndarray]:
    """The nonzero entries of :func:`_resize_matrix`'s rows in column order,
    as (columns (out, T) int64, weights (out, T) f32); a row with fewer than
    T entries is padded with weight 0 at its first column."""
    m = _resize_matrix(in_size, out_size, scale, method)
    nz = m != 0
    taps = max(1, int(nz.sum(1).max()))
    cols = np.zeros((out_size, taps), np.int64)
    wts = np.zeros((out_size, taps), np.float32)
    for o in range(out_size):
        c = np.flatnonzero(nz[o])
        cols[o, :len(c)], cols[o, len(c):] = c, c[0] if len(c) else 0
        wts[o, :len(c)] = m[o, c]
    return cols, wts


@functools.lru_cache(maxsize=64)
def _nearest_indices(in_size: int, out_size: int, scale: Optional[float]) -> np.ndarray:
    """torch ``mode="nearest"`` source indices, ``floor(i · in/out)`` (or
    ``floor(i · scale)``), clipped to the input."""
    s = scale if scale is not None else in_size / out_size
    idx = np.floor(np.arange(out_size, dtype=np.float64) * s)
    return np.clip(idx.astype(np.int64), 0, in_size - 1)


def resize(x: torch.Tensor, size=None, scale_factor: Optional[float] = None,
           method: str = "bilinear") -> torch.Tensor:
    """Resize the last two axes of ``x`` (torch bilinear, bicubic or nearest
    semantics).  Output size follows torch's ``floor(in * scale_factor)`` rule."""
    if method not in ("bilinear", "bicubic", "nearest"):
        raise ValueError(f"only bilinear, bicubic and nearest (torch semantics) are ported, got "
                         f"{method}; PIL's methods wait for the port of data/preprocess.py")
    in_h, in_w = int(x.shape[-2]), int(x.shape[-1])
    if size is not None:
        out_h, out_w = (size, size) if isinstance(size, int) else map(int, size)
        scale = None
    else:
        out_h, out_w = int(math.floor(in_h * scale_factor)), int(math.floor(in_w * scale_factor))
        scale = 1.0 / scale_factor
    if method == "nearest":
        ih = torch.from_numpy(_nearest_indices(in_h, out_h, scale)).to(x.device)
        iw = torch.from_numpy(_nearest_indices(in_w, out_w, scale)).to(x.device)
        return x.index_select(-2, ih).index_select(-1, iw)
    wdt = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    wh = torch.from_numpy(_resize_matrix(in_h, out_h, scale, method)).to(x.device, wdt)
    ww = torch.from_numpy(_resize_matrix(in_w, out_w, scale, method)).to(x.device, wdt)
    xc = x.to(wdt)
    y = torch.einsum("oh,...hw->...ow", wh, xc)  # bf16: f32 accumulate, bf16 out
    y = torch.einsum("pw,...ow->...op", ww, y)
    return y.to(x.dtype)


def resize_tokens(tokens: torch.Tensor, grid_hw: Tuple[int, int], size=None,
                  scale_factor: Optional[float] = None, method: str = "bilinear"
                  ) -> torch.Tensor:
    """Resize a (B, H·W, C) token grid spatially, staying channels-last."""
    b, p, c = tokens.shape
    h, w = grid_hw
    if h * w != p:
        raise ValueError(f"grid {grid_hw} does not match {p} tokens")
    if (method == "bilinear" and size is None and scale_factor is not None
            and float(scale_factor).is_integer() and scale_factor >= 2):
        return upsample_tokens(tokens, (h, w), int(scale_factor))
    y = resize(tokens.reshape(b, h, w, c).permute(0, 3, 1, 2), size=size,
               scale_factor=scale_factor, method=method)
    return y.permute(0, 2, 3, 1).reshape(b, -1, c)
