"""Fused bilinear-upsample + softmax cross-entropy, counterpart of
``lc2is_tpu/ops/fused_ce.py`` (entry ``upsampled_cross_entropy`` :302).

    loss = cross_entropy(resize(score_map, scale_factor=r, bilinear), labels)

the mean over non-ignored pixels of the f32 log-softmax NLL of the ×r
upsample, the label clipped to [0, K), with the gradient going straight onto
the low-res map.  On a CUDA tensor :func:`upsampled_cross_entropy` launches
``csrc/fused_ce.cu`` once (the port of both ``_fwd_kernel`` :89 and
``_bwd_kernel`` :117): one pass over tiles of the map in its (B, K, h, w)
layout and the labels in their integer type emits Σ nll, Σ valid and the
unscaled low-res gradient in the map's layout, so neither direction
materialises the (B, K, rH, rW) map, and the backward only scales and casts
it.  On a CPU tensor it runs :func:`upsampled_cross_entropy_plain`, which
materialises the upsample.  r = 1 is plain CE on either device
(``fused_ce.py:313-316``).
"""

from __future__ import annotations

from typing import Optional

import torch

from lc2is_tpu_torch.nn.losses import cross_entropy
from lc2is_tpu_torch.ops import _build
from lc2is_tpu_torch.ops.dispatch import use_kernel
from lc2is_tpu_torch.ops.resize import resize


def upsampled_cross_entropy_plain(score_map, labels, r: int, ignore_index=None):
    """Plain PyTorch version (any device): CE of the f32 bilinear ×r upsample."""
    return cross_entropy(resize(score_map.float(), scale_factor=r, method="bilinear"), labels,
                         ignore_index=ignore_index)


def fused_ce_fwd(score_map, labels, r: int, ignore_index=None):
    """One launch of the kernel: (Σ nll, Σ valid) as a (2,) f32 tensor and
    the unscaled low-res gradient (B, K, h, w) f32.  CUDA tensors only; the
    labels are read as they are when int32 or int64 (other integer types are
    cast to int32)."""
    b, k, h, w = score_map.shape
    if not 1 <= k <= 256 or r < 2:
        raise ValueError(f"fused_ce kernel takes 1 <= K <= 256 classes and r >= 2, got {k}, {r}")
    _build.check_operands(score_map.device, labels=(labels, (b, r * h, r * w)))
    s = score_map.contiguous()
    lab = labels.contiguous()
    if lab.dtype not in (torch.int32, torch.int64):
        lab = lab.to(torch.int32)
    code = _build.dtype_code(s)
    f32 = dict(dtype=torch.float32, device=s.device)
    grad = torch.empty((b, k, h, w), **f32)
    part = torch.empty(_build.size("lc2_fused_ce_partials", code, b, h, w, k, r), **f32)
    sums = torch.empty(2, **f32)
    _build.launch("lc2_fused_ce", s.device, code, s.data_ptr(), lab.data_ptr(),
                  lab.element_size(), grad.data_ptr(), part.data_ptr(), sums.data_ptr(), b, h, w,
                  k, r, int(ignore_index is not None), int(ignore_index or 0), _build.stream_of(s))
    upsampled_cross_entropy.launches += 1
    return sums, grad


class _UpsampledCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, score_map, labels, r, ignore_index):
        sums, grad = fused_ce_fwd(score_map, labels, r, ignore_index)
        denom = sums[1].clamp_min(1.0)
        ctx.save_for_backward(grad, denom)
        ctx.dtype = score_map.dtype
        return sums[0] / denom

    @staticmethod
    def backward(ctx, g):
        grad, denom = ctx.saved_tensors
        d = (grad * (g.float() / denom)).to(ctx.dtype)
        return d, None, None, None


def upsampled_cross_entropy(score_map: torch.Tensor, labels: torch.Tensor, r: int,
                            ignore_index: Optional[int] = None) -> torch.Tensor:
    """== cross_entropy(resize(score_map, scale_factor=r, bilinear), labels)
    for (B, K, h, w) low-res logits and (B, r·h, r·w) integer labels; a 0-d
    f32 loss, differentiable in ``score_map``."""
    if score_map.shape[-2] * r != labels.shape[-2] or score_map.shape[-1] * r != labels.shape[-1]:
        raise ValueError(f"labels {tuple(labels.shape)} are not {r} x score map "
                         f"{tuple(score_map.shape)}")
    if r == 1:
        return cross_entropy(score_map, labels, ignore_index=ignore_index)
    if not use_kernel(score_map):
        return upsampled_cross_entropy_plain(score_map, labels, r, ignore_index)
    return _UpsampledCE.apply(score_map, labels, r, ignore_index)


upsampled_cross_entropy.launches = 0
