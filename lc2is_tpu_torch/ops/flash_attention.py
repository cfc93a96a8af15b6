"""Flash attention: softmax(q·kᵀ/√D + key-padding bias)·v without the
(Lq, Lk) logits in device memory, with the row log-sum-exp.

Counterpart of ``lc2is_tpu/ops/flash_attention.py`` (entry ``flash_attention``
:340, forward kernel ``_flash_kernel`` :42).  On a CUDA tensor
:func:`flash_attention` launches the Hopper kernel ``csrc/flash_attention.cu``
(D in {64, 96}: the CLIP ViT-B/16's 12 x 64 heads and the v1 decoders'
8 x 96); on a CPU tensor it runs :func:`flash_attention_plain`, the same
function in plain PyTorch with the kernel's arithmetic: logits in f32 scaled
by 1/√D, softmax statistics in f32, probabilities rounded to v's dtype before
the value product (``:66-68``), f32 sums, a per-row reciprocal at the end
(``:78``).

A fully-masked query row gives NaN (and lse −∞), in the kernel and the plain
version alike, as the reference's docstring (:21) and torch state.  The
Pallas kernel itself does not: its −1e30 key bias turns such a row into the
mean of v over the block-padded key length (``tests/test_torch_flash.py``
pins both).

Training: the backward (TPU row 16, ``_flash_bwd_dq_kernel`` :163 and
``_flash_bwd_dkv_kernel`` :194) is not ported yet; on a CUDA tensor the
kernel runs inside a ``torch.autograd.Function`` whose backward raises.  On a
CPU tensor autograd runs through the plain version.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from lc2is_tpu_torch.ops import _build
from lc2is_tpu_torch.ops.dispatch import use_kernel

KERNEL_HEAD_DIMS = (64, 96)  # D values csrc/flash_attention.cu instantiates


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          key_padding_mask: Optional[torch.Tensor] = None,
                          with_stats: bool = False):
    """Plain PyTorch version of :func:`flash_attention` (any device)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(q.shape[-1]))
    if key_padding_mask is not None:
        s = s.masked_fill(key_padding_mask[:, None, None, :], float("-inf"))
    m = s.amax(-1, keepdim=True)
    # a row with no kept key: p = 0 and l = 0 (not exp(−∞ − (−∞)) = NaN), so
    # the output is 0 · (1/0) = NaN and lse = −∞, as the kernel decides
    p = torch.exp(s - torch.where(m == float("-inf"), torch.zeros_like(m), m))
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    out = (acc * (1.0 / l)).to(q.dtype)
    if with_stats:
        return out, (m + torch.log(l)).squeeze(-1)
    return out


def _check(q, k, v, key_padding_mask):
    """Raise on what the kernel does not take."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 or q.shape[:2] != k.shape[:2] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"flash_attention takes q (B, H, Lq, D), k and v (B, H, Lk, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, lq, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes D in {KERNEL_HEAD_DIMS}, got {d}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention kernel takes one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    _build.dtype_code(q)
    if b * h > 65535 or lq == 0 or k.shape[2] == 0:
        raise ValueError(f"flash_attention kernel takes 1 <= B·H <= 65535 and non-empty "
                         f"sequences, got {tuple(q.shape)} over {tuple(k.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention kernel: {name} must be contiguous, 16-byte "
                             f"aligned and on {q.device}")
    if key_padding_mask is not None:
        _build.check_operands(q.device, key_padding_mask=(key_padding_mask, (b, k.shape[2])))
        if key_padding_mask.dtype != torch.bool:
            raise TypeError(f"key_padding_mask must be bool, got {key_padding_mask.dtype}")


class _FlashForward(torch.autograd.Function):
    """The kernel forward; its backward (TPU row 16) is not ported."""

    @staticmethod
    def forward(ctx, q, k, v, key_padding_mask, with_stats):
        b, h, lq, d = q.shape
        out = torch.empty_like(q)
        lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device) if with_stats else None
        mask = None if key_padding_mask is None else key_padding_mask.contiguous().view(torch.uint8)
        _build.launch(
            "lc2_flash_attention", q.device, _build.dtype_code(q), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), None if mask is None else mask.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b * h, h, lq, k.shape[2], d,
            1.0 / math.sqrt(d), _build.stream_of(q))
        flash_attention.launches += 1
        if with_stats:
            ctx.mark_non_differentiable(lse)
            return out, lse
        return out

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("flash_attention has no backward on the card yet: its backward "
                           "kernels (TPU row 16, lc2is_tpu/ops/flash_attention.py:163 and :194) "
                           "are ported with v1 training; serve under torch.no_grad()")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_padding_mask: Optional[torch.Tensor] = None, with_stats: bool = False):
    """Attention of q (B, H, Lq, D) over k, v (B, H, Lk, D); key_padding_mask
    bool (B, Lk), True = ignore.  Returns the output in q's dtype and, with
    ``with_stats``, the row log-sum-exp (B, H, Lq) in f32.  On a CUDA tensor
    the kernel takes D in {64, 96}, f32 or bf16, contiguous inputs of one
    dtype, and raises on anything else."""
    if not use_kernel(q):
        return flash_attention_plain(q, k, v, key_padding_mask, with_stats)
    _check(q, k, v, key_padding_mask)
    return _FlashForward.apply(q, k, v, key_padding_mask, with_stats)


flash_attention.launches = 0
