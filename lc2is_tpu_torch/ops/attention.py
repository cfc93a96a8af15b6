"""Multi-head scaled-dot-product core with torch ``F.multi_head_attention_forward``
semantics, as a plain einsum-softmax or the flash kernel.

Counterpart of ``lc2is_tpu/ops/attention.py:29-86``, with its dispatch
(``:48-54``): a call with no dense ``attn_mask`` whose logits are big enough,
Lq·Lk >= 2^20 (the CLIP ViT-B/16's 1025² at 512², the v1 decoders'
self-attention), goes to ``ops/flash_attention``'s kernel on a CUDA tensor;
every other call, and every call on the CPU (as the JAX package keeps its CPU
backend on XLA), takes the einsum path.  The kernel takes one dtype, so a
call whose q, k and v differ in dtype stays on the einsum path, which follows
JAX's promotion.  A call with active attention dropout stays on the einsum
path too, as JAX's gate keeps it off flash (``:51``, ``:72-74``): the
dropout applies to the f32 probabilities before their rounding, its mask
drawn from the caller's ``torch.Generator``.

Masks: ``key_padding_mask`` is boolean (B, S) with True = IGNORE (torch
polarity); ``attn_mask`` is additive float or boolean (True = masked).  A
fully-masked query row yields NaN, as in torch and the JAX reference.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from lc2is_tpu_torch.ops.dispatch import use_kernel
from lc2is_tpu_torch.ops.flash_attention import flash_attention

FLASH_MIN_LOGITS = 1 << 20  # the gate of lc2is_tpu/ops/attention.py:51


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout (``lc2is_tpu/nn/layers.py:156-164``): each element kept
    with probability 1 − rate and scaled by 1 / (1 − rate), else 0; the mask
    drawn from ``generator`` (never from a global state).  Identity at rate 0."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout needs a torch.Generator for its masks")
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def scaled_dot_product_attention(
    q: torch.Tensor,  # (B, H, Lq, Dh)
    k: torch.Tensor,  # (B, H, Lk, Dh)
    v: torch.Tensor,  # (B, H, Lk, Dh)
    key_padding_mask: Optional[torch.Tensor] = None,  # (B, Lk) True = ignore
    attn_mask: Optional[torch.Tensor] = None,  # (Lq, Lk) additive or bool
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Returns (B, H, Lq, Dh); logits and softmax in f32.

    JAX promotes mixed dtypes where torch does not, so the einsum path casts
    explicitly, at JAX's points: logits from f32 copies of q and k, the
    probabilities rounded to q's dtype, and the value product and the result
    in the promoted type of q and v.  That covers the ContextDecoder's f32
    text over the bf16 stage-3 memory (an f32 result) and the v1 decoders'
    bf16 queries over the f32 text (probabilities rounded to bf16, an f32
    result).  ``dropout_rate`` > 0 (training) drops probabilities with masks
    from ``generator``."""
    if (attn_mask is None and dropout_rate == 0.0 and use_kernel(q)
            and q.shape[2] * k.shape[2] >= FLASH_MIN_LOGITS and q.dtype == k.dtype == v.dtype):
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), key_padding_mask)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(q.shape[-1])
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = logits.masked_fill(attn_mask, float("-inf"))
        else:
            logits = logits + attn_mask.float()
    if key_padding_mask is not None:
        logits = logits.masked_fill(key_padding_mask[:, None, None, :], float("-inf"))
    out_dt = torch.promote_types(q.dtype, v.dtype)
    probs = dropout(torch.softmax(logits, dim=-1), dropout_rate, generator)
    probs = probs.to(q.dtype).to(out_dt)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.to(out_dt))


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, l, e = x.shape
    return x.reshape(b, l, num_heads, e // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)
