"""Swin window attention on (N, p, C) windows, heads packed in C:

    out = softmax(q·kᵀ/√dh + bias [+ −1e30 where regions differ]) · v

Counterpart of ``lc2is_tpu/ops/window_attention.py::window_attention``
(:216; kernel ``_kernel`` :164, reference ``_xla_window_attention`` :196).
On a CUDA tensor :func:`window_attention` launches
``csrc/window_attention.cu``; on a CPU tensor it runs
:func:`window_attention_plain`.  The semantics are ``_kernel``'s: logits
accumulated in f32 and scaled by 1/√dh, the f32 relative-position bias added,
a query/key pair in different shift regions set to −1e30, the row max
subtracted, the row normalised by one reciprocal of its sum, the
probabilities rounded to v's dtype before the P·V product, which accumulates
in f32 and is cast to q's dtype.

Gradient (``_wa_bwd`` :249-259): the forward is a kernel inside a
``torch.autograd.Function`` whose backward recomputes through the plain
version (the JAX package's backward is an XLA recompute too, with no Pallas
kernel): dq, dk, dv and dbias, nothing for the region labels.

:func:`region_labels` is the 9-region shift trick of HF's ``img_mask``
(``window_attention.py:320-339``): each token of the rolled, partitioned
canvas carries the id of its region, and two tokens attend to each other
only when their ids are equal.  ``ops/swin_window.py`` uses the same
function.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from lc2is_tpu_torch.ops import _build
from lc2is_tpu_torch.ops.dispatch import use_kernel

NEG = -1e30  # the masked logit of window_attention.py:30
MAX_WINDOW_TOKENS = 144  # a window of 12
MAX_HEAD_DIM = 128


def region_labels(batch: int, hp: int, wp: int, window: int, shift: int,
                  device=None) -> Optional[torch.Tensor]:
    """(batch·nW, window²) int32 shift-region ids of the rolled, partitioned
    (hp, wp) canvas, windows in row-major order and the batch outermost; None
    when ``shift`` is 0 (no region masking)."""
    if shift == 0:
        return None

    def region(n):
        # 0: [0, n - window)   1: [n - window, n - shift)   2: [n - shift, n)
        i = torch.arange(n, device=device)
        return (i >= n - window).int() + (i >= n - shift).int()

    img = region(hp)[:, None] * 3 + region(wp)[None, :]
    m = img.reshape(hp // window, window, wp // window, window).transpose(1, 2)
    return m.reshape(-1, window * window).repeat(batch, 1)


def window_attention_plain(q, k, v, bias, regions, num_heads):
    """Plain PyTorch version of :func:`window_attention` (any device,
    differentiable)."""
    n, p, c = q.shape
    dh = c // num_heads

    def heads(t):
        return t.reshape(n, p, num_heads, dh).transpose(1, 2)

    logits = torch.einsum("bhqd,bhkd->bhqk", heads(q).float(), heads(k).float())
    logits = logits * (1.0 / math.sqrt(dh)) + bias.float()[None]
    if regions is not None:
        neq = regions[:, None, :, None] != regions[:, None, None, :]
        logits = logits.masked_fill(neq, NEG)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.float(), heads(v).float())
    return out.transpose(1, 2).reshape(n, p, c).to(q.dtype)


def _check(q, k, v, bias, regions, num_heads):
    n, p, c = q.shape
    if c % num_heads:
        raise ValueError(f"window_attention: C {c} is not a multiple of {num_heads} heads")
    dh = c // num_heads
    if not 1 <= p <= MAX_WINDOW_TOKENS or not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"window_attention kernel: {p} tokens a window (1 to "
                         f"{MAX_WINDOW_TOKENS}) and head width {dh} (1 to {MAX_HEAD_DIM}) "
                         "are outside what it takes")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"window_attention kernel: q, k, v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    shapes = dict(k=(k, (n, p, c)), v=(v, (n, p, c)), bias=(bias, (num_heads, p, p)))
    if regions is not None:
        shapes["regions"] = (regions, (n, p))
    _build.check_operands(q.device, **shapes)


def _launch(q, k, v, bias, regions, num_heads):
    n, p, c = q.shape
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    biasc = bias.float().contiguous()
    reg = None if regions is None else regions.int().contiguous()
    out = torch.empty_like(qc)
    _build.launch(
        "lc2_window_attention", qc.device, _build.dtype_code(qc), qc.data_ptr(), kc.data_ptr(),
        vc.data_ptr(), biasc.data_ptr(), None if reg is None else reg.data_ptr(),
        out.data_ptr(), n, p, c, num_heads, _build.stream_of(qc))
    window_attention.launches += 1
    return out


class _WindowAttention(torch.autograd.Function):
    """The kernel forward; the backward recomputes through the plain version."""

    @staticmethod
    def forward(ctx, q, k, v, bias, regions, num_heads):
        ctx.save_for_backward(q, k, v, bias)
        ctx.regions, ctx.num_heads = regions, num_heads
        return _launch(q, k, v, bias, regions, num_heads)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            out = window_attention_plain(*inputs, ctx.regions, ctx.num_heads)
            grads = torch.autograd.grad(out, inputs, g)
        return (*(d if need else None for d, need in zip(grads, ctx.needs_input_grad)),
                None, None)


def window_attention(q, k, v, bias, regions: Optional[torch.Tensor], num_heads: int):
    """q, k, v (N, p, C) windows, heads packed in C; bias (heads, p, p) f32
    relative-position bias; regions (N, p) int32 shift-region labels or None.
    Returns (N, p, C) in q's dtype.  Differentiable on both devices."""
    if not use_kernel(q):
        return window_attention_plain(q, k, v, bias, regions, num_heads)
    _check(q, k, v, bias, regions, num_heads)
    return _WindowAttention.apply(q, k, v, bias, regions, num_heads)


window_attention.launches = 0
