"""Flash attention: softmax(q·kᵀ/√D + key-padding bias)·v without the
(Lq, Lk) logits in device memory, with the row log-sum-exp, and its backward.

Counterpart of ``lc2is_tpu/ops/flash_attention.py`` (entry ``flash_attention``
:340, forward kernel ``_flash_kernel`` :42, backward ``_flash_backward``
:230-300 with ``_flash_bwd_dq_kernel`` :163 and ``_flash_bwd_dkv_kernel``
:194).  On a CUDA tensor :func:`flash_attention` launches the Hopper kernel
``csrc/flash_attention.cu`` (any D from 1 to 128, as the JAX kernel takes any
D: a block spans the whole head dimension), and a gradient through it the
kernels of ``csrc/flash_attention_bwd.cu`` (:func:`flash_attention_bwd`); on
a CPU tensor it runs :func:`flash_attention_plain`, the same function in
plain PyTorch with the kernel's arithmetic: logits in f32 scaled by 1/√D,
softmax statistics in f32, probabilities rounded to v's dtype before the
value product (``:66-68``), f32 sums, a per-row reciprocal at the end
(``:78``), and autograd runs through it.  D > 128 raises on the card.
Both dtypes run on the tensor cores: bf16 as ``mma.sync`` bf16 products,
f32 as 3xTF32 products (each f32 product three TF32 products of the
operands' hi and lo halves, f32-accurate), in the forward and the backward.

A fully-masked query row gives NaN (and lse −∞), in the kernel and the plain
version alike, as the reference's docstring (:21) and torch state.  The
Pallas kernel itself does not: its −1e30 key bias turns such a row into the
mean of v over the block-padded key length (``tests/test_torch_flash.py``
pins both).  The backward decides such a row explicitly: p = 0 there, so its
dq row is 0 and it adds nothing to dk or dv, and its Δ is 0 although its
output is NaN; the Pallas backward would differentiate its mean of v.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from lc2is_tpu_torch.ops import _build
from lc2is_tpu_torch.ops.dispatch import use_kernel

MAX_HEAD_DIM = 128  # csrc/flash_attention*.cu instantiate D rounded up to 16, 16 .. 128


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


def _delta(out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Δ = Σ_d dO·O per query row in f32 (``:242-246``), 0 on a fully-masked
    row (lse −∞), whose output is NaN."""
    return (g.float() * out.float()).sum(-1).masked_fill(torch.isneginf(lse), 0.0)


def flash_attention_backward_plain(q, k, v, key_padding_mask, out, lse, g):
    """Plain PyTorch version of :func:`flash_attention_bwd`: (dq, dk, dv) from
    the forward's output and f32 lse (B, H, Lq) and the output gradient g,
    with the kernels' arithmetic: p = exp(s·scale − lse) (0 at a masked key
    and on a fully-masked row), ds = p·(g·vᵀ − Δ), ds rounded to k's dtype
    before dq = scale·ds·k and to q's before dk = scale·dsᵀ·q, p rounded to
    g's dtype before dv = pᵀ·g, every sum in f32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    live = torch.isfinite(lse)[..., None].expand_as(s)
    if key_padding_mask is not None:
        live = live & ~key_padding_mask[:, None, None, :]
    p = torch.where(live, torch.exp(s * scale - lse[..., None]), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", g.float(), v.float())
    ds = torch.where(live, p * (dp - _delta(out, lse, g)[..., None]), 0.0)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.to(k.dtype).float(), k.float()) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).float(), q.float()) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(g.dtype).float(), g.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v, key_padding_mask):
    """Raise on what the kernel does not take."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 or q.shape[:2] != k.shape[:2] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"flash_attention takes q (B, H, Lq, D), k and v (B, H, Lk, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, lq, d = q.shape
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes 1 <= D <= {MAX_HEAD_DIM}, got {d}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention kernel takes one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    _build.dtype_code(q)
    if b * h == 0 or lq == 0 or k.shape[2] == 0:
        raise ValueError(f"flash_attention kernel takes non-empty inputs, got {tuple(q.shape)} "
                         f"over {tuple(k.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention kernel: {name} must be contiguous, 16-byte "
                             f"aligned and on {q.device}")
    if key_padding_mask is not None:
        _build.check_operands(q.device, key_padding_mask=(key_padding_mask, (b, k.shape[2])))
        if key_padding_mask.dtype != torch.bool:
            raise TypeError(f"key_padding_mask must be bool, got {key_padding_mask.dtype}")


def _mask_bytes(key_padding_mask):
    return None if key_padding_mask is None else key_padding_mask.contiguous().view(torch.uint8)


def flash_attention_bwd(q, k, v, key_padding_mask, out, lse, g):
    """(dq, dk, dv) of :func:`flash_attention` from its output, its f32 lse
    (B, H, Lq) and the output gradient g.  On a CUDA tensor: Δ in torch, then
    the dq kernel and the dk/dv kernel (one launch counted); on a CPU tensor
    :func:`flash_attention_backward_plain`."""
    if not use_kernel(q):
        return flash_attention_backward_plain(q, k, v, key_padding_mask, out, lse, g)
    _check(q, k, v, key_padding_mask)
    b, h, lq, d = q.shape
    g = g.to(q.dtype).contiguous()
    _build.check_operands(q.device, out=(out, q.shape), lse=(lse, (b, h, lq)), g=(g, q.shape))
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("flash_attention_bwd: lse must be contiguous float32")
    delta = _delta(out, lse, g).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    mask = _mask_bytes(key_padding_mask)
    _build.launch(
        "lc2_flash_attention_bwd", q.device, _build.dtype_code(q), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), None if mask is None else mask.data_ptr(), g.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * h, h, lq, k.shape[2],
        d, 1.0 / math.sqrt(d), _build.stream_of(q))
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class _FlashForward(torch.autograd.Function):
    """The kernel forward; when a gradient is needed it keeps q, k, v, the
    output and the lse (computed even when the caller did not ask for it)
    for :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, key_padding_mask, with_stats):
        b, h, lq, d = q.shape
        train = any(ctx.needs_input_grad[:3])
        out = torch.empty_like(q)
        lse = (torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
               if with_stats or train else None)
        mask = _mask_bytes(key_padding_mask)
        _build.launch(
            "lc2_flash_attention", q.device, _build.dtype_code(q), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), None if mask is None else mask.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b * h, h, lq, k.shape[2], d,
            1.0 / math.sqrt(d), _build.stream_of(q))
        flash_attention.launches += 1
        if train:
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.key_padding_mask = key_padding_mask
        if with_stats:
            ctx.mark_non_differentiable(lse)
            return out, lse
        return out

    @staticmethod
    def backward(ctx, g, *_):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, ctx.key_padding_mask, out, lse, g)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_padding_mask: Optional[torch.Tensor] = None, with_stats: bool = False):
    """Attention of q (B, H, Lq, D) over k, v (B, H, Lk, D); key_padding_mask
    bool (B, Lk), True = ignore.  Returns the output in q's dtype and, with
    ``with_stats``, the row log-sum-exp (B, H, Lq) in f32.  On a CUDA tensor
    the kernel takes 1 <= D <= 128, f32 or bf16, contiguous inputs of one
    dtype, and raises on anything else; a gradient runs the backward kernels."""
    if not use_kernel(q):
        return flash_attention_plain(q, k, v, key_padding_mask, with_stats)
    _check(q, k, v, key_padding_mask)
    return _FlashForward.apply(q, k, v, key_padding_mask, with_stats)


flash_attention.launches = 0
