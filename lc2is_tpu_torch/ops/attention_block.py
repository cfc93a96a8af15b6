"""Fused attention block of the decoder layers: q-projection + multi-head
attention over pre-projected K/V + out-projection + residual + post-LN.

Counterpart of ``lc2is_tpu/ops/attention_block.py`` (entry
``fused_attn_block`` :220).  K/V arrive already projected to (B, L, C), as
in JAX (their projections are plain matmuls outside the kernel).  On a CUDA
tensor :func:`fused_attn_block` launches ``csrc/attention_block.cu`` with
1/√dh folded into wq/bq (``attention_block.py:155-160``); on a CPU tensor it
runs :func:`fused_attn_block_plain`, the module composition of
``attention_block.py:93-113``.

Training: on a CUDA tensor the kernel runs inside a ``torch.autograd.Function``
whose backward is :func:`fused_attn_block_bwd` (``csrc/attention_block_bwd.cu``,
the port of ``attention_block.py::_bwd_kernel`` :264).  The 1/√dh fold into
wq/bq happens outside the Function as differentiable torch ops, and so do the
K/V projections, so autograd carries dK and dV back through them.  On a CPU
tensor autograd runs through the plain version.  In bf16 the backward's
products run on the tensor cores with bf16 intermediates where the TPU
kernel rounds (its workspace: ``lc2_attn_block_bwd_workspace_bf16``); in f32
on the CUDA cores (``lc2_attn_block_bwd_workspace``).

Int8 serving (the JAX entry's ``quant=True``, ``attention_block.py:38-96,190-205``):
:func:`fused_attn_block_q` quantises the folded q weights (1/√dh folded in
f32, rounded back to wq's dtype, then ``quantize_weight``) and wo per output
channel, and x and the head outputs per token (``ops/quant.py``); the
attention itself is the float block's.  On a CUDA tensor it launches the
int8 variant of ``csrc/attention_block.cu``; on a CPU tensor it runs
:func:`fused_attn_block_q_plain`.  Forward only: it raises if autograd needs
a gradient through it, as the JAX entry has no VJP on this branch.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from lc2is_tpu_torch.ops import _build
from lc2is_tpu_torch.ops.dispatch import use_kernel
from lc2is_tpu_torch.ops.quant import forward_only, qdot, quantize_weight


def _block_plain(x, k, v, q_proj, out_proj, ln_w, ln_b, num_heads, eps, softmax):
    """The plain block around its two projections: q = q_proj(x) in x's dtype;
    per head, f32 logits, ``softmax(logits)`` rounded to x's dtype, the
    weighted sum of v summed in f32 and rounded; s = out_proj(heads merged),
    the f32 pre-LN sum with the residual; LN(s) in f32, rounded."""
    b, p, c = x.shape
    dt = x.dtype
    dh = c // num_heads

    def heads(a):
        return a.reshape(a.shape[0], a.shape[1], num_heads, dh).transpose(1, 2).float()

    logits = torch.einsum("bhqd,bhkd->bhqk", heads(q_proj(x)), heads(k.to(dt)))
    probs = softmax(logits).to(dt)
    attn = torch.einsum("bhqk,bhkd->bhqd", probs.float(), heads(v.to(dt))).to(dt)
    s = out_proj(attn.transpose(1, 2).reshape(b, p, c))
    return F.layer_norm(s, (c,), ln_w, ln_b, eps).to(dt)


def fused_attn_block_plain(x, k, v, wq, bq, wo, bo, ln_w, ln_b, num_heads, eps=1e-5):
    """Plain PyTorch version of :func:`fused_attn_block` (any device)."""
    dt = x.dtype
    root = math.sqrt(x.shape[-1] // num_heads)
    return _block_plain(
        x, k, v, lambda a: F.linear(a, wq.to(dt), bq.to(dt)),
        lambda a: (F.linear(a, wo.to(dt), bo.to(dt)) + x).float(), ln_w.float(), ln_b.float(),
        num_heads, eps, lambda logits: torch.softmax(logits / root, dim=-1))


def _check(x, k, v, wq, bq, wo, bo, ln_w, ln_b, num_heads):
    b, p, c = x.shape
    l = k.shape[1]
    dh = c // num_heads
    if (c not in (64, 128, 256, 512) or num_heads > 8 or c % num_heads
            or dh not in (16, 32, 64) or l < 1):
        raise ValueError(f"fused_attn_block kernel: unsupported x {tuple(x.shape)}, "
                         f"k/v {tuple(k.shape)}/{tuple(v.shape)}, heads {num_heads}")
    _build.check_operands(x.device, k=(k, (b, l, c)), v=(v, (b, l, c)), wq=(wq, (c, c)),
                          bq=(bq, (c,)), wo=(wo, (c, c)), bo=(bo, (c,)), ln_w=(ln_w, (c,)),
                          ln_b=(ln_b, (c,)))


def fold_q_scale(wq, bq, num_heads):
    """(wq, bq) · 1/√dh in f32 before any rounding (``attention_block.py:155-160``);
    differentiable."""
    scale = 1.0 / math.sqrt(wq.shape[0] // num_heads)
    return wq.float() * scale, bq.float() * scale


def _launch_fwd(x, k, v, wq_s, bq_s, wo, bo, ln_w, ln_b, num_heads, eps):
    b, p, c = x.shape
    dt = x.dtype
    xc, kc, vc = (t.to(dt).contiguous() for t in (x, k, v))
    rest = [t.to(dt).contiguous() for t in (wq_s, bq_s, wo, bo, ln_w, ln_b)]
    out = torch.empty_like(xc)
    _build.launch(
        "lc2_attn_block", xc.device, _build.dtype_code(xc), xc.data_ptr(), kc.data_ptr(),
        vc.data_ptr(), *(t.data_ptr() for t in rest), out.data_ptr(), b, p, k.shape[1], c,
        num_heads, float(eps), _build.stream_of(xc))
    fused_attn_block.launches += 1
    return out


def fused_attn_block_bwd(x, k, v, g, wq_s, bq_s, wo, bo, ln_w, ln_b, num_heads, eps=1e-5):
    """Gradients of :func:`fused_attn_block` with respect to (x, k, v, wq_s,
    bq_s, wo, bo, ln_w, ln_b), given g = d loss / d out; ``wq_s``/``bq_s``
    carry the 1/√dh fold (:func:`fold_q_scale`).  x, k, v, g are CUDA tensors
    of the compute dtype; dx comes back in it, the rest in f32.  The forward
    is recomputed inside (``csrc/attention_block_bwd.cu``)."""
    b, p, c = x.shape
    l = k.shape[1]
    _check(x, k, v, wq_s, bq_s, wo, bo, ln_w, ln_b, num_heads)
    _build.check_operands(x.device, g=(g, tuple(x.shape)))
    dt = x.dtype
    xc, kc, vc, gc = (t.to(dt).contiguous() for t in (x, k, v, g))
    # f32 operands holding exactly the values the forward kernel used
    wq, bq, woc, boc, lnw = (t.to(dt).float().contiguous() for t in (wq_s, bq_s, wo, bo, ln_w))
    f32 = dict(dtype=torch.float32, device=x.device)
    dk, dv = torch.empty((b, l, c), **f32), torch.empty((b, l, c), **f32)
    grads = [torch.zeros(s, **f32) for s in ((c, c), (c,), (c, c), (c,), (c,), (c,))]
    dx = torch.empty_like(xc)
    ws_size = ("lc2_attn_block_bwd_workspace_bf16" if dt == torch.bfloat16
               else "lc2_attn_block_bwd_workspace")
    ws = torch.empty(_build.size(ws_size, b, p, l, c, num_heads), **f32)
    _build.launch(
        "lc2_attn_block_bwd", xc.device, _build.dtype_code(xc), xc.data_ptr(), kc.data_ptr(),
        vc.data_ptr(), gc.data_ptr(), wq.data_ptr(), bq.data_ptr(), woc.data_ptr(),
        boc.data_ptr(), lnw.data_ptr(), dx.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *(t.data_ptr() for t in grads), ws.data_ptr(), b, p, l, c, num_heads, float(eps),
        _build.stream_of(xc))
    fused_attn_block_bwd.launches += 1
    return (dx, dk, dv, *grads)


fused_attn_block_bwd.launches = 0


class _FusedAttnBlock(torch.autograd.Function):
    """The kernel forward with :func:`fused_attn_block_bwd` as its backward."""

    @staticmethod
    def forward(ctx, x, k, v, wq_s, bq_s, wo, bo, ln_w, ln_b, num_heads, eps):
        ctx.save_for_backward(x, k, v, wq_s, bq_s, wo, bo, ln_w, ln_b)
        ctx.cfg = (num_heads, eps)
        return _launch_fwd(x, k, v, wq_s, bq_s, wo, bo, ln_w, ln_b, num_heads, eps)

    @staticmethod
    def backward(ctx, g):
        x, k, v, *params = ctx.saved_tensors
        dx, dk, dv, *dparams = fused_attn_block_bwd(x, k, v, g, *params, *ctx.cfg)
        return (dx, dk.to(k.dtype), dv.to(v.dtype),
                *(d.to(p.dtype) for d, p in zip(dparams, params)), None, None)


def fused_attn_block(x, k, v, wq, bq, wo, bo, ln_w, ln_b, num_heads, eps=1e-5):
    """out = LN(x + Wo·MHA(Wq·x + bq, k, v) + bo)  (torch post-norm layer half).

    x (B, P, C) queries; k, v (B, L, C) projected keys/values, heads packed in
    C; wq, wo (C, C) torch layout; bq, bo, ln_w, ln_b (C,).  Differentiable on
    both devices."""
    if not use_kernel(x):
        return fused_attn_block_plain(x, k, v, wq, bq, wo, bo, ln_w, ln_b, num_heads, eps)
    _check(x, k, v, wq, bq, wo, bo, ln_w, ln_b, num_heads)
    wq_s, bq_s = fold_q_scale(wq, bq, num_heads)
    return _FusedAttnBlock.apply(x, k.to(x.dtype), v.to(x.dtype), wq_s, bq_s, wo, bo, ln_w, ln_b,
                                 num_heads, eps)


fused_attn_block.launches = 0


def _q_weights(wq, bq, wo, num_heads):
    """(wq codes, scales, folded bq, wo codes, scales): 1/√dh folded into wq
    and bq in f32 and rounded back to their dtypes (``attention_block.py:155-160``),
    then both weights quantised per output channel (:190-195)."""
    wq_s, bq_s = fold_q_scale(wq, bq, num_heads)
    return (*quantize_weight(wq_s.to(wq.dtype)), bq_s.to(bq.dtype), *quantize_weight(wo))


def fused_attn_block_q_plain(x, k, v, wq, bq, wo, bo, ln_w, ln_b, num_heads, eps=1e-5):
    """Plain PyTorch version of :func:`fused_attn_block_q` (any device): the
    TPU kernel's quant branch, softmax by a per-row reciprocal as there."""
    dt = x.dtype
    wqq, wqs, bq_s, woq, wos = _q_weights(wq, bq, wo, num_heads)

    def softmax(logits):
        e = torch.exp(logits - logits.amax(-1, keepdim=True))
        return e * (1.0 / e.sum(-1, keepdim=True))

    return _block_plain(
        x, k, v, lambda a: (qdot(a, wqq, wqs) + bq_s.to(dt).float()).to(dt),
        lambda a: qdot(a, woq, wos) + bo.to(dt).float() + x.float(), ln_w.to(dt).float(),
        ln_b.to(dt).float(), num_heads, eps, softmax)


def fused_attn_block_q(x, k, v, wq, bq, wo, bo, ln_w, ln_b, num_heads, eps=1e-5):
    """Int8 twin of :func:`fused_attn_block` (serving only): int8 q- and
    out-projections, float attention.  Arguments as there."""
    forward_only("fused_attn_block_q", x, k, v, wq, bq, wo, bo, ln_w, ln_b)
    if not use_kernel(x):
        return fused_attn_block_q_plain(x, k, v, wq, bq, wo, bo, ln_w, ln_b, num_heads, eps)
    _check(x, k, v, wq, bq, wo, bo, ln_w, ln_b, num_heads)
    b, p, c = x.shape
    dt = x.dtype
    wqq, wqs, bq_s, woq, wos = _q_weights(wq, bq, wo, num_heads)
    xc, kc, vc = (t.to(dt).contiguous() for t in (x, k, v))
    bqc, boc, lnw, lnb = (t.to(dt).contiguous() for t in (bq_s, bo, ln_w, ln_b))
    wqs, wos = wqs.contiguous(), wos.contiguous()
    out = torch.empty_like(xc)
    _build.launch(
        "lc2_attn_block_q", xc.device, _build.dtype_code(xc), xc.data_ptr(), kc.data_ptr(),
        vc.data_ptr(), wqq.data_ptr(), wqs.data_ptr(), bqc.data_ptr(), woq.data_ptr(),
        wos.data_ptr(), boc.data_ptr(), lnw.data_ptr(), lnb.data_ptr(), out.data_ptr(), b, p,
        k.shape[1], c, num_heads, float(eps), _build.stream_of(xc))
    fused_attn_block_q.launches += 1
    return out


fused_attn_block_q.launches = 0
