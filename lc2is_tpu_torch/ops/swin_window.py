"""One swin attention half on the (B, H, W, C) canvas, HF SwinLayer semantics:

    out = [x +] proj(window_attention(qkv(LN(x)) padded, rolled, partitioned))

Counterpart of both ``lc2is_tpu/ops/swin_canvas.py::swin_canvas_block``
(:974, swin stages 1-3) and ``lc2is_tpu/ops/window_attention.py::
fused_window_block`` (:645, C > 384), which compute this same function.  On
a CUDA tensor :func:`swin_window_block` launches ``csrc/swin_window.cu``
(indices from canvas coordinates, any stage, on the tensor cores: in f32 the
token-major plan at every C, every product in 3xTF32, f32-accurate: a
LayerNorm pass, the QKV product of the real tokens on the tiled GEMM, a
window-attention core that gathers each window's q, k and v from it, and the
out-projection GEMM, through the scratch ``lc2_swin_window_workspace_f32``;
in bf16 at C <= 384 one kernel with up to four windows a block, above it the
same plan on the bf16 GEMM through ``lc2_swin_window_workspace_bf16``; each
plan from one call of the C entry); on
a CPU tensor it runs :func:`swin_window_block_plain`, HF's pipeline written out:
LN, zero pad to window multiples (pad AFTER the LN), roll by -shift,
partition, attention with the relative-position bias and the 9-region
-100 mask, reverse, roll back, crop, out-projection, residual
(``residual=False`` drops the residual: the stochastic-depth training path
adds it outside, ``lc2is_tpu/nn/swin.py:316-335``).

Training: on a CUDA tensor the kernel runs inside a ``torch.autograd.Function``
whose backward is :func:`swin_window_block_bwd` (``csrc/swin_window_bwd.cu``,
the port of ``swin_canvas.py::_canvas_bwd_kernel`` :530 and
``window_attention.py::_block_bwd_kernel`` :701).  The 1/√dh fold into the q
rows and the relative-position table gather stay outside the Function as
differentiable torch ops, so autograd carries the q-row and bias gradients
back through them.  On a CPU tensor autograd runs through the plain version.

Int8 serving: :func:`swin_window_block_q` is the ``quant=True`` branch of
``window_attention.py::_block_kernel`` (:414-418, :468-476; weights folded and
quantised as :614-624): the f32 LN output, re-zeroed at HF pad tokens, is
quantised per token for an int8 packed QKV product, and the head outputs per
token for an int8 out-projection (``ops/quant.py``).  On a CUDA tensor it
launches the int8 variant of ``csrc/swin_window.cu``; on a CPU tensor it runs
:func:`swin_window_block_q_plain`.  Forward only: it raises if autograd needs
a gradient through it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from lc2is_tpu_torch.ops import _build
from lc2is_tpu_torch.ops.dispatch import use_kernel
from lc2is_tpu_torch.ops.quant import forward_only, qdot, quantize_weight
from lc2is_tpu_torch.ops.window_attention import region_labels


def _padded(n: int, win: int) -> int:
    return -(-n // win) * win


def _window_pipeline(x, hs, qkv_fn, bias, num_heads, win, shift, folded):
    """The plain versions' shared middle: hs (B, H, W, C) post-LN canvas ->
    zero pad to window multiples (HF pads after layernorm_before), roll by
    -shift, partition, ``qkv_fn`` -> attention with the relative-position bias
    and the 9-region -100 mask -> reverse, roll back, crop: the (B, H, W, C)
    head outputs in x's dtype.  ``folded``: 1/√dh is already in the q rows."""
    b, h, w, c = x.shape
    dt = x.dtype
    dh = c // num_heads
    n = win * win
    hp, wp = _padded(h, win), _padded(w, win)
    hs = F.pad(hs, (0, 0, 0, wp - w, 0, hp - h))
    if shift:
        hs = torch.roll(hs, (-shift, -shift), dims=(1, 2))
    nwh, nww = hp // win, wp // win
    tw = hs.reshape(b, nwh, win, nww, win, c).transpose(2, 3).reshape(-1, n, c)
    qkv = qkv_fn(tw)
    q, k, v = (t.reshape(-1, n, num_heads, dh).transpose(1, 2) for t in qkv.split(c, -1))
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    if not folded:
        logits = logits / math.sqrt(dh)
    logits = logits + bias.float()[None]
    if shift:
        lab = region_labels(1, hp, wp, win, shift, x.device)
        mask = torch.where(lab[:, None, :] != lab[:, :, None], -100.0, 0.0)
        logits = (logits.reshape(b, nwh * nww, num_heads, n, n) + mask[None, :, None]
                  ).reshape(-1, num_heads, n, n)
    probs = torch.softmax(logits, dim=-1).to(dt)
    o = torch.einsum("bhqk,bhkd->bhqd", probs, v).transpose(1, 2).reshape(b, nwh, nww, win, win, c)
    o = o.transpose(2, 3).reshape(b, hp, wp, c)
    if shift:
        o = torch.roll(o, (shift, shift), dims=(1, 2))
    return o[:, :h, :w]


def swin_window_block_plain(x, ln_w, ln_b, wqkv, bqkv, wo, bo, bias, num_heads, win,
                            shift, eps=1e-5, residual=True):
    """Plain PyTorch version of :func:`swin_window_block` (any device)."""
    c = x.shape[-1]
    dt = x.dtype
    hs = F.layer_norm(x.float(), (c,), ln_w.float(), ln_b.float(), eps).to(dt)
    o = _window_pipeline(x, hs, lambda tw: F.linear(tw, wqkv.to(dt), bqkv.to(dt)), bias,
                         num_heads, win, shift, folded=False)
    y = F.linear(o, wo.to(dt), bo.to(dt))
    return x + y if residual else y


def _check(x, ln_w, ln_b, wqkv, bqkv, wo, bo, bias, num_heads, win, shift):
    b, h, w, c = x.shape
    dh = c // num_heads
    if (c % 32 or c % num_heads or dh not in (16, 32, 64) or not 1 <= win <= 8
            or not 0 <= shift < win):
        raise ValueError(f"swin_window_block kernel: unsupported x {tuple(x.shape)}, "
                         f"heads {num_heads}, window {win}, shift {shift}")
    _build.check_operands(x.device, ln_w=(ln_w, (c,)), ln_b=(ln_b, (c,)),
                          wqkv=(wqkv, (3 * c, c)), bqkv=(bqkv, (3 * c,)), wo=(wo, (c, c)),
                          bo=(bo, (c,)), bias=(bias, (num_heads, win * win, win * win)))


def fold_q_scale(wqkv, bqkv, num_heads):
    """(wqkv, bqkv) with 1/√dh folded into the q rows, weights AND bias, in
    f32 before any rounding (``window_attention.py:554-561``); differentiable."""
    c = wqkv.shape[1]
    scale = 1.0 / math.sqrt(c // num_heads)
    return (torch.cat([wqkv[:c].float() * scale, wqkv[c:].float()]),
            torch.cat([bqkv[:c].float() * scale, bqkv[c:].float()]))


def _launch_fwd(x, ln_w, ln_b, wqkv_s, bqkv_s, wo, bo, bias, num_heads, win, shift, eps,
                residual):
    b, h, w, c = x.shape
    dt = x.dtype
    xc = _build.contiguous16(x)
    lnw, lnb, wq, bq, woc, boc = (_build.contiguous16(t.to(dt))
                                  for t in (ln_w, ln_b, wqkv_s, bqkv_s, wo, bo))
    biasc = bias.float().contiguous()
    out = torch.empty_like(xc)
    # the token-major plans' scratch: the LN output (then the head outputs)
    # and q|k|v, in f32 at every C, in bf16 above C 384 (with the biases in f32)
    n_ws = _build.size("lc2_swin_window_workspace_bf16" if dt == torch.bfloat16
                       else "lc2_swin_window_workspace_f32", b, h, w, c, num_heads, win)
    ws = torch.empty(n_ws, dtype=torch.float32, device=x.device) if n_ws > 0 else None
    _build.launch(
        "lc2_swin_window", xc.device, _build.dtype_code(xc), xc.data_ptr(), lnw.data_ptr(),
        lnb.data_ptr(), wq.data_ptr(), bq.data_ptr(), woc.data_ptr(), boc.data_ptr(),
        biasc.data_ptr(), out.data_ptr(), _build.ptr(ws), b, h, w, c, num_heads, win, shift,
        int(residual), float(eps), _build.stream_of(xc))
    swin_window_block.launches += 1
    return out


def swin_window_block_bwd(x, g, ln_w, ln_b, wqkv_s, bqkv_s, wo, bo, bias, num_heads, win,
                          shift, eps=1e-5, residual=True):
    """Gradients of :func:`swin_window_block` with respect to (x, ln_w, ln_b,
    wqkv_s, bqkv_s, wo, bo, bias), given g = d loss / d out; ``wqkv_s`` and
    ``bqkv_s`` carry the 1/√dh fold (:func:`fold_q_scale`).  x and g are CUDA
    tensors of the compute dtype; dx comes back in it, the rest in f32.  The
    forward is recomputed inside (``csrc/swin_window_bwd.cu``, every product
    on the tensor cores: in f32 in 3xTF32, f32-accurate, in bf16 with bf16
    intermediates where ``swin_canvas.py::_canvas_bwd_kernel`` rounds)."""
    b, h, w, c = x.shape
    _check(x, ln_w, ln_b, wqkv_s, bqkv_s, wo, bo, bias, num_heads, win, shift)
    _build.check_operands(x.device, g=(g, tuple(x.shape)))
    dt = x.dtype
    xc, gc = x.contiguous(), g.to(dt).contiguous()
    # the values the forward kernel used: the two weight matrices in the
    # dtype (the bf16 body's tensor-core operands), the vectors in f32
    wq, woc = (t.to(dt).contiguous() for t in (wqkv_s, wo))
    lnw, lnb, bq = (t.to(dt).float().contiguous() for t in (ln_w, ln_b, bqkv_s))
    biasc = bias.float().contiguous()
    f32 = dict(dtype=torch.float32, device=x.device)
    grads = [torch.zeros(s, **f32) for s in ((c,), (c,), (3 * c, c), (3 * c,), (c, c), (c,),
                                             tuple(bias.shape))]
    dx = torch.empty_like(xc)
    workspace = ("lc2_swin_window_bwd_workspace_bf16" if dt == torch.bfloat16
                 else "lc2_swin_window_bwd_workspace")
    ws = torch.empty(_build.size(workspace, b, h, w, c, win), **f32)
    _build.launch(
        "lc2_swin_window_bwd", xc.device, _build.dtype_code(xc), xc.data_ptr(), gc.data_ptr(),
        lnw.data_ptr(), lnb.data_ptr(), wq.data_ptr(), bq.data_ptr(), woc.data_ptr(),
        biasc.data_ptr(), dx.data_ptr(), *(t.data_ptr() for t in grads), ws.data_ptr(), b, h, w,
        c, num_heads, win, shift, int(residual), float(eps), _build.stream_of(xc))
    swin_window_block_bwd.launches += 1
    return (dx, *grads)


swin_window_block_bwd.launches = 0


class _SwinWindowBlock(torch.autograd.Function):
    """The kernel forward with :func:`swin_window_block_bwd` as its backward."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, wqkv_s, bqkv_s, wo, bo, bias, num_heads, win, shift, eps,
                residual):
        ctx.save_for_backward(x, ln_w, ln_b, wqkv_s, bqkv_s, wo, bo, bias)
        ctx.cfg = (num_heads, win, shift, eps, residual)
        return _launch_fwd(x, ln_w, ln_b, wqkv_s, bqkv_s, wo, bo, bias, num_heads, win, shift,
                           eps, residual)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        grads = swin_window_block_bwd(saved[0], g, *saved[1:], *ctx.cfg)
        # parameter grads in the parameters' own dtypes (f32 masters)
        return (grads[0], *(d.to(p.dtype) for d, p in zip(grads[1:], saved[1:])),
                None, None, None, None, None)


def swin_window_block(x, ln_w, ln_b, wqkv, bqkv, wo, bo, bias, num_heads, win, shift,
                      eps=1e-5, residual=True):
    """out = [x +] proj(window_attn(qkv(LN(x)))) straight on the canvas.

    x (B, H, W, C) channels-last; wqkv (3C, C) packed q|k|v torch layout,
    bqkv (3C,); wo (C, C), bo (C,); bias (heads, win², win²) relative-position
    bias in standard token order.  Differentiable on both devices."""
    if not use_kernel(x):
        return swin_window_block_plain(x, ln_w, ln_b, wqkv, bqkv, wo, bo, bias, num_heads,
                                       win, shift, eps, residual)
    _check(x, ln_w, ln_b, wqkv, bqkv, wo, bo, bias, num_heads, win, shift)
    wqkv_s, bqkv_s = fold_q_scale(wqkv, bqkv, num_heads)
    return _SwinWindowBlock.apply(x, ln_w, ln_b, wqkv_s, bqkv_s, wo, bo, bias, num_heads, win,
                                  shift, eps, residual)


swin_window_block.launches = 0


def _q_weights(wqkv, bqkv, wo, num_heads):
    """(wqkv codes, scales, folded bqkv, wo codes, scales): 1/√dh folded into
    the q rows in f32 and rounded back to the weights' dtypes
    (``window_attention.py:554-560``), then per-output-channel codes (:614-618)."""
    wqkv_s, bqkv_s = fold_q_scale(wqkv, bqkv, num_heads)
    return (*quantize_weight(wqkv_s.to(wqkv.dtype)), bqkv_s.to(bqkv.dtype),
            *quantize_weight(wo))


def swin_window_block_q_plain(x, ln_w, ln_b, wqkv, bqkv, wo, bo, bias, num_heads, win,
                              shift, eps=1e-5, residual=True):
    """Plain PyTorch version of :func:`swin_window_block_q` (any device)."""
    c = x.shape[-1]
    dt = x.dtype
    wq_q, wq_s, bqkv_s, wo_q, wo_s = _q_weights(wqkv, bqkv, wo, num_heads)
    hs = F.layer_norm(x.float(), (c,), ln_w.to(dt).float(), ln_b.to(dt).float(), eps)
    o = _window_pipeline(
        x, hs, lambda tw: (qdot(tw, wq_q, wq_s) + bqkv_s.to(dt).float()).to(dt), bias,
        num_heads, win, shift, folded=True)
    y = qdot(o, wo_q, wo_s) + bo.to(dt).float()
    return (x.float() + y if residual else y).to(dt)


def swin_window_block_q(x, ln_w, ln_b, wqkv, bqkv, wo, bo, bias, num_heads, win, shift,
                        eps=1e-5, residual=True):
    """Int8 twin of :func:`swin_window_block` (serving only): int8 packed
    QKV and out-projection, float attention.  Arguments as there."""
    forward_only("swin_window_block_q", x, ln_w, ln_b, wqkv, bqkv, wo, bo, bias)
    if not use_kernel(x):
        return swin_window_block_q_plain(x, ln_w, ln_b, wqkv, bqkv, wo, bo, bias, num_heads,
                                         win, shift, eps, residual)
    _check(x, ln_w, ln_b, wqkv, bqkv, wo, bo, bias, num_heads, win, shift)
    b, h, w, c = x.shape
    dt = x.dtype
    wq_q, wq_s, bqkv_s, wo_q, wo_s = _q_weights(wqkv, bqkv, wo, num_heads)
    xc = x.contiguous()
    lnw, lnb, bq, boc = (t.to(dt).contiguous() for t in (ln_w, ln_b, bqkv_s, bo))
    wq_s, wo_s, biasc = wq_s.contiguous(), wo_s.contiguous(), bias.float().contiguous()
    out = torch.empty_like(xc)
    _build.launch(
        "lc2_swin_window_q", xc.device, _build.dtype_code(xc), xc.data_ptr(), lnw.data_ptr(),
        lnb.data_ptr(), wq_q.data_ptr(), wq_s.data_ptr(), bq.data_ptr(), wo_q.data_ptr(),
        wo_s.data_ptr(), boc.data_ptr(), biasc.data_ptr(), out.data_ptr(), b, h, w, c,
        num_heads, win, shift, int(residual), float(eps), _build.stream_of(xc))
    swin_window_block_q.launches += 1
    return out


swin_window_block_q.launches = 0
