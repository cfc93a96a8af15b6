"""Gradients of the port's kernel ops on the CPU (autograd through their plain
PyTorch versions, the functions the Hopper backward kernels are held to on
the card) against ``jax.grad`` of the JAX entries in interpret mode, whose
custom VJPs run the Pallas backward kernels; same numpy inputs, f32.

Stated tolerances, each from the JAX test that pins the same gradient:
- swin attention half: rtol 2e-4, atol 2e-4 · max(1, max |ref|)
  (tests/test_swin_canvas.py:75-76);
- attention block: rtol 2e-4, atol 2e-4 · max(1, max |ref|) (the weight
  gradients are sums over all queries; tests/test_attention_block.py:52 uses
  2e-3 at L = 4096, and these shapes pass at the tighter swin bound);
- upsample: rtol = atol = 1e-5 (tests/test_upsample_kernel.py:127); bf16 bit for bit;
- fused_mlp: rtol 2e-4, atol 2e-4 · max(1, max |ref|) (the MLP of
  tests/test_fused_mlp.py at the swin bound);
- fused CE: loss rtol = atol = 1e-5, gradient rtol 1e-4, atol 1e-6
  (tests/test_fused_ce.py:31-33).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import t

from lc2is_tpu.nn import losses as jlosses
from lc2is_tpu.nn.swin import window_partition, window_reverse
from lc2is_tpu.ops.attention_block import fused_attn_block as jax_fused_attn_block
from lc2is_tpu.ops.fused_ce import upsampled_cross_entropy as jax_upsampled_ce
from lc2is_tpu.ops.fused_mlp import fused_mlp as jax_fused_mlp
from lc2is_tpu.ops.swin_canvas import swin_canvas_block
from lc2is_tpu.ops.upsample import upsample_tokens as jax_upsample_tokens
from lc2is_tpu.ops.window_attention import fused_window_block, pad_labels, region_labels
from lc2is_tpu_torch.nn import losses
from lc2is_tpu_torch.ops.attention_block import fused_attn_block
from lc2is_tpu_torch.ops.fused_ce import upsampled_cross_entropy
from lc2is_tpu_torch.ops.fused_mlp import fused_mlp
from lc2is_tpu_torch.ops.swin_window import swin_window_block
from lc2is_tpu_torch.ops.upsample import upsample_tokens


def _grads_jax(fn, args, g):
    """jax.grad of Σ fn(*args)·g over every argument, jitted once."""
    loss = lambda *a: (fn(*a) * g).sum()  # noqa: E731
    return jax.jit(jax.grad(loss, argnums=tuple(range(len(args)))))(
        *(jnp.asarray(a) for a in args))


def _grads_port(fn, args, g):
    ts = [t(a).requires_grad_() for a in args]
    return torch.autograd.grad(fn(*ts), ts, t(g))


def _close_scaled(got, want, names, rtol=2e-4):
    for name, a, b in zip(names, got, want):
        w = np.asarray(b)
        np.testing.assert_allclose(a.detach().numpy(), w, rtol=rtol,
                                   atol=rtol * max(1.0, float(np.abs(w).max())), err_msg=name)


SWIN_NAMES = ["x", "ln_w", "ln_b", "wqkv", "bqkv", "wo", "bo", "bias"]


def _swin_args(b, h, w, c, heads, win, seed):
    rs = np.random.RandomState(seed)
    a = [rs.randn(b, h, w, c), 1 + 0.1 * rs.randn(c), 0.5 * rs.randn(c),
         rs.randn(3 * c, c) / np.sqrt(c), 0.1 * rs.randn(3 * c), rs.randn(c, c) / np.sqrt(c),
         0.1 * rs.randn(c), 0.1 * rs.randn(heads, win * win, win * win)]
    return [x.astype(np.float32) for x in a], rs.randn(b, h, w, c).astype(np.float32)


@pytest.mark.parametrize("h,w,c,heads,win,shift,residual", [
    (18, 18, 32, 2, 7, 3, True),    # HF pad 18 -> 21, shifted: pad tokens in every region
    (18, 18, 32, 2, 7, 3, False),   # the drop-path branch
    (14, 21, 32, 4, 7, 0, False),
    (12, 12, 64, 2, 4, 2, True),
])
def test_swin_window_block_grad_vs_canvas(h, w, c, heads, win, shift, residual):
    """Canvas-direct VJP (the Pallas ``_canvas_bwd_kernel``), every gradient."""
    args, g = _swin_args(2, h, w, c, heads, win, seed=h + c + shift)
    want = _grads_jax(lambda *a: swin_canvas_block(*a, heads, win, shift, interpret=True,
                                                   residual=residual), args, g)
    got = _grads_port(lambda *a: swin_window_block(*a, heads, win, shift, residual=residual),
                      args, g)
    _close_scaled(got, want, SWIN_NAMES)


@pytest.mark.parametrize("shift", [0, 3])
def test_swin_window_block_grad_vs_window_block(shift):
    """Stage-4-like padded canvas (16² -> 21²) through ``fused_window_block``
    (the Pallas ``_block_bwd_kernel``) on the pad / roll / partition layout of
    lc2is_tpu/nn/swin.py:340-376, every gradient."""
    b, h, w, c, heads, win = 2, 16, 16, 64, 4, 7
    hp = wp = 21
    args, g = _swin_args(b, h, w, c, heads, win, seed=7)

    def reference(x, *weights):
        xp = jnp.pad(x, ((0, 0), (0, hp - h), (0, wp - w), (0, 0)))
        if shift:
            xp = jnp.roll(xp, (-shift, -shift), axis=(1, 2))
        yw = fused_window_block(
            window_partition(xp, win), *weights, region_labels(b, hp, wp, win, shift), heads,
            interpret=True, pad_mask=pad_labels(b, h, w, hp, wp, win, shift))
        y = window_reverse(yw, win, hp, wp)
        if shift:
            y = jnp.roll(y, (shift, shift), axis=(1, 2))
        return y[:, :h, :w]

    want = _grads_jax(reference, args, g)
    got = _grads_port(lambda *a: swin_window_block(*a, heads, win, shift), args, g)
    _close_scaled(got, want, SWIN_NAMES)


@pytest.mark.parametrize("p,l,c,heads", [(40, 7, 64, 4), (33, 151, 64, 2), (24, 1030, 64, 8)])
def test_fused_attn_block_grad(p, l, c, heads):
    rs = np.random.RandomState(l)
    args = [rs.randn(2, p, c), rs.randn(2, l, c), rs.randn(2, l, c),
            rs.randn(c, c) / np.sqrt(c), 0.1 * rs.randn(c), rs.randn(c, c) / np.sqrt(c),
            0.1 * rs.randn(c), 1 + 0.1 * rs.randn(c), 0.1 * rs.randn(c)]
    args = [a.astype(np.float32) for a in args]
    g = rs.randn(2, p, c).astype(np.float32)
    want = _grads_jax(lambda *a: jax_fused_attn_block(*a, heads, interpret=True), args, g)
    got = _grads_port(lambda *a: fused_attn_block(*a, heads), args, g)
    _close_scaled(got, want, ["x", "k", "v", "wq", "bq", "wo", "bo", "ln_w", "ln_b"])


@pytest.mark.parametrize("hw,dtype", [
    pytest.param((8, 8), "float32", id="hw0"), pytest.param((16, 4), "float32", id="hw1"),
    pytest.param((8, 8), "bfloat16", id="bf16-hw0"),
    pytest.param((5, 7), "bfloat16", id="bf16-5x7")])
def test_upsample_tokens_grad(hw, dtype):
    """r = 2: the JAX VJP runs the Pallas ``_adj_kernel``.  bf16: equal bit
    for bit (the port's backward rounds where ``_adj_kernel`` rounds: each
    row's W-adjoint, then the H-adjoint)."""
    rs = np.random.RandomState(hw[1])
    x = rs.randn(2, hw[0] * hw[1], 24).astype(np.float32)
    g = rs.randn(2, 4 * hw[0] * hw[1], 24).astype(np.float32)
    if dtype == "float32":
        (want,) = _grads_jax(lambda a: jax_upsample_tokens(a, hw, 2, interpret=True), [x], g)
        (got,) = _grads_port(lambda a: upsample_tokens(a, hw, 2), [x], g)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        return
    xj, gj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16)
    _, vjp = jax.vjp(lambda a: jax_upsample_tokens(a, hw, 2, interpret=True), xj)
    want = np.asarray(vjp(gj)[0].astype(jnp.float32))
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    (got,) = torch.autograd.grad(upsample_tokens(xt, hw, 2), xt, torch.from_numpy(g).bfloat16())
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("activation,ln_position", [("gelu", "pre"), ("relu", "post"),
                                                    ("relu", "pre"), ("gelu", "post")])
def test_fused_mlp_grad(activation, ln_position):
    rs = np.random.RandomState(len(activation) + len(ln_position))
    t_, c, f = 50, 32, 128
    args = [rs.randn(t_, c), 1 + 0.1 * rs.randn(c), 0.1 * rs.randn(c), rs.randn(f, c) / np.sqrt(c),
            0.1 * rs.randn(f), rs.randn(c, f) / np.sqrt(f), 0.1 * rs.randn(c)]
    args = [a.astype(np.float32) for a in args]
    g = rs.randn(t_, c).astype(np.float32)
    kw = dict(activation=activation, ln_position=ln_position)
    want = _grads_jax(lambda *a: jax_fused_mlp(*a, interpret=True, **kw), args, g)
    got = _grads_port(lambda *a: fused_mlp(*a, **kw), args, g)
    _close_scaled(got, want, ["x", "ln_w", "ln_b", "w1", "b1", "w2", "b2"])


@pytest.mark.parametrize("b,k,h,w,r,ign", [
    (2, 7, 8, 8, 4, None),
    (1, 23, 8, 6, 4, 255),
    (1, 9, 2, 2, 16, None),
    (2, 5, 2, 3, 16, 255),
])
def test_upsampled_cross_entropy(b, k, h, w, r, ign):
    """Loss and low-res gradient, ``ignore_index`` None and 255 (a tenth of
    the pixels ignored; labels drawn over [0, K + 2) so clipping shows)."""
    rs = np.random.RandomState(b * k + r)
    x = rs.randn(b, k, h, w).astype(np.float32)
    y = rs.randint(0, k + 2, size=(b, r * h, r * w)).astype(np.int32)
    if ign is not None:
        y[rs.rand(*y.shape) < 0.1] = ign

    def jloss(v):
        return jax_upsampled_ce(v, jnp.asarray(y), r, ignore_index=ign, interpret=True)

    want_loss, want_grad = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(x))
    xt = t(x).requires_grad_()
    loss = upsampled_cross_entropy(xt, torch.from_numpy(y).long(), r, ignore_index=ign)
    (grad,) = torch.autograd.grad(loss, [xt])
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("ign", [None, 0])
def test_losses(ign):
    """``cross_entropy`` and ``auxiliary_loss`` against lc2is_tpu/nn/losses.py."""
    rs = np.random.RandomState(5)
    logits = rs.randn(2, 6, 16, 16).astype(np.float32)
    low = rs.randn(2, 6, 4, 4).astype(np.float32)
    y = rs.randint(0, 6, size=(2, 16, 16)).astype(np.int32)
    want = (jlosses.cross_entropy(jnp.asarray(logits), jnp.asarray(y), ignore_index=ign),
            jlosses.auxiliary_loss(jnp.asarray(low), jnp.asarray(y), ignore_index=ign))
    yt = torch.from_numpy(y)
    got = (losses.cross_entropy(t(logits), yt, ignore_index=ign),
           losses.auxiliary_loss(t(low), yt, ignore_index=ign))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.item(), float(b), rtol=1e-5, atol=1e-6)
