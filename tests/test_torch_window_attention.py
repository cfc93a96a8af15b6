"""The port's window attention (TPU row 8) and the windowed swin attention
route against lc2is_tpu on the same inputs: ``ops/window_attention``'s plain
version (the CPU side of ``window_attention``) against the JAX Pallas kernel
in interpret mode at the cases of ``tests/test_window_attention.py``, its
gradients against ``jax.grad`` through the JAX custom VJP, the region labels,
HF's -100 mask, window partition / reverse, and ``SwinAttention.forward``
against JAX's ``SwinAttention.apply`` on the same converted parameters.

Stated tolerances: f32 within 2e-5 absolute (the JAX tests' own bound);
bf16, where both sides round the probabilities and the output to bf16 but
sum in other orders, within 1e-2 + 1e-2·|ref| (a bf16 step is 2^-8 of the
value's power of two: a few steps at the outputs' scale)."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import close, load_jax_params, numpy_params, t

import lc2is_tpu.ops.window_attention as jwa
from lc2is_tpu.nn.swin import SwinAttention as JSwinAttention
from lc2is_tpu.nn.swin import _shift_attn_mask as jax_shift_attn_mask
from lc2is_tpu.nn.swin import window_partition as jax_window_partition
from lc2is_tpu.nn.swin import window_reverse as jax_window_reverse
from lc2is_tpu_torch.nn.swin import (SwinAttention, _shift_attn_mask, window_partition,
                                     window_reverse)
from lc2is_tpu_torch.ops import window_attention as wa

F32 = dict(rtol=0, atol=2e-5)
BF16 = dict(rtol=1e-2, atol=1e-2)

# (n, heads, c, p, region labels (batch, hp, wp, win, shift) or None, zero bias)
CASES = {
    "p49 h2": (8, 2, 32, 49, None, False),
    "p49 h3": (12, 3, 96, 49, None, False),
    "p16 regions": (8, 2, 32, 16, (2, 8, 8, 4, 2), False),
    "n5": (5, 2, 64, 49, None, True),
}


def _inputs(n, heads, c, p, zero_bias, seed=0):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(n, p, c).astype(np.float32) for _ in range(3))
    bias = np.zeros((heads, p, p), np.float32) if zero_bias else \
        rs.randn(heads, p, p).astype(np.float32)
    return q, k, v, bias


def _jax_regions(reg):
    return None if reg is None else jwa.region_labels(*reg)


def _port_regions(reg):
    return None if reg is None else wa.region_labels(*reg)


@pytest.mark.parametrize("case", list(CASES))
def test_window_attention_matches_pallas_kernel(case):
    n, heads, c, p, reg, zero_bias = CASES[case]
    q, k, v, bias = _inputs(n, heads, c, p, zero_bias)
    want = jax.jit(lambda *a: jwa.window_attention(*a, _jax_regions(reg), heads, block_windows=4,
                                                   interpret=True))(q, k, v, bias)
    got = wa.window_attention(t(q), t(k), t(v), t(bias), _port_regions(reg), heads)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, p, c)
    close(got, want, **F32)


@pytest.mark.parametrize("case", ["p49 h3", "p16 regions"])
def test_window_attention_bf16(case):
    """bf16 q, k, v: the output in bf16 on both sides, within the bf16
    tolerance of the JAX kernel's."""
    n, heads, c, p, reg, zero_bias = CASES[case]
    q, k, v, bias = _inputs(n, heads, c, p, zero_bias, seed=1)
    bq, bk, bv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jax.jit(lambda *a: jwa.window_attention(*a, _jax_regions(reg), heads, block_windows=4,
                                                   interpret=True))(bq, bk, bv, bias)
    pq, pk, pv = (t(np.asarray(a.astype(jnp.float32))).bfloat16() for a in (bq, bk, bv))
    got = wa.window_attention(pq, pk, pv, t(bias), _port_regions(reg), heads)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    close(got, np.asarray(want.astype(jnp.float32)), **BF16)


@pytest.mark.parametrize("route", ["plain", "function"])
@pytest.mark.parametrize("case", ["p16 regions", "p49 h2"])
def test_window_attention_gradients(case, route, monkeypatch):
    """dq, dk, dv and dbias against ``jax.grad`` of JAX's ``window_attention``
    (Pallas forward in interpret mode, its XLA-recompute VJP).  ``plain``:
    autograd through the plain version (the CPU route); ``function``: the
    card's ``autograd.Function`` with its launch replaced by the plain
    version, so its recompute backward runs here."""
    n, heads, c, p, reg, zero_bias = CASES[case]
    q, k, v, bias = _inputs(n, heads, c, p, zero_bias, seed=2)
    gout = np.random.RandomState(3).randn(n, p, c).astype(np.float32)
    orig = jwa._window_attention_fwd_impl
    monkeypatch.setattr(jwa, "_window_attention_fwd_impl", lambda *a: orig(*a[:7], True))
    regions_j = _jax_regions(reg)
    want = jax.jit(jax.grad(
        lambda q_, k_, v_, b_: jnp.sum(jwa.window_attention(q_, k_, v_, b_, regions_j, heads)
                                       * gout), argnums=(0, 1, 2, 3)))(q, k, v, bias)
    leaves = [t(a).requires_grad_(True) for a in (q, k, v, bias)]
    regions = _port_regions(reg)
    if route == "function":
        launched = []
        monkeypatch.setattr(wa, "_launch", lambda *a: launched.append(1)
                            or wa.window_attention_plain(*a))
        out = wa._WindowAttention.apply(*leaves, regions, heads)
        assert launched == [1]
    else:
        out = wa.window_attention(*leaves, regions, heads)
    (out * t(gout)).sum().backward()
    for leaf, w in zip(leaves, want):
        close(leaf.grad, w, **F32)


@pytest.mark.parametrize("hp,wp,win,shift", [(8, 8, 4, 2), (12, 12, 4, 2), (21, 14, 7, 3),
                                             (12, 24, 12, 6), (8, 8, 4, 0)])
def test_region_labels_and_mask_match_jax(hp, wp, win, shift):
    labels = wa.region_labels(3, hp, wp, win, shift)
    mask = _shift_attn_mask(hp, wp, win, shift)
    if shift == 0:
        assert labels is None and mask is None and jwa.region_labels(3, hp, wp, win, 0) is None
        return
    assert labels.dtype == torch.int32
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jwa.region_labels(3, hp, wp, win,
                                                                               shift)))
    assert mask.dtype == torch.float32
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jax_shift_attn_mask(hp, wp, win,
                                                                               shift)))


@pytest.mark.parametrize("b,h,w,c,win", [(2, 8, 8, 3, 4), (1, 14, 21, 5, 7)])
def test_window_partition_reverse_match_jax(b, h, w, c, win):
    x = np.random.RandomState(4).randn(b, h, w, c).astype(np.float32)
    parts = window_partition(t(x), win)
    np.testing.assert_array_equal(parts.numpy(), np.asarray(jax_window_partition(x, win)))
    back = window_reverse(parts, win, h, w)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        jax_window_reverse(jnp.asarray(parts.numpy()), win, h, w)))
    np.testing.assert_array_equal(back.numpy(), x)


# (dim, heads, table window, canvas (hp, wp), shift, effective window or None)
ATTN_CASES = {
    "shift 0": (32, 2, 4, (8, 8), 0, None),
    "shift 2": (32, 2, 4, (8, 12), 2, None),
    "window 7 shift 3": (48, 3, 7, (14, 14), 3, None),
    "eff window 4 of 7": (32, 4, 7, (4, 4), 0, 4),
}


@pytest.mark.parametrize("jax_route", ["pallas-interpret", "xla"])
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_swin_attention_forward_matches_jax(case, jax_route, monkeypatch):
    """The port's ``SwinAttention.forward`` (window attention's CPU route)
    against JAX's ``SwinAttention.apply`` on the same converted parameters:
    through JAX's Pallas window attention (``LC2IS_PALLAS_INTERPRET=1``) and
    through its XLA route (``attn_impl="xla"``, the -100 region mask)."""
    dim, heads, window, (hp, wp), shift, eff = ATTN_CASES[case]
    win = eff or window
    b = 2
    x = np.random.RandomState(5).randn(b * (hp // win) * (wp // win), win * win,
                                       dim).astype(np.float32)
    info = (hp, wp, win, shift)
    if jax_route == "xla":
        jm = JSwinAttention(dim, heads, window, attn_impl="xla")
    else:
        monkeypatch.setenv("LC2IS_PALLAS_INTERPRET", "1")
        jm = JSwinAttention(dim, heads, window)
    # shift_info and the window are static: closed over, not traced
    params = numpy_params(SimpleNamespace(init=lambda key, x_: jm.init(key, x_, info, eff)),
                          jnp.asarray(x))
    want = jax.jit(lambda p_, x_: jm.apply(p_, x_, info, eff))(params, jnp.asarray(x))
    port = load_jax_params(SwinAttention(dim, heads, window), params)
    with torch.no_grad():
        got = port(t(x), info, eff)
    assert tuple(got.shape) == x.shape
    close(got, want, rtol=2e-5, atol=2e-5)
