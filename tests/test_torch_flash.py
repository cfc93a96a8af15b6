"""The port's flash attention (``ops/flash_attention.py``) against lc2is_tpu's
Pallas kernel, run in interpret mode as ``tests/test_flash_attention.py``
runs it (``_flash_forward(..., interpret=True)``, 64 x 64 blocks so that
ragged lengths span several blocks), on the same numpy-seeded inputs.

Stated tolerances: f32 rtol = atol = 2e-4 (both sum in f32, in other
orders).  bf16 rtol = atol = 1e-2: the output is rounded to bf16 (2^-8
relative), and the kernel rounds each block's p = exp(s − running max) to
bf16 where the plain version rounds p relative to the row's final max, so a
probability may differ by one bf16 step.  The LSE is f32 on both sides
(2e-4).

Fully-masked rows: the port gives NaN (lse −∞), as the JAX package's
``_reference`` and torch do; the Pallas kernel gives the mean of v over the
block-padded key length instead (its −1e30 bias), which a separate test pins
so the difference stays recorded.  The same holds for the backward: the
port's gives 0 on such a row, the Pallas backward differentiates its mean of
v (both pinned).  The backward's own tolerances are stated where its tests
begin."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import TOL, close

from lc2is_tpu.ops import flash_attention as jfa
from lc2is_tpu_torch.ops import attention
from lc2is_tpu_torch.ops.flash_attention import (flash_attention, flash_attention_backward_plain,
                                                 flash_attention_bwd, flash_attention_plain)

BF16_TOL = dict(rtol=1e-2, atol=1e-2)


def _qkv(seed, b, h, lq, lk, d):
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(b, h, n, d).astype(np.float32) for n in (lq, lk, lk))


def _mask(seed, b, lk, full_rows=()):
    """Key-padding mask, True = ignore: a random kept prefix per batch entry
    (at least one key), and every key of the entries in ``full_rows``."""
    rs = np.random.RandomState(seed)
    lens = rs.randint(1, lk + 1, size=b)
    m = np.arange(lk)[None] >= lens[:, None]
    m[list(full_rows)] = True
    return m


def _pallas(q, k, v, mask, dtype, **kw):
    """The Pallas forward in interpret mode, jitted once: (out, lse (B, H, Lq))."""
    b, h, lq, _ = q.shape

    def fn(q, k, v, m):
        args = [a.astype(dtype) for a in (q, k, v)]
        out, lse = jfa._flash_forward(*args, m, interpret=True, with_stats=True, **kw)
        return out.astype(jnp.float32), lse[:, :lq, 0].reshape(b, h, lq)

    jm = None if mask is None else jnp.asarray(mask)
    return jax.jit(fn)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 96])
@pytest.mark.parametrize("lq,lk,masked", [(130, 77, False), (130, 77, True), (200, 300, False),
                                          (200, 300, True)])
def test_plain_matches_pallas(dtype, d, lq, lk, masked):
    q, k, v = _qkv(lq + lk + d, 2, 2, lq, lk, d)
    mask = _mask(lk, 2, lk) if masked else None
    want, want_lse = _pallas(q, k, v, mask, getattr(jnp, dtype), block_q=64, block_k=64)
    tdt = getattr(torch, dtype)
    got, lse = flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                               None if mask is None else torch.from_numpy(mask),
                               with_stats=True)
    assert got.dtype == tdt and lse.dtype == torch.float32 and tuple(lse.shape) == (2, 2, lq)
    assert torch.isfinite(got).all()
    close(got, want, **(TOL if dtype == "float32" else BF16_TOL))
    close(lse, want_lse)


def test_fully_masked_rows_give_nan():
    """Batch entry 1 has every key masked: NaN output and lse −∞ there, as
    the JAX package's ``_reference`` (:303) gives; the other entry agrees."""
    q, k, v = _qkv(7, 2, 3, 40, 90, 64)
    mask = _mask(8, 2, 90, full_rows=(1,))
    got, lse = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(mask),
                               with_stats=True)
    want = jax.jit(jfa._reference)(*(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(mask))
    assert torch.isnan(got[1]).all() and np.isnan(np.asarray(want[1])).all()
    assert torch.isneginf(lse[1]).all() and torch.isfinite(lse[0]).all()
    close(got[0], want[0])


def test_pallas_fully_masked_row_is_the_mean_of_v():
    """What the Pallas kernel returns on a fully-masked row (the port returns
    NaN there): with every key biased by −1e30, every logit rounds to −1e30
    in f32 and every p = 1, so the row is Σv over the block-padded key
    length (the padding rows are 0) divided by that length, 256 for 200 keys
    at the default blocks."""
    q, k, v = _qkv(9, 1, 1, 4, 200, 64)
    mask = np.ones((1, 200), bool)
    out = jax.jit(lambda *a: jfa._flash_forward(*a, interpret=True))(
        *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(mask))
    want = np.broadcast_to(v[0, 0].sum(0) / 256.0, (4, 64))
    np.testing.assert_allclose(np.asarray(out)[0, 0], want, rtol=1e-5, atol=1e-6)
    ported = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(mask))
    assert torch.isnan(ported).all()


def test_plain_gradients_match_softmax_attention():
    """On the CPU autograd runs through the plain version: its gradients are
    those of softmax(q·kᵀ/√D + mask)·v."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(11, 2, 2, 9, 13, 64))
    mask = torch.from_numpy(_mask(12, 2, 13))
    g = torch.from_numpy(np.random.RandomState(13).randn(2, 2, 9, 64).astype(np.float32))
    got = torch.autograd.grad(flash_attention(q, k, v, mask), (q, k, v), g)
    s = (q @ k.transpose(-1, -2) / 8.0).masked_fill(mask[:, None, None], -math.inf)
    want = torch.autograd.grad(torch.softmax(s, -1) @ v, (q, k, v), g)
    for a, b in zip(got, want):
        close(a, b.detach().numpy())


def test_gate_keeps_the_cpu_on_the_einsum_path():
    """ops/attention.py sends nothing to the kernel on the CPU, even above the
    2^20-logit gate, and its result there equals the plain flash version."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(14, 1, 2, 1024, 1024, 64))
    before = flash_attention.launches
    got = attention.scaled_dot_product_attention(q, k, v)
    assert flash_attention.launches == before
    assert q.shape[2] * k.shape[2] >= attention.FLASH_MIN_LOGITS
    close(got, flash_attention_plain(q, k, v).numpy())


# The backward.  Both sides start from the Pallas forward's own output and
# lse, so the comparison isolates the backward.  f32: rtol = atol = 2e-4, as
# tests/test_flash_attention.py holds the Pallas backward.  bf16: every
# gradient within 2e-2 · max |ref|: both round ds and p to bf16 at the same
# points and the gradients to bf16 at the end, but each recomputes p from
# logits summed in its own order, so a rounded ds may differ by one bf16 step.
BWD_BF16_REL = 2e-2


def _pallas_bwd(q, k, v, mask, g, dtype):
    """The Pallas forward and backward in interpret mode (64 x 64 blocks),
    jitted once: (out, lse (B, H, Lq), dq, dk, dv), arrays in f32."""
    b, h, lq, _ = q.shape

    def fn(q, k, v, m, g):
        args = [a.astype(dtype) for a in (q, k, v)]
        out, lse = jfa._flash_forward(*args, m, block_q=64, block_k=64, interpret=True,
                                      with_stats=True)
        grads = jfa._flash_backward(*args, m, out, lse, g.astype(dtype), block_q=64,
                                    block_k=64, interpret=True)
        return tuple(a.astype(jnp.float32) for a in (out, lse[:, :lq, 0].reshape(b, h, lq),
                                                      *grads))

    jm = None if mask is None else jnp.asarray(mask)
    return jax.jit(fn)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm, jnp.asarray(g))


def _plain_bwd_at(q, k, v, mask, g, out, lse, tdt):
    """flash_attention_backward_plain on numpy inputs cast to ``tdt``, with
    the given forward output and lse."""
    q, k, v, out, g = (torch.from_numpy(np.array(a, np.float32)).to(tdt)
                       for a in (q, k, v, out, g))
    return flash_attention_backward_plain(
        q, k, v, None if mask is None else torch.from_numpy(mask), out,
        torch.from_numpy(np.array(lse, np.float32)), g)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,lq,lk,masked", [
    (64, 130, 77, True), (64, 200, 300, False), (96, 130, 77, False), (96, 200, 300, True),
    (48, 130, 77, True), (40, 200, 300, True)])
def test_backward_plain_matches_pallas(dtype, d, lq, lk, masked):
    """flash_attention_backward_plain against the Pallas backward
    (``_flash_backward``, interpret mode) on the Pallas forward's out and lse:
    ragged lengths over several blocks, key-padding masks, D 64 and 96 (the
    v1 shapes) and 48 and 40 (48 is nhead 16 over the ViT-B width; 40 is no
    multiple of 16)."""
    q, k, v = _qkv(3 * lq + lk + d, 2, 2, lq, lk, d)
    g = np.random.RandomState(d).randn(2, 2, lq, d).astype(np.float32)
    mask = _mask(lk + 1, 2, lk) if masked else None
    out, lse, *want = _pallas_bwd(q, k, v, mask, g, getattr(jnp, dtype))
    tdt = getattr(torch, dtype)
    got = _plain_bwd_at(q, k, v, mask, g, out, lse, tdt)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == tdt and tuple(a.shape) == w.shape, name
        if dtype == "float32":
            close(a, w)
        else:
            w = np.asarray(w)
            np.testing.assert_allclose(a.float().numpy(), w, rtol=0,
                                       atol=BWD_BF16_REL * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("masked", [False, True])
def test_plain_backward_is_autograd_of_the_plain_forward(masked):
    """On the CPU autograd differentiates flash_attention_plain; the plain
    backward, on that forward's out and lse, gives the same gradients (f32,
    TOL)."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(15, 2, 3, 37, 50, 40))
    g = torch.from_numpy(np.random.RandomState(16).randn(2, 3, 37, 40).astype(np.float32))
    mask = torch.from_numpy(_mask(17, 2, 50)) if masked else None
    out, lse = flash_attention(q, k, v, mask, with_stats=True)
    want = torch.autograd.grad(out, (q, k, v), g)
    got = flash_attention_bwd(q.detach(), k.detach(), v.detach(), mask, out.detach(),
                              lse.detach(), g)
    for a, b in zip(got, want):
        close(a, b.numpy())


def test_backward_of_fully_masked_rows():
    """Batch entry 1 has every key masked (its output NaN, lse −∞): the port's
    backward gives 0 for its dq rows and for its dk and dv (p = 0 there, Δ =
    0), and the other entry agrees with the Pallas backward.  Pinned beside
    it, the Pallas value: its −1e30 bias makes every p of that row exp(0) = 1,
    so its dv at every key is the sum of g over the queries."""
    q, k, v = _qkv(18, 2, 2, 40, 90, 64)
    g = np.random.RandomState(19).randn(2, 2, 40, 64).astype(np.float32)
    mask = _mask(20, 2, 90, full_rows=(1,))
    out, lse, *want = _pallas_bwd(q, k, v, mask, g, jnp.float32)
    want_dv = np.asarray(want[2])
    np.testing.assert_allclose(want_dv[1], np.broadcast_to(g[1].sum(1, keepdims=True),
                                                           (2, 90, 64)), rtol=1e-5, atol=1e-5)
    ported_out, ported_lse = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                             torch.from_numpy(mask), with_stats=True)
    assert torch.isnan(ported_out[1]).all() and torch.isneginf(ported_lse[1]).all()
    got = flash_attention_bwd(*(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(mask),
                              ported_out, ported_lse, torch.from_numpy(g))
    for a, w in zip(got, want):
        assert torch.isfinite(a).all() and not a[1].any()
        close(a[0], np.asarray(w)[0])
