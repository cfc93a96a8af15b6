"""The arithmetic of the flash kernels (``lc2is_tpu_torch/csrc/
flash_attention.cu``, ``flash_attention_bwd.cu``), emulated tile by tile on
the CPU and held against lc2is_tpu's Pallas kernels in interpret mode at the
same 64 x 64 blocks (as ``tests/test_torch_flash.py`` runs them) and against
the port's plain versions, on the same numpy-seeded inputs: the bf16 bodies
as below, the f32 bodies (3xTF32) by the emulation of
``tests/test_torch_flash_f32x3_tiles.py``, which holds it tighter.

The emulation follows the kernels' tile order and rounding points: 64-key
tiles in the forward; the running max kept in log2 units with the scale and
log2 e folded into one factor, p = exp2(s·scale·log2 e − m); p rounded to
the working dtype per tile, against the running max, before P·V, while l
sums the unrounded p; one reciprocal per row at the end; lse = m·ln 2 +
log l.  The backward recomputes p = exp2(s·scale·log2 e − lse·log2 e),
rounds ds (and p) before each product and sums dq over 64-key tiles and dk,
dv over 64-query tiles.  Ragged lengths (64 ± 1, 2·64 + 1), key-padding
masks (a kept prefix, or keys masked in the middle of a tile) and a
fully-masked entry are covered.

Stated tolerances: f32 rtol = atol = 2e-4 (the sums run in other orders,
and exp2 of a folded product differs from exp in the last bits).  bf16
forward rtol = atol = 1e-2 (the output is rounded to bf16, 2^-8 relative,
and a p rounded against the running max may differ by one bf16 step from
one rounded against the row's final max); bf16 backward 2e-2·max|ref| (a
rounded ds may differ by one bf16 step, as in ``tests/test_torch_flash.py``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import TOL, close

from lc2is_tpu.ops import flash_attention as jfa
from lc2is_tpu_torch.ops.flash_attention import (flash_attention_backward_plain,
                                                 flash_attention_plain)

BF16_TOL = dict(rtol=1e-2, atol=1e-2)
BWD_BF16_REL = 2e-2
BLOCK = 64  # the kernels' key tile (forward, dq) and streamed query tile (dk, dv)
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def _round(x, dtype):
    """x rounded to the working dtype, kept in f32."""
    return x.to(dtype).float()


def tiled_forward(q, k, v, mask, dtype):
    """The forward kernel's arithmetic over 64-key tiles: (out in dtype, lse
    f32).  q, k, v f32 (B, H, L, D) holding dtype values; mask (B, Lk) bool
    or None, True = ignore.  f32: the 3xTF32 body's emulation."""
    if dtype == torch.float32:
        from test_torch_flash_f32x3_tiles import x3_forward  # it imports this module
        out, lse = x3_forward(*(a.numpy() for a in (q, k, v)),
                              None if mask is None else mask.numpy())
        return torch.from_numpy(out), torch.from_numpy(lse)
    b, h, lq, d = q.shape
    sl2 = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32) * LOG2E
    m = torch.full((b, h, lq), -math.inf)
    l = torch.zeros(b, h, lq)
    o = torch.zeros(b, h, lq, d)
    for k0 in range(0, k.shape[2], BLOCK):
        s = q @ k[:, :, k0:k0 + BLOCK].transpose(-1, -2)
        if mask is not None:
            s = s.masked_fill(mask[:, None, None, k0:k0 + BLOCK], -math.inf)
        m_new = torch.maximum(m, s.amax(-1) * sl2)
        # a row with no kept key yet: base 0, so p = 0 and alpha = 0
        base = torch.where(m_new == -math.inf, torch.zeros_like(m_new), m_new)
        alpha = torch.exp2(m - base)
        p = torch.exp2(s * sl2 - base[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + _round(p, dtype) @ v[:, :, k0:k0 + BLOCK]
        m = m_new
    return (o * (1.0 / l)[..., None]).to(dtype), m * LN2 + torch.log(l)


def tiled_backward(q, k, v, mask, out, lse, g, dtype):
    """The backward kernels' arithmetic: dq summed over 64-key tiles, dk and
    dv over 64-query tiles; (dq, dk, dv) in dtype.  f32: the 3xTF32 bodies'
    emulation."""
    if dtype == torch.float32:
        from test_torch_flash_f32x3_tiles import x3_backward  # it imports this module
        return tuple(torch.from_numpy(a) for a in x3_backward(
            *(a.numpy() for a in (q, k, v)), None if mask is None else mask.numpy(),
            out.float().numpy(), lse.numpy(), g.numpy()))
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    sl2 = torch.tensor(scale, dtype=torch.float32) * LOG2E
    delta = (g * out.float()).sum(-1).masked_fill(torch.isneginf(lse), 0.0)
    live = torch.isfinite(lse)[..., None].expand(-1, -1, -1, k.shape[2])
    if mask is not None:
        live = live & ~mask[:, None, None, :]
    s = q @ k.transpose(-1, -2)
    p = torch.where(live, torch.exp2(s * sl2 - (lse * LOG2E)[..., None]), 0.0)
    ds = torch.where(live, p * (g @ v.transpose(-1, -2) - delta[..., None]), 0.0)
    ds_r, p_r = _round(ds, dtype), _round(p, dtype)
    dq = sum(ds_r[..., k0:k0 + BLOCK] @ k[:, :, k0:k0 + BLOCK]
             for k0 in range(0, k.shape[2], BLOCK)) * scale
    dk = sum(ds_r[:, :, q0:q0 + BLOCK].transpose(-1, -2) @ q[:, :, q0:q0 + BLOCK]
             for q0 in range(0, q.shape[2], BLOCK)) * scale
    dv = sum(p_r[:, :, q0:q0 + BLOCK].transpose(-1, -2) @ g[:, :, q0:q0 + BLOCK]
             for q0 in range(0, q.shape[2], BLOCK))
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


def _inputs(seed, b, h, lq, lk, d, masked, dtype):
    """numpy-seeded q, k, v, g (f32 numpy, rounded through dtype) and a mask:
    None, a kept prefix per entry (True) or keys 20-40 of every 64-key tile
    plus a random quarter of the rest ("middle"); key 0 always kept."""
    rs = np.random.RandomState(seed)
    arrs = [rs.randn(b, h, n, d).astype(np.float32) for n in (lq, lk, lk, lq)]
    arrs = [torch.from_numpy(a).to(dtype).float().numpy() for a in arrs]
    mask = None
    if masked == "middle":
        keys = np.arange(lk) % BLOCK
        mask = ((keys >= 20) & (keys < 40))[None] | (rs.rand(b, lk) < 0.25)
    elif masked:
        mask = np.arange(lk)[None] >= rs.randint(1, lk + 1, size=b)[:, None]
    if mask is not None:
        mask[:, 0] = False
    return arrs, mask


def _pallas(q, k, v, mask, g, jdt):
    """The Pallas forward (and, with g, backward) in interpret mode at 64 x 64
    blocks: (out, lse (B, H, Lq)[, dq, dk, dv]) as f32 numpy."""
    b, h, lq, _ = q.shape

    def fn(q, k, v, m, g):
        args = [a.astype(jdt) for a in (q, k, v)]
        out, lse = jfa._flash_forward(*args, m, block_q=BLOCK, block_k=BLOCK, interpret=True,
                                      with_stats=True)
        res = [out, lse[:, :lq, 0].reshape(b, h, lq)]
        if g is not None:
            res += list(jfa._flash_backward(*args, m, out, lse, g.astype(jdt), block_q=BLOCK,
                                            block_k=BLOCK, interpret=True))
        return tuple(a.astype(jnp.float32) for a in res)

    jm = None if mask is None else jnp.asarray(mask)
    jg = None if g is None else jnp.asarray(g)
    return [np.array(a) for a in jax.jit(fn)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             jm, jg)]


def _bf16_close(got, want, rel, name=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=rel * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lq,lk,d,masked", [
    (63, 65, 64, False), (129, 64, 96, True), (130, 129, 24, "middle"), (64, 129, 8, True)])
def test_tiled_forward_matches_pallas_and_plain(dtype, lq, lk, d, masked):
    """The forward emulation against the Pallas forward at 64 x 64 blocks and
    against flash_attention_plain: ragged lengths at the kernels' tile edges,
    D 64 and 96 (the v1 widths), 24 and 8 (multiples of 8, not of 16)."""
    tdt = getattr(torch, dtype)
    (q, k, v, _), mask = _inputs(lq + 7 * lk + d, 2, 2, lq, lk, d, masked, tdt)
    tm = None if mask is None else torch.from_numpy(mask)
    got, lse = tiled_forward(*(torch.from_numpy(a) for a in (q, k, v)), tm, tdt)
    assert got.dtype == tdt and torch.isfinite(got).all() and torch.isfinite(lse).all()
    want, want_lse = _pallas(q, k, v, mask, None, getattr(jnp, dtype))
    plain, plain_lse = flash_attention_plain(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                                             tm, with_stats=True)
    tol = TOL if dtype == "float32" else BF16_TOL
    close(got, want, **tol)
    close(got, plain.float().numpy(), **tol)
    close(lse, want_lse)
    close(lse, plain_lse.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiled_forward_fully_masked_entry(dtype):
    """An entry with every key masked: NaN rows and lse −∞, as the plain
    version gives (the Pallas kernel gives the mean of v there instead,
    pinned in tests/test_torch_flash.py); the other entry agrees."""
    tdt = getattr(torch, dtype)
    (q, k, v, _), mask = _inputs(31, 2, 2, 65, 129, 64, True, tdt)
    mask[1] = True
    tm = torch.from_numpy(mask)
    got, lse = tiled_forward(*(torch.from_numpy(a) for a in (q, k, v)), tm, tdt)
    plain, plain_lse = flash_attention_plain(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                                             tm, with_stats=True)
    assert torch.isnan(got[1]).all() and torch.isneginf(lse[1]).all()
    assert torch.equal(torch.isnan(got), torch.isnan(plain))
    close(got[0], plain[0].float().numpy(), **(TOL if dtype == "float32" else BF16_TOL))
    close(lse[0], plain_lse[0].numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lq,lk,d,masked", [
    (129, 65, 64, True), (65, 130, 96, "middle"), (130, 63, 24, False)])
def test_tiled_backward_matches_pallas_and_plain(dtype, lq, lk, d, masked):
    """The backward emulation on the Pallas forward's out and lse, against
    the Pallas backward at 64 x 64 blocks and against
    flash_attention_backward_plain."""
    tdt = getattr(torch, dtype)
    (q, k, v, g), mask = _inputs(3 * lq + lk + d, 2, 2, lq, lk, d, masked, tdt)
    out, lse, *want = _pallas(q, k, v, mask, g, getattr(jnp, dtype))
    tm = None if mask is None else torch.from_numpy(mask)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    tout, tlse, tg = torch.from_numpy(out).to(tdt), torch.from_numpy(lse), torch.from_numpy(g)
    got = tiled_backward(*t, tm, tout, tlse, tg, tdt)
    plain = flash_attention_backward_plain(*(a.to(tdt) for a in t), tm, tout, tlse, tg.to(tdt))
    for name, a, w, p in zip(("dq", "dk", "dv"), got, want, plain):
        assert a.dtype == tdt and torch.isfinite(a).all(), name
        if dtype == "float32":
            close(a, w)
            close(a, p.numpy())
        else:
            _bf16_close(a, w, BWD_BF16_REL, name)
            _bf16_close(a, p.float().numpy(), BWD_BF16_REL, name)


def test_folded_exp2_is_exp():
    """exp2(s·(scale·log2 e) − m·log2 e) in f32 equals exp(s·scale − m) to
    f32 rounding over the logits' range: the forward's one-FMA form and the
    backward's recompute stand for the reference's exp."""
    rs = np.random.RandomState(32)
    s = torch.from_numpy(rs.randn(4096).astype(np.float32) * 40)
    m = torch.from_numpy(rs.randn(4096).astype(np.float32) * 5)
    scale = 1.0 / math.sqrt(64)
    sl2 = torch.tensor(scale, dtype=torch.float32) * LOG2E
    got = torch.exp2(s * sl2 - m * LOG2E)
    want = torch.exp(s.double() * scale - m.double())
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=2e-6, atol=1e-30)
