"""The arithmetic of the bf16 swin window block's token-major plan
(``lc2is_tpu_torch/csrc/swin_window.cu``, C > 384: TPU row 9's range),
emulated step by step on the CPU and held against lc2is_tpu's
``fused_window_block`` (``ops/window_attention.py::_block_kernel``) in
interpret mode, on the pad / roll / partition layout that
``lc2is_tpu/nn/swin.py:340-376`` gives it, and against the port's
``swin_window_block_plain``, on the same numpy-seeded inputs.  The plan
serves C > 384 on the card; its arithmetic does not depend on C, so the
emulation runs at narrow widths.  With no rounding the same emulation stands
for the algorithm at f32.

The plan, as the kernels compute it (1/√dh folded into the q rows of wqkv
and bqkv in f32, then rounded, as the wrapper hands them over):
  1. the LayerNorm of the B·H·W real tokens in canvas order, two-pass f32
     statistics, rounded to bf16;
  2. q|k|v = round(LN · wqkvᵀ + bqkv) for those tokens, the k dimension
     summed in 32-wide slices (the GEMM's ring); an HF pad token has no row;
  3. per window, its tokens gathered from those rows by the roll and pad
     indexing, bqkv's q|k|v at HF pad tokens (the value the one-kernel plan
     computes for a zeroed LN row); per head, S = q · kᵀ + bias, −100 where
     the shift regions differ, e = exp2((S − max) · log2 e) unnormalised,
     O = round(round(e) · v · (1 / Σ e)) (the TPU canvas kernel's order,
     swin_canvas.py:394-398), written back to the real tokens' rows;
  4. out = round(O · woᵀ + bo [+ x]) over the real tokens, rounded once.

Stated tolerances.  f32: 2e-4 absolute and relative against both
references (tests/test_swin_canvas.py:47-48; the sums run in other orders,
exp2 of a folded product differs from exp in the last bits, and
``_block_kernel`` normalises exp(s − 30) without the row max).  bf16:
|Δ| <= 5e-2 + 2e-2·|ref| against both, the card gate of ``chip_smoke.py``
phase 3 (``_block_kernel`` rounds the normalised probabilities where the
plan rounds the unnormalised e, and the plain version rounds the
normalised ones too).  The control, the same emulation with the pad tokens'
k and v set to zero instead of bqkv's, fails those tolerances on a padded
canvas.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lc2is_tpu.nn.swin import window_partition, window_reverse
from lc2is_tpu.ops.window_attention import fused_window_block, pad_labels, region_labels
from lc2is_tpu_torch.ops.swin_window import fold_q_scale, swin_window_block_plain

LOG2E = 1.4426950408889634
KSLICE = 32  # k-slice of the tiled GEMM's ring (csrc/gemm_bf16.cuh)
TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4), torch.bfloat16: dict(rtol=2e-2, atol=5e-2)}


def _round(x, dtype):
    """x rounded to the working dtype, kept in f32."""
    return x.to(dtype).float()


def _mm(a, b, kt=KSLICE):
    """a @ b in f32, the k dimension summed in kt-wide slices in order."""
    out = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for k0 in range(0, a.shape[-1], kt):
        out = out + a[..., k0:k0 + kt] @ b[k0:k0 + kt]
    return out


def window_tokens(b, h, w, win, shift):
    """(canvas row of each window token, -1 at an HF pad token; its shift
    region label), both (B · nwh · nww, win²), as the core computes them:
    rolled (R, Cc) is canvas ((R + shift) % Hp, (Cc + shift) % Wp)."""
    hp, wp = -(-h // win) * win, -(-w // win) * win
    rr, cc = torch.arange(hp), torch.arange(wp)
    y, xq = (rr + shift) % hp, (cc + shift) % wp
    pix = torch.where((y[:, None] < h) & (xq[None, :] < w), y[:, None] * w + xq[None, :],
                      torch.tensor(-1))

    def region(i, n):
        return ((i >= n - win).long() + (i >= n - shift).long()) if shift else 0 * i

    lab = region(rr, hp)[:, None] * 3 + region(cc, wp)[None, :]

    def windows(t):
        return t.reshape(hp // win, win, wp // win, win).transpose(1, 2).reshape(-1, win * win)

    pix, lab = windows(pix), windows(lab)
    pix = torch.cat([torch.where(pix >= 0, pix + i * h * w, pix) for i in range(b)])
    return pix, lab.repeat(b, 1)


def tiled_token_major_block(x, lnw, lnb, wqkv, bqkv, wo, bo, bias, heads, win, shift, dtype,
                            residual=True, eps=1e-5, pad_kv_zero=False):
    """The plan's four steps (identity rounding for f32) on a (B, H, W, C)
    canvas of f32 values holding dtype values; weights f32 (wqkv, bqkv
    unscaled, as swin_window_block takes them).  ``pad_kv_zero``: the
    control, HF pad tokens' k and v zero instead of bqkv's."""
    b, h, w, c = x.shape
    dh, n = c // heads, win * win
    wq_s, bq_s = (_round(t, dtype) for t in fold_q_scale(wqkv, bqkv, heads))
    lnw, lnb, wo, bo = (_round(t, dtype) for t in (lnw, lnb, wo, bo))
    xt = x.reshape(-1, c)
    # 1. LayerNorm of the real tokens, rounded
    mu = xt.mean(-1, keepdim=True)
    rs = torch.rsqrt(((xt - mu) ** 2).mean(-1, keepdim=True) + eps)
    ln = _round((xt - mu) * rs * lnw + lnb, dtype)
    # 2. q|k|v of the real tokens, rounded
    qkv = _round(_mm(ln, wq_s.t()) + bq_s, dtype)
    # 3. gathered per window; bqkv's row at an HF pad token
    pad_row = bq_s.clone()
    if pad_kv_zero:
        pad_row[c:] = 0.0
    pix, lab = window_tokens(b, h, w, win, shift)
    rows = torch.cat([qkv, pad_row[None]])[torch.where(pix >= 0, pix, qkv.shape[0])]
    q, k, v = (t.reshape(-1, n, heads, dh).transpose(1, 2) for t in rows.split(c, -1))
    s = q @ k.transpose(-1, -2) + bias
    if shift:
        s = s - 100.0 * (lab[:, None, :, None] != lab[:, None, None, :]).float()
    e = torch.exp2((s - s.amax(-1, keepdim=True)) * LOG2E)
    o = _round((_round(e, dtype) @ v) * (1.0 / e.sum(-1, keepdim=True)), dtype)
    o = o.transpose(1, 2).reshape(-1, c)
    ho = torch.zeros_like(ln)
    real = pix.reshape(-1) >= 0
    ho[pix.reshape(-1)[real]] = o[real]
    # 4. the out-projection, + bo [+ x], rounded once
    y = _mm(ho, wo.t()) + bo
    return _round(xt + y if residual else y, dtype).reshape(b, h, w, c)


def _inputs(seed, b, h, w, c, heads, win, dtype):
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(b, h, w, c).astype(np.float32)).to(dtype).float().numpy()
    params = [1 + 0.1 * rs.randn(c), 0.5 * rs.randn(c), rs.randn(3 * c, c) / np.sqrt(c),
              0.1 * rs.randn(3 * c), rs.randn(c, c) / np.sqrt(c), 0.1 * rs.randn(c),
              0.1 * rs.randn(heads, win * win, win * win)]
    return [x] + [a.astype(np.float32) for a in params]


def _pallas_block(args, heads, win, shift, dtype, residual):
    """fused_window_block (interpret mode) on the pad / roll / partition
    layout of lc2is_tpu/nn/swin.py:340-376, cropped back to the canvas."""
    b, h, w, _ = args[0].shape
    hp, wp = -(-h // win) * win, -(-w // win) * win
    jdt = getattr(jnp, dtype)

    def reference(x, *weights):
        xp = jnp.pad(x.astype(jdt), ((0, 0), (0, hp - h), (0, wp - w), (0, 0)))
        if shift:
            xp = jnp.roll(xp, (-shift, -shift), axis=(1, 2))
        yw = fused_window_block(
            window_partition(xp, win), *weights, region_labels(b, hp, wp, win, shift), heads,
            residual=residual, interpret=True,
            pad_mask=pad_labels(b, h, w, hp, wp, win, shift))
        y = window_reverse(yw, win, hp, wp)
        if shift:
            y = jnp.roll(y, (shift, shift), axis=(1, 2))
        return y[:, :h, :w].astype(jnp.float32)

    return np.asarray(jax.jit(reference)(*(jnp.asarray(a) for a in args)))


CASES = [  # (H, W, C, heads, shift), batch 2, windows of 7, dh 32
    (9, 9, 64, 2, 0),     # 9² padded to 14²
    (9, 9, 64, 2, 3),
    (12, 10, 128, 4, 0),  # 12 x 10 padded to 14 x 14
    (12, 10, 128, 4, 3),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,w,c,heads,shift", CASES)
def test_tiled_token_major_block_matches_pallas_and_plain(dtype, h, w, c, heads, shift):
    """The plan's emulation against fused_window_block (interpret mode) and
    swin_window_block_plain, the residual on at shift 0 and off at shift 3."""
    tdt = getattr(torch, dtype)
    residual = shift == 0
    args = _inputs(h * w + c + shift, 2, h, w, c, heads, 7, tdt)
    t = [torch.from_numpy(a) for a in args]
    got = tiled_token_major_block(*t, heads, 7, shift, tdt, residual=residual)
    want = _pallas_block(args, heads, 7, shift, dtype, residual)
    plain = swin_window_block_plain(t[0].to(tdt), *t[1:], heads, 7, shift,
                                    residual=residual).float().numpy()
    assert got.shape == t[0].shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL[tdt])
    np.testing.assert_allclose(got.numpy(), plain, **TOL[tdt])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiled_token_major_block_needs_bqkv_at_pad_tokens(dtype):
    """The control: zero k and v at the HF pad tokens (instead of bqkv's)
    misses both references by more than the tolerance on a padded canvas."""
    tdt = getattr(torch, dtype)
    h, w, c, heads, shift = 9, 9, 64, 2, 3
    args = _inputs(7, 2, h, w, c, heads, 7, tdt)
    t = [torch.from_numpy(a) for a in args]
    got = tiled_token_major_block(*t, heads, 7, shift, tdt, pad_kv_zero=True).numpy()
    want = _pallas_block(args, heads, 7, shift, dtype, True)
    plain = swin_window_block_plain(t[0].to(tdt), *t[1:], heads, 7, shift).float().numpy()
    tol = TOL[tdt]
    for ref in (want, plain):
        assert not np.all(np.abs(got - ref) <= tol["atol"] + tol["rtol"] * np.abs(ref))


def test_window_tokens_cover_each_real_token_once():
    """The gather's index: every real token of the canvas in exactly one
    window, the HF pad positions -1 (14² - 9² of them an image)."""
    pix, lab = window_tokens(2, 9, 9, 7, 3)
    real = pix[pix >= 0]
    assert sorted(real.tolist()) == list(range(2 * 81))
    assert int((pix < 0).sum()) == 2 * (14 * 14 - 81)
    assert set(lab.unique().tolist()) <= set(range(9)) and math.prod(lab.shape) == pix.numel()
