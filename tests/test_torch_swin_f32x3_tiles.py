"""The arithmetic of the f32 body of the swin window block (TPU rows 6 and 9,
``lc2is_tpu_torch/csrc/swin_window.cu``, ``launch_f32_plan``), which runs the
token-major plan with every product on the tensor cores in 3xTF32, emulated
step by step in numpy on the CPU and held against lc2is_tpu's two Pallas
forwards of this function in f32 in interpret mode (as the JAX package's own
tests run them) and against the port's ``swin_window_block_plain``, on the
same numpy-seeded inputs.

The 3xTF32 product (``csrc/gemm_f32x3.cuh``, emulated as in
tests/test_torch_f32x3_tiles.py): each operand value a is split into hi =
tf32(a) and lo = tf32(a - hi) (``cvt.rna.tf32.f32``), and a · b accumulated as
lo·hi' + hi·lo' + hi·hi' into a fresh f32 sum per 32-wide k-slice, added to
the running sum (the forward bodies add each mma's products in f32, round to
nearest, which a sum in f32 models).

The plan (1/√dh folded into the q rows of wqkv and bqkv in f32, as the
wrapper hands them over; nothing rounded below f32):
  1. the LayerNorm of the B·H·W real tokens in canvas order, two-pass f32
     statistics;
  2. q|k|v = LN · wqkvᵀ + bqkv for those tokens (the GEMM, 32-wide slices);
     an HF pad token has no row;
  3. per window, its tokens gathered from those rows by the roll and pad
     indexing (``window_tokens`` of tests/test_torch_window_block_tiles.py,
     the core's ``Canvas::pixel``), bqkv's q|k|v at HF pad tokens and zeros
     past win², as a 64-row tile; per head S = q · kᵀ (dh in 32-wide slices)
     + bias, −100 where the shift regions differ, keys past win² dropped; e
     = exp2((S − max) · log2 e); O = e · v (the keys in two 32-key slices) ·
     (1 / Σ e), written back to the real tokens' rows;
  4. out = O · woᵀ + bo [+ x] over the real tokens (the GEMM).

Stated tolerance: ≤ 2e-6 · max |ref|, the rule of the other f32 bodies'
emulations, against ``swin_canvas_block(..., interpret=True)`` (row 6, C ≤
384, dh 16 and 32), ``fused_window_block(..., interpret=True)`` on the pad /
roll / partition layout of ``lc2is_tpu/nn/swin.py`` (row 9, C > 384) and
the plain version alike.  The control that must fail the same rule: the
one-term emulation (hi·hi' only, one TF32 product a product).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lc2is_tpu.ops.swin_canvas import swin_canvas_block
from lc2is_tpu_torch.ops.swin_window import swin_window_block_plain
from test_torch_bwd_f32x3_tiles import mmx
from test_torch_f32x3_tiles import LOG2E, _within
from test_torch_window_block_tiles import _pallas_block, window_tokens

KSLICE = 32  # the k-slice of the GEMM and of the core's two products
ROWS = 64    # a window's tile: win² <= 64 tokens, padded


def swin_block_x3(x, lnw, lnb, wqkv, bqkv, wo, bo, bias, heads, win, shift, residual=True,
                  terms=3, eps=1e-5):
    """The f32 plan's four steps on f32 numpy arrays (wqkv, bqkv unscaled, as
    swin_window_block takes them); ``terms=1``: the one-term control."""
    b, h, w, c = x.shape
    dh, n = c // heads, win * win
    scale = np.float32(1 / math.sqrt(dh))
    wq_s, bq_s = wqkv.copy(), bqkv.copy()
    wq_s[:c] *= scale
    bq_s[:c] *= scale
    # 1. the LayerNorm of the real tokens, two-pass f32 statistics
    xt = x.reshape(-1, c)
    mu = xt.mean(-1, keepdims=True, dtype=np.float32)
    rs = 1 / np.sqrt(((xt - mu) ** 2).mean(-1, keepdims=True, dtype=np.float32) + np.float32(eps))
    ln = ((xt - mu) * rs * lnw + lnb).astype(np.float32)
    # 2. q|k|v of the real tokens
    qkv = mmx(ln, wq_s.T, terms, KSLICE) + bq_s
    # 3. each window's 64-row tile gathered: bqkv at an HF pad token, zeros past n
    pix, lab = (t.numpy() for t in window_tokens(b, h, w, win, shift))
    nwin = pix.shape[0]
    rows = np.concatenate([qkv, bq_s[None]])[np.where(pix >= 0, pix, qkv.shape[0])]
    rows = np.pad(rows, ((0, 0), (0, ROWS - n), (0, 0)))
    q, k, v = (t.reshape(nwin, ROWS, heads, dh).transpose(0, 2, 1, 3)
               for t in np.split(rows, 3, -1))
    s = mmx(q, np.swapaxes(k, -1, -2), terms, KSLICE)
    labw = np.pad(lab, ((0, 0), (0, ROWS - n)))
    s = (s + np.pad(bias, ((0, 0), (0, ROWS - n), (0, ROWS - n)))
         - np.float32(100) * (labw[:, None, :, None] != labw[:, None, None, :]))
    s[..., n:] = -np.inf
    e = np.exp2((s - s.max(-1, keepdims=True)).astype(np.float64) * LOG2E).astype(np.float32)
    o = mmx(e, v, terms, KSLICE) * (np.float32(1) / e.sum(-1, keepdims=True, dtype=np.float32))
    o = o[:, :, :n].transpose(0, 2, 1, 3).reshape(-1, c)
    ho = np.zeros_like(ln)
    real = pix.reshape(-1) >= 0
    ho[pix.reshape(-1)[real]] = o[real]
    # 4. the out-projection, + bo [+ x]
    y = mmx(ho, wo.T, terms, KSLICE) + bo
    return (y + xt if residual else y).reshape(b, h, w, c)


def _inputs(seed, b, h, w, c, heads, win):
    rs = np.random.RandomState(seed)
    params = [1 + 0.1 * rs.randn(c), 0.5 * rs.randn(c), rs.randn(3 * c, c) / np.sqrt(c),
              0.1 * rs.randn(3 * c), rs.randn(c, c) / np.sqrt(c), 0.1 * rs.randn(c),
              0.1 * rs.randn(heads, win * win, win * win)]
    return [a.astype(np.float32) for a in [rs.randn(b, h, w, c)] + params]


# (B, H, W, C, heads, shift, residual); windows of 7
CANVAS_CASES = [
    (2, 9, 9, 64, 4, 3, True),      # dh 16, 9² padded to 14², shifted
    (1, 14, 12, 64, 2, 0, False),   # dh 32, one side padded: the drop-path branch
    (1, 14, 14, 96, 3, 3, False),   # dh 32, swin-small stage 1's width, no padding
]
WINDOWED_CASES = [
    (1, 9, 9, 448, 14, 3, True),    # C > 384: row 9's range, dh 32, padded and shifted
    (1, 10, 8, 448, 14, 0, False),  # both sides padded, unshifted, no residual
]


@pytest.fixture(scope="module")
def references():
    """(inputs, the Pallas forward in f32 in interpret mode, the plain
    version) of a case, each computed once for the module."""
    cache = {}

    def get(case):
        if case not in cache:
            b, h, w, c, heads, shift, residual = case
            args = _inputs(b * h * w + c + heads + shift, b, h, w, c, heads, 7)
            if c <= 384:
                pallas = np.array(jax.jit(lambda *a: swin_canvas_block(
                    *a, heads, 7, shift, interpret=True, residual=residual))(
                        *map(jnp.asarray, args)))
            else:
                pallas = _pallas_block(args, heads, 7, shift, "float32", residual)
            plain = swin_window_block_plain(*map(torch.from_numpy, args), heads, 7, shift,
                                            residual=residual).numpy()
            cache[case] = args, pallas, plain
        return cache[case]

    return get


@pytest.mark.parametrize("case", CANVAS_CASES + WINDOWED_CASES)
def test_swin_block_x3_matches_pallas_and_plain(references, case):
    """The f32 plan's emulation against the Pallas forward of its range (the
    canvas kernel at C <= 384, the windowed block above it; interpret mode)
    and swin_window_block_plain."""
    _, _, _, c, heads, shift, residual = case
    args, pallas, plain = references(case)
    got = swin_block_x3(*args, heads, 7, shift, residual)
    assert got.shape == args[0].shape
    what = "Pallas canvas" if c <= 384 else "Pallas windowed"
    _within(got, pallas, what)
    _within(got, plain, "plain")


@pytest.mark.parametrize("case", [CANVAS_CASES[0], WINDOWED_CASES[0]])
def test_swin_block_x3_one_term_control_fails(references, case):
    """The control: one TF32 product a product fails the rule against the
    Pallas forward and the plain version."""
    _, _, _, _, heads, shift, residual = case
    args, pallas, plain = references(case)
    got = swin_block_x3(*args, heads, 7, shift, residual, terms=1)
    for want, what in ((pallas, "Pallas"), (plain, "plain")):
        with pytest.raises(AssertionError):
            _within(got, want, what)

