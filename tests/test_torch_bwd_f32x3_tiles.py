"""The arithmetic of the f32 bodies of the two training backwards, which run
every product on the tensor cores in 3xTF32, emulated step by step in numpy
on the CPU and held against lc2is_tpu's Pallas backward kernels in f32 in
interpret mode (as the JAX package's own tests run them) and against
autograd through the port's plain versions, on the same numpy-seeded inputs.

The 3xTF32 product (``lc2is_tpu_torch/csrc/gemm_f32x3.cuh``, emulated as
in tests/test_torch_f32x3_tiles.py): each operand value a is split into hi
= tf32(a) and lo = tf32(a - hi) (``cvt.rna.tf32.f32``), and a · b
accumulated as lo·hi' + hi·lo' + hi·hi' into a fresh f32 sum per k-slice,
added to the running sum.  The GEMM's slices are 32 wide; a weight
gradient's K (the tokens) is cut into the chunks the GEMM's split over
blocks gives it, each chunk's partial added to the output in turn (its
atomics).  Its operands are gathered from flat buffers by the kernel's own
index arithmetic for each orientation: A (m, k) at a[m·lda + k] or, M
contiguous, a[k·lda + m]; B (k, n) at b[n·ldb + k] or, N contiguous,
b[k·ldb + n].

Row 3, ``fused_attn_block_bwd`` (``csrc/attention_block_bwd.cu``,
``attn_bwd_f32``): q = x · wqᵀ + bq with 1/√dh folded into wq, bq; the
head outputs and each row's log-sum-exp (log2 units) by the forward's core
(``csrc/attn_core_f32.cuh``: key ranges as ``CorePlan`` cuts them, merged
in order); s = att · woᵀ + bo + x; the post-LN backward (ds, dln_w, dln_b,
dbo); dWo = dsᵀ · att and dO = ds · wo; delta = Σ dO∘att per head; dq per
64-key tile and dk, dv per 64-query tile (p = 2^(s·log2 e − lse), ds = p∘(dP
− delta)), each tile's sum fresh and added to the running sum; dWq = dqᵀ · x,
dbq = Σ dq, dx = dq · wq + ds.

Rows 7 and 10, ``swin_window_block_bwd`` (``csrc/swin_window_bwd.cu``,
``swin_bwd_f32``): LN(x) in window order (zero at HF pad tokens), qkv = LN
· wqkvᵀ + bqkv (1/√dh folded into the q rows), dA = g · wo; per window and
head over a 64-row tile, S = q·kᵀ + bias − 100 across regions (keys past
win² dropped), P the max-subtracted softmax, O = P·v, dP = dA·vᵀ, dS =
P∘(dP − rowsum(P∘dP)) (dbias sums it), dQ = dS·k, dV = Pᵀ·dA, dK = dSᵀ·q;
dWo = gᵀ · att, dWqkv = dqkvᵀ · LN, the bias gradients as column sums, dLN =
dqkv · wqkv, the LN backward, scattered back to the canvas.

Stated tolerance: every gradient within 2e-6 · max |ref| of the reference,
the forward's rule (tests/test_torch_f32x3_tiles.py), against the Pallas
backward and autograd through the plain version alike.  A gradient that is
0 in exact arithmetic (dk, dwq, dbq over one key, where the softmax is
constant) is held to 2e-6 · max |ref| of its partner of the same scale (dv,
dwo, dbo).  The control that must fail the same rule: the one-term emulation
(hi·hi' only, one TF32 product a product).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lc2is_tpu.nn.swin import window_partition, window_reverse
from lc2is_tpu.ops import attention_block as jab
from lc2is_tpu.ops.swin_canvas import swin_canvas_block
from lc2is_tpu.ops.window_attention import fused_window_block, pad_labels, region_labels
from lc2is_tpu_torch.ops.attention_block import fused_attn_block_plain
from lc2is_tpu_torch.ops.swin_window import swin_window_block_plain
from test_torch_f32x3_tiles import LOG2E, core_plan, split

REL = 2e-6  # of max |ref|, each gradient
KSLICE = 32  # the GEMM's k-slice
TILE = 64  # key tile of the recompute and dq, query tile of dk / dv, the swin core's rows
SMS = 132
ATTN_NAMES = ("x", "k", "v", "wq", "bq", "wo", "bo", "ln_w", "ln_b")
SWIN_NAMES = ("x", "ln_w", "ln_b", "wqkv", "bqkv", "wo", "bo", "bias")


def mmx(a, b, terms=3, kslice=None):
    """a (..., K) @ b (..., K, N) as the 3xTF32 products sum it: per k-slice
    (the whole K when kslice is None) lo·hi + hi·lo + hi·hi into a fresh f32
    sum, added to the running sum; ``terms=1`` keeps hi·hi only."""
    ah, al = split(a)
    bh, bl = split(b)
    k = a.shape[-1]
    kslice = kslice or k
    acc = None
    for k0 in range(0, k, kslice):
        s = slice(k0, k0 + kslice)
        part = ah[..., s] @ bh[..., s, :]
        if terms == 3:
            part = al[..., s] @ bh[..., s, :] + ah[..., s] @ bl[..., s, :] + part
        acc = part if acc is None else acc + part
    return acc.astype(np.float32)


def operand(buf, rows, cols, ld, contiguous_rows):
    """The (rows x cols) operand the GEMM reads from a flat f32 buffer:
    element (r, c) at buf[r·ld + c] when its rows are contiguous (A K-major, a
    B read N-contiguous) or at buf[c·ld + r] (A M-contiguous, B read from a
    torch-layout weight)."""
    r, c = np.arange(rows)[:, None], np.arange(cols)[None, :]
    idx = r * ld + c if contiguous_rows else c * ld + r
    return np.asarray(buf, np.float32).reshape(-1)[idx]


def gemm_x3(m, n, k, a, lda, a_t, b, ldb, b_t, terms=3):
    """gemm32::product<a_t, b_t>(M, N, K, a, lda, b, ldb): the operands
    gathered as the kernel indexes them, 32-wide k-slices."""
    am = operand(a, k, m, lda, True).T if a_t else operand(a, m, k, lda, True)
    bm = operand(b, k, n, ldb, True) if b_t else operand(b, k, n, ldb, False)
    return mmx(am, bm, terms, KSLICE)


def weight_grad_x3(m, n, k, a, lda, b, ldb, terms=3):
    """The weight-gradient form, product<true, true> with ep.atomic: K split
    into the chunks the launch gives (64 x 64 tiles, about four blocks an SM,
    at most one chunk per 256 tokens), each chunk's 32-slice sum added to the
    output in turn."""
    tiles = -(-m // 64) * -(-n // 64)
    splits = min(-(-4 * SMS // tiles), -(-k // 256))
    kchunk = -(-(-(-k // splits)) // KSLICE) * KSLICE
    am = operand(a, k, m, lda, True).T
    bm = operand(b, k, n, ldb, True)
    out = np.zeros((m, n), np.float32)
    for k0 in range(0, k, kchunk):
        out += mmx(am[:, k0:k0 + kchunk], bm[k0:k0 + kchunk], terms, KSLICE)
    return out


def _exp2(x):
    return np.exp2(np.asarray(x, np.float64)).astype(np.float32)


# ---------------------------------------------------------------------------
# row 3: the decoder attention block's backward
# ---------------------------------------------------------------------------


def core_with_lse(qh, kh, vh, ranges, per, terms):
    """attn_core_f32 for one (image, head): each range's online softmax over
    its 64-key tiles (log2 units), the ranges merged in order; (O, lse2)."""
    n_tiles = -(-kh.shape[0] // TILE)
    parts = []
    for r in range(ranges):
        m = np.full(qh.shape[0], -np.inf, np.float32)
        l = np.zeros(qh.shape[0], np.float32)
        o = np.zeros(qh.shape, np.float32)
        for t in range(r * per, min(n_tiles, (r + 1) * per)):
            kt, vt = kh[TILE * t:TILE * (t + 1)], vh[TILE * t:TILE * (t + 1)]
            s = mmx(qh, kt.T, terms)
            m_new = np.maximum(m, s.max(1) * np.float32(LOG2E))
            alpha = _exp2(m - m_new)
            p = _exp2(s.astype(np.float64) * LOG2E - m_new[:, None])
            l = l * alpha + p.sum(1, dtype=np.float32)
            o = o * alpha[:, None] + mmx(p, vt, terms)
            m = m_new
        parts.append((m, l, o))
    top = np.max([m for m, _, _ in parts], 0)
    l = sum(lr * _exp2(m - top) for m, lr, _ in parts)
    o = sum(orr * _exp2(m - top)[:, None] for m, _, orr in parts)
    return o * (np.float32(1) / l)[:, None], top + np.log2(l).astype(np.float32)


def attn_block_bwd_x3(x, k, v, g, wq, bq, wo, bo, lnw, heads, terms=3, eps=1e-5):
    """Row 3's f32 body on f32 numpy arrays (wq, bq unscaled): the gradients
    (dx, dk, dv, dwq, dbq, dwo, dbo, dln_w, dln_b), dwq and dbq carried back
    through the 1/√dh fold."""
    b, p, c = x.shape
    l = k.shape[1]
    dh, bp = c // heads, b * p
    scale = np.float32(1 / math.sqrt(dh))
    wq_s, bq_s = wq * scale, bq * scale
    xf = x.reshape(-1)
    q = (gemm_x3(bp, c, c, xf, c, False, wq_s, c, False, terms) + bq_s).reshape(b, p, c)
    _, _, ranges, per = core_plan(b, p, l, heads)
    att = np.zeros_like(q)
    lse = np.zeros((b, heads, p), np.float32)
    for i in range(b):
        for h in range(heads):
            cs = slice(h * dh, (h + 1) * dh)
            att[i, :, cs], lse[i, h] = core_with_lse(q[i, :, cs], k[i, :, cs], v[i, :, cs],
                                                     ranges, per, terms)
    s = gemm_x3(bp, c, c, att, c, False, wo, c, False, terms) + bo + x.reshape(bp, c)
    mu = s.mean(-1, keepdims=True, dtype=np.float32)
    rs = 1 / np.sqrt(((s - mu) ** 2).mean(-1, keepdims=True, dtype=np.float32) + np.float32(eps))
    sh = (s - mu) * rs
    gf = g.reshape(bp, c)
    dsh = gf * lnw
    ds = rs * (dsh - dsh.mean(-1, keepdims=True) - sh * (dsh * sh).mean(-1, keepdims=True))
    dlnw, dlnb, dbo = (gf * sh).sum(0), gf.sum(0), ds.sum(0)
    dwo = weight_grad_x3(c, c, bp, ds, c, att, c, terms)
    d_o = gemm_x3(bp, c, c, ds, c, False, wo, c, True, terms).reshape(b, p, c)
    dq, dk, dv = np.zeros_like(q), np.zeros_like(k), np.zeros_like(v)
    for i in range(b):
        for h in range(heads):
            cs = slice(h * dh, (h + 1) * dh)
            qh, kh, vh, gh = q[i, :, cs], k[i, :, cs], v[i, :, cs], d_o[i, :, cs]
            delta = (gh * att[i, :, cs]).sum(-1)
            for k0 in range(0, l, TILE):  # dq: fresh sums per key tile
                kt, vt = kh[k0:k0 + TILE], vh[k0:k0 + TILE]
                pt = _exp2(mmx(qh, kt.T, terms) * np.float64(LOG2E) - lse[i, h][:, None])
                dst = pt * (mmx(gh, vt.T, terms) - delta[:, None])
                dq[i, :, cs] += mmx(dst, kt, terms)
            for k0 in range(0, l, TILE):  # dk, dv: fresh sums per query tile
                kt, vt = kh[k0:k0 + TILE], vh[k0:k0 + TILE]
                for q0 in range(0, p, TILE):
                    qt, gt = qh[q0:q0 + TILE], gh[q0:q0 + TILE]
                    pt = _exp2(mmx(kt, qt.T, terms) * np.float64(LOG2E)
                               - lse[i, h, q0:q0 + TILE][None, :])
                    dst = pt * (mmx(vt, gt.T, terms) - delta[q0:q0 + TILE][None, :])
                    dv[i, k0:k0 + TILE, cs] += mmx(pt, gt, terms)
                    dk[i, k0:k0 + TILE, cs] += mmx(dst, qt, terms)
    dwq = weight_grad_x3(c, c, bp, dq, c, x, c, terms)
    dbq = dq.reshape(bp, c).sum(0)
    dx = gemm_x3(bp, c, c, dq, c, False, wq_s, c, True, terms) + ds
    return [dx.reshape(b, p, c), dk, dv, dwq * scale, dbq * scale, dwo, dbo, dlnw, dlnb]


def _attn_inputs(seed, b, p, l, c):
    rs = np.random.RandomState(seed)
    acts = [rs.randn(b, n, c) for n in (p, l, l)]
    params = [rs.randn(c, c) / np.sqrt(c), 0.1 * rs.randn(c), rs.randn(c, c) / np.sqrt(c),
              0.1 * rs.randn(c), 1 + 0.1 * rs.randn(c), 0.1 * rs.randn(c)]
    g = rs.randn(b, p, c)
    return [a.astype(np.float32) for a in acts + params], g.astype(np.float32)


def _attn_refs(args, g, heads):
    """(jax.vjp of the Pallas block in f32, interpret mode: its custom VJP
    runs _bwd_kernel; autograd through fused_attn_block_plain)."""
    def fn(*a):
        _, vjp = jax.vjp(lambda *t: jab.fused_attn_block(*t, heads, interpret=True), *a[:-1])
        return vjp(a[-1])

    pallas = [np.array(r) for r in jax.jit(fn)(*map(jnp.asarray, args), jnp.asarray(g))]
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    out = fused_attn_block_plain(*leaves, heads)
    plain = [t.numpy() for t in torch.autograd.grad(out, leaves, torch.from_numpy(g))]
    return pallas, plain


def _within_grads(got, want, names, partners=None):
    """Every gradient within REL · max |ref| (raises AssertionError); a
    gradient named in ``partners`` is held to REL · max |partner ref|."""
    for i, (a, w, name) in enumerate(zip(got, want, names)):
        w = np.asarray(w, np.float32)
        ref = np.asarray(want[partners[i]], np.float32) if partners and i in partners else w
        err = np.abs(np.asarray(a, np.float32) - w).max()
        lim = REL * np.abs(ref).max()
        assert np.isfinite(a).all() and err <= lim, f"{name}: max |Δ| {err:.3e} > {lim:.3e}"


ONE_KEY_PARTNERS = {1: 2, 3: 5, 4: 6}  # dk: dv, dwq: dwo, dbq: dbo


@pytest.mark.parametrize("b,p,l,c,heads", [
    (2, 40, 151, 128, 2),  # dh 64, the class count as L: 3 key ranges, ragged tiles
    (2, 70, 7, 64, 4),     # dh 16, P past a query tile, 7 keys
    (1, 33, 130, 64, 2),   # dh 32, L past two key tiles
    (2, 17, 1, 128, 8),    # dh 16 at 8 heads, one key
])
def test_attn_block_bwd_x3_matches_pallas_and_plain(b, p, l, c, heads):
    """Row 3's f32 emulation against the Pallas backward (interpret mode)
    and autograd through fused_attn_block_plain, every gradient."""
    args, g = _attn_inputs(p + l + c + heads, b, p, l, c)
    got = attn_block_bwd_x3(*args[:3], g, *args[3:8], heads)
    pallas, plain = _attn_refs(args, g, heads)
    partners = ONE_KEY_PARTNERS if l == 1 else None
    _within_grads(got, pallas, [n + " (Pallas)" for n in ATTN_NAMES], partners)
    _within_grads(got, plain, [n + " (plain)" for n in ATTN_NAMES], partners)


def test_attn_block_bwd_x3_one_term_control_fails():
    """The control: one TF32 product a product fails the rule against the
    Pallas backward and the plain version."""
    args, g = _attn_inputs(7, 2, 40, 151, 128)
    got = attn_block_bwd_x3(*args[:3], g, *args[3:8], 2, terms=1)
    for want in _attn_refs(args, g, 2):
        with pytest.raises(AssertionError):
            _within_grads(got, want, ATTN_NAMES)


# ---------------------------------------------------------------------------
# rows 7 and 10: the swin window block's backward
# ---------------------------------------------------------------------------


def _layout(b, h, w, win, shift):
    """(canvas pixel of each window-ordered token, -1 at an HF pad token;
    its region label), as ``Canvas::pixel`` and the core compute them."""
    hp, wp = -(-h // win) * win, -(-w // win) * win
    nwh, nww, n = hp // win, wp // win, win * win
    m = np.arange(b * nwh * nww * n)
    t, wb = m % n, m // n
    wdw, bi = wb % (nwh * nww), wb // (nwh * nww)
    r = (wdw // nww) * win + t // win
    cc = (wdw % nww) * win + t % win
    y, x = (r + shift) % hp, (cc + shift) % wp
    pix = np.where((y < h) & (x < w), (bi * h + y) * w + x, -1)

    def region(i, size):
        return ((i >= size - win).astype(int) + (i >= size - shift)) if shift else 0 * i

    return pix, region(r, hp) * 3 + region(cc, wp)


def swin_block_bwd_x3(x, g, lnw, lnb, wqkv, bqkv, wo, bias, heads, win, shift, residual,
                      terms=3, eps=1e-5):
    """Rows 7 and 10's f32 body on f32 numpy arrays (wqkv, bqkv unscaled):
    the gradients (dx, dln_w, dln_b, dwqkv, dbqkv, dwo, dbo, dbias), the q
    rows of dwqkv and dbqkv carried back through the 1/√dh fold."""
    b, h, w, c = x.shape
    dh, n = c // heads, win * win
    scale = np.float32(1 / math.sqrt(dh))
    wq_s, bq_s = wqkv.copy(), bqkv.copy()
    wq_s[:c] *= scale
    bq_s[:c] *= scale
    pix, lab = _layout(b, h, w, win, shift)
    real = pix >= 0
    mt = pix.size
    # 1. LN per token (two-pass f32 statistics), zero at pad tokens; g gathered
    xt = x.reshape(-1, c)[np.where(real, pix, 0)]
    mu = xt.mean(-1, keepdims=True, dtype=np.float32)
    rs = 1 / np.sqrt(((xt - mu) ** 2).mean(-1, keepdims=True, dtype=np.float32) + np.float32(eps))
    xh = (xt - mu) * rs
    hn = np.where(real[:, None], xh * lnw + lnb, 0).astype(np.float32)
    gw = np.where(real[:, None], g.reshape(-1, c)[np.where(real, pix, 0)], 0).astype(np.float32)
    # 2. qkv = LN · wqkvᵀ + bqkv; dA = g · wo (wo read N-contiguous)
    qkv = gemm_x3(mt, 3 * c, c, hn, c, False, wq_s, c, False, terms) + bq_s
    d_a = gemm_x3(mt, c, c, gw, c, False, wo, c, True, terms)
    # 3. the core: windows as 64-row tiles (rows past n zero), keys past n dropped
    nwin = mt // n

    def tiles(t):  # (M, C) -> (windows, heads, 64, dh)
        t = t.reshape(nwin, n, heads, dh).transpose(0, 2, 1, 3)
        return np.pad(t, ((0, 0), (0, 0), (0, TILE - n), (0, 0)))

    q, k, v = (tiles(t) for t in np.split(qkv, 3, -1))
    da = tiles(d_a)
    s = mmx(q, np.swapaxes(k, -1, -2), terms)
    bz = np.pad(bias, ((0, 0), (0, TILE - n), (0, TILE - n)))
    labw = np.pad(lab.reshape(nwin, n), ((0, 0), (0, TILE - n)))
    s = s + bz - 100.0 * (labw[:, None, :, None] != labw[:, None, None, :])
    s[..., n:] = -np.inf
    e = _exp2((s - s.max(-1, keepdims=True)) * np.float64(LOG2E))
    pr = (e * (np.float32(1) / e.sum(-1, keepdims=True, dtype=np.float32))).astype(np.float32)
    pr[:, :, n:] = 0.0
    o = mmx(pr, v, terms)
    dp = mmx(da, np.swapaxes(v, -1, -2), terms)
    dsc = (pr * (dp - (pr * dp).sum(-1, keepdims=True, dtype=np.float32))).astype(np.float32)
    dbias = dsc.sum(0)[:, :n, :n]
    dq = mmx(dsc, k, terms)
    dv = mmx(np.swapaxes(pr, -1, -2), da, terms)
    dk = mmx(np.swapaxes(dsc, -1, -2), q, terms)

    def merged(t):  # (windows, heads, 64, dh) -> (M, C)
        return t[:, :, :n].transpose(0, 2, 1, 3).reshape(mt, c)

    att = merged(o)
    dqkv = np.concatenate([merged(dq), merged(dk), merged(dv)], -1)
    # 4. weight gradients (split over blocks) and bias gradients
    dwo = weight_grad_x3(c, c, mt, gw, c, att, c, terms)
    dbo = gw.sum(0)
    dwq_s = weight_grad_x3(3 * c, c, mt, dqkv, 3 * c, hn, c, terms)
    dbq_s = dqkv.sum(0)
    # 5. dLN = dqkv · wqkv (wqkv read N-contiguous), the LN backward, scattered
    dy = gemm_x3(mt, c, 3 * c, dqkv, 3 * c, False, wq_s, c, True, terms)
    dy = np.where(real[:, None], dy, 0)
    dxh = dy * lnw
    dxt = rs * (dxh - dxh.mean(-1, keepdims=True) - xh * (dxh * xh).mean(-1, keepdims=True))
    dx = np.zeros((b * h * w, c), np.float32)
    dx[pix[real]] = dxt[real]
    dx = dx.reshape(b, h, w, c) + (g if residual else 0)
    dlnw = (dy * xh)[real].sum(0)
    dlnb = dy[real].sum(0)
    dwqkv = np.concatenate([dwq_s[:c] * scale, dwq_s[c:]])
    dbqkv = np.concatenate([dbq_s[:c] * scale, dbq_s[c:]])
    return [dx, dlnw, dlnb, dwqkv, dbqkv, dwo, dbo, dbias]


def _swin_inputs(seed, b, h, w, c, heads, win):
    rs = np.random.RandomState(seed)
    x, g = rs.randn(b, h, w, c), rs.randn(b, h, w, c)
    params = [1 + 0.1 * rs.randn(c), 0.5 * rs.randn(c), rs.randn(3 * c, c) / np.sqrt(c),
              0.1 * rs.randn(3 * c), rs.randn(c, c) / np.sqrt(c), 0.1 * rs.randn(c),
              0.1 * rs.randn(heads, win * win, win * win)]
    return [a.astype(np.float32) for a in [x] + params], g.astype(np.float32)


def _canvas_grads(args, g, heads, win, shift, residual):
    """jax.vjp of swin_canvas_block in f32 (interpret mode): row 7's Pallas
    backward, _canvas_bwd_kernel."""
    def fn(*a):
        _, vjp = jax.vjp(lambda *t: swin_canvas_block(*t, heads, win, shift, interpret=True,
                                                      residual=residual), *a[:-1])
        return vjp(a[-1])

    return [np.array(r) for r in jax.jit(fn)(*map(jnp.asarray, args), jnp.asarray(g))]


def _windowed_grads(args, g, heads, win, shift, residual):
    """jax.vjp of fused_window_block in f32 (interpret mode) on the pad /
    roll / partition layout of lc2is_tpu/nn/swin.py: row 10's Pallas
    backward, _block_bwd_kernel."""
    b, h, w, _ = args[0].shape
    hp, wp = -(-h // win) * win, -(-w // win) * win

    def block(x, *weights):
        xp = jnp.pad(x, ((0, 0), (0, hp - h), (0, wp - w), (0, 0)))
        if shift:
            xp = jnp.roll(xp, (-shift, -shift), axis=(1, 2))
        yw = fused_window_block(
            window_partition(xp, win), *weights, region_labels(b, hp, wp, win, shift), heads,
            residual=residual, interpret=True, pad_mask=pad_labels(b, h, w, hp, wp, win, shift))
        y = window_reverse(yw, win, hp, wp)
        if shift:
            y = jnp.roll(y, (shift, shift), axis=(1, 2))
        return y[:, :h, :w]

    def fn(*a):
        _, vjp = jax.vjp(block, *a[:-1])
        return vjp(a[-1])

    return [np.array(r) for r in jax.jit(fn)(*map(jnp.asarray, args), jnp.asarray(g))]


def _swin_plain_grads(args, g, heads, win, shift, residual):
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    out = swin_window_block_plain(*leaves, heads, win, shift, residual=residual)
    return [t.numpy() for t in torch.autograd.grad(out, leaves, torch.from_numpy(g))]


@pytest.mark.parametrize("b,h,w,c,heads,win,shift,residual", [
    (2, 9, 9, 64, 2, 7, 3, False),    # dh 32, 9² padded to 14², shifted: the drop-path branch
    (1, 14, 12, 64, 4, 7, 0, True),   # dh 16, one side padded, the residual
    (1, 10, 10, 128, 2, 7, 3, True),  # dh 64, padded and shifted
])
def test_swin_block_bwd_x3_matches_pallas_and_plain(b, h, w, c, heads, win, shift, residual):
    """Rows 7 and 10's f32 emulation against both Pallas backwards (the
    canvas kernel's and the windowed block's, interpret mode) and autograd
    through swin_window_block_plain, every gradient."""
    args, g = _swin_inputs(b * h * w + c + shift, b, h, w, c, heads, win)
    got = swin_block_bwd_x3(*args[:1], g, *args[1:6], args[7], heads, win, shift, residual)
    names = [n + " (plain)" for n in SWIN_NAMES]
    _within_grads(got, _swin_plain_grads(args, g, heads, win, shift, residual), names)
    _within_grads(got, _canvas_grads(args, g, heads, win, shift, residual),
                  [n + " (Pallas canvas)" for n in SWIN_NAMES])
    _within_grads(got, _windowed_grads(args, g, heads, win, shift, residual),
                  [n + " (Pallas windowed)" for n in SWIN_NAMES])


def test_swin_block_bwd_x3_one_term_control_fails():
    """The control: one TF32 product a product fails the rule against the
    Pallas backward and the plain version."""
    args, g = _swin_inputs(3, 2, 9, 9, 64, 2, 7)
    got = swin_block_bwd_x3(*args[:1], g, *args[1:6], args[7], 2, 7, 3, False, terms=1)
    for want in (_canvas_grads(args, g, 2, 7, 3, False),
                 _swin_plain_grads(args, g, 2, 7, 3, False)):
        with pytest.raises(AssertionError):
            _within_grads(got, want, SWIN_NAMES)
