"""The arithmetic of the f32 bodies of the decoder attention block and the
feed-forward, which run every product on the tensor cores in 3xTF32,
emulated step by step in numpy on the CPU and held against lc2is_tpu's
Pallas kernels in f32 in interpret mode (as the JAX package's own tests run
them) and against the port's plain versions, on the same numpy-seeded inputs.

The 3xTF32 product (``lc2is_tpu_torch/csrc/gemm_f32x3.cuh``): each operand
value a is split into hi = tf32(a) and lo = tf32(a - hi), where tf32 is
``cvt.rna.tf32.f32`` (round to nearest, ties away from zero, on the 13 low
mantissa bits), and a · b is accumulated as lo·hi' + hi·lo' + hi·hi' in f32,
the GEMM's K in 32-wide slices.

Row 2, ``fused_attn_block`` (``csrc/attention_block.cu``, ``attn_block_f32``):
q = x · wqᵀ + bq with 1/√dh folded into wq and bq in f32; per (image, head)
the key axis cut into ranges of 64-key tiles as ``CorePlan`` cuts it (enough
ranges to fill two waves of 132 SMs); per range the online softmax tile by
tile in log2 units, S = Q · Kᵀ and P · V in 3xTF32; the ranges' (m, l, O)
merged in order; s = att · woᵀ + bo + x; out = LN(s) with f32 statistics.

Row 1, ``fused_mlp`` (``csrc/fused_mlp.cu``, ``fused_mlp_f32``): pre h =
LN(x), post h = x; upre = h · w1ᵀ + b1; u = act(upre) (erf-gelu or relu); y
= u · w2ᵀ + b2 [+ x]; pre out = y, post out = LN(y).

Stated tolerance: ≤ 2e-6 · max |ref|, against the Pallas kernel and the
plain version alike.  The emulation lands near 2e-7: the three-term product
is f32-accurate, and what is left is f32 rounding in other sums' orders and
the JAX f32 erf's few ulps.  The control that must fail the same rule: the
one-term emulation (hi·hi' only, TF32 products), 5e-5 to 1e-4 of max |ref|.
A TF32 product cannot pass for an f32 one here, whereas the card's f32 gate
of phase 3 (1e-3 + 1e-3·|ref|) could not tell them apart.

The wrappers' card path, the launch recorded on CPU tensors: the f32 bodies
(and the swin window block's, tests/test_torch_swin_f32x3_tiles.py) get a
workspace of their size entry's floats.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lc2is_tpu.ops import attention_block as jab
from lc2is_tpu.ops import fused_mlp as jmlp
from lc2is_tpu_torch.ops import _build
from lc2is_tpu_torch.ops.attention_block import fused_attn_block_plain
from lc2is_tpu_torch.ops.fused_mlp import fused_mlp_plain

REL = 2e-6  # of max |ref|
LOG2E = np.float32(1.4426950408889634)
KEYS = 64  # keys of a streamed K/V tile
SMS = 132


def tf32(a):
    """a rounded to TF32 as cvt.rna.tf32.f32 does: to nearest on the 13 low
    mantissa bits, ties away from zero (the magnitude's bits rounded)."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    mag = ((bits & np.uint32(0x7FFFFFFF)) + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return ((bits & np.uint32(0x80000000)) | mag).view(np.float32)


def split(a):
    """(hi, lo): a = hi + lo to about 2^-22 relative, both TF32."""
    hi = tf32(a)
    return hi, tf32(a - hi)


def mm3(a, b, terms=3, kslice=32):
    """a (..., K) @ b (K, N) as the 3xTF32 GEMM: per k-slice lo·hi + hi·lo +
    hi·hi added to an f32 accumulator; ``terms=1`` keeps hi·hi only (one
    TF32 product, the control)."""
    ah, al = split(a)
    bh, bl = split(b)
    acc = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32)
    for k0 in range(0, a.shape[-1], kslice):
        s = slice(k0, k0 + kslice)
        if terms == 3:
            acc += al[..., s] @ bh[s]
            acc += ah[..., s] @ bl[s]
        acc += ah[..., s] @ bh[s]
    return acc


def core_plan(b, p, l, heads):
    """``CorePlan`` of csrc/attention_block.cu: (warps, query tiles, key
    ranges, key tiles a range)."""
    warps = -(-p // 16) if p <= 160 else 8
    q_tiles = -(-p // (16 * warps))
    n_tiles = -(-l // KEYS)
    s = min(n_tiles, -(-2 * SMS // (b * heads * q_tiles)))
    per = -(-n_tiles // s)
    return warps, q_tiles, -(-n_tiles // per), per


def attn_core(qh, kh, vh, ranges, per, terms):
    """One (image, head): the online softmax over each range's 64-key tiles
    (log2 units, the row max subtracted), then the ranges merged in order."""
    n_tiles = -(-kh.shape[0] // KEYS)
    parts = []
    for r in range(ranges):
        m = np.full(qh.shape[0], -np.inf, np.float32)
        l = np.zeros(qh.shape[0], np.float32)
        o = np.zeros(qh.shape, np.float32)
        for t in range(r * per, min(n_tiles, (r + 1) * per)):
            kt, vt = kh[KEYS * t:KEYS * (t + 1)], vh[KEYS * t:KEYS * (t + 1)]
            s = mm3(qh, kt.T, terms)
            m_new = np.maximum(m, s.max(1) * LOG2E)
            alpha = np.exp2(m - m_new)
            # one FMA, s · log2 e − m, then exp2
            p = np.exp2((s.astype(np.float64) * LOG2E - m_new[:, None]).astype(np.float32))
            l = l * alpha + p.sum(1, dtype=np.float32)
            o = o * alpha[:, None] + mm3(p, vt, terms)
            m = m_new
        parts.append((m, l, o))
    if ranges == 1:
        m, l, o = parts[0]
        return o * (np.float32(1) / l)[:, None]
    top = np.max([m for m, _, _ in parts], 0)
    l = sum(lr * np.exp2(m - top) for m, lr, _ in parts)
    o = sum(orr * np.exp2(m - top)[:, None] for m, _, orr in parts)
    return o * (np.float32(1) / l)[:, None]


def ln(v, w, b, eps=1e-5):
    """LayerNorm with two-pass f32 statistics, as layer_norm.cuh takes them."""
    mu = v.mean(-1, keepdims=True, dtype=np.float32)
    var = ((v - mu) ** 2).mean(-1, keepdims=True, dtype=np.float32)
    return (v - mu) / np.sqrt(var + np.float32(eps)) * w + b


def attn_block_x3(x, k, v, wq, bq, wo, bo, lnw, lnb, heads, terms=3):
    """Row 2's f32 body on f32 numpy arrays (wq, bq unscaled): (out, ranges)."""
    b, p, c = x.shape
    l = k.shape[1]
    dh = c // heads
    scale = np.float32(1 / math.sqrt(dh))
    q = (mm3(x.reshape(-1, c), (wq * scale).T, terms) + bq * scale).reshape(b, p, c)
    _, _, ranges, per = core_plan(b, p, l, heads)
    att = np.zeros_like(q)
    for i in range(b):
        for h in range(heads):
            cs = slice(h * dh, (h + 1) * dh)
            att[i, :, cs] = attn_core(q[i, :, cs], k[i, :, cs], v[i, :, cs], ranges, per, terms)
    s = mm3(att.reshape(-1, c), wo.T, terms) + bo + x.reshape(-1, c)
    return ln(s, lnw, lnb).reshape(b, p, c), ranges


def fused_mlp_x3(x, lnw, lnb, w1, b1, w2, b2, activation, pre, residual, terms=3):
    """Row 1's f32 body on f32 numpy arrays: (out, upre)."""
    h = ln(x, lnw, lnb) if pre else x
    upre = mm3(h, w1.T, terms) + b1
    if activation == "relu":
        u = np.maximum(upre, np.float32(0))
    else:  # erf-gelu, as the f32 policy (erff on the card)
        u = torch.nn.functional.gelu(torch.from_numpy(upre)).numpy()
    y = mm3(u, w2.T, terms) + b2
    if residual:
        y = y + x
    return (y if pre else ln(y, lnw, lnb)), upre


def _within(got, want, what, rel=REL):
    """got within rel · max |want| of want (raises AssertionError)."""
    want = np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    lim = rel * np.abs(want).max()
    assert np.isfinite(got).all() and err <= lim, f"{what}: max |Δ| {err:.3e} > {lim:.3e}"


def _attn_inputs(seed, b, p, l, c):
    rs = np.random.RandomState(seed)
    acts = [rs.randn(b, n, c) for n in (p, l, l)]
    params = [rs.randn(c, c) / np.sqrt(c), 0.1 * rs.randn(c), rs.randn(c, c) / np.sqrt(c),
              0.1 * rs.randn(c), 1 + 0.1 * rs.randn(c), 0.1 * rs.randn(c)]
    return [a.astype(np.float32) for a in acts + params]


def _attn_refs(args, heads):
    """(the Pallas kernel in f32, interpret mode; the plain version)."""
    pallas = np.array(jab.fused_attn_block(*map(jnp.asarray, args), heads, interpret=True))
    plain = fused_attn_block_plain(*map(torch.from_numpy, args), heads).numpy()
    return pallas, plain


@pytest.mark.parametrize("b,p,l,c,heads", [
    (2, 40, 300, 128, 2),  # dh 64, 5 ranges of one tile, the last ragged
    (2, 33, 151, 64, 4),   # dh 16, the class count as L: 3 ranges
    (2, 17, 65, 128, 8),   # dh 16 at 8 heads, L one past a tile: 2 ranges
    (1, 40, 257, 64, 2),   # dh 32, one image: 5 ranges, the last one key
])
def test_attn_block_x3_matches_pallas_and_plain(b, p, l, c, heads):
    """Row 2's emulation, across 2 to 5 key ranges, against the Pallas
    kernel (interpret mode) and fused_attn_block_plain in f32."""
    args = _attn_inputs(p + l + c + heads, b, p, l, c)
    got, ranges = attn_block_x3(*args, heads)
    assert ranges >= 2
    pallas, plain = _attn_refs(args, heads)
    _within(got, pallas, "Pallas")
    _within(got, plain, "plain")


def test_attn_block_x3_one_term_control_fails():
    """The control: the same emulation with one TF32 product a product fails
    the rule against the Pallas kernel and the plain version."""
    args = _attn_inputs(5, 2, 40, 300, 128)
    got, _ = attn_block_x3(*args, 2, terms=1)
    pallas, plain = _attn_refs(args, 2)
    for want, what in ((pallas, "Pallas"), (plain, "plain")):
        with pytest.raises(AssertionError):
            _within(got, want, what)


@pytest.mark.parametrize("b,p,l,heads,warps,q_tiles,ranges", [
    (16, 151, 16384, 8, 10, 1, 3),  # PromptFTNv2's prompt decoder: 384 blocks of 86 tiles
    (16, 151, 256, 8, 10, 1, 2),    # PromptFTNv1's, 4 key tiles: 2 ranges of 2
    (16, 4096, 4096, 8, 8, 32, 1),  # FTNDecoderV2's self-attention: query tiles fill the card
    (1, 151, 16384, 8, 10, 1, 32),  # batch 1: 32 ranges of 8 tiles
    (16, 256, 64, 8, 8, 2, 1),      # one key tile: one range
])
def test_core_plan_at_the_main_path_shapes(b, p, l, heads, warps, q_tiles, ranges):
    """CorePlan at the main-path shapes: every query row of a head in one
    block up to 160 rows, 128-row tiles above; as many key ranges of equal
    tile counts as two waves of the SMs want, where the keys allow; no range
    empty."""
    got = core_plan(b, p, l, heads)
    assert got[:3] == (warps, q_tiles, ranges), got
    assert got[3] * (ranges - 1) < -(-l // KEYS) <= got[3] * ranges


def _mlp_inputs(seed, t, c, f):
    rs = np.random.RandomState(seed)
    params = [1 + 0.1 * rs.randn(c), 0.1 * rs.randn(c), rs.randn(f, c) / np.sqrt(c),
              0.1 * rs.randn(f), rs.randn(c, f) / np.sqrt(f), 0.1 * rs.randn(c)]
    return [a.astype(np.float32) for a in [rs.randn(t, c)] + params]


def _mlp_refs(args, activation, pos, residual):
    """(the Pallas kernel's output and saved pre-activation in f32,
    interpret mode; the plain version)."""
    jx, *jw = map(jnp.asarray, args)
    kw = dict(activation=activation, ln_position=pos, residual=residual)
    pallas = np.array(jmlp.fused_mlp(jx, *jw, interpret=True, **kw))
    _, upre = jmlp._fwd_impl(jx, *jw, act=activation, pre=pos == "pre", residual=residual,
                             eps=1e-5, block_tokens=None, interpret=True, save_upre=True)
    plain = fused_mlp_plain(*map(torch.from_numpy, args), **kw).numpy()
    return pallas, np.array(upre), plain


@pytest.mark.parametrize("t,c,activation,pos,residual", [
    (40, 128, "relu", "post", True),   # the decoder layers' form
    (37, 96, "gelu", "pre", True),     # swin stage 1's width
    (33, 64, "gelu", "post", False),
    (29, 128, "relu", "pre", False),
])
def test_fused_mlp_x3_matches_pallas_and_plain(t, c, activation, pos, residual):
    """Row 1's emulation (F = 4C, one 32-wide k-slice more than C) against
    the Pallas kernel (interpret mode), its saved pre-activation against the
    Pallas kernel's, and the output against fused_mlp_plain, in f32."""
    args = _mlp_inputs(t + c + residual, t, c, 4 * c)
    got, upre = fused_mlp_x3(*args, activation, pos == "pre", residual)
    pallas, jupre, plain = _mlp_refs(args, activation, pos, residual)
    _within(got, pallas, "Pallas")
    _within(upre, jupre, "Pallas upre")
    _within(got, plain, "plain")


def test_fused_mlp_x3_one_term_control_fails():
    """The control: one TF32 product a product fails the rule."""
    args = _mlp_inputs(3, 40, 128, 512)
    got, _ = fused_mlp_x3(*args, "relu", False, True, terms=1)
    pallas, _, plain = _mlp_refs(args, "relu", "post", True)
    for want, what in ((pallas, "Pallas"), (plain, "plain")):
        with pytest.raises(AssertionError):
            _within(got, want, what)


def test_tf32_rounds_to_nearest_ties_away():
    """tf32 as cvt.rna rounds: 13 low bits cleared, a half ulp (0x1000)
    rounded away from zero for either sign, below it down, above it up."""
    one = np.float32(1.0).view(np.uint32)
    vals = np.array([one + 0x1000, one + 0xFFF, one + 0x1001, one + 0x2000 + 0x1000],
                    np.uint32).view(np.float32)
    want = np.array([one + 0x2000, one, one + 0x2000, one + 0x4000], np.uint32).view(np.float32)
    np.testing.assert_array_equal(tf32(vals), want)
    np.testing.assert_array_equal(tf32(-vals), -want)
    a = np.random.RandomState(0).randn(1000).astype(np.float32)
    hi, lo = split(a)
    assert not (hi.view(np.uint32) & 0x1FFF).any() and not (lo.view(np.uint32) & 0x1FFF).any()
    assert np.abs(hi + lo - a).max() <= 2.0 ** -21 * np.abs(a).max()


@pytest.mark.parametrize("op", ["fused_mlp", "fused_attn_block", "swin_window_block"])
def test_f32_wrappers_hand_over_a_workspace(monkeypatch, op):
    """The card path of each wrapper in f32, its launch replaced by a
    recorder on CPU tensors: the arguments it hands ctypes match the entry
    point's argtypes, and the f32 body gets a workspace of its size entry's
    floats (lc2_*_workspace_f32)."""
    from lc2is_tpu_torch.ops import attention_block, fused_mlp, swin_window

    calls, sizes = [], []
    monkeypatch.setattr(_build, "launch", lambda name, dev, *a: calls.append((name, a)))
    monkeypatch.setattr(_build, "size", lambda name, *a: sizes.append((name, a)) or 64)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    mod = {"fused_mlp": fused_mlp, "fused_attn_block": attention_block,
           "swin_window_block": swin_window}[op]
    monkeypatch.setattr(mod, "use_kernel", lambda t: True)
    rs = np.random.RandomState(0)
    c = 128
    if op == "fused_mlp":
        x = torch.from_numpy(rs.randn(5, c).astype(np.float32))
        w = [torch.from_numpy(rs.randn(*s).astype(np.float32))
             for s in ((c,), (c,), (4 * c, c), (4 * c,), (c, 4 * c), (c,))]
        with torch.no_grad():
            fused_mlp.fused_mlp(x, *w, activation="relu", ln_position="post")
        want_size = ("lc2_fused_mlp_workspace_f32", (5, c, 4 * c, 0))
    elif op == "swin_window_block":  # a 9 x 8 canvas, padded to 14², 4 heads
        x = torch.from_numpy(rs.randn(2, 9, 8, c).astype(np.float32))
        w = [torch.from_numpy(rs.randn(*s).astype(np.float32))
             for s in ((c,), (c,), (3 * c, c), (3 * c,), (c, c), (c,), (4, 49, 49))]
        with torch.no_grad():
            swin_window.swin_window_block(x, *w, 4, 7, 3)
        want_size = ("lc2_swin_window_workspace_f32", (2, 9, 8, c, 4, 7))
    else:
        x, k, v = (torch.from_numpy(rs.randn(2, n, c).astype(np.float32)) for n in (7, 9, 9))
        w = [torch.from_numpy(rs.randn(*s).astype(np.float32))
             for s in ((c, c), (c,), (c, c), (c,), (c,), (c,))]
        with torch.no_grad():
            attention_block.fused_attn_block(x, k, v, *w, 4)
        want_size = ("lc2_attn_block_fwd_workspace_f32", (2, 7, 9, c, 4))
    (name, args), = calls
    kinds = {_build.ctypes.c_void_p: (int, type(None)), _build.ctypes.c_int: (int,),
             _build.ctypes.c_float: (float,)}
    argtypes = _build.SIGNATURES[name]
    assert len(args) == len(argtypes), name
    for a, t in zip(args, argtypes):
        assert isinstance(a, kinds[t]), (name, a, t)
    assert sizes == [want_size]
    ws = args[11 if op == "fused_attn_block" else 10]  # after the output
    assert isinstance(ws, int) and ws != 0
    assert want_size[0] in _build.SIZE_SIGNATURES
