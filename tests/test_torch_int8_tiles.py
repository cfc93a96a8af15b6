"""The arithmetic of the bf16 tensor-core bodies of the int8 serving row,
emulated step by step on the CPU in the kernels' op order and held against
lc2is_tpu's Pallas kernels in interpret mode (as the JAX package's own tests
run them) and against the port's plain versions, on the same numpy-seeded
inputs.  The same emulation with no rounding, and erf-gelu, stands for the
algorithm in f32.

Both bodies run on the ``mma.sync`` s8 GEMM of
``lc2is_tpu_torch/csrc/gemm_s8.cuh``: acc = A · Bᵀ summed exactly in s32 over
64-byte k-slices of two 32-byte mma steps, then the epilogue v = (acc ·
s_row) · s_col + bias, each product and the sum rounded in f32; the row pass
gives a row's codes round-half-even(v / s) with s = max(max|v| / 127, 1e-12),
and the weight pass a weight's per output channel by the same arithmetic
(``ops/quant.py::quantize_weight``, which the emulation runs).

Row 17, ``fused_mlp_q`` (``csrc/fused_mlp_q.cu``): the row pass over LN(x)
(f32 statistics and f32 weights, not rounded; pre) or x (post); the first
GEMM with epilogue act(v) and the hidden row max |u| taken over all of F
(the kernel's atomicMax over 128-column tiles, order-free); the same GEMM
again, the hidden codes with the scale of that max; the second GEMM, v + x
(pre: rounded out; post: f32 s, then LN with f32 weights, rounded).

Row 2q, ``fused_attn_block_q`` (``csrc/attention_block.cu``): the row pass
over x; q = round(v) with 1/√dh folded into wq and bq (bq rounded to the
dtype); the attention core of row 2 (64-key tiles, p rounded per tile, O
scaled by 1/l and rounded); the row pass over the head outputs; s = v + x in
f32; LN with the dtype's weights, rounded.

Exact checks: the tiled s32 accumulators equal ``a.int() @ b.int().T``; the
recomputed hidden codes equal the codes of a stored f32 hidden (route A)
bit for bit; the kernels' division-free codes (a multiply by the correctly
rounded reciprocal, the division only near a half-integer) equal
round-half-even(v / s).  A control that must fail: row 17 with the hidden row max taken
per 128-column tile instead of over all of F.

Stated tolerances, ``chip_smoke.py``'s int8 rule: bf16 |Δ| ≤ 2e-2 ·
max|ref|; f32 every element within that and at most a 1e-4 share of them
above 1e-3 · max|ref| (the two sides' LayerNorm and softmax differ in the
last bits, so a code may land on the other side of a .5 boundary).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lc2is_tpu.ops import attention_block as jab
from lc2is_tpu.ops import quant as jquant
from lc2is_tpu_torch.ops.attention_block import _q_weights, fused_attn_block_q_plain
from lc2is_tpu_torch.ops.fused_mlp import _act, _act_name
from lc2is_tpu_torch.ops.quant import fused_mlp_q_plain, quant_act, quantize_weight
from test_torch_block_tiles import LOG2E, TILE, _merge, _round, _split
from test_torch_fwd_tiles import _ln  # two-pass f32 statistics, as the row and LN passes

INT8_REL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}
INT8_F32_FLIP_SHARE = 1e-4
KSLICE = 64  # bytes of a k-slice of the s8 GEMM's ring
KSTEP = 32  # k of one mma.sync m16n8k32
NTILE = 128  # columns of a GEMM block tile


def _int8_close(got, want, dtype, what):
    """The int8 rule of chip_smoke.py against the reference ``want``."""
    want = torch.as_tensor(np.asarray(want, np.float32))
    assert torch.isfinite(got).all(), what
    d = (got.float() - want).abs()
    top = want.abs().max().item()
    assert d.max().item() <= INT8_REL[torch.bfloat16] * top, (what, d.max().item(), top)
    if dtype == torch.float32:
        over = int((d > INT8_REL[torch.float32] * top).sum())
        assert over <= INT8_F32_FLIP_SHARE * d.numel(), (what, over, d.numel())


def s8_gemm(a, b):
    """acc = a · bᵀ of int8 a (M, K) and b (N, K), s32, summed as the GEMM's
    ring does: 64-byte k-slices in order, two 32-byte mma steps each."""
    acc = torch.zeros(a.shape[0], b.shape[0], dtype=torch.int32)
    for k0 in range(0, a.shape[1], KSLICE):
        for kk in range(k0, min(k0 + KSLICE, a.shape[1]), KSTEP):
            acc += a[:, kk:kk + KSTEP].int() @ b[:, kk:kk + KSTEP].int().T
    return acc


def row_pass(v, lnw=None, lnb=None, eps=1e-5):
    """The row pass: (codes int8, scales (M,)) of f32 rows v, LN'd first with
    f32 weights when lnw is given."""
    if lnw is not None:
        v = _ln(v, lnw, lnb, eps)
    s = (v.abs().amax(-1) / 127.0).clamp_min(1e-12)
    return torch.round(v / s[:, None]).to(torch.int8), s


def dequant(acc, s_row, s_col, bias):
    """The epilogue's v: (acc · s_row) · s_col + bias, each op rounded in f32."""
    return (acc.float() * s_row[:, None]) * s_col.reshape(1, -1) + bias


def codes_by_reciprocal(v, s):
    """The kernels' codes (``gemm_s8.cuh::quant_code_rcp``): q = v · rs with
    rs = 1/s correctly rounded, rounded half to even; where q lies within
    1e-4 of a half-integer, the IEEE quotient decides."""
    rs = 1.0 / s
    q = v * rs
    r = torch.round(q)
    near = (q - r).abs() > 0.4999
    return torch.where(near, torch.round(v / s), r)


def test_reciprocal_codes_equal_division_codes():
    """The kernels' division-free codes equal round-half-even(v / s) bit for
    bit: on rows of every magnitude, on exact zeros (the relu hidden), and on
    values one f32 step either side of every half-integer code boundary,
    where the reciprocal alone, the control, rounds some the other way."""
    rs = np.random.RandomState(0)
    v = torch.from_numpy((rs.randn(4096, 256) * 10.0 ** rs.uniform(-6, 3, (4096, 1)))
                         .astype(np.float32))
    v[::7] = torch.relu(v[::7])
    s = (v.abs().amax(-1, keepdim=True) / 127.0).clamp_min(1e-12)
    ties = (torch.arange(-127, 127, dtype=torch.float32) + 0.5)[None] * s[:64]
    near = torch.cat([ties, torch.nextafter(ties, ties + 1), torch.nextafter(ties, ties - 1)], 1)
    for vals, scale in ((v, s), (near, s[:64])):
        want = torch.round(vals / scale)
        assert torch.equal(codes_by_reciprocal(vals, scale), want)
    # the control: the reciprocal without its fallback misses codes at the boundaries
    assert not torch.equal(torch.round(near * (1.0 / s[:64])), torch.round(near / s[:64]))


# ---------------------------------------------------------------------------
# row 17: the int8 feed-forward
# ---------------------------------------------------------------------------


def tiled_fused_mlp_q(x, lnw, lnb, w1, b1, w2, b2, activation, pre, residual, dtype, eps=1e-5,
                      tile_max=False):
    """Row 17's bf16 body (identity rounding for f32) on an f32 (T, C) x
    holding dtype values and f32 weights: (out, hidden codes, stored f32
    hidden).  ``tile_max``: the control, each 128-column tile of the hidden
    quantised with its own max (the output pass still dequantises with the
    row's)."""
    act = _act_name(activation, dtype)
    w1q, w1s = quantize_weight(w1)
    w2q, w2s = quantize_weight(w2)
    xq, sx = row_pass(x, lnw, lnb, eps) if pre else row_pass(x)

    def hidden():  # the first GEMM's epilogue, kActMax and kActCode alike
        return _act(act, dequant(s8_gemm(xq, w1q), sx, w1s, b1))

    u = hidden()
    f = u.shape[1]
    tile_maxes = [u[:, f0:f0 + NTILE].abs().amax(1) for f0 in range(0, f, NTILE)]
    hmax = torch.stack(tile_maxes).amax(0)  # atomicMax over the tiles: any order
    su = (hmax / 127.0).clamp_min(1e-12)
    u2 = hidden()
    if tile_max:
        scales = torch.cat([((m / 127.0).clamp_min(1e-12))[:, None].expand(-1, min(NTILE, f - f0))
                            for m, f0 in zip(tile_maxes, range(0, f, NTILE))], 1)
    else:
        scales = su[:, None]
    hq = torch.round(u2 / scales).to(torch.int8)
    y = dequant(s8_gemm(hq, w2q), su, w2s, b2)
    if residual:
        y = y + x
    out = y if pre else _ln(y, lnw, lnb, eps)
    return _round(out, dtype), hq, u


def _mlp_inputs(seed, t, c, f, dtype):
    """numpy-seeded x (rounded through dtype) and f32 (ln_w, ln_b, w1, b1, w2, b2)."""
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(t, c).astype(np.float32)).to(dtype).float().numpy()
    params = [1 + 0.1 * rs.randn(c), 0.1 * rs.randn(c), rs.randn(f, c) / np.sqrt(c),
              0.1 * rs.randn(f), rs.randn(c, f) / np.sqrt(f), 0.1 * rs.randn(c)]
    return [x] + [a.astype(np.float32) for a in params]


def _pallas_mlp_q(args, dtype, **kw):
    jx = jnp.asarray(args[0]).astype(getattr(jnp, str(dtype).split(".")[-1]))
    out = jquant.fused_mlp_q(jx, *(jnp.asarray(a) for a in args[1:]), interpret=True, **kw)
    return np.array(out.astype(jnp.float32))


MLP_CASES = [
    (200, 96, 192, "gelu", "pre", True),   # swin's form; 200 tokens: no multiple of 128
    (77, 128, 192, "gelu", "pre", False),
    (130, 128, 192, "relu", "post", True),  # the decoder layers' form
    (65, 96, 192, "relu", "post", False),
    (129, 96, 384, "relu", "pre", True),
    (191, 128, 512, "gelu", "post", True),
    (63, 64, 192, "relu", "pre", True),     # C 64: K one 64-byte slice
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,c,f,activation,pos,residual", MLP_CASES)
def test_tiled_fused_mlp_q_matches_pallas_and_plain(dtype, t, c, f, activation, pos, residual):
    """Row 17's emulation against the Pallas int8 kernel (interpret mode)
    and fused_mlp_q_plain on the same inputs."""
    tdt = getattr(torch, dtype)
    args = _mlp_inputs(t + c + f + residual, t, c, f, tdt)
    kw = dict(activation=activation, ln_position=pos, residual=residual)
    got, _, _ = tiled_fused_mlp_q(*(torch.from_numpy(a) for a in args), activation, pos == "pre",
                                  residual, tdt)
    _int8_close(got, _pallas_mlp_q(args, tdt, **kw), tdt, "Pallas")
    plain = fused_mlp_q_plain(torch.from_numpy(args[0]).to(tdt),
                              *(torch.from_numpy(a) for a in args[1:]), **kw)
    _int8_close(got, plain.float().numpy(), tdt, "plain")


@pytest.mark.parametrize("t,c,f,activation,pos", [(200, 96, 192, "gelu", "pre"),
                                                  (130, 128, 192, "relu", "post"),
                                                  (191, 128, 512, "gelu", "post")])
def test_recomputed_hidden_codes_equal_stored_hidden_codes(t, c, f, activation, pos):
    """Route B (the max pass, then the codes pass recomputing the hidden)
    gives the codes of route A (an f32 hidden stored, then quantised per
    row) bit for bit, and the emulated s32 accumulators equal the exact
    int32 product."""
    args = [torch.from_numpy(a) for a in _mlp_inputs(t * c + f, t, c, f, torch.bfloat16)]
    _, hq, u = tiled_fused_mlp_q(*args, activation, pos == "pre", True, torch.bfloat16)
    stored, _ = quant_act(u)
    assert torch.equal(hq, stored)
    xq, _ = row_pass(args[0], args[1], args[2])
    w1q, _ = quantize_weight(args[3])
    assert torch.equal(s8_gemm(xq, w1q), xq.int() @ w1q.int().T)
    w2q, _ = quantize_weight(args[5])
    assert torch.equal(s8_gemm(hq, w2q), hq.int() @ w2q.int().T)


@pytest.mark.parametrize("pos,activation", [("pre", "gelu"), ("post", "relu")])
def test_tiled_fused_mlp_q_control_tile_max_fails(pos, activation):
    """The control that must fail: the hidden quantised with each 128-column
    tile's own max instead of the row's over all of F (a kernel that streams
    F tile by tile) is outside the bf16 int8 rule of the Pallas kernel's
    output, while the emulation as the kernels run it is inside."""
    tdt = torch.bfloat16
    args = _mlp_inputs(5, 150, 128, 384, tdt)
    kw = dict(activation=activation, ln_position=pos, residual=True)
    want = _pallas_mlp_q(args, tdt, **kw)
    t = [torch.from_numpy(a) for a in args]
    good, _, _ = tiled_fused_mlp_q(*t, activation, pos == "pre", True, tdt)
    _int8_close(good, want, tdt, "Pallas")
    bad, _, _ = tiled_fused_mlp_q(*t, activation, pos == "pre", True, tdt, tile_max=True)
    with pytest.raises(AssertionError):
        _int8_close(bad, want, tdt, "Pallas")


# ---------------------------------------------------------------------------
# row 2q: the int8 decoder attention block
# ---------------------------------------------------------------------------


def tiled_attn_block_q(x, k, v, wq, bq, wo, bo, lnw, lnb, heads, dtype, eps=1e-5):
    """Row 2q's bf16 body (identity rounding for f32) on f32 tensors holding
    dtype activations and f32 weights (wq, bq unscaled)."""
    b, p, c = x.shape
    wqq, wqs, bq_s, woq, wos = _q_weights(wq, bq, wo, heads)
    rows = x.reshape(-1, c)
    xq, sx = row_pass(rows)
    q = _round(dequant(s8_gemm(xq, wqq), sx, wqs, _round(bq_s, dtype)), dtype).reshape(b, p, c)
    qh, kh, vh = (_split(t, heads) for t in (q, k, v))
    m = torch.full((b, heads, p), -torch.inf)
    l = torch.zeros(b, heads, p)
    o = torch.zeros(b, heads, p, c // heads)
    for k0 in range(0, k.shape[1], TILE):  # attn_fwd_mma: 64-key tiles, p rounded per tile
        s = qh @ kh[:, :, k0:k0 + TILE].transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(-1) * LOG2E)
        alpha = torch.exp2(m - m_new)
        pt = torch.exp2(s * LOG2E - m_new[..., None])
        l = l * alpha + pt.sum(-1)
        o = o * alpha[..., None] + _round(pt, dtype) @ vh[:, :, k0:k0 + TILE]
        m = m_new
    att = _round(_merge(o * (1.0 / l)[..., None]), dtype).reshape(-1, c)
    aq, sa = row_pass(att)
    s = dequant(s8_gemm(aq, woq), sa, wos, _round(bo, dtype)) + rows
    out = _ln(s, _round(lnw, dtype), _round(lnb, dtype), eps)
    return _round(out, dtype).reshape(b, p, c)


def _attn_q_inputs(seed, b, p, l, c, dtype):
    """numpy-seeded (x, k, v, wq, bq, wo, bo, ln_w, ln_b), f32 numpy, the
    activations rounded through dtype."""
    rs = np.random.RandomState(seed)
    acts = [torch.from_numpy(rs.randn(b, n, c).astype(np.float32)).to(dtype).float().numpy()
            for n in (p, l, l)]
    params = [rs.randn(c, c) / np.sqrt(c), 0.1 * rs.randn(c), rs.randn(c, c) / np.sqrt(c),
              0.1 * rs.randn(c), 1 + 0.1 * rs.randn(c), 0.1 * rs.randn(c)]
    return acts + [a.astype(np.float32) for a in params]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p,l,c,heads", [
    (65, 151, 64, 4),   # dh 16, ragged P, the class count as L
    (130, 7, 64, 2),    # dh 32, P past a 128-row GEMM tile, one ragged key tile
    (63, 1, 128, 2),    # dh 64, one key
    (129, 65, 128, 4),  # dh 32, L one past a key tile
    (100, 64, 96, 3),   # C 96, dh 32, L one whole key tile
])
def test_tiled_attn_block_q_matches_pallas_and_plain(dtype, p, l, c, heads):
    """Row 2q's emulation against the Pallas kernel's int8 branch
    (interpret mode) and fused_attn_block_q_plain on the same inputs."""
    tdt = getattr(torch, dtype)
    args = _attn_q_inputs(3 * p + l + c + heads, 2, p, l, c, tdt)
    got = tiled_attn_block_q(*(torch.from_numpy(a) for a in args), heads, tdt)
    jdt = getattr(jnp, dtype)
    arrs = [jnp.asarray(a).astype(jdt) if i < 3 else jnp.asarray(a) for i, a in enumerate(args)]
    want = jab.fused_attn_block(*arrs, heads, interpret=True, quant=True)
    _int8_close(got, np.array(want.astype(jnp.float32)), tdt, "Pallas")
    t = [torch.from_numpy(a).to(tdt) if i < 3 else torch.from_numpy(a)
         for i, a in enumerate(args)]
    _int8_close(got, fused_attn_block_q_plain(*t, heads).float().numpy(), tdt, "plain")


@pytest.mark.parametrize("c,heads", [(64, 4), (128, 2)])
def test_tiled_attn_block_q_exact_products(c, heads):
    """The emulated s32 accumulators of both projections equal the exact
    int32 products (the GEMM's k-slice order cannot change an s32 sum)."""
    args = [torch.from_numpy(a) for a in _attn_q_inputs(c, 2, 70, 9, c, torch.bfloat16)]
    wqq, _, _, woq, _ = _q_weights(args[3], args[4], args[5], heads)
    xq, _ = row_pass(args[0].reshape(-1, c))
    for w in (wqq, woq):
        assert torch.equal(s8_gemm(xq, w), xq.int() @ w.int().T)
