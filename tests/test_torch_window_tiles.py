"""The arithmetic of the bf16 tensor-core bodies of window attention
(``lc2is_tpu_torch/csrc/window_attention.cu``, TPU row 8) and of the swin
window block's backward (``csrc/swin_window_bwd.cu``, TPU rows 7 and 10),
emulated tile by tile on the CPU and held against lc2is_tpu's Pallas kernels
in interpret mode (``ops.window_attention.window_attention`` and the custom
VJP of ``ops.swin_canvas.swin_canvas_block``, as the JAX package's own tests
run them) and against the port's plain versions, on the same numpy-seeded
inputs.  With no rounding the same emulation stands for the f32 bodies'
algorithm.

Row 8, as the kernel computes it: the keys padded to a multiple of 16 (64
at p = 49) and the padded ones dropped; the logits q·kᵀ accumulated in f32
and multiplied by 1/√dh in f32 (not folded into q), + the f32 bias, −1e30
where the two tokens' region labels differ; e = exp2((s − max) · log2 e);
the row multiplied by one reciprocal of its sum; the normalised
probabilities rounded to bf16 before P·V, which accumulates in f32 and is
rounded.

Rows 7 and 10, the dataflow of ``swin_canvas.py::_canvas_bwd_kernel`` with
1/√dh folded into the q rows of wqkv and bqkv in f32, then rounded (as the
wrapper hands them over): the LN output (two-pass f32 statistics, zero at
HF pad tokens), qkv = LN · wqkvᵀ + bqkv, the gathered output gradient g and
dA = g · wo are bf16; per window and head over a 64-key tile, S = q·kᵀ +
bias − 100 across regions, P the max-subtracted softmax (one reciprocal of
the sum), round(P) the P·V and dV operand, the head outputs rounded,
dS = P∘(dP − rowsum(P∘dP)) in f32 (dbias sums it), round(dS) the dQ and dK
operand, dq, dk, dv rounded; dWo = gᵀ·att, dWqkv = dqkvᵀ·LN in f32, dbo and
dbqkv f32 column sums; dLN = round(dqkv · wqkv); the LayerNorm backward in
f32; the GEMMs sum 32-wide k-slices, as the GEMM's ring does.  Under the
fold, dS is rounded unscaled where the reference rounds dS · (1/√dh): the
emulation shows that this counterpart holds the Pallas backward within the
bf16 gate.

Stated tolerances.  Row 8, f32: 2e-5 absolute and relative against the
Pallas kernel and the plain version (tests/test_torch_window_attention.py's
f32 bound; exp2 of a scaled difference and exp differ in the last bits);
bf16: |Δ| ≤ 5e-2 + 2e-2·|ref|, the card gate of phase 3w.  Rows 7 and 10,
each gradient ‖Δ‖/‖ref‖: f32 ≤ 1e-4, bf16 ≤ 2e-2, the card gates of the
f32 and bf16 backward (one bf16 step in a rounded intermediate moves a
gradient by ~2^-8 relative).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lc2is_tpu.ops.swin_canvas import swin_canvas_block
from lc2is_tpu.ops.window_attention import window_attention as jax_window_attention
from lc2is_tpu_torch.ops.swin_window import fold_q_scale, swin_window_block_plain
from lc2is_tpu_torch.ops.window_attention import NEG, window_attention_plain

LOG2E = 1.4426950408889634
KSLICE = 32  # k-slice of the bf16 GEMM's ring (csrc/gemm_bf16.cuh)
GRAD_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
SWIN_NAMES = ["x", "ln_w", "ln_b", "wqkv", "bqkv", "wo", "bo", "bias"]


def _round(x, dtype):
    """x rounded to the working dtype, kept in f32."""
    return x.to(dtype).float()


def _mm(a, b, kt=KSLICE):
    """a @ b in f32, the k dimension summed in kt-wide slices in order."""
    out = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for k0 in range(0, a.shape[-1], kt):
        out = out + a[..., k0:k0 + kt] @ b[k0:k0 + kt]
    return out


# ---------------------------------------------------------------------------
# row 8: window attention
# ---------------------------------------------------------------------------


def tiled_window_attention(q, k, v, bias, regions, heads, dtype):
    """The bf16 body's arithmetic (identity rounding for f32) on (N, p, C)
    f32 tensors holding dtype values."""
    n, p, c = q.shape
    dh = c // heads
    pk = -(-p // 16) * 16  # the keys a warp's registers hold
    qh, kh, vh = (t.reshape(n, p, heads, dh).transpose(1, 2) for t in (q, k, v))
    s = (qh @ kh.transpose(-1, -2)) * torch.tensor(1.0 / math.sqrt(dh), dtype=torch.float32)
    s = s + bias
    if regions is not None:
        s = s.masked_fill(regions[:, None, :, None] != regions[:, None, None, :], NEG)
    s = F.pad(s, (0, pk - p), value=-math.inf)  # padded keys: dropped
    e = torch.exp2((s - s.amax(-1, keepdim=True)) * LOG2E)
    probs = _round(e * (1.0 / e.sum(-1, keepdim=True)), dtype)
    out = probs @ F.pad(vh, (0, 0, 0, pk - p))  # padded v rows load as zeros
    return _round(out.transpose(1, 2).reshape(n, p, c), dtype)


def _window_inputs(seed, n, p, heads, dh, dtype, regions):
    rs = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rs.randn(n, p, heads * dh).astype(np.float32)).to(dtype).float()
               for _ in range(3))
    bias = torch.from_numpy(0.5 * rs.randn(heads, p, p).astype(np.float32))
    reg = torch.from_numpy(rs.randint(0, 3, size=(n, p)).astype(np.int32)) if regions else None
    return q, k, v, bias, reg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,p,heads,dh,regions", [
    (6, 49, 2, 32, True),    # swin's window of 7 inside one 64-key tile, shifted
    (6, 49, 3, 32, False),
    (4, 16, 2, 16, True),    # a window of 4: one 16-key chunk
    (3, 65, 1, 64, True),    # past the 64-key bound
    (2, 144, 2, 24, False),  # a window of 12, a head width zero-filled to 32
])
def test_tiled_window_attention_matches_pallas_and_plain(dtype, n, p, heads, dh, regions):
    """The row-8 emulation against window_attention (interpret mode) and
    window_attention_plain."""
    tdt = getattr(torch, dtype)
    q, k, v, bias, reg = _window_inputs(n * p + dh, n, p, heads, dh, tdt, regions)
    got = tiled_window_attention(q, k, v, bias, reg, heads, tdt)
    jdt = getattr(jnp, dtype)
    want = np.asarray(jax_window_attention(
        *(jnp.asarray(t.numpy()).astype(jdt) for t in (q, k, v)), jnp.asarray(bias.numpy()),
        None if reg is None else jnp.asarray(reg.numpy()), heads, interpret=True
    ).astype(jnp.float32))
    plain = window_attention_plain(q.to(tdt), k.to(tdt), v.to(tdt), bias, reg, heads)
    assert got.shape == q.shape and torch.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=2e-5, atol=2e-5)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=5e-2)
        np.testing.assert_allclose(got.numpy(), plain.float().numpy(), rtol=2e-2, atol=5e-2)


def test_tiled_window_attention_needs_its_labels():
    """The same emulation without the region labels misses the shifted
    reference by far more than the gate: the control that phase 3w runs on
    the card."""
    q, k, v, bias, reg = _window_inputs(3, 6, 49, 2, 32, torch.bfloat16, True)
    want = window_attention_plain(q.bfloat16(), k.bfloat16(), v.bfloat16(), bias, reg, 2).float()
    got = tiled_window_attention(q, k, v, bias, None, 2, torch.bfloat16)
    assert not bool(((got - want).abs() <= 5e-2 + 2e-2 * want.abs()).all())


# ---------------------------------------------------------------------------
# rows 7 and 10: the swin window block's backward
# ---------------------------------------------------------------------------


def _labels(hp, wp, win, shift):
    def region(n):
        i = torch.arange(n)
        return (i >= n - win).long() + (i >= n - shift).long()

    return region(hp)[:, None] * 3 + region(wp)[None, :]


def tiled_swin_block_bwd(x, g, lnw, lnb, wqkv, bqkv, wo, bias, heads, win, shift, dtype,
                         residual=True, eps=1e-5):
    """Gradients of swin_window_block with respect to (x, ln_w, ln_b, wqkv,
    bqkv, wo, bo, bias) as the bf16 body computes them (identity rounding for
    f32), on f32 tensors holding dtype values (x, g) and f32 parameters;
    wqkv and bqkv unscaled, as swin_window_block takes them."""
    b, h, w, c = x.shape
    dh, n = c // heads, win * win
    scale = 1.0 / math.sqrt(dh)
    wq_s, bq_s = (_round(t, dtype) for t in fold_q_scale(wqkv, bqkv, heads))
    lnw_r, lnb_r, wo_r = (_round(t, dtype) for t in (lnw, lnb, wo))
    hp, wp = -(-h // win) * win, -(-w // win) * win
    nwh, nww = hp // win, wp // win

    def to_windows(t):  # (B, H, W, C) canvas -> (M, C) window order; pads zero
        t = F.pad(t, (0, 0, 0, wp - w, 0, hp - h))
        if shift:
            t = torch.roll(t, (-shift, -shift), (1, 2))
        return t.reshape(b, nwh, win, nww, win, -1).transpose(2, 3).reshape(b * nwh * nww * n, -1)

    def to_canvas(t):  # the adjoint: (M, C) -> (B, H, W, C), pads dropped
        t = t.reshape(b, nwh, nww, win, win, -1).transpose(2, 3).reshape(b, hp, wp, -1)
        if shift:
            t = torch.roll(t, (shift, shift), (1, 2))
        return t[:, :h, :w]

    # 1. LayerNorm (two-pass f32 statistics) rounded; the gathered gradient
    mu = x.mean(-1, keepdim=True)
    rs = torch.rsqrt(((x - mu) ** 2).mean(-1, keepdim=True) + eps)
    xh = (x - mu) * rs
    hn = to_windows(_round(xh * lnw_r + lnb_r, dtype))
    gw = to_windows(g)
    # 2. qkv and dA on the GEMM
    qkv = _round(_mm(hn, wq_s.t()) + bq_s, dtype)
    d_att = _round(_mm(gw, wo_r), dtype)

    def heads_of(t):
        return t.reshape(-1, n, heads, dh).transpose(1, 2)

    q, k, v = (heads_of(t) for t in qkv.split(c, -1))
    da = heads_of(d_att)
    # 3. the attention core over a 64-key tile (keys past n dropped)
    s = q @ k.transpose(-1, -2) + bias
    if shift:
        lab = _labels(hp, wp, win, shift).reshape(nwh, win, nww, win).transpose(1, 2)
        lab = lab.reshape(-1, n).repeat(b, 1)
        s = s - 100.0 * (lab[:, None, :, None] != lab[:, None, None, :]).float()
    e = torch.exp2((s - s.amax(-1, keepdim=True)) * LOG2E)
    p = e * (1.0 / e.sum(-1, keepdim=True))
    pb = _round(p, dtype)
    att = _round(pb @ v, dtype)
    dp = da @ v.transpose(-1, -2)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    dbias = ds.sum(0)
    dsb = _round(ds, dtype)
    dq, dk = _round(dsb @ k, dtype), _round(dsb.transpose(-1, -2) @ q, dtype)
    dv = _round(pb.transpose(-1, -2) @ da, dtype)

    def merged(t):
        return t.transpose(1, 2).reshape(-1, c)

    att, dqkv = merged(att), torch.cat([merged(dq), merged(dk), merged(dv)], -1)
    # 4. weight and bias gradients in f32
    dwo = gw.t() @ att
    dbo = gw.sum(0)
    dwq_s = dqkv.t() @ hn
    dbq_s = dqkv.sum(0)
    # 5. dLN, rounded; the LayerNorm backward in f32
    dy = to_canvas(_round(_mm(dqkv, wq_s), dtype))
    dxh = dy * lnw_r
    dx = rs * (dxh - dxh.mean(-1, keepdim=True) - xh * (dxh * xh).mean(-1, keepdim=True))
    if residual:
        dx = dx + g
    dlnw, dlnb = (dy * xh).sum((0, 1, 2)), dy.sum((0, 1, 2))
    # back through the fold (autograd of fold_q_scale: the q rows times 1/√dh)
    dwqkv = torch.cat([dwq_s[:c] * scale, dwq_s[c:]])
    dbqkv = torch.cat([dbq_s[:c] * scale, dbq_s[c:]])
    return [_round(dx, dtype), dlnw, dlnb, dwqkv, dbqkv, dwo, dbo, dbias]


def _swin_args(seed, b, h, w, c, heads, win, dtype):
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(b, h, w, c).astype(np.float32)).to(dtype).float()
    g = torch.from_numpy(rs.randn(b, h, w, c).astype(np.float32)).to(dtype).float()
    params = [1 + 0.1 * rs.randn(c), 0.5 * rs.randn(c), rs.randn(3 * c, c) / np.sqrt(c),
              0.1 * rs.randn(3 * c), rs.randn(c, c) / np.sqrt(c), 0.1 * rs.randn(c),
              0.1 * rs.randn(heads, win * win, win * win)]
    return x, g, [torch.from_numpy(a.astype(np.float32)) for a in params]


def _rel(got, want):
    d = (got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30)
    return d.item()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,w,c,heads,win,shift,residual", [
    (2, 18, 18, 64, 2, 7, 3, False),  # dh 32, HF pad 18 -> 21, shifted: the drop-path branch
    (1, 14, 21, 32, 2, 7, 0, True),   # dh 16, one side padded, the residual
    (1, 12, 12, 64, 1, 4, 2, True),   # dh 64, window 4
])
def test_tiled_swin_block_bwd_matches_pallas_and_plain(dtype, b, h, w, c, heads, win, shift,
                                                       residual):
    """The rows-7/10 emulation against jax.vjp of swin_canvas_block
    (``_canvas_bwd_kernel`` in interpret mode) and autograd through
    swin_window_block_plain, every gradient."""
    tdt = getattr(torch, dtype)
    x, g, params = _swin_args(b * h * w + c + shift, b, h, w, c, heads, win, tdt)
    lnw, lnb, wqkv, bqkv, wo, bo, bias = params
    got = tiled_swin_block_bwd(x, g, lnw, lnb, wqkv, bqkv, wo, bias, heads, win, shift, tdt,
                               residual)

    jdt = getattr(jnp, dtype)
    jargs = [jnp.asarray(x.numpy()).astype(jdt)] + [jnp.asarray(t.numpy()) for t in params]
    _, vjp = jax.vjp(lambda *a: swin_canvas_block(*a, heads, win, shift, interpret=True,
                                                  residual=residual), *jargs)
    want_jax = [torch.from_numpy(np.array(t.astype(jnp.float32)))
                for t in vjp(jnp.asarray(g.numpy()).astype(jdt))]

    leaves = [x.to(tdt).requires_grad_()] + [t.clone().requires_grad_() for t in params]
    out = swin_window_block_plain(*leaves, heads, win, shift, residual=residual)
    want_plain = torch.autograd.grad(out, leaves, g.to(tdt))

    for name, a, wj, wp in zip(SWIN_NAMES, got, want_jax, want_plain):
        assert a.shape == wj.shape == wp.shape and torch.isfinite(a).all(), name
        assert _rel(a, wj) <= GRAD_REL[tdt], (name, "pallas", _rel(a, wj))
        assert _rel(a, wp) <= GRAD_REL[tdt], (name, "plain", _rel(a, wp))
