"""The arithmetic of the bf16 tensor-core bodies of the decoder attention
backward (``lc2is_tpu_torch/csrc/attention_block_bwd.cu``, TPU row 3, whose
forward recompute, ``csrc/attn_block_fwd.cuh``, is row 2's forward) and of
the swin window block (``csrc/swin_window.cu``, TPU row 6), emulated tile by
tile on the CPU and held against lc2is_tpu's Pallas kernels in interpret mode
(the custom VJP of ``ops.attention_block.fused_attn_block`` and
``ops.swin_canvas.swin_canvas_block``, as the JAX package's own tests run
them) and against the port's plain versions, on the same numpy-seeded
inputs.  The same emulation with no rounding stands for the f32 bodies'
algorithm.

Row 3, as the kernel computes it (1/√dh folded into wq and bq in f32, then
rounded to the working dtype, as the wrapper hands them over):
q = round(x · wqᵀ + bq); the recompute over 64-key tiles with the running
max in log2 units, p rounded per tile before P · V while l sums the
unrounded p, O = round(acc / l), lse = m · ln 2 + log l; s = O · woᵀ + bo + x
and the post-LN backward in f32 (ds; dln_w, dln_b, dbo summed from it);
dWo = round(ds)ᵀ · O; dO = round(round(ds) · wo); delta = Σ dO · O a head;
p = exp2(s · log2 e − lse · log2 e) over all keys, the score gradient
p · (dO · vᵀ − delta) rounded before each product; dq summed over 64-key
tiles, dk and dv over 64-query tiles; dbq = Σ dq unrounded; dWq =
round(dq)ᵀ · x; dx = round(round(dq) · wq + ds).  The C x C products sum
32-wide k-slices in f32, as the GEMM's ring does.  (An exactly-zero
reference gradient, dk at L = 1, is held to an RMS of 1e-5 instead.)

Row 6: LayerNorm with two-pass f32 statistics, rounded, zero at HF pad
tokens (after the LN); qkv = round(LN · wqkvᵀ + bqkv) with 1/√dh folded into
the q rows; per window and head, S = q · kᵀ + bias, −100 where the shift
regions differ, e = exp2((S − max) · log2 e) unnormalised, O = round(e) · v
scaled by 1 / Σ e (the TPU canvas kernel's order, swin_canvas.py:394-398)
and rounded; out = round(O · woᵀ + bo [+ x]), cropped; the products sum
64-wide k-slices (32 where C is no multiple of 64), as the weight ring.

Stated tolerances.  f32: 2e-4 absolute and relative for the forward
(tests/test_swin_canvas.py:47-48; the sums run in other orders and exp2 of a
folded product differs from exp in the last bits) and ‖Δ‖/‖ref‖ ≤ 1e-4 for
each gradient (the card gate of the f32 backward).  bf16: each gradient
‖Δ‖/‖ref‖ ≤ 2e-2, the card gate of the bf16 backward (one bf16 step in a
rounded intermediate moves a gradient by ~2^-8 relative); the swin block
|Δ| ≤ 5e-2 + 2e-2·|ref| against the plain version (the card gate of phase 3)
and ≤ 0.12 absolute, mean ≤ 0.02, against the Pallas kernel, whose bf16
LayerNorm normalises in bf16 and rounds three times
(tests/test_swin_canvas.py:131-134).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lc2is_tpu.ops import attention_block as jab
from lc2is_tpu.ops.swin_canvas import swin_canvas_block
from lc2is_tpu_torch.ops.attention_block import fold_q_scale, fused_attn_block_plain
from lc2is_tpu_torch.ops.swin_window import fold_q_scale as fold_qkv_scale
from lc2is_tpu_torch.ops.swin_window import swin_window_block_plain

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
TILE = 64  # key tile of the recompute and dq, query tile of dk / dv
KSLICE = 32  # k-slice of the decoder backward's GEMM ring
F32_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _round(x, dtype):
    """x rounded to the working dtype, kept in f32."""
    return x.to(dtype).float()


def _mm(a, b, kt=KSLICE):
    """a @ b in f32, the k dimension summed in kt-wide slices in order."""
    out = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for k0 in range(0, a.shape[-1], kt):
        out = out + a[..., k0:k0 + kt] @ b[k0:k0 + kt]
    return out


def _grad_close(got, want, rel, name):
    """‖got − want‖ ≤ rel·‖want‖ + an RMS of 1e-5: the floor holds a
    gradient that is exactly 0 in the reference (dk at L = 1, where the
    softmax is constant) to f32 noise."""
    want = torch.as_tensor(np.asarray(want, np.float32))
    err = (got.float() - want).norm().item()
    assert err <= rel * want.norm().item() + 1e-5 * math.sqrt(want.numel()), (name, err)


# ---------------------------------------------------------------------------
# row 3: the decoder attention block's backward
# ---------------------------------------------------------------------------


def _split(t, heads):  # (B, n, C) -> (B, H, n, dh)
    return t.reshape(t.shape[0], t.shape[1], heads, t.shape[2] // heads).transpose(1, 2)


def _merge(t):  # (B, H, n, dh) -> (B, n, C)
    return t.transpose(1, 2).reshape(t.shape[0], t.shape[2], -1)


def tiled_attn_block_fwd(x, k, v, wq, bq, wo, bo, heads, dtype):
    """The forward of the bf16 body that row 2 runs and row 3 recomputes
    (``csrc/attn_block_fwd.cuh``), identity rounding for f32: (q, att, lse,
    s), s the f32 pre-LN sum.  x (B, P, C), k, v (B, L, C): f32 holding dtype
    values; weights f32 (wq, bq unscaled)."""
    b, p, c = x.shape
    dh = c // heads
    wq_s, bq_s = (_round(t, dtype) for t in fold_q_scale(wq, bq, heads))
    wo, bo = (_round(t, dtype) for t in (wo, bo))
    q = _round(_mm(x, wq_s.t()) + bq_s, dtype)
    qh, kh, vh = (_split(t, heads) for t in (q, k, v))
    # online softmax over 64-key tiles
    m = torch.full((b, heads, p), -math.inf)
    l = torch.zeros(b, heads, p)
    o = torch.zeros(b, heads, p, dh)
    for k0 in range(0, k.shape[1], TILE):
        s = qh @ kh[:, :, k0:k0 + TILE].transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(-1) * LOG2E)
        alpha = torch.exp2(m - m_new)
        pt = torch.exp2(s * LOG2E - m_new[..., None])
        l = l * alpha + pt.sum(-1)
        o = o * alpha[..., None] + _round(pt, dtype) @ vh[:, :, k0:k0 + TILE]
        m = m_new
    att = _round(_merge(o * (1.0 / l)[..., None]), dtype)
    lse = m * LN2 + torch.log(l)
    return q, att, lse, _mm(att, wo.t()) + bo + x


def tiled_attn_block_bwd(x, k, v, g, wq, bq, wo, bo, lnw, heads, dtype, eps=1e-5):
    """The bf16 body's arithmetic (identity rounding for f32).  x, g (B, P,
    C), k, v (B, L, C): f32 holding dtype values; weights f32 (wq, bq
    unscaled).  Returns (dx, dk, dv, dwq_s, dbq_s, dwo, dbo, dlnw, dlnb), the
    q gradients with respect to the folded wq_s, bq_s."""
    b, p, c = x.shape
    # the recompute, then s and the post-LN backward in f32
    q, att, lse, sf = tiled_attn_block_fwd(x, k, v, wq, bq, wo, bo, heads, dtype)
    wq_s = _round(fold_q_scale(wq, bq, heads)[0], dtype)
    wo, lnw = _round(wo, dtype), _round(lnw, dtype)
    qh, kh, vh = (_split(t, heads) for t in (q, k, v))
    mu = sf.mean(-1, keepdim=True)
    rs = torch.rsqrt(((sf - mu) ** 2).mean(-1, keepdim=True) + eps)
    sh = (sf - mu) * rs
    dsh = g * lnw
    ds = rs * (dsh - dsh.mean(-1, keepdim=True) - sh * (dsh * sh).mean(-1, keepdim=True))
    dlnw, dlnb, dbo = (g * sh).sum((0, 1)), g.sum((0, 1)), ds.sum((0, 1))
    dsb = _round(ds, dtype)
    dwo = _mm(dsb.reshape(-1, c).t(), att.reshape(-1, c))
    datt = _round(_mm(dsb, wo), dtype)
    dah = _split(datt, heads)
    delta = (dah * _split(att, heads)).sum(-1)
    # score gradients from the lse over all keys, rounded before each product
    pf = torch.exp2((qh @ kh.transpose(-1, -2)) * LOG2E - (lse * LOG2E)[..., None])
    dl = _round(pf * (dah @ vh.transpose(-1, -2) - delta[..., None]), dtype)
    pr = _round(pf, dtype)
    dq = sum(dl[..., k0:k0 + TILE] @ kh[:, :, k0:k0 + TILE] for k0 in range(0, k.shape[1], TILE))
    dk = sum(dl[:, :, q0:q0 + TILE].transpose(-1, -2) @ qh[:, :, q0:q0 + TILE]
             for q0 in range(0, p, TILE))
    dv = sum(pr[:, :, q0:q0 + TILE].transpose(-1, -2) @ dah[:, :, q0:q0 + TILE]
             for q0 in range(0, p, TILE))
    dq, dk, dv = _merge(dq), _merge(dk), _merge(dv)
    dbq = dq.sum((0, 1))
    dqb = _round(dq, dtype)
    dwq = _mm(dqb.reshape(-1, c).t(), x.reshape(-1, c))
    dx = _round(_mm(dqb, wq_s) + ds, dtype)
    return dx, dk, dv, dwq, dbq, dwo, dbo, dlnw, dlnb


def _attn_inputs(seed, b, p, l, c, dtype):
    """numpy-seeded (x, k, v, wq, bq, wo, bo, ln_w, ln_b) and g, f32 numpy,
    the activations and g rounded through dtype."""
    rs = np.random.RandomState(seed)
    acts = [rs.randn(b, n, c).astype(np.float32) for n in (p, l, l)]
    params = [rs.randn(c, c) / np.sqrt(c), 0.1 * rs.randn(c), rs.randn(c, c) / np.sqrt(c),
              0.1 * rs.randn(c), 1 + 0.1 * rs.randn(c), 0.1 * rs.randn(c)]
    g = rs.randn(b, p, c).astype(np.float32)
    rnd = [torch.from_numpy(a).to(dtype).float().numpy() for a in acts + [g]]
    return rnd[:3] + [a.astype(np.float32) for a in params], rnd[3]


def _pallas_attn_grads(args, g, heads, jdt):
    """Gradients of the Pallas block (interpret mode) through its custom VJP:
    the Pallas backward kernel (_bwd_kernel)."""
    def fn(*a):
        arrs = [a_.astype(jdt) if i < 3 else a_ for i, a_ in enumerate(a[:-1])]
        out, vjp = jax.vjp(lambda *t: jab.fused_attn_block(*t, heads, interpret=True), *arrs)
        return tuple(r.astype(jnp.float32) for r in vjp(a[-1].astype(jdt)))

    return [np.array(r) for r in jax.jit(fn)(*(jnp.asarray(a) for a in args), jnp.asarray(g))]


def _plain_attn_grads(args, g, heads, dtype):
    leaves = [torch.from_numpy(a).to(dtype) if i < 3 else torch.from_numpy(a)
              for i, a in enumerate(args)]
    leaves = [t.requires_grad_() for t in leaves]
    out = fused_attn_block_plain(*leaves, heads)
    return torch.autograd.grad(out, leaves, torch.from_numpy(g).to(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p,l,c,heads", [
    (65, 151, 64, 4),   # dh 16, ragged P, the class count as L
    (130, 7, 64, 2),    # dh 32, P past two query tiles
    (63, 1, 64, 1),     # dh 64, one key
    (129, 65, 128, 2),  # dh 64, L one past a key tile
])
def test_tiled_attn_block_bwd_matches_pallas_and_plain(dtype, p, l, c, heads):
    """The row-3 emulation against the Pallas backward (custom VJP, interpret
    mode) and against autograd through fused_attn_block_plain: every
    gradient, the q weight and bias ones carried back through the 1/√dh
    fold (d wq = d wq_s / √dh)."""
    tdt = getattr(torch, dtype)
    args, g = _attn_inputs(p + 3 * l + c + heads, 2, p, l, c, tdt)
    t = [torch.from_numpy(a) for a in args]
    got = list(tiled_attn_block_bwd(*t[:3], torch.from_numpy(g), *t[3:8], heads, tdt))
    scale = 1.0 / math.sqrt(c // heads)
    got[3], got[4] = got[3] * scale, got[4] * scale
    names = ("x", "k", "v", "wq", "bq", "wo", "bo", "ln_w", "ln_b")
    want = _pallas_attn_grads(args, g, heads, getattr(jnp, dtype))
    plain = _plain_attn_grads(args, g, heads, tdt)
    for name, a, w, pl in zip(names, got, want, plain):
        assert torch.isfinite(a).all(), name
        _grad_close(a, w, GRAD_REL[tdt], name)
        _grad_close(a, pl.float().detach().numpy(), GRAD_REL[tdt], name + " (plain)")


def test_tiled_recompute_equals_one_softmax():
    """The recompute's online softmax over 64-key tiles (f32) equals one
    softmax over all keys: lse and O at f32 rounding, at L = 151 (two full
    tiles and a ragged one)."""
    args, g = _attn_inputs(5, 1, 70, 151, 64, torch.float32)
    x, k, v = (torch.from_numpy(a) for a in args[:3])
    heads, dh = 2, 32
    s = (x.reshape(1, 70, heads, dh).transpose(1, 2)
         @ k.reshape(1, 151, heads, dh).transpose(1, 2).transpose(-1, -2))
    m = torch.full((1, heads, 70), -math.inf)
    l = torch.zeros(1, heads, 70)
    for k0 in range(0, 151, TILE):
        st = s[..., k0:k0 + TILE]
        m_new = torch.maximum(m, st.amax(-1) * LOG2E)
        l = l * torch.exp2(m - m_new) + torch.exp2(st * LOG2E - m_new[..., None]).sum(-1)
        m = m_new
    np.testing.assert_allclose((m * LN2 + torch.log(l)).numpy(),
                               torch.logsumexp(s, -1).numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# row 6: the swin window block
# ---------------------------------------------------------------------------


def _regions(hp, wp, win, shift):
    def region(n):
        i = torch.arange(n)
        return (i >= n - win).long() + (i >= n - shift).long()

    return region(hp)[:, None] * 3 + region(wp)[None, :]


def tiled_swin_block(x, lnw, lnb, wqkv, bqkv, wo, bo, bias, heads, win, shift, dtype,
                     residual=True, eps=1e-5):
    """The bf16 body's arithmetic (identity rounding for f32) on a (B, H, W,
    C) canvas of f32 values holding dtype values; weights f32 (wqkv, bqkv
    unscaled, as swin_window_block takes them)."""
    b, h, w, c = x.shape
    dh, n = c // heads, win * win
    kt = 64 if c % 64 == 0 else 32  # the weight ring's k-slice
    wq_s, bq_s = (_round(t, dtype) for t in fold_qkv_scale(wqkv, bqkv, heads))
    lnw, lnb, wo, bo = (_round(t, dtype) for t in (lnw, lnb, wo, bo))
    mu = x.mean(-1, keepdim=True)
    rs = torch.rsqrt(((x - mu) ** 2).mean(-1, keepdim=True) + eps)
    hs = _round((x - mu) * rs * lnw + lnb, dtype)
    hp, wp = -(-h // win) * win, -(-w // win) * win
    hs = F.pad(hs, (0, 0, 0, wp - w, 0, hp - h))  # HF pads after the LN: zeros
    if shift:
        hs = torch.roll(hs, (-shift, -shift), (1, 2))
    nwh, nww = hp // win, wp // win
    tw = hs.reshape(b, nwh, win, nww, win, c).transpose(2, 3).reshape(-1, n, c)
    qkv = _round(_mm(tw, wq_s.t(), kt) + bq_s, dtype)
    q, k, v = (t.reshape(-1, n, heads, dh).transpose(1, 2) for t in qkv.split(c, -1))
    s = q @ k.transpose(-1, -2) + bias
    if shift:
        lab = _regions(hp, wp, win, shift).reshape(nwh, win, nww, win).transpose(1, 2)
        lab = lab.reshape(-1, n).repeat(b, 1)
        s = s - 100.0 * (lab[:, None, :, None] != lab[:, None, None, :]).float()
    e = torch.exp2((s - s.amax(-1, keepdim=True)) * LOG2E)
    o = _round((_round(e, dtype) @ v) * (1.0 / e.sum(-1, keepdim=True)), dtype)
    o = o.transpose(1, 2).reshape(b, nwh, nww, win, win, c).transpose(2, 3).reshape(b, hp, wp, c)
    if shift:
        o = torch.roll(o, (shift, shift), (1, 2))
    y = _mm(o[:, :h, :w], wo.t(), kt) + bo
    return _round(x + y if residual else y, dtype)


def _swin_inputs(seed, b, h, w, c, heads, win, dtype):
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(b, h, w, c).astype(np.float32)).to(dtype).float().numpy()
    params = [1 + 0.1 * rs.randn(c), 0.5 * rs.randn(c), rs.randn(3 * c, c) / np.sqrt(c),
              0.1 * rs.randn(3 * c), rs.randn(c, c) / np.sqrt(c), 0.1 * rs.randn(c),
              0.1 * rs.randn(heads, win * win, win * win)]
    return [x] + [a.astype(np.float32) for a in params]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,w,c,heads,win,shift", [
    (18, 18, 32, 2, 7, 3),  # dh 16, HF-padded 21 x 21, shifted
    (14, 21, 64, 2, 7, 0),  # dh 32, one side padded
    (16, 16, 64, 1, 7, 3),  # dh 64, stage-4-like grid
    (12, 12, 64, 2, 4, 2),  # window 4, shifted
    (10, 9, 32, 1, 4, 0),   # window 4, HF-padded 12 x 12
])
def test_tiled_swin_block_matches_pallas_and_plain(dtype, h, w, c, heads, win, shift):
    """The row-6 emulation against swin_canvas_block (interpret mode) and
    swin_window_block_plain, with the residual."""
    tdt = getattr(torch, dtype)
    args = _swin_inputs(h + w + c + heads + win + shift, 2, h, w, c, heads, win, tdt)
    t = [torch.from_numpy(a) for a in args]
    got = tiled_swin_block(*t, heads, win, shift, tdt)
    jdt = getattr(jnp, dtype)
    want = np.array(jax.jit(lambda x_, *p: swin_canvas_block(
        x_.astype(jdt), *p, heads, win, shift, interpret=True).astype(jnp.float32))(
            *(jnp.asarray(a) for a in args)))
    plain = swin_window_block_plain(t[0].to(tdt), *t[1:], heads, win, shift).float().numpy()
    assert got.shape == t[0].shape and torch.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
        np.testing.assert_allclose(got.numpy(), plain, **F32_TOL)
    else:
        d = np.abs(got.numpy() - want)
        assert d.max() <= 0.12 and d.mean() <= 0.02, (d.max(), d.mean())
        np.testing.assert_allclose(got.numpy(), plain, rtol=2e-2, atol=5e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiled_swin_block_without_residual(dtype):
    """residual=False (the drop-path training path) against the Pallas
    kernel's branch-only output and the plain version."""
    tdt = getattr(torch, dtype)
    args = _swin_inputs(11, 2, 18, 18, 64, 2, 7, tdt)
    t = [torch.from_numpy(a) for a in args]
    got = tiled_swin_block(*t, 2, 7, 3, tdt, residual=False)
    jdt = getattr(jnp, dtype)
    want = np.array(jax.jit(lambda x_, *p: swin_canvas_block(
        x_.astype(jdt), *p, 2, 7, 3, interpret=True, residual=False).astype(jnp.float32))(
            *(jnp.asarray(a) for a in args)))
    plain = swin_window_block_plain(t[0].to(tdt), *t[1:], 2, 7, 3, residual=False)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), **F32_TOL)
    else:
        d = np.abs(got.numpy() - want)
        assert d.max() <= 0.12 and d.mean() <= 0.02, (d.max(), d.mean())
        np.testing.assert_allclose(got.numpy(), plain.float().numpy(), rtol=2e-2, atol=5e-2)


def test_unnormalised_rounding_order():
    """Rounding the unnormalised e and scaling P · V by 1 / Σ e afterwards
    (the kernel's order) and rounding the normalised probabilities (the plain
    version's) agree within one bf16 step of the result, and exactly in f32."""
    rs = np.random.RandomState(7)
    s = torch.from_numpy(rs.randn(64, 49, 49).astype(np.float32) * 3)
    v = torch.from_numpy(rs.randn(64, 49, 32).astype(np.float32)).to(torch.bfloat16).float()
    e = torch.exp2((s - s.amax(-1, keepdim=True)) * LOG2E)
    kernel = (_round(e, torch.bfloat16) @ v) / e.sum(-1, keepdim=True)
    plain = _round(torch.softmax(s, -1), torch.bfloat16) @ v
    assert (kernel - plain).abs().max() <= 2 ** -7 * v.abs().max()
    np.testing.assert_allclose((e @ v / e.sum(-1, keepdim=True)).numpy(),
                               (torch.softmax(s, -1) @ v).numpy(), rtol=1e-5, atol=1e-5)
