"""The arithmetic of the two redesigned kernels of the loss and the served
head, emulated tile by tile on the CPU and held against lc2is_tpu's Pallas
kernels in interpret mode (as the JAX package's own tests run them) and
against the port's plain versions, on the same numpy-seeded inputs.

Rows 13-14, ``upsampled_cross_entropy`` (``lc2is_tpu_torch/csrc/fused_ce.cu``):
a block owns a tile of low-res cells (the plan of ``make_plan``: 8 x 16 at r
4 in bf16, 8 x 8 in f32, 3 x 8 at r 16) and computes every hi-res pixel whose
taps reach it: its own pixels and a ring, grouped by the pair of cells their
taps read along each axis (the pixels past an edge join the edge pair with
weight 0 or 1).  In f32 on the map's values, in log2 units: per class a
unit's two column values blended across its rows and scaled by log2 e,
each pixel's logit c0 + fx · (c1 − c0); the max, Σ 2^(v − max) over the
classes in order, lse, nll for the block's own valid pixels; then, per unit
of up to PU adjacent pixels of a row sharing a column pair, the column sums
Σ w · 2^(v − lse) minus the one-hot terms, and per own cell and group of 4
classes the row-weighted sum of the units reaching it, its rows split over
Z threads (each in order) whose sums meet in an xor tree.  Stated tolerances: the loss within 1e-5
relative (+1e-6), the gradient ‖Δ‖/‖ref‖ within ``GRAD_TOL`` of
``tests/test_torch_cuda.py`` (f32 1e-4, bf16 2e-2).  A control that must
fail: the same emulation without the ring (own pixels only).

Row 12, ``score_upsample_argmax`` (``csrc/upsample_argmax.cu``, its bf16
body): 16 x 16 tiles with an 18 x 18 halo of clamped tokens, taken in chunks
of 64: each token's f32 norm (32 lanes, each over 8 channels of every 256
in order, then the xor tree), the divisor max(‖v‖, eps) rounded to bf16,
each element multiplied by its correctly rounded reciprocal (equal to the
division for bf16 operands) and rounded; the score product in f32 over 16-channel steps, each score
rounded to bf16; then the argmax over classes in passes of 160 (strict >,
so a tie keeps the lower class), a unit being the output pixels of a row
that read one pair of halo columns: h(g), h(g + 1) blended across rows with
the row phase weights, then w_other · h(other) + w_cur · h(cur), each product
and sum rounded to f32.  Masks must equal the Pallas kernel's and the plain
version's except at near-ties, as ``tests/test_torch_serve.py`` and the card
tests hold them: a pixel whose two best blended plain scores lie within two
bf16 steps of the largest score.  A control that must fail: the halo
clamped to the tile instead of the image.

Every ``extern "C"`` declaration of the two sources is held against the
argtypes ``ops/_build.py`` binds, and both wrappers' card paths, with the
launch recorded on CPU tensors, against those argtypes.
"""

import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lc2is_tpu.ops.fused_ce import upsampled_cross_entropy as jax_upsampled_ce
from lc2is_tpu.ops.upsample_argmax import score_upsample_argmax as jax_score_upsample_argmax
from lc2is_tpu_torch.ops import _build
from lc2is_tpu_torch.ops.fused_ce import upsampled_cross_entropy_plain
from lc2is_tpu_torch.ops.upsample_argmax import (_phase_weights, l2_normalize, score_map_plain,
                                                 score_upsample_argmax_plain, upsample_blend_plain)

CSRC = Path(__file__).resolve().parents[1] / "lc2is_tpu_torch" / "csrc"
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
LOG2E = 1.4426950408889634  # multiplies an f32 tensor as the f32 constant kLog2e


def _f32(a):
    return torch.as_tensor(a, dtype=torch.float32)


def _fma(a, b, c):
    """a · b + c rounded once (the product is exact in f64)."""
    return _f32(_f32(a).double() * _f32(b).double() + _f32(c).double())


def _lerp2(w0, a, w1, b):
    """fused_ce.cu's lerp2: fma(w1, b, w0 · a)."""
    return _fma(w1, b, _f32(w0) * a)


LN2 = 0.6931471805599453


# ---------------------------------------------------------------------------
# rows 13-14: the fused upsample cross-entropy
# ---------------------------------------------------------------------------


def pair_of(y, n, r):
    """The pair of cells hi-res coordinate y reads (fused_ce.cu::pair_of)."""
    return min(max(math.floor((2 * y + 1 - r) / (2 * r)), 0), max(n - 2, 0))


def pair_lo(a, r):
    return 0 if a == 0 else r * a + r // 2


def pair_hi(a, n, r):
    return r * n if a >= max(n - 1, 1) - 1 else r * (a + 1) + r // 2


def frac_of(y, a, n, r):
    if n == 1:
        return np.float32(0.0)
    return np.float32(min(max(np.float32(2 * (y - r * a) + 1 - r) / np.float32(2 * r), 0.0), 1.0))


def _axis_max(n, t, r, pu):
    """(lines, units a line, units of one pair): the maxima over the tiles."""
    lines = segs = pair_segs = 0
    pairs = max(n - 1, 1)
    for i0 in range(0, n, t):
        lo, hi = max(i0 - 1, 0), min(i0 + t - 1, pairs - 1)
        lines = max(lines, pair_hi(hi, n, r) - pair_lo(lo, r))
        n_a = [-(-(pair_hi(a, n, r) - pair_lo(a, r)) // pu) for a in range(lo, hi + 1)]
        segs, pair_segs = max(segs, sum(n_a)), max(pair_segs, max(n_a))
    return lines, segs, pair_segs


def ce_plan(esize, h, w, k, r):
    """fused_ce.cu::make_plan: (tile rows, tile columns, PU, units of one
    column pair at most), the first tile whose shared memory fits two
    resident blocks, else one."""
    up16 = lambda n: -(-n // 16) * 16  # noqa: E731
    pu = 2 if r <= 3 else 4 if r <= 7 else 8 if r <= 15 else 16
    tiles = ([(8, 16), (8, 8), (4, 8), (4, 4), (2, 4), (2, 2), (1, 2)] if r <= 8 else
             [(3, 8), (2, 8), (2, 4), (1, 4), (1, 2)])
    for budget in (115712, 232448):
        for th, tw in tiles:
            rows, _, _ = _axis_max(h, th, r, pu)
            xs, segs, gsegs = _axis_max(w, tw, r, pu)
            units = rows * segs
            smem = (up16(k * (th + 2) * (tw + (4 if esize == 2 else 2)) * esize)
                    + up16(2 * (units + 1) * 8 * 4) + up16(pu * units * 4) + 2 * up16(rows * 4)
                    + up16(xs * 4) + up16(segs * 12) + up16((tw + 2) * 4) + up16(xs * 4)
                    + up16(pu * units) + up16(68))
            if smem <= budget:
                return th, tw, pu, gsegs
    raise ValueError("no plan")


def tiled_fused_ce(x, labels, r, ignore_index=None, ring=True):
    """fused_ce.cu's pass on f32 tensors holding the map's values: (Σ nll,
    Σ valid, unscaled gradient (B, K, h, w)).  ring=False: the control, the
    tile's own hi-res pixels only."""
    b_, k, h, w = x.shape
    th, tw, pu, gsegs = ce_plan(x.element_size(), h, w, k, r)
    xf = _f32(x)
    lab = labels.long()
    grad = torch.zeros(b_, k, h, w)
    nll_sum, n_valid = 0.0, 0.0
    ph, pw = max(h - 1, 1), max(w - 1, 1)
    for b in range(b_):
        s = xf[b]
        for i0 in range(0, h, th):
            for j0 in range(0, w, tw):
                pa_lo, pa_hi = max(i0 - 1, 0), min(i0 + th - 1, ph - 1)
                ga_lo, ga_hi = max(j0 - 1, 0), min(j0 + tw - 1, pw - 1)
                y_lo, y_hi = pair_lo(pa_lo, r), pair_hi(pa_hi, h, r)
                own = (r * i0, r * min(i0 + th, h), r * j0, r * min(j0 + tw, w))
                if not ring:
                    y_lo, y_hi = own[0], own[1]
                # the units of a row: each column pair's pixels in runs of pu
                segs = []
                for g in range(ga_lo, ga_hi + 1):
                    lo, hi = pair_lo(g, r), pair_hi(g, w, r)
                    if not ring:
                        lo, hi = max(lo, own[2]), min(hi, own[3])
                    segs += [(g, x0, min(x0 + pu, hi)) for x0 in range(lo, hi, pu)]
                rows = []  # per row: pair, fy, the column sums of its units
                for y in range(y_lo, y_hi):
                    a = pair_of(y, h, r)
                    fy = frac_of(y, a, h, r)
                    gy = np.float32(1.0) - fy
                    a1 = min(a + 1, h - 1)
                    t0, t1 = [], []
                    for g, x0, x1 in segs:
                        g1 = min(g + 1, w - 1)
                        c0 = _lerp2(gy, s[:, a, g], fy, s[:, a1, g]) * LOG2E
                        d = _lerp2(gy, s[:, a, g1], fy, s[:, a1, g1]) * LOG2E - c0
                        d0, d1 = torch.zeros(k), torch.zeros(k)
                        for xx in range(x0, x1):
                            fx = frac_of(xx, pair_of(xx, w, r), w, r)
                            gx = np.float32(1.0) - fx
                            v = _fma(fx, d, c0)  # log2 units
                            m = v.max()
                            se = torch.cumsum(torch.exp2(v - m), 0)[-1]
                            lse = m + torch.log2(se)
                            y_lab = int(lab[b, y, xx])
                            valid = ignore_index is None or y_lab != ignore_index
                            c = min(max(y_lab, 0), k - 1)
                            if valid and own[0] <= y < own[1] and own[2] <= xx < own[3]:
                                nll_sum += float((lse - v[c]) * LN2)
                                n_valid += 1.0
                            e = torch.exp2(v - lse) if valid else torch.zeros(k)
                            d0 = _fma(gx, e, d0)
                            d1 = _fma(fx, e, d1)
                            if valid:
                                d0[c] -= gx
                                d1[c] -= fx
                        t0.append(d0)
                        t1.append(d1)
                    rows.append((y, a, fy, t0, t1))
                # the gather: per own cell, Z row splits, each summing its rows in
                # order (right sums of pair bb − 1, then left sums of bb, two
                # slots a side padded with zeros), then an xor tree
                cells = (min(i0 + th, h) - i0) * (min(j0 + tw, w) - j0)
                z_n = 1
                while z_n < 32 and 2 * z_n * 2 * cells <= 256:
                    z_n *= 2
                for a in range(i0, min(i0 + th, h)):
                    for bb in range(j0, min(j0 + tw, w)):
                        mine = [(fy if pa == a - 1 else np.float32(1.0) - fy, t0, t1)
                                for y, pa, fy, t0, t1 in rows
                                if pa_lo <= pa <= pa_hi and pa in (a - 1, a)]
                        parts = []
                        for zz in range(z_n):
                            acc = torch.zeros(k)
                            for wy, t0, t1 in mine[zz::z_n]:
                                right = [d1 for (g, _, _), d1 in zip(segs, t1) if g == bb - 1]
                                left = [d0 for (g, _, _), d0 in zip(segs, t0) if g == bb]
                                if gsegs <= 2:
                                    right += [torch.zeros(k)] * (2 - len(right))
                                    left += [torch.zeros(k)] * (2 - len(left))
                                row = torch.zeros(k)
                                for part in right + left:
                                    row = row + part
                                acc = _fma(wy, row, acc)
                            parts.append(acc)
                        o = 1
                        while o < z_n:
                            parts = [parts[i] + parts[i ^ o] for i in range(z_n)]
                            o *= 2
                        grad[b, :, a, bb] = parts[0]
    return nll_sum, n_valid, grad


def _ce_inputs(seed, b, k, h, w, r, ign, dtype, lab_dtype):
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(b, k, h, w).astype(np.float32)).to(dtype)
    y = rs.randint(-1, k + 2, size=(b, r * h, r * w))
    if ign is not None:
        y[rs.rand(*y.shape) < 0.2] = ign
    return x, torch.from_numpy(y).to(lab_dtype)


def _ce_check(got, want, dtype):
    """(loss ok, gradient ‖Δ‖/‖ref‖) of the emulation (loss, gradient)
    against a reference (loss, gradient)."""
    loss_ok = abs(got[0] - want[0]) <= 1e-5 * abs(want[0]) + 1e-6
    rel = (torch.as_tensor(got[1]).float() - torch.as_tensor(want[1]).float()).norm() / \
        torch.as_tensor(want[1]).float().norm().clamp_min(1e-30)
    return loss_ok, float(rel)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,k,h,w,r,ign,lab_dtype", [
    (1, 7, 9, 17, 4, 255, torch.int64),   # one past the tile at r 4 (8 x 16; f32 8 x 8)
    (1, 151, 4, 6, 4, None, torch.int64),
    (1, 256, 2, 3, 4, 0, torch.int32),    # K 256
    (1, 1, 3, 3, 4, None, torch.int64),   # K 1: the gradient is exactly zero
    (1, 9, 4, 9, 16, 3, torch.int64),     # one past the 3 x 8 tile at r 16
    (2, 5, 3, 2, 2, None, torch.int32),
    (1, 6, 4, 5, 6, 0, torch.int64),      # r 6: three units in an edge column pair
])
def test_tiled_fused_ce_matches_pallas_and_plain(dtype, b, k, h, w, r, ign, lab_dtype):
    x, y = _ce_inputs(b * k + h * w + r, b, k, h, w, r, ign, dtype, lab_dtype)
    nll, cnt, grad = tiled_fused_ce(x, y, r, ign)
    denom = max(cnt, 1.0)
    got = (nll / denom, grad / denom)
    # the Pallas kernels (interpret mode) and their custom VJP, on the same values
    xj = jnp.asarray(_f32(x).numpy(), JDT[dtype])
    jl, jg = jax.jit(jax.value_and_grad(lambda v: jax_upsampled_ce(
        v, jnp.asarray(y.numpy().astype(np.int32)), r, ignore_index=ign, interpret=True)))(xj)
    pallas = (float(jl), torch.from_numpy(np.array(jg, np.float32)))
    # the plain version: autograd through the f32 upsample and CE
    xp = _f32(x).requires_grad_()
    lp = upsampled_cross_entropy_plain(xp, y.long(), r, ignore_index=ign)
    (gp,) = torch.autograd.grad(lp, [xp])
    for what, want in (("pallas", pallas), ("plain", (lp.item(), gp))):
        loss_ok, rel = _ce_check(got, want, dtype)
        assert loss_ok, (what, got[0], want[0])
        if k == 1:
            assert not got[1].any() and not torch.as_tensor(want[1]).any(), what
        else:
            assert rel <= GRAD_TOL[dtype], (what, rel)


def test_tiled_fused_ce_control_without_the_ring_fails():
    """Dropping the ring (the hi-res pixels outside the tile whose taps reach
    its cells) leaves the tile's edge cells short of gradient: the check
    must fail."""
    x, y = _ce_inputs(5, 1, 7, 9, 17, 4, None, torch.float32, torch.int64)
    nll, cnt, grad = tiled_fused_ce(x, y, 4, ring=False)
    xp = x.clone().requires_grad_()
    lp = upsampled_cross_entropy_plain(xp, y, 4)
    (gp,) = torch.autograd.grad(lp, [xp])
    loss_ok, rel = _ce_check((nll / cnt, grad / cnt), (lp.item(), gp), torch.float32)
    assert loss_ok  # own pixels still count their nll once
    assert rel > GRAD_TOL[torch.float32], rel


@pytest.mark.parametrize("h,w,r,dtype,want", [
    (128, 128, 4, torch.bfloat16, (8, 16, 4, 2)),
    (32, 32, 16, torch.bfloat16, (3, 8, 16, 2)),
    (128, 128, 4, torch.float32, (8, 8, 4, 2)),
    (32, 32, 16, torch.float32, (3, 8, 16, 2)),
])
def test_ce_plan_at_the_step_shapes(h, w, r, dtype, want):
    """The flagship step's two launches (151 classes) take the tiles the
    design states, two blocks resident: the ring costs 1.2x the own pixels at
    r 4 (36 x 68 for 32 x 64) and 1.5x at r 16 (64 x 144 for 48 x 128)."""
    esize = torch.tensor([], dtype=dtype).element_size()
    assert ce_plan(esize, h, w, 151, r) == want
    th, tw = want[:2]
    rows, _, _ = _axis_max(h, th, r, want[2])
    cols, _, _ = _axis_max(w, tw, r, want[2])
    assert rows * cols / (r * th * r * tw) <= 1.5


# ---------------------------------------------------------------------------
# row 12: the served mask head's bf16 body
# ---------------------------------------------------------------------------

HT, HH, MC, KP = 16, 18, 64, 160


def _bf16(a):
    return a.to(torch.bfloat16).float()


def _norm_lanes(row):
    """32 lanes over the channels (C a multiple of 8: lane l takes 8l .. 8l
    + 7 of every 256 in order; else c ≡ l mod 32), fma(x, x, ss), then the
    xor tree (o = 16, 8, 4, 2, 1): lane 0's sum."""
    c = row.numel()
    lanes = torch.zeros(32)
    if c % 8 == 0:
        for c0 in range(0, c, 256):
            chunk = row[c0:c0 + 256]
            n = chunk.numel() // 8
            chunk = chunk.reshape(n, 8)
            for i in range(8):
                lanes[:n] = _fma(chunk[:, i], chunk[:, i], lanes[:n])
    else:
        for c0 in range(0, c, 32):
            part = row[c0:c0 + 32]
            lanes[:part.numel()] = _fma(part, part, lanes[:part.numel()])
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[torch.arange(32) ^ o]
    return lanes[0]


def tiled_head_scores(v, tn, grid, i0, j0, eps=1e-12, clamp_to_tile=False):
    """The bf16 body's scores of one tile's 18 x 18 halo tokens: (K, 324)
    f32 holding bf16 values.  clamp_to_tile: the control's halo."""
    c = v.shape[-1]
    n = torch.arange(HH * HH)
    ys, xs = i0 - 1 + n // HH, j0 - 1 + n % HH
    if clamp_to_tile:
        ys = ys.clamp(i0, min(i0 + HT, grid) - 1)
        xs = xs.clamp(j0, min(j0 + HT, grid) - 1)
    px = ys.clamp(0, grid - 1) * grid + xs.clamp(0, grid - 1)
    tok = _f32(v[px])
    bmat = _f32(tn).T  # (C, K)
    scores = []
    for n0 in range(0, HH * HH, MC):  # chunks of 64 tokens
        rows = []
        for row in tok[n0:n0 + MC]:
            dn = _bf16(torch.sqrt(_norm_lanes(row)).clamp_min(eps))
            rows.append(_bf16(row * torch.reciprocal(dn)))
        a = torch.stack(rows)
        acc = torch.zeros(a.shape[0], bmat.shape[1])
        for c0 in range(0, c, 16):  # the product's 16-channel steps
            acc = acc + _f32(a[:, c0:c0 + 16].double() @ bmat[c0:c0 + 16].double())
        scores.append(_bf16(acc))
    return torch.cat(scores).T


def tiled_head_argmax(score_tiles, grid, r, k):
    """The argmax phase over every tile: score_tiles[(i0, j0)] (K, 324);
    classes in passes of 160, strict >, a unit per output row and halo
    column pair; (r·grid, r·grid) int32."""
    out = torch.zeros(r * grid, r * grid, dtype=torch.int32)
    phases = _phase_weights(r)
    for (i0, j0), s in score_tiles.items():
        s = s.reshape(k, HH, HH)
        for oyl in range(HT * r):
            oy = r * i0 + oyl
            if oy >= r * grid:
                continue
            li, (prev, wo, wc) = oyl // r, phases[oyl % r]
            ro = li if prev else li + 2
            for g in range(HT + 1):
                px0 = max((g - 1) * r + r // 2, 0)
                px1 = min(g * r + r // 2, HT * r)
                if px1 <= px0:
                    continue
                # H blend of halo columns g and g + 1, every class
                hcol = [_f32(wo) * s[:, ro, cc] + _f32(wc) * s[:, li + 1, cc]
                        for cc in (g, g + 1)]
                for oxl in range(px0, px1):
                    ox = r * j0 + oxl
                    if ox >= r * grid:
                        continue
                    pprev, pwo, pwc = phases[oxl % r]
                    w0, w1 = (pwo, pwc) if pprev else (pwc, pwo)
                    val = _f32(w0) * hcol[0] + _f32(w1) * hcol[1]
                    best, arg = None, 0
                    for k0 in range(0, k, KP):  # class passes
                        part = val[k0:k0 + KP]
                        j = int(torch.argmax(part))  # first of the largest: the lowest class
                        if best is None or part[j] > best:
                            best, arg = part[j], k0 + j
                    out[oy, ox] = arg
    return out


def tiled_score_upsample_argmax(v, tn, grid, r, eps=1e-12, clamp_to_tile=False):
    """The bf16 body end to end on (B, grid², C) tokens: (B, r·grid, r·grid)."""
    outs = []
    for b in range(v.shape[0]):
        tiles = {(i0, j0): tiled_head_scores(v[b], tn[b], grid, i0, j0, eps, clamp_to_tile)
                 for i0 in range(0, grid, HT) for j0 in range(0, grid, HT)}
        outs.append(tiled_head_argmax(tiles, grid, r, tn.shape[1]))
    return torch.stack(outs)


def _near_ties(got, want, blended):
    """Pixels where got != want whose two best blended scores lie more than
    two bf16 steps of the largest score apart (must be none)."""
    tie = 2 * 2.0 ** (math.floor(math.log2(blended.abs().max().item())) - 7)
    differ = got != torch.as_tensor(want).int()
    top2 = blended.topk(2, dim=1).values
    return int(((top2[:, 0] - top2[:, 1])[differ] > tie).sum()), int(differ.sum())


def _head_inputs(seed, b, grid, k, c):
    rs = np.random.RandomState(seed)
    v = torch.from_numpy(rs.randn(b, grid * grid, c).astype(np.float32)).to(torch.bfloat16)
    tn = l2_normalize(torch.from_numpy(rs.randn(b, k, c).astype(np.float32)).to(torch.bfloat16), 2)
    return v, tn


@pytest.mark.parametrize("b,grid,k,c,r", [
    (1, 17, 7, 48, 4),    # one past the 16 x 16 tile
    (1, 8, 161, 32, 4),   # one class into the second pass
    (1, 16, 170, 40, 2),  # C not a multiple of 32 (the slices zero-fill)
    (2, 6, 3, 16, 3),
    (1, 4, 256, 24, 16),  # K 256, r 16: a unit of 16 pixels
])
def test_tiled_score_upsample_argmax_matches_pallas_and_plain(b, grid, k, c, r):
    v, tn = _head_inputs(grid * k + c, b, grid, k, c)
    got = tiled_score_upsample_argmax(v, tn, grid, r)
    blended = upsample_blend_plain(score_map_plain(v, tn, grid), r)
    # block_rows 2 (1 at r 16): the same function, a smaller unrolled body
    # to compile in interpret mode
    pallas = jax.jit(lambda a, t_: jax_score_upsample_argmax(a, t_, grid, r=r, interpret=True,
                                                             block_rows=2 if r < 8 else 1))(
        jnp.asarray(_f32(v).numpy(), jnp.bfloat16), jnp.asarray(_f32(tn).numpy(), jnp.bfloat16))
    for what, want in (("pallas", np.array(pallas)),
                       ("plain", score_upsample_argmax_plain(v, tn, grid, r))):
        bad, n = _near_ties(got, want, blended)
        assert got.dtype == torch.int32 and tuple(got.shape) == tuple(np.shape(want)), what
        assert bad == 0, (what, bad, n)


def test_tiled_score_upsample_argmax_control_halo_fails():
    """The halo clamped to the tile instead of the image changes the blends
    along every inner tile edge: masks must differ beyond near-ties."""
    v, tn = _head_inputs(3, 1, 20, 9, 32)
    got = tiled_score_upsample_argmax(v, tn, 20, 4, clamp_to_tile=True)
    bad, _ = _near_ties(got, score_upsample_argmax_plain(v, tn, 20, 4),
                        upsample_blend_plain(score_map_plain(v, tn, 20), 4))
    assert bad > 0


def test_norm_lanes_is_the_f32_norm():
    """The kernel's lane-strided sum of squares agrees with the f32 norm the
    plain version takes to within rounding (both then round the divisor to
    bf16)."""
    row = torch.from_numpy(np.random.RandomState(4).randn(512).astype(np.float32))
    assert abs(float(_norm_lanes(row)) - float((row.double() ** 2).sum())) <= 1e-5 * 512


# ---------------------------------------------------------------------------
# the C entry points the two wrappers bind
# ---------------------------------------------------------------------------

_C_TYPES = {"void*": _build.ctypes.c_void_p, "int": _build.ctypes.c_int,
            "float": _build.ctypes.c_float}


def _decl(name):
    """(ctypes types, parameter names) of extern "C" ``name`` in csrc/*.cu."""
    text = "".join(p.read_text() for p in sorted(CSRC.glob("*.cu")))
    params = re.search(rf'extern "C" [^(]* {name}\(([^)]*)\)', text).group(1).split(",")
    types = ["".join(re.sub(r"\bconst\b", "", a).split()).rsplit("*", 1)[0] + "*"
             if "*" in a else a.split()[0] for a in params]
    return [_C_TYPES[t_] for t_ in types], [a.split()[-1].lstrip("*") for a in params]


@pytest.mark.parametrize("name,check", [
    ("lc2_fused_ce", "labels, label_bytes"),
    ("lc2_fused_ce_partials", "dtype, B, h, w, K, r"),
    ("lc2_score_upsample_argmax", "out, ws"),
    ("lc2_upsample_argmax", "out, ws"),
    ("lc2_upsample_argmax_workspace", "B, H, W, K, r"),
])
def test_entry_points_match_their_bindings(name, check):
    """Each entry point of the two sources is bound with the argtypes of
    its extern "C" declaration; the named parameters follow one another."""
    table = _build.SIGNATURES if name in _build.SIGNATURES else _build.SIZE_SIGNATURES
    types, names = _decl(name)
    assert types == list(table[name]), name
    want = check.split(", ")
    i = names.index(want[0])
    assert names[i:i + len(want)] == want, (name, names)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lab_dtype", [torch.int64, torch.int32, torch.uint8])
def test_fused_ce_wrapper_passes_its_signature(monkeypatch, dtype, lab_dtype):
    """The CE wrapper's card path, its launch recorded on CPU tensors: the
    map goes over in its (B, K, h, w) layout, int32 and int64 labels as
    they are (their own pointer and element size; other integer types cast
    to int32), a (B, K, h, w) f32 gradient, and arguments of the argtypes'
    kinds; the backward only scales and casts that gradient."""
    from lc2is_tpu_torch.ops import fused_ce

    calls = []
    monkeypatch.setattr(_build, "launch", lambda name, dev, *a: calls.append((name, a)))
    monkeypatch.setattr(_build, "size", lambda name, *a: 64)
    monkeypatch.setattr(_build, "stream_of", lambda t_: 0)
    monkeypatch.setattr(fused_ce, "use_kernel", lambda t_: True)
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(2, 5, 3, 4).astype(np.float32)).to(dtype)
    y = torch.from_numpy(rs.randint(0, 5, size=(2, 12, 16))).to(lab_dtype)
    sums, grad = fused_ce.fused_ce_fwd(x, y, 4, 255)
    (name, args), = calls
    kinds = {_build.ctypes.c_void_p: (int, type(None)), _build.ctypes.c_int: (int,)}
    assert len(args) == len(_build.SIGNATURES[name])
    for a, t_ in zip(args, _build.SIGNATURES[name]):
        assert isinstance(a, kinds[t_]), (a, t_)
    assert args[1] == x.data_ptr()
    if lab_dtype in (torch.int64, torch.int32):
        assert args[2] == y.data_ptr() and args[3] == y.element_size()
    else:
        assert args[3] == 4
    assert grad.shape == (2, 5, 3, 4) and grad.dtype == torch.float32
    assert args[7:] == (2, 3, 4, 5, 4, 1, 255, 0)


@pytest.mark.parametrize("k", [151, 161])
def test_head_wrappers_pass_their_signature(monkeypatch, k):
    """The head wrappers' card path on CPU tensors: a workspace of the size
    entry's floats only past one 160-class pass, and arguments of the
    argtypes' kinds."""
    from lc2is_tpu_torch.ops import upsample_argmax as ua

    calls = []
    monkeypatch.setattr(_build, "launch", lambda name, dev, *a: calls.append((name, a)))
    monkeypatch.setattr(_build, "size", lambda name, b, h, w, k_, r: b * r * h * r * w
                        if k_ > 160 else 0)
    monkeypatch.setattr(_build, "stream_of", lambda t_: 0)
    monkeypatch.setattr(ua, "use_kernel", lambda t_: True)
    v, tn = _head_inputs(1, 2, 5, k, 16)
    ua.score_upsample_argmax(v, tn, 5, 4)
    ua.upsample_argmax(torch.zeros(2, k, 5, 5, dtype=torch.bfloat16), 4)
    kinds = {_build.ctypes.c_void_p: (int, type(None)), _build.ctypes.c_int: (int,),
             _build.ctypes.c_float: (float,)}
    for (name, args), ws_at in zip(calls, (4, 3)):
        assert len(args) == len(_build.SIGNATURES[name])
        for a, t_ in zip(args, _build.SIGNATURES[name]):
            assert isinstance(a, kinds[t_]), (name, a, t_)
        assert (args[ws_at] is None) == (k <= 160), name


def test_reciprocal_multiply_equals_division_for_bf16():
    """bf16(x · rcp(d)) == bf16(x / d) for every bf16 significand pair: the
    quotient of two 8-bit significands is never within 2^-17 of a bf16
    rounding midpoint, so the reciprocal's f32 rounding cannot move it."""
    m = torch.arange(128, 256, dtype=torch.float32) / 128  # every significand in [1, 2)
    for scale in (1.0, 2.0 ** -20, 2.0 ** 30):
        x = _bf16(m[:, None] * scale)
        d = _bf16(m[None, :])
        assert torch.equal(_bf16(x / d), _bf16(x * torch.reciprocal(d)))
