"""The arithmetic of the f32 bodies of flash attention (TPU rows 15 and 16),
which run every product on the tensor cores in 3xTF32
(``lc2is_tpu_torch/csrc/flash_attention.cu``'s ``flash_x3_kernel``,
``csrc/flash_attention_bwd.cu``'s ``flash_bwd_dq_x3`` and
``flash_bwd_dkv_x3``), emulated tile by tile in numpy on the CPU and held
against lc2is_tpu's Pallas flash kernels in f32 in interpret mode at 64 x 64
blocks (as ``tests/test_torch_flash_tiles.py`` runs them) and against the
port's plain versions, on the same numpy-seeded inputs.

The 3xTF32 product (``csrc/gemm_f32x3.cuh``, emulated as in
``tests/test_torch_f32x3_tiles.py``): each operand value a is split into hi
= tf32(a) and lo = tf32(a - hi), and a · b is lo·hi' + hi·lo' + hi·hi', each
term one m16n8k8 product over an 8-wide k step.

Forward: 64-key tiles; S = Q · Kᵀ and P · V with every mma's products (one
term over one 8-wide k step; the hi·hi' term as two products over 4, as
``gemm32::mma_x3_row_k4hi`` runs it) added to the running sum in f32; a
dropped key (masked, or past Lk) −∞; the running max in log2 units with
scale · log2 e folded in, p = 2^(s·scale·log2 e − m) from one FMA; l sums p;
a tile with no kept key skipped; out = O · (1 / l), lse = m · ln 2 + log l,
so a row with no kept key gives NaN and −∞.

Backward, on the forward's out and lse: p = 2^(s·scale·log2 e − lse·log2 e)
and ds = p ∘ (dO · vᵀ − Δ), 0 at a dropped key and on a fully-masked row (Δ
as the wrapper computes it, 0 there); dq = scale · Σ ds · k summed over key
tiles, dk = scale · Σ dsᵀ · q and dv = Σ pᵀ · dO over query tiles, each tile's
products summed fresh and added to the running sum in f32; tiles of 64 rows
(32 above D 64).

Stated tolerance: within 1e-5 · max |ref| of the Pallas kernels and of the
plain versions (the output, lse and each gradient), chip_smoke.py's 3xTF32
rule for the card's bodies; the emulation lands near 1e-7.  The control that
must fail the same rule: the one-term emulation (hi·hi' only, one TF32
product a product), near 1e-4.
"""

import math

import numpy as np
import pytest
import torch
from test_torch_f32x3_tiles import LOG2E, split
from test_torch_flash_tiles import _inputs, _pallas

from lc2is_tpu_torch.ops.flash_attention import (_delta, flash_attention_backward_plain,
                                                 flash_attention_plain)

REL = 1e-5  # of max |ref|: the 3xTF32 rule
KEYS = 64  # the forward's key tile
LN2 = np.float32(0.6931471805599453)


def _exp2(x):
    """2^x of a float64 argument, rounded once to f32 (exp2 of an FMA)."""
    return np.exp2(np.asarray(x, np.float64)).astype(np.float32)


def mm_each(a, b, terms=3):
    """a (M, K) @ b (K, N) as the forward's mma chain sums it: each term of
    each 8-wide k step (lo·hi', hi·lo', then hi·hi' as two 4-wide products;
    ``terms=1``: hi·hi' only) a product of its own, added to the running sum
    in f32."""
    ah, al = split(a)
    bh, bl = split(b)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        s = slice(k0, k0 + 8)
        if terms == 3:
            acc += al[:, s] @ bh[s]
            acc += ah[:, s] @ bl[s]
        for h in (slice(k0, k0 + 4), slice(k0 + 4, k0 + 8)):
            acc += ah[:, h] @ bh[h]
    return acc


def mm_fresh(a, b, terms=3):
    """a @ b as one tile's fresh sum of the backward: the three terms over
    the whole K (the mma's own adds within it)."""
    ah, al = split(a)
    bh, bl = split(b)
    acc = ah @ bh
    if terms == 3:
        acc = al @ bh + ah @ bl + acc
    return acc.astype(np.float32)


def _scale(d):
    scale = np.float32(1 / math.sqrt(d))
    return scale, np.float32(scale * LOG2E)


def x3_forward(q, k, v, mask, terms=3):
    """flash_x3_kernel on f32 numpy (B, H, L, D) arrays and a (B, Lk) bool
    mask (True = ignore) or None: (out, lse)."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    _, sl2 = _scale(d)
    out = np.empty(q.shape, np.float32)
    lse = np.empty((b, h, lq), np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        for i in range(b):
            for j in range(h):
                m = np.full(lq, -np.inf, np.float32)
                l = np.zeros(lq, np.float32)
                o = np.zeros((lq, d), np.float32)
                for k0 in range(0, lk, KEYS):
                    keep = np.ones(min(KEYS, lk - k0), bool) if mask is None else \
                        ~mask[i, k0:k0 + KEYS]
                    if not keep.any():
                        continue
                    s = mm_each(q[i, j], k[i, j, k0:k0 + KEYS].T, terms)
                    s[:, ~keep] = -np.inf
                    m_new = np.maximum(m, s.max(1) * sl2)
                    alpha = _exp2(m.astype(np.float64) - m_new)
                    p = _exp2(s.astype(np.float64) * sl2 - m_new[:, None])
                    l = l * alpha + p.sum(1, dtype=np.float32)
                    o = o * alpha[:, None] + mm_each(p, v[i, j, k0:k0 + KEYS], terms)
                    m = m_new
                out[i, j] = o * (np.float32(1) / l)[:, None]
                lse[i, j] = m * LN2 + np.log(l)
    return out, lse


def x3_backward(q, k, v, mask, out, lse, g, terms=3):
    """flash_bwd_dq_x3 and flash_bwd_dkv_x3 on f32 numpy arrays: (dq, dk, dv)."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    scale, sl2 = _scale(d)
    rows = 64 if -(-d // 16) * 16 <= 64 else 32  # the streamed tiles
    delta = _delta(torch.from_numpy(out), torch.from_numpy(lse), torch.from_numpy(g)).numpy()
    dq, dk, dv = np.zeros_like(q), np.zeros_like(k), np.zeros_like(v)
    for i in range(b):
        keep = np.ones(lk, bool) if mask is None else ~mask[i]
        for j in range(h):
            live = np.isfinite(lse[i, j])[:, None] & keep[None, :]
            lse2 = (lse[i, j] * LOG2E).astype(np.float32)
            s = mm_fresh(q[i, j], k[i, j].T, terms)
            dp = mm_fresh(g[i, j], v[i, j].T, terms)
            with np.errstate(all="ignore"):  # a fully-masked row's lse is −∞
                p = np.where(live, _exp2(s.astype(np.float64) * sl2 - lse2[:, None]), 0)
            p = p.astype(np.float32)
            ds = np.where(live, p * (dp - delta[i, j][:, None]), 0).astype(np.float32)
            for k0 in range(0, lk, rows):
                t = slice(k0, k0 + rows)
                dq[i, j] += mm_fresh(ds[:, t], k[i, j, t], terms)
            for q0 in range(0, lq, rows):
                t = slice(q0, q0 + rows)
                dk[i, j] += mm_fresh(ds[t].T, q[i, j, t], terms)
                dv[i, j] += mm_fresh(p[t].T, g[i, j, t], terms)
    return dq * scale, dk * scale, dv


def _within(got, want, what, rel=REL):
    """got within rel · max |want| of want, NaN where want is NaN (raises
    AssertionError)."""
    want = np.asarray(want, np.float32)
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan), f"{what}: NaN in other places"
    err = np.abs(got[~nan] - want[~nan]).max()
    lim = rel * np.abs(want[~nan]).max()
    assert err <= lim, f"{what}: max |Δ| {err:.3e} > {rel} · max |ref| = {lim:.3e}"


# (Lq, Lk, D, mask): 64 ± 1 and 2·64 + 1 on both axes, D 40 and 64 (the
# ViT's), a kept prefix per entry (True) or keys 20-40 of every 64-key tile
# and a random quarter of the rest ("middle"), 77 queries over 129 keys
CASES = [(63, 65, 64, False), (65, 129, 40, True), (129, 63, 40, "middle"),
         (129, 129, 64, "middle"), (77, 129, 64, True)]


def _case(lq, lk, d, masked):
    (q, k, v, g), mask = _inputs(lq + 7 * lk + d, 2, 2, lq, lk, d, masked, torch.float32)
    return q, k, v, g, mask


def _refs(q, k, v, g, mask):
    """(Pallas, plain) references: (out, lse, dq, dk, dv) each; the
    backwards on the Pallas forward's out and lse (no row here is fully
    masked: the two forwards agree)."""
    pallas = _pallas(q, k, v, mask, g, np.float32)
    tm = None if mask is None else torch.from_numpy(mask)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    out, lse = flash_attention_plain(*t, tm, with_stats=True)
    grads = flash_attention_backward_plain(*t, tm, torch.from_numpy(pallas[0]),
                                           torch.from_numpy(pallas[1]), torch.from_numpy(g))
    return pallas, [out.numpy(), lse.numpy()] + [a.numpy() for a in grads]


@pytest.mark.parametrize("lq,lk,d,masked", CASES)
def test_x3_matches_pallas_and_plain(lq, lk, d, masked):
    """The forward emulation (out, lse) and the backward's on the Pallas
    forward's out and lse (dq, dk, dv), each within REL of max |ref| of the
    Pallas kernels at 64 x 64 blocks and of the plain versions."""
    q, k, v, g, mask = _case(lq, lk, d, masked)
    pallas, plain = _refs(q, k, v, g, mask)
    got = list(x3_forward(q, k, v, mask)) + list(x3_backward(q, k, v, mask, *pallas[:2], g))
    for name, a, w, p in zip(("out", "lse", "dq", "dk", "dv"), got, pallas, plain):
        assert np.isfinite(a).all(), name
        _within(a, w, f"{name} against Pallas")
        _within(a, p, f"{name} against plain")


def test_x3_one_term_control_fails():
    """One TF32 product a product, the same plan: the forward and every
    gradient miss REL against both references."""
    q, k, v, g, mask = _case(129, 129, 64, "middle")
    pallas, plain = _refs(q, k, v, g, mask)
    got = list(x3_forward(q, k, v, mask, terms=1)) + \
        list(x3_backward(q, k, v, mask, *pallas[:2], g, terms=1))
    for name, a, w, p in zip(("out", "lse", "dq", "dk", "dv"), got, pallas, plain):
        if name == "lse":  # log l of a sum of p: TF32 there moves it by less
            continue
        for want, what in ((w, "Pallas"), (p, "plain")):
            with pytest.raises(AssertionError):
                _within(a, want, f"{name} against {what}")


def test_x3_fully_masked_entry():
    """An entry with every key masked: NaN rows and lse −∞ in the forward,
    in the same places as the plain version (the Pallas kernel gives the
    mean of v there instead, pinned in tests/test_torch_flash.py); its dq,
    dk and dv 0 in the backward; the other entry within REL of the plain
    versions."""
    (q, k, v, g), mask = _inputs(31, 2, 2, 65, 129, 40, True, torch.float32)
    mask[1] = True
    out, lse = x3_forward(q, k, v, mask)
    tm = torch.from_numpy(mask)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    p_out, p_lse = flash_attention_plain(*t, tm, with_stats=True)
    assert np.isnan(out[1]).all() and np.isneginf(lse[1]).all()
    assert np.array_equal(np.isnan(out), torch.isnan(p_out).numpy())
    assert np.array_equal(np.isneginf(lse), torch.isneginf(p_lse).numpy())
    _within(out[0], p_out[0].numpy(), "out")
    _within(lse[0], p_lse[0].numpy(), "lse")
    grads = x3_backward(q, k, v, mask, p_out.numpy(), p_lse.numpy(), g)
    want = flash_attention_backward_plain(*t, tm, p_out, p_lse, torch.from_numpy(g))
    for name, a, w in zip(("dq", "dk", "dv"), grads, want):
        assert not a[1].any() and not w[1].any(), name
        _within(a[0], w[0].numpy(), name)
