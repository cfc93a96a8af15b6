"""The served mask head and the int8 serving row of the port against
lc2is_tpu, same inputs from a numpy seed.  JAX runs its Pallas entries in
interpret mode; the port runs its plain versions (CPU tensors).

Stated bounds:
- masks: equal, except at a pixel where the two best blended scores of the
  port's plain version lie within 1e-5 (f32) or 1e-2 (bf16) of each other;
- quantisers: int8 codes equal, scales within 1 ulp;
- int8 ops: max |Δ| <= 2e-3 · max |ref| (f32; a code that rounds the other
  way at a .5 boundary moves an output by one step of its scale).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import (TINY_SWIN, jax_ref, load_jax_params, numpy_params,
                             small_denseclip_cfg, t)

from lc2is_tpu.models import zoo as jzoo
from lc2is_tpu.nn.swin import window_partition, window_reverse
from lc2is_tpu.ops import quant as jquant
from lc2is_tpu.ops.attention_block import fused_attn_block as jax_fused_attn_block
from lc2is_tpu.ops.upsample_argmax import score_upsample_argmax as jax_score_upsample_argmax
from lc2is_tpu.ops.upsample_argmax import upsample_argmax as jax_upsample_argmax
from lc2is_tpu.ops.window_attention import fused_window_block, pad_labels, region_labels
from lc2is_tpu_torch.models import zoo
from lc2is_tpu_torch.ops import quant
from lc2is_tpu_torch.ops.attention_block import fused_attn_block_q
from lc2is_tpu_torch.ops.swin_window import swin_window_block_q
from lc2is_tpu_torch.ops.upsample_argmax import (l2_normalize, score_map_plain,
                                                 score_upsample_argmax, upsample_argmax,
                                                 upsample_blend_plain)

NEAR_TIE = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
INT8_REL = 2e-3
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _assert_masks_near_ties(got, want, blended, dtype):
    """got == want except where the top two of ``blended`` (B, K, H, W) are
    within the near-tie bound."""
    want = torch.from_numpy(np.array(want)).int()
    assert got.dtype == torch.int32 and got.shape == want.shape
    differ = got != want
    top2 = blended.topk(2, dim=1).values
    gap = (top2[:, 0] - top2[:, 1])[differ]
    assert gap.le(NEAR_TIE[dtype]).all(), (int(differ.sum()), gap.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grid,k,c", [(16, 151, 64), (8, 7, 32), (128, 5, 16)])
def test_score_upsample_argmax(dtype, grid, k, c):
    """The shapes of tests/test_upsample_kernel.py:54-92 (grid 128: the
    served grid)."""
    rs = np.random.RandomState(grid + k + c)
    b = 1 if grid == 128 else 2
    v = torch.from_numpy(rs.randn(b, grid * grid, c).astype(np.float32)).to(dtype)
    tn = l2_normalize(torch.from_numpy(rs.randn(b, k, c).astype(np.float32)).to(dtype), 2)
    # block_rows=2: the same function (row blocks walk the grid), a 4x smaller
    # unrolled kernel body to compile in interpret mode
    want = jax.jit(lambda a, b_: jax_score_upsample_argmax(a, b_, grid, r=4, interpret=True,
                                                           block_rows=2))(
        jnp.asarray(v.float().numpy(), JDT[dtype]), jnp.asarray(tn.float().numpy(), JDT[dtype]))
    got = score_upsample_argmax(v, tn, grid, r=4)
    _assert_masks_near_ties(got, want, upsample_blend_plain(score_map_plain(v, tn, grid), 4),
                            dtype)


def test_upsample_argmax():
    rs = np.random.RandomState(7)
    x = rs.randn(2, 151, 12, 16).astype(np.float32)
    want = jax_ref(lambda a: jax_upsample_argmax(a, r=4, interpret=True, block_rows=2), x)
    _assert_masks_near_ties(upsample_argmax(t(x), r=4), want,
                            upsample_blend_plain(t(x), 4), torch.float32)


def test_quantizers():
    rs = np.random.RandomState(0)
    w = (rs.randn(64, 96) * rs.uniform(0.1, 3.0, (64, 1))).astype(np.float32)
    h = (rs.randn(40, 96) * rs.uniform(0.01, 10.0, (40, 1))).astype(np.float32)
    pairs = [(quant.quantize_weight(t(w)), jquant.quantize_weight(jnp.asarray(w))),
             (quant.quant_act(t(h)), jquant.quant_act(jnp.asarray(h)))]
    for (q, s), (jq, js) in pairs:
        assert q.dtype == torch.int8 and tuple(s.shape) == js.shape
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_max_ulp(s.numpy(), np.asarray(js), maxulp=1)
    wq, ws = quant.quantize_weight(t(w))
    want = jquant.qdot(jnp.asarray(h), *jquant.quantize_weight(jnp.asarray(w)))
    np.testing.assert_allclose(quant.qdot(t(h), wq, ws).numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)


def _close_rel(got, want, rel=INT8_REL):
    want = np.asarray(want, np.float32)
    err = np.abs(got.detach().float().numpy() - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("activation,ln_position", [("gelu", "pre"), ("relu", "post")])
def test_fused_mlp_q(activation, ln_position):
    rs = np.random.RandomState(1)
    n, c, f = 50, 96, 384
    args = [rs.randn(n, c), 1 + 0.1 * rs.randn(c), 0.1 * rs.randn(c), rs.randn(f, c) / np.sqrt(c),
            0.1 * rs.randn(f), rs.randn(c, f) / np.sqrt(f), 0.1 * rs.randn(c)]
    args = [a.astype(np.float32) for a in args]
    kw = dict(activation=activation, ln_position=ln_position)
    want = jax_ref(lambda *a: jquant.fused_mlp_q(*a, interpret=True, **kw), *args)
    _close_rel(quant.fused_mlp_q(*map(t, args), **kw), want)


@pytest.mark.parametrize("l", [7, 64])
def test_fused_attn_block_q(l):
    rs = np.random.RandomState(2)
    b, p, c, heads = 2, 40, 64, 4
    args = [rs.randn(b, p, c), rs.randn(b, l, c), rs.randn(b, l, c),
            rs.randn(c, c) / np.sqrt(c), 0.1 * rs.randn(c), rs.randn(c, c) / np.sqrt(c),
            0.1 * rs.randn(c), 1 + 0.1 * rs.randn(c), 0.1 * rs.randn(c)]
    args = [a.astype(np.float32) for a in args]
    want = jax_ref(lambda *a: jax_fused_attn_block(*a, heads, interpret=True, quant=True), *args)
    _close_rel(fused_attn_block_q(*map(t, args), heads), want)


@pytest.mark.parametrize("shift", [0, 3])
def test_swin_window_block_q(shift):
    """A ragged canvas (16² padded to 21², so pad tokens), shifted and not
    (region masks), against fused_window_block(quant=True) on the pad / roll /
    partition layout of lc2is_tpu/nn/swin.py:340-376."""
    b, h, w, c, heads, win = 2, 16, 16, 64, 4, 7
    hp = wp = 21
    rs = np.random.RandomState(4 + shift)
    args = [rs.randn(b, h, w, c), 1 + 0.1 * rs.randn(c), 0.5 * rs.randn(c),
            rs.randn(3 * c, c) / np.sqrt(c), 0.1 * rs.randn(3 * c), rs.randn(c, c) / np.sqrt(c),
            0.1 * rs.randn(c), 0.1 * rs.randn(heads, win * win, win * win)]
    args = [a.astype(np.float32) for a in args]

    def reference(x, *weights):
        xp = jnp.pad(x, ((0, 0), (0, hp - h), (0, wp - w), (0, 0)))
        if shift:
            xp = jnp.roll(xp, (-shift, -shift), axis=(1, 2))
        regions = region_labels(b, hp, wp, win, shift) if shift else None
        yw = fused_window_block(window_partition(xp, win), *weights, regions, heads,
                                interpret=True, pad_mask=pad_labels(b, h, w, hp, wp, win, shift),
                                quant=True)
        y = window_reverse(yw, win, hp, wp)
        if shift:
            y = jnp.roll(y, (shift, shift), axis=(1, 2))
        return y[:, :h, :w]

    want = jax_ref(reference, *args)
    _close_rel(swin_window_block_q(*map(t, args), heads, win, shift), want)


SLICE_KW = dict(cfg=small_denseclip_cfg(), class_names=tuple(f"c{i}" for i in range(7)),
                swin_cfg=TINY_SWIN)
X_SLICE = np.random.RandomState(3).randn(2, 3, 64, 64).astype(np.float32)


def test_slice_predict_masks():
    """The small PromptAuxCrossA at 64² (grid 16: the fused head) with
    predict_masks=True against JAX's xla path, whose unfused chain equals its
    kernel in f32 (tests/test_upsample_kernel.py:54); near-ties from JAX's
    own score-map head on the same weights."""
    jm = jzoo.PromptAuxCrossA(attn_impl="xla", predict_masks=True, **SLICE_KW)
    jmap = jzoo.PromptAuxCrossA(attn_impl="xla", **SLICE_KW)
    px = jnp.asarray(X_SLICE)
    params = numpy_params(jm, {"pixel_values": px})
    want = jax.jit(lambda p, a: (jm.apply(p, {"pixel_values": a}),
                                 jmap.apply(p, {"pixel_values": a})))(params, px)
    port = load_jax_params(zoo.PromptAuxCrossA(predict_masks=True, device="cpu", **SLICE_KW),
                           params)
    with torch.no_grad():
        got = port({"pixel_values": t(X_SLICE)})
    np.testing.assert_allclose(got["low_score_map"].numpy(), np.asarray(want[0]["low_score_map"]),
                               rtol=0, atol=1e-3)
    _assert_masks_near_ties(got["outputs"], want[0]["outputs"], t(want[1]["outputs"]),
                            torch.float32)


def test_slice_int8(monkeypatch):
    """The same model with quant_int8=True against the JAX package's Pallas
    path in interpret mode (one jitted forward).  Measured when written, on
    the CPU: mask agreement 0.99902 (4 of 8192 pixels), low score map max |Δ|
    1.4e-7 of max |ref| 9.5e-2 (the int8 swin MLPs agree to rounding); JAX
    forward 28.7 s of the test's 45 s."""
    monkeypatch.setenv("LC2IS_PALLAS_INTERPRET", "1")
    jm = jzoo.PromptAuxCrossA(predict_masks=True, quant_int8=True, **SLICE_KW)
    px = jnp.asarray(X_SLICE)
    params = numpy_params(jm, {"pixel_values": px})
    t0 = time.time()
    want = jax.jit(lambda p, a: jm.apply(p, {"pixel_values": a}))(params, px)
    jax.block_until_ready(want)
    jax_s = time.time() - t0
    port = load_jax_params(zoo.PromptAuxCrossA(predict_masks=True, quant_int8=True, device="cpu",
                                               **SLICE_KW), params)
    with torch.no_grad():
        got = port({"pixel_values": t(X_SLICE)})
    agree = (got["outputs"].numpy() == np.asarray(want["outputs"])).mean()
    low_ref = np.asarray(want["low_score_map"])
    low_err = np.abs(got["low_score_map"].numpy() - low_ref).max()
    print(f"int8 slice: mask agreement {agree:.5f}, low score map max |Δ| {low_err:.3e} "
          f"of max |ref| {np.abs(low_ref).max():.3e}; JAX forward {jax_s:.1f} s")
    assert agree >= 0.98
    assert low_err <= 2e-2 * np.abs(low_ref).max()


def test_int8_is_serving_only():
    """A forward in training mode, or with autograd needing a gradient
    through an int8 op, raises."""
    model = zoo.PromptAuxCrossA(quant_int8=True, device="cpu", **SLICE_KW)
    with pytest.raises(RuntimeError, match="serving only"):
        model({"pixel_values": t(X_SLICE)})
    x = torch.zeros(4, 96, requires_grad=True)
    w1, w2 = torch.zeros(384, 96), torch.zeros(96, 384)
    with pytest.raises(RuntimeError, match="serving only"):
        quant.fused_mlp_q(x, torch.ones(96), torch.zeros(96), w1, torch.zeros(384), w2,
                          torch.zeros(96))
