"""The arithmetic of the redesigned upsample kernels (TPU rows 4 and 5,
``lc2is_tpu_torch/csrc/upsample.cu``), emulated band by band and lane by
lane on the CPU and held against lc2is_tpu's Pallas kernels in interpret
mode (as the JAX package's own tests run them), against the VJP of
``lc2is_tpu.ops.upsample.upsample_tokens`` (``_adj_kernel`` at r 2, XLA's
VJP of ``_xla_reference`` at r 4) and against the port's plain versions, on
the same numpy-seeded inputs.

Forward at r 2 (``upsample2_kernel``): a thread owns one lane of a token's
channels at input column j and walks down a band of input rows with three
widened rows (above, current, below; output columns 2j, 2j+1 as
0.25·x[j-1] + 0.75·x[j] and 0.75·x[j] + 0.25·x[j+1], the neighbours clamped,
rounded to the element type); the band reads one halo row above and below,
clamped at the image edge; each input row gives output rows 2i (0.25 above
+ 0.75 current) and 2i+1 (0.75 current + 0.25 below), rounded once.
Adjoint at r 2 (``upsample2_adjoint_kernel``): a thread walks down the
output-gradient rows that reach its band, narrowing each over columns
2j-1 .. 2j+2 (0.25, 0.75, 0.75, 0.25; the clamped tap folded onto column 0
and W-1) and rounding it; dx row i sums the narrowed rows 2i-1 .. 2i+2 with
the same weights (folded onto row 0 and H-1), rounded once.  Other r: the
taps of each output coordinate from src = (o + 0.5)/r - 0.5 in double, each
dx lane from its 2r x 2r output-gradient lanes, zero weights skipped.
Every product and sum is rounded once, left to right (no fused
multiply-add), as the plain versions compute them.

Stated tolerance: bf16 bit for bit against the Pallas kernels and the JAX
VJP (the products of bf16 values and the fixed weights are exact in f32 and
their sums too), and bit for bit against the plain versions in both dtypes
(the same operations in the same order); f32 against JAX within 1e-6 of
max |JAX| (its sums run in other orders).  Controls that must fail: the
adjoint rounded in the old order (each column's H-adjoint rounded first),
and a band without its halo row (the band's own edge rows taken for the
rows beyond it).

The band height and the lane width are the launch's choices
(``band_rows``, ``lane_bytes``), mirrored here and held against the
constants of the source; the two entry points against their ctypes
bindings, and the wrapper's card path recorded on CPU tensors.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lc2is_tpu.ops.upsample import upsample_tokens as jax_upsample_tokens
from lc2is_tpu_torch.ops import _build
from lc2is_tpu_torch.ops import upsample as up
from lc2is_tpu_torch.ops.upsample import (upsample_tokens, upsample_tokens_adjoint_plain,
                                          upsample_tokens_plain)

SRC = (Path(__file__).resolve().parents[1] / "lc2is_tpu_torch" / "csrc" / "upsample.cu").read_text()
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
F32_REL = 1e-6


def _const(name):
    return int(eval(re.search(rf"constexpr int {name} = ([^;]+);", SRC).group(1)))


THREADS = _const("kThreads")
MIN_BLOCKS = {False: _const("kMinBlocks"), True: _const("kMinBlocksAdjoint")}


def lane_bytes(ptr_align, c, itemsize):
    """upsample.cu's lane_bytes: the widest of 16, 8, 4, 2 bytes (at least
    one element) dividing a token's channels and the pointers' alignment."""
    nb = 16
    while nb > itemsize:
        if (c * itemsize) % nb == 0 and ptr_align % nb == 0:
            return nb
        nb //= 2
    return itemsize


def band_rows(b, h, w, c, itemsize, adjoint, ptr_align=256):
    """upsample.cu's band height for a launch of the forward or the adjoint."""
    n = lane_bytes(ptr_align, c, itemsize) // itemsize
    chunks = -(-(w * (c // n)) // THREADS)
    hb = 16
    while hb > 1 and b * chunks * -(-h // hb) < MIN_BLOCKS[adjoint]:
        hb //= 2
    return hb


def _blend(wa, a, wb, b):
    """wa·a + wb·b in f32, each product and the sum rounded once."""
    return wa * a + wb * b


def _lanes(c, itemsize, align=256):
    n = lane_bytes(align, c, itemsize) // itemsize
    return [slice(c0, c0 + n) for c0 in range(0, c, n)]


def _tap(o, i, n, r):
    """upsample.cu's tap_weight, per element of the integer tensors o, i."""
    src = (o.double() + 0.5) / r - 0.5
    fl = torch.floor(src)
    f = (src - fl).float()
    a = fl.long().clamp(0, n - 1)
    b = (fl.long() + 1).clamp(0, n - 1)
    zero = torch.zeros_like(f)
    return torch.where(a == i, 1.0 - f, zero) + torch.where(b == i, f, zero)


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------


def _up2_band(xf, dt, i0, i1, halo):
    """Output rows 2·i0 .. 2·i1 of one band at r 2: (B, 2(i1 - i0), W, 2, n)."""
    _, h, w, _ = xf.shape
    j = torch.arange(w)
    jl, jr = (j - 1).clamp(min=0), (j + 1).clamp(max=w - 1)

    def widen(i):
        row = xf[:, i]
        return torch.stack([_blend(0.25, row[:, jl], 0.75, row),
                            _blend(0.75, row, 0.25, row[:, jr])], 2).to(dt).float()

    lo, hi = (0, h - 1) if halo else (i0, i1 - 1)
    prev, cur = widen(max(i0 - 1, lo)), widen(i0)
    rows = []
    for i in range(i0, i1):
        nxt = widen(min(i + 1, hi))
        rows += [_blend(0.25, prev, 0.75, cur).to(dt), _blend(0.75, cur, 0.25, nxt).to(dt)]
        prev, cur = cur, nxt
    return torch.stack(rows, 1)


def _up_any_band(xf, dt, i0, i1, r, halo):
    """Output rows r·i0 .. r·i1 of one band at any r: (B, r(i1 - i0), rW, n)."""
    _, h, w, _ = xf.shape
    ox = torch.arange(r * w)
    sx = (ox.double() + 0.5) / r - 0.5
    fx = (sx - torch.floor(sx)).float()[None, :, None]
    xa = torch.floor(sx).long().clamp(0, w - 1)
    xb = (torch.floor(sx).long() + 1).clamp(0, w - 1)
    lo, hi = (0, h - 1) if halo else (i0, i1 - 1)
    rows = []
    for oy in range(r * i0, r * i1):
        sy = (oy + 0.5) / r - 0.5
        fy = np.float32(sy - np.floor(sy))
        gy, fy = float(np.float32(1.0) - fy), float(fy)
        ya, yb = min(max(int(np.floor(sy)), lo), hi), min(max(int(np.floor(sy)) + 1, lo), hi)
        wa = _blend(1.0 - fx, xf[:, ya, xa], fx, xf[:, ya, xb]).to(dt).float()
        wb = _blend(1.0 - fx, xf[:, yb, xa], fx, xf[:, yb, xb]).to(dt).float()
        rows.append(_blend(gy, wa, fy, wb).to(dt))
    return torch.stack(rows, 1)


def emulate_forward(x, grid_hw, r, hb=None, halo=True):
    """upsample.cu's forward on (B, H·W, C): bands of hb input rows (the
    launch's when None), one lane of channels at a time."""
    b, p, c = x.shape
    h, w = grid_hw
    hb = hb or band_rows(b, h, w, c, x.element_size(), adjoint=False)
    out = torch.empty(b, r * h, r * w, c, dtype=x.dtype)
    for lane in _lanes(c, x.element_size()):
        xf = x.reshape(b, h, w, c)[..., lane].float()
        for i0 in range(0, h, hb):
            i1 = min(i0 + hb, h)
            if r == 2:
                band = _up2_band(xf, x.dtype, i0, i1, halo).reshape(b, 2 * (i1 - i0), 2 * w, -1)
            else:
                band = _up_any_band(xf, x.dtype, i0, i1, r, halo)
            out[:, r * i0:r * i1, :, lane] = band
    return out.reshape(b, r * h * r * w, c)


# ---------------------------------------------------------------------------
# the adjoint
# ---------------------------------------------------------------------------


def _narrow2(gf, dt, y):
    """Output-gradient row y narrowed to every column j at r 2, rounded."""
    w = gf.shape[2] // 2
    j = torch.arange(w)
    left, right = (j == 0)[:, None], (j == w - 1)[:, None]
    row = gf[:, y]
    a, b_ = row[:, (2 * j - 1).clamp(min=0)], row[:, 2 * j]
    c, d = row[:, 2 * j + 1], row[:, (2 * j + 2).clamp(max=2 * w - 1)]
    s = torch.where(left, 1.0, 0.75) * b_
    s = torch.where(left, s, 0.25 * a + s)
    s = s + torch.where(right, 1.0, 0.75) * c
    s = torch.where(right, s, s + 0.25 * d)
    return s.to(dt).float()


def _adj2_band(gf, dt, i0, i1, h, halo):
    """dx rows i0 .. i1 of one band at r 2.  halo=False: the control, the
    band's edges taken for the image's."""
    top_row, bottom_row = (0, h - 1) if halo else (i0, i1 - 1)
    na = _narrow2(gf, dt, 2 * i0 - 1) if i0 > top_row else None
    nb = _narrow2(gf, dt, 2 * i0)
    rows = []
    for i in range(i0, i1):
        top, bottom = i == top_row, i == bottom_row
        nc = _narrow2(gf, dt, 2 * i + 1)
        nd = None if bottom else _narrow2(gf, dt, 2 * i + 2)
        s = (1.0 if top else 0.75) * nb
        if not top:
            s = 0.25 * na + s
        s = s + (1.0 if bottom else 0.75) * nc
        if not bottom:
            s = s + 0.25 * nd
        rows.append(s.to(dt))
        na, nb = nc, nd
    return torch.stack(rows, 1)


def _masked_sum(terms):
    """Σ of (weight, value) pairs left to right, pairs of weight 0 skipped
    per element (an element's sum starts at its first nonzero pair)."""
    acc = started = None
    for wgt, val in terms:
        t = wgt * val
        nz = wgt != 0
        if acc is None:
            acc, started = torch.where(nz, t, torch.zeros_like(t)), nz.expand_as(t).clone()
            continue
        acc = torch.where(nz, torch.where(started, acc + t, t), acc)
        started = started | nz
    return acc


def _adj_any_band(gf, dt, i0, i1, h, r, halo):
    """dx rows i0 .. i1 of one band at any r."""
    _, oh, ow, _ = gf.shape
    w = ow // r
    j = torch.arange(w)[:, None]
    top, bottom = (0, h - 1) if halo else (i0, i1 - 1)
    rows = []
    for i in range(i0, i1):
        terms = []
        for y in range(max(r * i - r // 2, r * top), min(r * i - r // 2 + 2 * r, r * bottom + r)):
            # halo=False: the band alone, its rows numbered from 0
            wy = float(_tap(torch.tensor(y - r * top), torch.tensor(i - top), bottom - top + 1, r))
            if wy == 0.0:
                continue
            xo = r * j - r // 2 + torch.arange(2 * r)[None]
            valid = (xo >= 0) & (xo < ow)
            wx = torch.where(valid, _tap(xo, j, w, r), 0.0)
            vals = gf[:, y][:, xo.clamp(0, ow - 1)]  # (B, W, 2r, n)
            narrow = _masked_sum([(wx[None, :, k, None], vals[:, :, k]) for k in range(2 * r)])
            terms.append((torch.tensor(wy), narrow.to(dt).float()))
        rows.append(_masked_sum(terms).to(dt))
    return torch.stack(rows, 1)


def emulate_adjoint(g, grid_hw, r, hb=None, halo=True):
    """upsample.cu's adjoint on (B, rH·rW, C) -> (B, H·W, C)."""
    b, _, c = g.shape
    h, w = grid_hw
    hb = hb or band_rows(b, h, w, c, g.element_size(), adjoint=True)
    dx = torch.empty(b, h, w, c, dtype=g.dtype)
    for lane in _lanes(c, g.element_size()):
        gf = g.reshape(b, r * h, r * w, c)[..., lane].float()
        for i0 in range(0, h, hb):
            i1 = min(i0 + hb, h)
            dx[:, i0:i1, :, lane] = (_adj2_band(gf, g.dtype, i0, i1, h, halo) if r == 2 else
                                     _adj_any_band(gf, g.dtype, i0, i1, h, r, halo))
    return dx.reshape(b, h * w, c)


def h_first_adjoint(g, grid_hw, r):
    """The control: the adjoint in the old order, each output-gradient
    column's H-adjoint rounded to the element type first."""
    b, _, c = g.shape
    h, w = grid_hw
    tall = up._adjoint_sum(g.reshape(b, r * h, r * w, c), 1, h, r).to(g.dtype)
    return up._adjoint_sum(tall, 2, w, r).to(g.dtype).reshape(b, h * w, c)


# ---------------------------------------------------------------------------
# the JAX reference
# ---------------------------------------------------------------------------


def _inputs(b, hw, c, r, dtype, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, hw[0] * hw[1], c).astype(np.float32)
    g = rs.randn(b, hw[0] * hw[1] * r * r, c).astype(np.float32)
    return torch.from_numpy(x).to(dtype), torch.from_numpy(g).to(dtype)


def _jax_fwd_vjp(x, g, hw, r):
    """lc2is_tpu's upsample_tokens (interpret mode) and its VJP at g."""
    jdt = JDT[x.dtype]
    xj = jnp.asarray(x.float().numpy(), jdt)
    out, vjp = jax.vjp(lambda a: jax_upsample_tokens(a, hw, r, interpret=True), xj)
    (dx,) = vjp(jnp.asarray(g.float().numpy(), jdt))
    return (torch.from_numpy(np.array(out.astype(jnp.float32))),
            torch.from_numpy(np.array(dx.astype(jnp.float32))))


def _agree(got, want, dtype):
    """bf16: equal bit for bit; f32: within F32_REL of max |want|."""
    got = got.float()
    if dtype == torch.bfloat16:
        assert torch.equal(got, want), int((got != want).sum())
    else:
        lim = F32_REL * want.abs().max().item()
        assert (got - want).abs().max().item() <= lim


# (grid, C, r, band rows or None for the launch's): the four grids, a band
# split with a ragged last band (17 = 4·4 + 1, 9 = 4·2 + 1), C 24 / 8 / 3
# for 16- and 2-byte bf16 lanes, one row and one column, and a main-path
# grid scaled down (16², C 64) at the launch's band
CASES = [((8, 8), 24, 2, None), ((5, 7), 24, 2, 2), ((1, 3), 8, 2, None),
         ((17, 9), 24, 2, 4), ((17, 9), 3, 2, 8), ((9, 1), 8, 2, 4), ((16, 16), 64, 2, None),
         ((8, 8), 24, 4, None), ((5, 7), 8, 4, 2), ((1, 3), 3, 4, None), ((17, 9), 24, 4, 4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw,c,r,hb", CASES)
def test_kernels_match_pallas_and_jax_vjp(dtype, hw, c, r, hb):
    """The emulated forward against the Pallas ``_kernel``, the emulated
    adjoint against the VJP (``_adj_kernel`` at r 2)."""
    x, g = _inputs(2, hw, c, r, dtype, seed=hw[0] * 31 + c + r)
    want_y, want_dx = _jax_fwd_vjp(x, g, hw, r)
    _agree(emulate_forward(x, hw, r, hb), want_y, dtype)
    _agree(emulate_adjoint(g, hw, r, hb), want_dx, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw,c,r,hb", CASES)
def test_kernels_match_plain_versions_bit_for_bit(dtype, hw, c, r, hb):
    """The same operations in the same order: equal to the plain versions."""
    x, g = _inputs(2, hw, c, r, dtype, seed=hw[1] * 7 + c)
    assert torch.equal(emulate_forward(x, hw, r, hb), upsample_tokens_plain(x, hw, r))
    assert torch.equal(emulate_adjoint(g, hw, r, hb), upsample_tokens_adjoint_plain(g, hw, r))


@pytest.mark.parametrize("r", [2, 4])
@pytest.mark.parametrize("hw", [(8, 8), (5, 7), (17, 9)])
def test_port_vjp_equals_jax_vjp_bf16(r, hw):
    """upsample_tokens on the CPU (its autograd Function, the plain forward
    and adjoint) against lc2is_tpu's forward and VJP, bf16 bit for bit."""
    x, g = _inputs(2, hw, 16, r, torch.bfloat16, seed=r + hw[0])
    want_y, want_dx = _jax_fwd_vjp(x, g, hw, r)
    xt = x.clone().requires_grad_()
    y = upsample_tokens(xt, hw, r)
    (dx,) = torch.autograd.grad(y, xt, g)
    assert torch.equal(y.detach().float(), want_y)
    assert torch.equal(dx.float(), want_dx)
    assert torch.equal(upsample_tokens_adjoint_plain(g, hw, r).float(), want_dx)


@pytest.mark.parametrize("r", [2, 4])
@pytest.mark.parametrize("hw", [(8, 8), (5, 7), (17, 9)])
def test_control_h_first_rounding_fails(r, hw):
    """The old order (each column's H-adjoint rounded first), and autograd
    through the plain forward, which rounds so too, differ from JAX's VJP in
    bf16 on more than a tenth of the elements."""
    x, g = _inputs(2, hw, 16, r, torch.bfloat16, seed=r + hw[0])
    _, want_dx = _jax_fwd_vjp(x, g, hw, r)
    old = h_first_adjoint(g, hw, r).float()
    xt = x.clone().requires_grad_()
    (auto,) = torch.autograd.grad(upsample_tokens_plain(xt, hw, r), xt, g)
    for wrong in (old, auto.float()):
        assert int((wrong != want_dx).sum()) > want_dx.numel() // 10


@pytest.mark.parametrize("r", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_control_band_without_halo_fails(r, dtype):
    """Bands of 4 rows over a grid of 17 without their halo rows disagree
    with JAX, forward and adjoint, in both dtypes."""
    hw = (17, 9)
    x, g = _inputs(2, hw, 8, r, dtype, seed=11)
    want_y, want_dx = _jax_fwd_vjp(x, g, hw, r)
    lim = F32_REL * want_y.abs().max().item()
    assert (emulate_forward(x, hw, r, 4, halo=False).float() - want_y).abs().max() > lim
    lim = F32_REL * want_dx.abs().max().item()
    assert (emulate_adjoint(g, hw, r, 4, halo=False).float() - want_dx).abs().max() > lim


# ---------------------------------------------------------------------------
# the launch's choices and the C entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c,itemsize,align,want", [
    (512, 2, 256, 16), (24, 2, 256, 16), (8, 2, 256, 16), (3, 2, 256, 2), (12, 2, 256, 8),
    (512, 2, 2, 2), (512, 2, 4, 4), (3, 4, 256, 4), (6, 4, 256, 8), (512, 4, 256, 16)])
def test_lane_width(c, itemsize, align, want):
    assert lane_bytes(align, c, itemsize) == want


@pytest.mark.parametrize("b,grid,c,adjoint,want", [
    (16, 16, 768, False, 1), (16, 32, 384, False, 2), (16, 16, 512, False, 1),
    (16, 32, 512, False, 2), (16, 64, 512, False, 8), (8, 64, 512, False, 4),
    (8, 16, 768, True, 1), (8, 32, 384, True, 2), (8, 16, 512, True, 1), (8, 32, 512, True, 2),
    (8, 64, 512, True, 8), (2, 17, 24, False, 1)])
def test_band_rows_at_the_main_path_shapes(b, grid, c, adjoint, want):
    """The band height of each main-path launch (batch 16 forward, batch 8
    step's forward and adjoint) with the source's kThreads, kMinBlocks and
    kMinBlocksAdjoint."""
    assert (THREADS, MIN_BLOCKS[False], MIN_BLOCKS[True]) == (256, 1056, 528)
    assert band_rows(b, grid, grid, c, 2, adjoint) == want


def _decl(name):
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)', SRC).group(1).split(",")
    kinds = {"void*": _build.ctypes.c_void_p, "int": _build.ctypes.c_int}
    return [kinds["void*" if "*" in a else a.split()[0]] for a in params]


@pytest.mark.parametrize("name", ["lc2_upsample", "lc2_upsample_adjoint"])
def test_entry_points_match_their_bindings(name):
    assert _decl(name) == list(_build.SIGNATURES[name])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrappers_launch_forward_and_adjoint(monkeypatch, dtype):
    """The card path on CPU tensors, the launches recorded: the forward and,
    through autograd, the adjoint, each once, with arguments of the
    argtypes' kinds and a fresh output of the right shape."""
    calls = []

    def launch(name, dev, *a):
        calls.append((name, a))

    monkeypatch.setattr(_build, "launch", launch)
    monkeypatch.setattr(_build, "stream_of", lambda t_: 0)
    monkeypatch.setattr(up, "use_kernel", lambda t_: True)
    x = torch.zeros(2, 15, 24, dtype=dtype, requires_grad=True)
    before = (upsample_tokens.launches, up.upsample_tokens_adjoint.launches)
    y = upsample_tokens(x, (3, 5), 2)
    (dx,) = torch.autograd.grad(y, x, torch.zeros_like(y))
    assert [n for n, _ in calls] == ["lc2_upsample", "lc2_upsample_adjoint"]
    assert y.shape == (2, 60, 24) and dx.shape == (2, 15, 24) and dx.dtype == dtype
    assert (upsample_tokens.launches, up.upsample_tokens_adjoint.launches) == (
        before[0] + 1, before[1] + 1)
    kinds = {_build.ctypes.c_void_p: (int,), _build.ctypes.c_int: (int,)}
    for name, args in calls:
        assert len(args) == len(_build.SIGNATURES[name])
        for a, t_ in zip(args, _build.SIGNATURES[name]):
            assert isinstance(a, kinds[t_]), (name, a, t_)
        assert args[3:8] == (2, 3, 5, 24, 2)
