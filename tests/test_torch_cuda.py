"""The Hopper kernels on the card, at shapes the 512² main path does not give
them: ragged row, key and window tiles, odd grids, other head widths, a
window shrunk to a small grid, and a small whole model.  Each kernel is held
against its plain PyTorch version on the same CUDA tensors.

These tests need an NVIDIA GPU (sm_90a) and nvcc; elsewhere they skip.  They
import neither jax nor ``tests/conftest.py``'s JAX set-up, so on a machine
with the card they run as

    python -m pytest --noconftest -o markers=cuda -p no:cacheprovider tests/test_torch_cuda.py -q

Stated tolerance, kernel against plain version: f32 |Δ| <= 2e-4 + 2e-4·|ref|
(both sum in f32, in other orders); bf16 |Δ| <= 5e-2 + 2e-2·|ref| (the two
round intermediates to bf16 at the same points, but sum in other orders).
Gradients (the backward kernels against autograd through the plain
versions) are held norm-relative, ‖Δ‖ / ‖ref‖, because the weight gradients
are sums over every token: f32 <= 1e-4, bf16 <= 2e-2 (the plain backward
rounds every intermediate to bf16, the kernels accumulate in f32).
Masks (the argmax head) equal their plain version's except at near-ties, a
pixel whose two best blended scores are within 1e-5 (f32) or, where each
side rounds its scores to bf16, two bf16 steps at the largest score (a score
differs by at most one step, and the blend is convex).
Int8 kernels: |Δ| <= 1e-3 · max |ref| (f32), 2e-2 · max |ref| (bf16): a code
that rounds the other way moves an output by one step of its scale.
"""

import numpy as np
import pytest
import torch

from lc2is_tpu_torch.ops.attention_block import (fused_attn_block, fused_attn_block_bwd,
                                                 fused_attn_block_plain, fused_attn_block_q,
                                                 fused_attn_block_q_plain)
from lc2is_tpu_torch.ops.flash_attention import (flash_attention, flash_attention_backward_plain,
                                                 flash_attention_bwd, flash_attention_plain)
from lc2is_tpu_torch.ops.fused_ce import upsampled_cross_entropy, upsampled_cross_entropy_plain
from lc2is_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_plain
from lc2is_tpu_torch.ops.quant import fused_mlp_q, fused_mlp_q_plain
from lc2is_tpu_torch.ops.swin_window import (swin_window_block, swin_window_block_bwd,
                                             swin_window_block_plain, swin_window_block_q,
                                             swin_window_block_q_plain)
from lc2is_tpu_torch.ops.upsample_argmax import (l2_normalize, score_map_plain,
                                                 score_upsample_argmax,
                                                 score_upsample_argmax_plain, upsample_argmax,
                                                 upsample_argmax_plain, upsample_blend_plain)
from lc2is_tpu_torch.ops.upsample import (upsample_tokens, upsample_tokens_adjoint,
                                          upsample_tokens_plain)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=2e-4, rtol=2e-4), torch.bfloat16: dict(atol=5e-2, rtol=2e-2)}
INT8_REL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]
# attention outputs are averages of v, far below 1 over many keys (about 0.05
# over 1025 unit-normal keys), so TOL's bf16 atol would pass a kernel that
# dropped a key tile: bf16 flash is held to a share of the largest output
FLASH_BF16_REL = 2e-2


def flash_tol(want):
    if want.dtype == torch.float32:
        return TOL[torch.float32]
    return dict(atol=FLASH_BF16_REL * want.float().abs().max().item(), rtol=0)


def _key_mask(rs, lk, masked, device):
    """Key-padding mask (B = 3, True = ignore) of the flash tests, entry 0
    fully masked: None; True: a random kept prefix per entry; "middle":
    keys 20-40 of every 64-key tile and a random quarter of the rest, so
    that tiles have dead 8-key groups and partly kept ones in their middle
    (key 0 kept in entries 1 and 2)."""
    if not masked:
        return None
    if masked == "middle":
        keys = np.arange(lk)
        mask = np.broadcast_to(((keys % 64) >= 20) & ((keys % 64) < 40), (3, lk))
        mask = torch.from_numpy(mask | (rs.rand(3, lk) < 0.25))
        mask[1:, 0] = False
    else:
        mask = torch.from_numpy(np.arange(lk)[None] >= rs.randint(1, lk + 1, size=3)[:, None])
    mask[0] = True
    return mask.to(device)


@pytest.fixture
def cuda():
    """The card; the test skips where there is none (decided here, at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernels run only on the card")
    return torch.device("cuda")


def _rand(rs, *shape, scale=1.0, offset=0.0, dtype=torch.float32, device="cuda"):
    return torch.from_numpy((offset + scale * rs.standard_normal(shape)).astype(np.float32)
                            ).to(device=device, dtype=dtype)


def _check(fn, kernel_fn, plain_fn, *args, **kw):
    """Run the kernel (one launch counted) and its plain version; compare."""
    before = fn.launches
    got = kernel_fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = plain_fn(*args, **kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), **TOL[got.dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_tok,c,act,pos,residual", [
    (77, 96, "gelu", "pre", True),
    (33, 768, "gelu", "pre", True),
    (50, 512, "relu", "post", True),
    (5, 128, "relu", "post", False),
    (40, 192, "gelu", "pre", False),
])
def test_fused_mlp_kernel(cuda, dtype, n_tok, c, act, pos, residual):
    rs = np.random.RandomState(0)
    f = 4 * c
    args = (_rand(rs, n_tok, c, dtype=dtype), _rand(rs, c, scale=0.1, offset=1.0),
            _rand(rs, c, scale=0.1), _rand(rs, f, c, scale=c ** -0.5), _rand(rs, f, scale=0.1),
            _rand(rs, c, f, scale=f ** -0.5), _rand(rs, c, scale=0.1))
    _check(fused_mlp, fused_mlp, fused_mlp_plain, *args, activation=act, ln_position=pos,
           residual=residual)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h,w,c,heads,shift,residual", [
    (128, 128, 96, 3, 0, True),    # swin-small stage 1 at 512², HF-padded to 133²
    (128, 128, 96, 3, 3, False),
    (64, 64, 192, 6, 0, True),     # stage 2
    (64, 64, 192, 6, 3, False),
    (32, 32, 384, 12, 0, True),    # stage 3
    (32, 32, 384, 12, 3, False),
    (16, 16, 768, 24, 0, True),    # stage 4 (TPU row 10)
    (16, 16, 768, 24, 3, False),
])
def test_swin_window_block_bwd_kernel_stage_shapes(cuda, dtype, h, w, c, heads, shift, residual):
    """The swin backward (TPU rows 7 and 10) at every swin-small stage shape
    of a 512² image, window 7."""
    rs = np.random.RandomState(h + shift)
    args = [_rand(rs, 1, h, w, c, dtype=dtype), _rand(rs, c, scale=0.1, offset=1.0),
            _rand(rs, c, scale=0.5), _rand(rs, 3 * c, c, scale=c ** -0.5),
            _rand(rs, 3 * c, scale=0.1), _rand(rs, c, c, scale=c ** -0.5), _rand(rs, c, scale=0.1),
            _rand(rs, heads, 49, 49, scale=0.1)]
    g = _rand(rs, 1, h, w, c, dtype=dtype)
    kw = dict(num_heads=heads, win=7, shift=shift, residual=residual)
    _check_grads(swin_window_block_bwd, lambda *a: swin_window_block(*a, **kw),
                 lambda *a: swin_window_block_plain(*a, **kw), args, g)


@pytest.mark.parametrize("b,h,w,c,heads,win,shift,residual", [
    (2, 18, 23, 96, 3, 7, 3, True),    # H, W no multiples of the window, odd head count
    (2, 20, 20, 160, 5, 7, 3, False),  # 5 heads of 32
    (3, 14, 14, 96, 3, 7, 0, False),   # whole windows, no HF pad
    (2, 16, 16, 128, 2, 8, 3, True),   # window 8: 64 tokens, a full key tile; dh 64
    (2, 17, 19, 64, 4, 8, 0, False),   # window 8, HF-padded, dh 16
    (1, 9, 9, 192, 6, 8, 5, True),     # window 8, shift 5
])
def test_swin_window_block_bwd_kernel_tile_edges(cuda, b, h, w, c, heads, win, shift, residual):
    """The bf16 tensor-core body of the swin backward at its tile edges:
    windows of 49 and 64 tokens in a 64-row tile, HF padding, odd head
    counts, every head width, shifted and not, with and without the
    residual."""
    rs = np.random.RandomState(b * h * w + c + shift)
    dtype = torch.bfloat16
    args = [_rand(rs, b, h, w, c, dtype=dtype), _rand(rs, c, scale=0.1, offset=1.0),
            _rand(rs, c, scale=0.5), _rand(rs, 3 * c, c, scale=c ** -0.5),
            _rand(rs, 3 * c, scale=0.1), _rand(rs, c, c, scale=c ** -0.5), _rand(rs, c, scale=0.1),
            _rand(rs, heads, win * win, win * win, scale=0.1)]
    g = _rand(rs, b, h, w, c, dtype=dtype)
    kw = dict(num_heads=heads, win=win, shift=shift, residual=residual)
    _check_grads(swin_window_block_bwd, lambda *a: swin_window_block(*a, **kw),
                 lambda *a: swin_window_block_plain(*a, **kw), args, g)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p,l,c,heads", [
    (40, 7, 512, 8),
    (33, 151, 512, 8),
    (70, 1030, 512, 8),
    (16, 17, 64, 4),
    (45, 64, 128, 4),
])
def test_fused_attn_block_kernel(cuda, dtype, p, l, c, heads):
    rs = np.random.RandomState(1)
    args = (_rand(rs, 2, p, c, dtype=dtype), _rand(rs, 2, l, c, dtype=dtype),
            _rand(rs, 2, l, c, dtype=dtype), _rand(rs, c, c, scale=c ** -0.5),
            _rand(rs, c, scale=0.1), _rand(rs, c, c, scale=c ** -0.5), _rand(rs, c, scale=0.1),
            _rand(rs, c, scale=0.1, offset=1.0), _rand(rs, c, scale=0.1))
    _check(fused_attn_block, fused_attn_block, fused_attn_block_plain, *args, heads)


def _attn_args(rs, b, p, l, c, dtype=torch.bfloat16):
    return (_rand(rs, b, p, c, dtype=dtype), _rand(rs, b, l, c, dtype=dtype),
            _rand(rs, b, l, c, dtype=dtype), _rand(rs, c, c, scale=c ** -0.5),
            _rand(rs, c, scale=0.1), _rand(rs, c, c, scale=c ** -0.5), _rand(rs, c, scale=0.1),
            _rand(rs, c, scale=0.1, offset=1.0), _rand(rs, c, scale=0.1))


@pytest.mark.parametrize("l", [1, 63, 64, 65, 151, 1025])
@pytest.mark.parametrize("p,c,heads", [(65, 64, 4), (63, 128, 4), (130, 256, 4), (1, 512, 8),
                                       (100, 512, 8)])
def test_fused_attn_block_bf16_tile_edges(cuda, l, p, c, heads):
    """The bf16 tensor-core body (64-query blocks, 64-key tiles, 128 x 128
    GEMM tiles) at query counts off the 64-row tile, key counts at and
    around the 64-key tile and DenseClip's 1025, every C of the wrapper's set
    and dh 16, 32 and 64."""
    rs = np.random.RandomState(p + l + c)
    _check(fused_attn_block, fused_attn_block, fused_attn_block_plain,
           *_attn_args(rs, 2, p, l, c), heads)


def test_fused_attn_block_bf16_control_fails(cuda):
    """The control that must fail: the kernel over all keys but the last
    64-key tile (L = 151: keys 0-127) is outside the bf16 bound of the plain
    version over all keys."""
    rs = np.random.RandomState(3)
    args = _attn_args(rs, 2, 130, 151, 512)
    want = fused_attn_block_plain(*args, 8).float()
    short = (args[0], args[1][:, :128].contiguous(), args[2][:, :128].contiguous()) + args[3:]
    got = fused_attn_block(*short, 8).float()
    assert torch.isfinite(got).all()
    with pytest.raises(AssertionError):
        torch.testing.assert_close(got, want, **TOL[torch.bfloat16])


@pytest.mark.parametrize("c", [96, 128, 192, 256, 384, 512, 768])
@pytest.mark.parametrize("act,pos,residual", [("gelu", "pre", True), ("relu", "post", True),
                                              ("gelu", "post", False)])
def test_fused_mlp_bf16_every_width(cuda, c, act, pos, residual):
    """The bf16 body (two 128 x 128-tile GEMMs around LayerNorm passes) at
    every C of KERNEL_WIDTHS, token counts off the 64- and 128-row tiles."""
    rs = np.random.RandomState(c)
    n_tok, f = {96: 1, 128: 63, 192: 65, 256: 200, 384: 129, 512: 257, 768: 100}[c], 4 * c
    args = (_rand(rs, n_tok, c, dtype=torch.bfloat16), _rand(rs, c, scale=0.1, offset=1.0),
            _rand(rs, c, scale=0.1), _rand(rs, f, c, scale=c ** -0.5), _rand(rs, f, scale=0.1),
            _rand(rs, c, f, scale=f ** -0.5), _rand(rs, c, scale=0.1))
    _check(fused_mlp, fused_mlp, fused_mlp_plain, *args, activation=act, ln_position=pos,
           residual=residual)


@pytest.mark.parametrize("n_tok,c,f,act,pos", [(77, 96, 384, "gelu", "pre"),
                                               (130, 512, 2048, "relu", "post"),
                                               (65, 768, 2048, "relu", "pre"),
                                               (200, 384, 1536, "gelu", "pre")])
def test_fused_mlp_bf16_training_upre(cuda, n_tok, c, f, act, pos):
    """The training launch's saved pre-activation equals the plain one,
    h · w1ᵀ + b1 from the bf16 operands in f32, rounded to bf16 (within the
    bf16 bound: the sums run in another order), and its output the plain
    version's; F = 2048 at C 768 is the v1 decoders' shape."""
    from lc2is_tpu_torch.ops import fused_mlp as mlp
    rs = np.random.RandomState(n_tok)
    dt = torch.bfloat16
    x = _rand(rs, n_tok, c, dtype=dt)
    args = (_rand(rs, c, scale=0.1, offset=1.0), _rand(rs, c, scale=0.1),
            _rand(rs, f, c, scale=c ** -0.5), _rand(rs, f, scale=0.1),
            _rand(rs, c, f, scale=f ** -0.5), _rand(rs, c, scale=0.1))
    before = fused_mlp.launches
    out, upre = mlp._launch(x, *args, act, pos, True, 1e-5, save_upre=True)
    torch.cuda.synchronize()
    assert fused_mlp.launches == before + 1 and upre.dtype == dt and upre.shape == (n_tok, f)
    h = mlp._ln(x, args[0], args[1], 1e-5) if pos == "pre" else x
    want = (h.float() @ args[2].to(dt).float().t() + args[3].to(dt).float()).to(dt)
    torch.testing.assert_close(upre.float(), want.float(), **TOL[dt])
    plain = fused_mlp_plain(x, *args, activation=act, ln_position=pos)
    torch.testing.assert_close(out.float(), plain.float(), **TOL[dt])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hw,c,r", [((5, 7), 24, 2), ((5, 7), 24, 4), ((1, 3), 8, 2),
                                    ((9, 9), 512, 2)])
def test_upsample_tokens_kernel(cuda, dtype, hw, c, r):
    x = _rand(np.random.RandomState(2), 2, hw[0] * hw[1], c, dtype=dtype)
    _check(upsample_tokens, upsample_tokens, upsample_tokens_plain, x, hw, r)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h,w,c,heads,win,shift", [
    (18, 18, 32, 2, 7, 0),
    (18, 18, 32, 2, 7, 3),
    (14, 14, 32, 1, 7, 3),
    (14, 21, 64, 4, 7, 0),   # dh 16, one side padded
    (12, 12, 64, 1, 4, 2),   # dh 64, window 4
    (16, 16, 768, 24, 7, 3),  # stage-4-like: 16² canvas padded to 21²
    (4, 4, 96, 3, 4, 0),     # window shrunk to a 4² grid
])
def test_swin_window_block_kernel(cuda, dtype, h, w, c, heads, win, shift):
    rs = np.random.RandomState(3)
    args = (_rand(rs, 2, h, w, c, dtype=dtype), _rand(rs, c, scale=0.1, offset=1.0),
            _rand(rs, c, scale=0.5), _rand(rs, 3 * c, c, scale=c ** -0.5),
            _rand(rs, 3 * c, scale=0.1), _rand(rs, c, c, scale=c ** -0.5), _rand(rs, c, scale=0.1),
            _rand(rs, heads, win * win, win * win, scale=0.1))
    _check(swin_window_block, swin_window_block, swin_window_block_plain, *args, heads, win,
           shift)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("c,heads", [(96, 3), (192, 6), (384, 12), (768, 24)])
def test_swin_window_block_kernel_window_tail(cuda, dtype, c, heads, shift):
    """27 windows (3 images of 15², padded to 21²): no multiple of the 4 or
    2 windows a bf16 block takes at the swin-small widths, so the last block
    runs part-empty; the residual off at shift 3."""
    rs = np.random.RandomState(4)
    args = (_rand(rs, 3, 15, 15, c, dtype=dtype), _rand(rs, c, scale=0.1, offset=1.0),
            _rand(rs, c, scale=0.5), _rand(rs, 3 * c, c, scale=c ** -0.5),
            _rand(rs, 3 * c, scale=0.1), _rand(rs, c, c, scale=c ** -0.5), _rand(rs, c, scale=0.1),
            _rand(rs, heads, 49, 49, scale=0.1))
    _check(swin_window_block, swin_window_block, swin_window_block_plain, *args, heads, 7,
           shift, residual=shift == 0)


def _near_tie(dtype, blended):
    if dtype != torch.bfloat16:
        return 1e-5
    return 2 * 2.0 ** (np.floor(np.log2(blended.abs().max().item())) - 7)


def _check_masks(fn, got, want, blended, dtype):
    """``dtype``: the one both sides round their scores to."""
    torch.cuda.synchronize()
    assert fn.launches > 0 and got.dtype == torch.int32 and got.shape == want.shape
    differ = got != want
    top2 = blended.topk(2, dim=1).values
    assert (top2[:, 0] - top2[:, 1])[differ].le(_near_tie(dtype, blended)).all(), int(differ.sum())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,grid,k,c,r", [
    (2, 16, 151, 64, 4),
    (1, 13, 7, 33, 4),     # ragged tiles, C not a multiple of the channel chunk
    (1, 24, 200, 512, 4),  # K over one class pass
    (2, 9, 5, 16, 2),
])
def test_score_upsample_argmax_kernel(cuda, dtype, b, grid, k, c, r):
    rs = np.random.RandomState(11)
    v = _rand(rs, b, grid * grid, c, dtype=dtype)
    tn = l2_normalize(_rand(rs, b, k, c, dtype=dtype), 2)
    before = score_upsample_argmax.launches
    got = score_upsample_argmax(v, tn, grid, r)
    assert score_upsample_argmax.launches == before + 1
    _check_masks(score_upsample_argmax, got, score_upsample_argmax_plain(v, tn, grid, r),
                 upsample_blend_plain(score_map_plain(v, tn, grid), r), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,r", [((2, 151, 12, 20), 4), ((1, 5, 7, 9), 3), ((1, 256, 8, 8), 4),
                                     ((1, 170, 17, 33), 2)])
def test_upsample_argmax_kernel(cuda, dtype, shape, r):
    x = _rand(np.random.RandomState(12), *shape, dtype=dtype)
    before = upsample_argmax.launches
    got = upsample_argmax(x, r)
    assert upsample_argmax.launches == before + 1
    # both sides blend the same values in f32
    _check_masks(upsample_argmax, got, upsample_argmax_plain(x, r), upsample_blend_plain(x, r),
                 torch.float32)


@pytest.mark.parametrize("b,grid,k,c,r", [
    (1, 17, 151, 512, 4),  # one past the 16 x 16 tile
    (2, 33, 256, 512, 4),  # K over two class passes, two tiles past a multiple
    (1, 16, 161, 96, 4),   # one class into the second pass
    (1, 7, 20, 64, 16),    # r 16: 16 output pixels a unit
    (1, 12, 9, 520, 2),    # C not a multiple of the 32-channel slice
])
def test_score_upsample_argmax_bf16_tile_edges(cuda, b, grid, k, c, r):
    """The bf16 body (the score product on the tensor cores, 16 x 16 tiles,
    160 classes a pass) at tile, class-pass and channel-slice edges."""
    rs = np.random.RandomState(31)
    v = _rand(rs, b, grid * grid, c, dtype=torch.bfloat16)
    tn = l2_normalize(_rand(rs, b, k, c, dtype=torch.bfloat16), 2)
    got = score_upsample_argmax(v, tn, grid, r)
    _check_masks(score_upsample_argmax, got, score_upsample_argmax_plain(v, tn, grid, r),
                 upsample_blend_plain(score_map_plain(v, tn, grid), r), torch.bfloat16)


@pytest.mark.parametrize("c", [512, 768])
def test_score_upsample_argmax_f32_control_beside_bf16(cuda, c):
    """The f32 body (the control: the CUDA-core product) and the bf16 body
    on the same tokens: each equal to its plain version but near-ties, and
    the two equal to each other but near-ties of the bf16 bound.  C 768 is
    past the bf16 body's shared memory and runs the tile body in bf16."""
    rs = np.random.RandomState(32)
    grid, k = 20, 151
    v = _rand(rs, 2, grid * grid, c)
    tn = l2_normalize(_rand(rs, 2, k, c), 2)
    masks = {}
    for dt in DTYPES:
        vd, td = v.to(dt), tn.to(dt)
        masks[dt] = score_upsample_argmax(vd, td, grid, 4)
        _check_masks(score_upsample_argmax, masks[dt], score_upsample_argmax_plain(vd, td, grid, 4),
                     upsample_blend_plain(score_map_plain(vd, td, grid), 4), dt)
    _check_masks(score_upsample_argmax, masks[torch.bfloat16], masks[torch.float32],
                 upsample_blend_plain(score_map_plain(v.to(torch.bfloat16), tn.to(torch.bfloat16),
                                                      grid), 4), torch.bfloat16)


def _check_int8(fn, kernel_fn, plain_fn, *args, **kw):
    before = fn.launches
    with torch.no_grad():
        got = kernel_fn(*args, **kw)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        want = plain_fn(*args, **kw)
    assert got.shape == want.shape and got.dtype == want.dtype and torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= INT8_REL[got.dtype] * want.float().abs().max().item(), err


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_tok,c,act,pos,residual", [
    (77, 96, "gelu", "pre", True),
    (33, 768, "gelu", "pre", True),
    (50, 512, "relu", "post", True),
    (5, 128, "relu", "post", False),
    (40, 192, "gelu", "pre", False),
])
def test_fused_mlp_q_kernel(cuda, dtype, n_tok, c, act, pos, residual):
    rs = np.random.RandomState(13)
    f = 4 * c
    args = (_rand(rs, n_tok, c, dtype=dtype), _rand(rs, c, scale=0.1, offset=1.0),
            _rand(rs, c, scale=0.1), _rand(rs, f, c, scale=c ** -0.5), _rand(rs, f, scale=0.1),
            _rand(rs, c, f, scale=f ** -0.5), _rand(rs, c, scale=0.1))
    _check_int8(fused_mlp_q, fused_mlp_q, fused_mlp_q_plain, *args, activation=act,
                ln_position=pos, residual=residual)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p,l,c,heads", [(40, 7, 512, 8), (33, 151, 512, 8), (70, 1030, 512, 8),
                                         (16, 17, 64, 4), (45, 64, 128, 4)])
def test_fused_attn_block_q_kernel(cuda, dtype, p, l, c, heads):
    rs = np.random.RandomState(14)
    args = (_rand(rs, 2, p, c, dtype=dtype), _rand(rs, 2, l, c, dtype=dtype),
            _rand(rs, 2, l, c, dtype=dtype), _rand(rs, c, c, scale=c ** -0.5),
            _rand(rs, c, scale=0.1), _rand(rs, c, c, scale=c ** -0.5), _rand(rs, c, scale=0.1),
            _rand(rs, c, scale=0.1, offset=1.0), _rand(rs, c, scale=0.1))
    _check_int8(fused_attn_block_q, fused_attn_block_q, fused_attn_block_q_plain, *args, heads)


def _mlp_q_args(rs, n_tok, c, f, dtype):
    return (_rand(rs, n_tok, c, dtype=dtype), _rand(rs, c, scale=0.1, offset=1.0),
            _rand(rs, c, scale=0.1), _rand(rs, f, c, scale=c ** -0.5), _rand(rs, f, scale=0.1),
            _rand(rs, c, f, scale=f ** -0.5), _rand(rs, c, scale=0.1))


@pytest.mark.parametrize("n_tok", [1, 127, 129, 16385])
@pytest.mark.parametrize("c,f,act,pos,residual", [
    (96, 384, "gelu", "pre", True),     # swin stage 1: K = 96 is one and a half 64-byte slices
    (96, 208, "gelu", "pre", False),    # F tail: 80 columns past a 128-column tile
    (512, 2048, "relu", "post", True),  # the decoder layers
    (512, 2064, "relu", "post", False),  # F tail: 16 columns, K of the second product ragged
])
def test_fused_mlp_q_bf16_tile_edges(cuda, n_tok, c, f, act, pos, residual):
    """The bf16 tensor-core body of fused_mlp_q (row pass, the s8 GEMM's
    max, codes and output passes, the LN pass) at token counts off the
    128-row tile and hidden widths off the 128-column tile, against its
    plain version by the bf16 int8 rule."""
    rs = np.random.RandomState(n_tok + c + f)
    _check_int8(fused_mlp_q, fused_mlp_q, fused_mlp_q_plain,
                *_mlp_q_args(rs, n_tok, c, f, torch.bfloat16), activation=act, ln_position=pos,
                residual=residual)


@pytest.mark.parametrize("c,f", [(768, 4096), (384, 3088)])
def test_fused_mlp_q_bf16_hidden_past_the_f32_cap(cuda, c, f):
    """The bf16 body keeps no hidden row on chip, so F is not capped at 3072
    as the f32 body's is (swin-base's F 4096; a ragged F past the cap); the
    f32 body still raises there."""
    rs = np.random.RandomState(c + f)
    _check_int8(fused_mlp_q, fused_mlp_q, fused_mlp_q_plain,
                *_mlp_q_args(rs, 300, c, f, torch.bfloat16), activation="gelu", ln_position="pre")
    with torch.no_grad(), pytest.raises(ValueError):
        fused_mlp_q(*_mlp_q_args(rs, 30, c, f, torch.float32))


def test_fused_mlp_q_bf16_is_deterministic(cuda):
    """The hidden row max is an atomicMax on the bits of non-negative
    floats: the output repeats bit for bit."""
    rs = np.random.RandomState(21)
    args = _mlp_q_args(rs, 4099, 512, 2048, torch.bfloat16)
    with torch.no_grad():
        first = fused_mlp_q(*args, activation="relu", ln_position="post")
        for _ in range(3):
            assert torch.equal(fused_mlp_q(*args, activation="relu", ln_position="post"), first)


@pytest.mark.parametrize("l", [1, 151, 1024])
@pytest.mark.parametrize("p,c,heads", [(1, 512, 8), (127, 512, 8), (129, 64, 4), (65, 128, 2),
                                       (200, 256, 4)])
def test_fused_attn_block_q_bf16_tile_edges(cuda, l, p, c, heads):
    """The bf16 tensor-core body of fused_attn_block_q (row passes and the s8
    GEMM around the attention core, the LN pass) at query counts off the
    128-row GEMM and 64-row attention tiles, one key, the class count and a
    whole number of key tiles, dh 16, 32 and 64, against its plain version by
    the bf16 int8 rule."""
    rs = np.random.RandomState(p + l + c)
    args = (_rand(rs, 2, p, c, dtype=torch.bfloat16), _rand(rs, 2, l, c, dtype=torch.bfloat16),
            _rand(rs, 2, l, c, dtype=torch.bfloat16), _rand(rs, c, c, scale=c ** -0.5),
            _rand(rs, c, scale=0.1), _rand(rs, c, c, scale=c ** -0.5), _rand(rs, c, scale=0.1),
            _rand(rs, c, scale=0.1, offset=1.0), _rand(rs, c, scale=0.1))
    _check_int8(fused_attn_block_q, fused_attn_block_q, fused_attn_block_q_plain, *args, heads)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h,w,c,heads,win,shift", [
    (18, 18, 32, 2, 7, 3),
    (14, 21, 64, 4, 7, 0),   # dh 16, one side padded
    (12, 12, 64, 1, 4, 2),   # dh 64, window 4
    (16, 16, 768, 24, 7, 3),  # stage 4: 16² canvas padded to 21²
    (4, 4, 96, 3, 4, 0),     # window shrunk to a 4² grid
])
def test_swin_window_block_q_kernel(cuda, dtype, h, w, c, heads, win, shift):
    rs = np.random.RandomState(15)
    args = (_rand(rs, 2, h, w, c, dtype=dtype), _rand(rs, c, scale=0.1, offset=1.0),
            _rand(rs, c, scale=0.5), _rand(rs, 3 * c, c, scale=c ** -0.5),
            _rand(rs, 3 * c, scale=0.1), _rand(rs, c, c, scale=c ** -0.5), _rand(rs, c, scale=0.1),
            _rand(rs, heads, win * win, win * win, scale=0.1))
    _check_int8(swin_window_block_q, swin_window_block_q, swin_window_block_q_plain, *args,
                heads, win, shift)


def test_unsupported_shapes_raise(cuda):
    """A shape the kernel does not take raises on the card; it never falls
    back to the plain version."""
    rs = np.random.RandomState(4)
    c = 16
    args = (_rand(rs, 1, 7, 7, c), _rand(rs, c), _rand(rs, c), _rand(rs, 3 * c, c),
            _rand(rs, 3 * c), _rand(rs, c, c), _rand(rs, c), _rand(rs, 1, 49, 49))
    with pytest.raises(ValueError):
        swin_window_block(*args, 1, 7, 0)
    with pytest.raises(ValueError):
        fused_mlp(_rand(rs, 4, 80), _rand(rs, 80), _rand(rs, 80), _rand(rs, 320, 80),
                  _rand(rs, 320), _rand(rs, 80, 320), _rand(rs, 80))


SMALL_SWIN = dict(embed_dim=96, depths=(1, 1, 1, 1), num_heads=(3, 6, 12, 24))


def test_swin_model_on_card(cuda):
    """SwinModel at swin widths on a 100² input (grids 25, 13, 7, 4: HF pads,
    odd merges, a window shrunk to the last grid), f32 on the card against
    its plain run on the CPU."""
    from lc2is_tpu_torch.core.convert import seeded_init_
    from lc2is_tpu_torch.nn.swin import SwinModel

    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = seeded_init_(SwinModel(**SMALL_SWIN), seed=7).eval()
    gpu = SwinModel(device=cuda, **SMALL_SWIN).eval()
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    x = _rand(np.random.RandomState(8), 2, 3, 100, 100, device="cpu")
    with torch.no_grad():
        want, got = cpu(x), gpu(x.to(cuda))
    assert [tuple(h.shape[1:]) for h in got] == [(625, 96), (169, 192), (49, 384), (16, 768),
                                                 (16, 768)]
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, **TOL[torch.float32])


def test_small_model_on_card(cuda):
    """A small PromptAuxCrossA (swin widths, one block a stage, decoder 512,
    2-layer text tower) at 128² on the card against its plain run on the CPU,
    f32; every kernel launched; bf16 finite."""
    from lc2is_tpu_torch.core.convert import seeded_init_
    from lc2is_tpu_torch.models.zoo import PromptAuxCrossA

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(class_names=("wall", "sky", "tree", "person", "road"), dec_dim=512, nhead=8,
              swin_cfg=SMALL_SWIN,
              cfg=dict(text_encoder=dict(context_length=10, vocab_size=49408,
                                         transformer_width=512, transformer_heads=8,
                                         transformer_layers=2, embed_dim=512),
                       context_decoder=dict(transformer_width=64, transformer_heads=4,
                                            transformer_layers=1),
                       context_length=5, text_dim=512))
    cpu = seeded_init_(PromptAuxCrossA(device="cpu", **kw), seed=5).eval()
    gpu = PromptAuxCrossA(device=cuda, **kw).eval()
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    x = _rand(np.random.RandomState(6), 2, 3, 128, 128, device="cpu")
    kernels = (swin_window_block, fused_mlp, fused_attn_block, upsample_tokens)
    before = [f.launches for f in kernels]
    with torch.no_grad():
        want = cpu({"pixel_values": x})
        got = gpu({"pixel_values": x.to(cuda)})
        torch.cuda.synchronize()
        assert all(f.launches > b for f, b in zip(kernels, before))
        assert tuple(got["outputs"].shape) == (2, 5, 128, 128)
        assert tuple(got["low_score_map"].shape) == (2, 5, 8, 8)
        for key in ("outputs", "low_score_map"):
            torch.testing.assert_close(got[key].cpu(), want[key], atol=1e-3, rtol=0)
        gpu16 = PromptAuxCrossA(device=cuda, dtype=torch.bfloat16, **kw).eval()
        gpu16.load_state_dict(cpu.state_dict(), strict=True)
        out16 = gpu16({"pixel_values": x.to(cuda, torch.bfloat16)})
        assert all(torch.isfinite(v).all() for v in out16.values())


def _check_grads(counter, kernel_fn, plain_fn, args, g):
    """Gradients of every argument through the kernel path (one backward
    launch counted) and through the plain version, norm-relative."""
    ka = [a.detach().clone().requires_grad_() for a in args]
    pa = [a.detach().clone().requires_grad_() for a in args]
    before = counter.launches
    got = torch.autograd.grad(kernel_fn(*ka), ka, g)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    want = torch.autograd.grad(plain_fn(*pa), pa, g)
    dt = args[0].dtype
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and torch.isfinite(a).all(), i
        rel = ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()
        assert rel <= GRAD_TOL[dt], (i, rel)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h,w,c,heads,win,shift,residual", [
    (18, 18, 32, 2, 7, 3, True),
    (18, 18, 32, 2, 7, 3, False),
    (14, 21, 64, 4, 7, 0, True),    # dh 16, one side padded
    (12, 12, 64, 1, 4, 2, False),   # dh 64, window 4
    (16, 16, 768, 24, 7, 3, True),  # stage-4-like: 16² canvas padded to 21²
    (4, 4, 96, 3, 4, 0, True),      # window shrunk to a 4² grid
])
def test_swin_window_block_bwd_kernel(cuda, dtype, h, w, c, heads, win, shift, residual):
    rs = np.random.RandomState(5)
    args = [_rand(rs, 2, h, w, c, dtype=dtype), _rand(rs, c, scale=0.1, offset=1.0),
            _rand(rs, c, scale=0.5), _rand(rs, 3 * c, c, scale=c ** -0.5),
            _rand(rs, 3 * c, scale=0.1), _rand(rs, c, c, scale=c ** -0.5), _rand(rs, c, scale=0.1),
            _rand(rs, heads, win * win, win * win, scale=0.1)]
    g = _rand(rs, 2, h, w, c, dtype=dtype)
    kw = dict(num_heads=heads, win=win, shift=shift, residual=residual)
    _check_grads(swin_window_block_bwd, lambda *a: swin_window_block(*a, **kw),
                 lambda *a: swin_window_block_plain(*a, **kw), args, g)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p,l,c,heads", [
    (40, 7, 512, 8),
    (33, 151, 512, 8),
    (70, 1030, 512, 8),
    (16, 17, 64, 4),
    (45, 64, 128, 4),
    # the bf16 body's tile edges: 64-row query and key tiles, 128-row GEMM
    # tiles over B·P, at C 512 (dh 64), 128 (dh 16) and 256 (dh 32)
    (63, 63, 512, 8),
    (64, 65, 512, 8),
    (65, 1030, 512, 8),
    (129, 65, 512, 8),
    (1, 63, 512, 8),
    (65, 63, 128, 8),
    (129, 1030, 128, 8),
    (64, 65, 256, 8),
    (129, 1030, 256, 8),
])
def test_fused_attn_block_bwd_kernel(cuda, dtype, p, l, c, heads):
    rs = np.random.RandomState(6)
    args = [_rand(rs, 2, p, c, dtype=dtype), _rand(rs, 2, l, c, dtype=dtype),
            _rand(rs, 2, l, c, dtype=dtype), _rand(rs, c, c, scale=c ** -0.5),
            _rand(rs, c, scale=0.1), _rand(rs, c, c, scale=c ** -0.5), _rand(rs, c, scale=0.1),
            _rand(rs, c, scale=0.1, offset=1.0), _rand(rs, c, scale=0.1)]
    g = _rand(rs, 2, p, c, dtype=dtype)
    _check_grads(fused_attn_block_bwd, lambda *a: fused_attn_block(*a, heads),
                 lambda *a: fused_attn_block_plain(*a, heads), args, g)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p,c,heads", [(1, 512, 8), (65, 512, 8), (129, 128, 8), (64, 256, 8)])
def test_fused_attn_block_bwd_kernel_one_key(cuda, dtype, p, c, heads):
    """L = 1: the softmax over one key is constant, so the gradients that
    reach only through it (dk, dwq, dbq) are exactly 0 in the plain version
    and f32 noise in the kernel (its p and delta are summed in other
    orders), each held below GRAD_TOL of a partner's norm of the same scale
    (dv, dwo, dbo); every other gradient as in
    test_fused_attn_block_bwd_kernel."""
    rs = np.random.RandomState(8)
    args = [_rand(rs, 2, p, c, dtype=dtype), _rand(rs, 2, 1, c, dtype=dtype),
            _rand(rs, 2, 1, c, dtype=dtype), _rand(rs, c, c, scale=c ** -0.5),
            _rand(rs, c, scale=0.1), _rand(rs, c, c, scale=c ** -0.5), _rand(rs, c, scale=0.1),
            _rand(rs, c, scale=0.1, offset=1.0), _rand(rs, c, scale=0.1)]
    g = _rand(rs, 2, p, c, dtype=dtype)
    ka = [a.detach().clone().requires_grad_() for a in args]
    pa = [a.detach().clone().requires_grad_() for a in args]
    before = fused_attn_block_bwd.launches
    got = torch.autograd.grad(fused_attn_block(*ka, heads), ka, g)
    torch.cuda.synchronize()
    assert fused_attn_block_bwd.launches == before + 1
    want = torch.autograd.grad(fused_attn_block_plain(*pa, heads), pa, g)
    zero_partner = {1: 2, 3: 5, 4: 6}  # dk: dv, dwq: dwo, dbq: dbo
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and torch.isfinite(a).all(), i
        if i in zero_partner:
            assert float(b.float().abs().max()) == 0.0, i
            assert a.float().norm() <= GRAD_TOL[dtype] * got[zero_partner[i]].float().norm(), i
        else:
            rel = ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()
            assert rel <= GRAD_TOL[dtype], (i, rel)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hw,c,r", [((5, 7), 24, 2), ((5, 7), 24, 4), ((1, 3), 8, 2),
                                    ((9, 9), 512, 2)])
def test_upsample_tokens_adjoint_kernel(cuda, dtype, hw, c, r):
    rs = np.random.RandomState(7)
    x = _rand(rs, 2, hw[0] * hw[1], c, dtype=dtype)
    g = _rand(rs, 2, hw[0] * hw[1] * r * r, c, dtype=dtype)
    _check_grads(upsample_tokens_adjoint, lambda a: upsample_tokens(a, hw, r),
                 lambda a: upsample_tokens_plain(a, hw, r), [x], g)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,k,h,w,r,ign", [
    (2, 151, 8, 8, 4, None),
    (1, 151, 5, 7, 4, 255),
    (2, 9, 3, 2, 16, 0),
    (1, 256, 4, 4, 2, None),
    (1, 1, 3, 3, 4, None),
])
def test_upsampled_cross_entropy_kernel(cuda, dtype, b, k, h, w, r, ign):
    """Loss (f32 <= 1e-5 relative) and low-res gradient; labels over
    [0, K + 2) so clipping shows, a fifth ignored where ignore_index is set."""
    rs = np.random.RandomState(8)
    x = _rand(rs, b, k, h, w, dtype=dtype)
    y = torch.from_numpy(rs.randint(0, k + 2, size=(b, r * h, r * w))).to(cuda)
    if ign is not None:
        y[torch.from_numpy(rs.rand(b, r * h, r * w) < 0.2).to(cuda)] = ign
    xk, xp = x.clone().requires_grad_(), x.clone().requires_grad_()
    before = upsampled_cross_entropy.launches
    lk = upsampled_cross_entropy(xk, y, r, ignore_index=ign)
    (gk,) = torch.autograd.grad(lk, [xk])
    torch.cuda.synchronize()
    assert upsampled_cross_entropy.launches == before + 1
    lp = upsampled_cross_entropy_plain(xp, y, r, ignore_index=ign)
    (gp,) = torch.autograd.grad(lp, [xp])
    assert abs(lk.item() - lp.item()) <= 1e-5 * abs(lp.item()) + 1e-6
    rel = ((gk.float() - gp.float()).norm() / gp.float().norm().clamp_min(1e-30)).item()
    assert gk.dtype == dtype and rel <= GRAD_TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,k,h,w,r,ign", [
    (1, 151, 9, 17, 4, 255),   # one past the 8 x 16 tile (bf16; f32 8 x 8)
    (1, 151, 32, 32, 16, None),  # r 16 at h 32: 3 x 8 tiles, the last row of tiles ragged
    (1, 40, 4, 9, 16, 0),      # one past the 3 x 8 tile
    (2, 256, 6, 20, 4, None),  # K 256
    (1, 7, 5, 3, 3, 1),        # odd r and w (bf16 copies element by element)
    (1, 9, 4, 6, 6, None),     # r 6: three units in an edge column pair (the gather's loop)
])
def test_upsampled_cross_entropy_kernel_tile_edges(cuda, dtype, b, k, h, w, r, ign):
    """The tiled kernel at tile edges, against autograd through its plain
    version (loss 1e-5 relative, gradient GRAD_TOL), int64 labels."""
    rs = np.random.RandomState(33)
    x = _rand(rs, b, k, h, w, dtype=dtype)
    y = torch.from_numpy(rs.randint(-1, k + 2, size=(b, r * h, r * w))).to(cuda)
    if ign is not None:
        y[torch.from_numpy(rs.rand(b, r * h, r * w) < 0.2).to(cuda)] = ign
    xk, xp = x.clone().requires_grad_(), x.clone().requires_grad_()
    lk = upsampled_cross_entropy(xk, y, r, ignore_index=ign)
    (gk,) = torch.autograd.grad(lk, [xk])
    lp = upsampled_cross_entropy_plain(xp, y, r, ignore_index=ign)
    (gp,) = torch.autograd.grad(lp, [xp])
    assert abs(lk.item() - lp.item()) <= 1e-5 * abs(lp.item()) + 1e-6
    rel = ((gk.float() - gp.float()).norm() / gp.float().norm().clamp_min(1e-30)).item()
    assert gk.dtype == dtype and rel <= GRAD_TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_upsampled_cross_entropy_is_deterministic(cuda, dtype):
    """Two launches on the same inputs give the same sums and gradient bit
    for bit: every low-res cell's gradient is gathered by one thread in a
    fixed order, and the loss partials are reduced in a fixed order."""
    from lc2is_tpu_torch.ops.fused_ce import fused_ce_fwd

    rs = np.random.RandomState(34)
    x = _rand(rs, 2, 151, 19, 23, dtype=dtype)
    y = torch.from_numpy(rs.randint(0, 151, size=(2, 76, 92))).to(cuda)
    first, second = fused_ce_fwd(x, y, 4, 0), fused_ce_fwd(x, y, 4, 0)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    assert first[1].shape == (2, 151, 19, 23)


@pytest.mark.parametrize("lab_dtype", [torch.int64, torch.int32])
def test_upsampled_cross_entropy_reads_labels_as_given(cuda, monkeypatch, lab_dtype):
    """int64 and int32 labels go to the kernel as they are (no cast, no
    copy: the pointer handed over is the labels' own, with their element
    size), and the map in its (B, K, h, w) layout; the loss equals the same
    labels cast to the other type."""
    from lc2is_tpu_torch.ops import _build, fused_ce

    rs = np.random.RandomState(35)
    x = _rand(rs, 1, 19, 9, 17, dtype=torch.bfloat16)
    y = torch.from_numpy(rs.randint(0, 19, size=(1, 36, 68))).to(cuda, lab_dtype)
    seen = []
    launch = _build.launch
    monkeypatch.setattr(_build, "launch", lambda name, dev, *a: seen.append(a) or launch(
        name, dev, *a))
    loss = fused_ce.upsampled_cross_entropy(x, y, 4)
    (args,) = seen
    assert args[1] == x.data_ptr() and args[2] == y.data_ptr()
    assert args[3] == y.element_size()
    other = y.to(torch.int32 if lab_dtype == torch.int64 else torch.int64)
    assert torch.equal(loss, fused_ce.upsampled_cross_entropy(x, other, 4))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_tok,c,act,pos,residual", [
    (77, 96, "gelu", "pre", True),
    (50, 512, "relu", "post", True),
    (40, 192, "gelu", "pre", False),
])
def test_fused_mlp_grad_on_card(cuda, dtype, n_tok, c, act, pos, residual):
    """The Function's analytic backward from the kernel's saved
    pre-activation (exact-gelu derivative, as the JAX VJP) against autograd
    through the plain version."""
    rs = np.random.RandomState(9)
    f = 4 * c
    args = [_rand(rs, n_tok, c, dtype=dtype), _rand(rs, c, scale=0.1, offset=1.0),
            _rand(rs, c, scale=0.1), _rand(rs, f, c, scale=c ** -0.5), _rand(rs, f, scale=0.1),
            _rand(rs, c, f, scale=f ** -0.5), _rand(rs, c, scale=0.1)]
    g = _rand(rs, n_tok, c, dtype=dtype)
    kw = dict(activation=act, ln_position=pos, residual=residual)
    ka = [a.clone().requires_grad_() for a in args]
    pa = [a.clone().requires_grad_() for a in args]
    got = torch.autograd.grad(fused_mlp(*ka, **kw), ka, g)
    want = torch.autograd.grad(fused_mlp_plain(*pa, **kw), pa, g)
    for i, (a, b) in enumerate(zip(got, want)):
        rel = ((a.float() - b.float()).norm() / b.float().norm()).item()
        assert rel <= GRAD_TOL[dtype], (i, rel)


def test_small_train_step_on_card(cuda):
    """One f32 training step of a small PromptAuxCrossA (swin widths, one
    block a stage, decoder 512, 2-layer text tower) at 128², batch 2, drop
    path off, on the card against the same step on the CPU: losses (1e-4
    relative), every gradient (norm-relative 1e-3), the parameters after
    AdamW (1e-2 · lr) where the gradient is not f32 noise, the frozen tower
    bit for bit."""
    from lc2is_tpu_torch.core.convert import seeded_init_
    from lc2is_tpu_torch.engine.engine import train_step
    from lc2is_tpu_torch.engine.optim import make_optimizer
    from lc2is_tpu_torch.models.zoo import FROZEN_PREFIXES, PromptAuxCrossA

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(class_names=("wall", "sky", "tree", "person", "road"), dec_dim=512, nhead=8,
              swin_cfg=dict(SMALL_SWIN, drop_path_rate=0.0), return_score_map=True,
              cfg=dict(text_encoder=dict(context_length=10, vocab_size=49408,
                                         transformer_width=512, transformer_heads=8,
                                         transformer_layers=2, embed_dim=512),
                       context_decoder=dict(transformer_width=64, transformer_heads=4,
                                            transformer_layers=1),
                       context_length=5, text_dim=512))
    frozen = FROZEN_PREFIXES["prompt_aux_cross_a"]
    cpu = seeded_init_(PromptAuxCrossA(device="cpu", **kw), seed=5)
    gpu = PromptAuxCrossA(device=cuda, **kw)
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    before = {k: v.clone() for k, v in cpu.state_dict().items()}
    rs = np.random.RandomState(10)
    x = _rand(rs, 2, 3, 128, 128, device="cpu")
    y = torch.from_numpy(rs.randint(0, 5, size=(2, 128, 128)))
    lr = 1e-3
    runs = []
    for model, dev in ((cpu, "cpu"), (gpu, cuda)):
        opt = make_optimizer(model, lr=lr, frozen_prefixes=frozen)
        runs.append(train_step(model, opt, {"pixel_values": x.to(dev)}, y.to(dev)))
    torch.cuda.synchronize()
    for key in runs[0]:
        assert abs(runs[1][key].item() - runs[0][key].item()) <= 1e-4 * abs(runs[0][key].item())
    gp, cp = dict(gpu.named_parameters()), dict(cpu.named_parameters())
    for name, p in cpu.named_parameters():
        q = gp[name]
        if p.grad is None:
            assert q.grad is None, name
        else:
            # a swin key bias has an exactly-zero gradient (softmax is invariant
            # to q·bk): its f32 noise is held to the query bias's gradient norm
            key_bias = name.endswith("attention.self.key.bias")
            ref = cp[name.replace("key.bias", "query.bias")] if key_bias else p
            rel = ((q.grad.cpu() - p.grad).norm() / ref.grad.norm()).item()
            assert rel <= 1e-3, (name, rel)
            if key_bias:
                continue
            # Adam's first update lr·g/(|g| + eps) follows the noise of a tiny g
            sure = p.grad.abs() >= torch.clamp(1e-3 * p.grad.abs().max(), min=1e-6)
            torch.testing.assert_close(q.detach().cpu()[sure], p.detach()[sure], rtol=0,
                                       atol=1e-2 * lr + 1e-7)
        if name.startswith(frozen[0] + "."):
            assert torch.equal(q.detach().cpu(), before[name]), name


def test_small_model_masks_and_int8_on_card(cuda):
    """The small PromptAuxCrossA of test_small_model_on_card with the served
    head, float and int8 (f32 at 128²: the int8 MLP and decoder attention
    kernels run; stage 4, whose blocks took the int8 window block, is not run,
    since no model reads it), on the card against the CPU: masks equal except
    near-ties of the CPU's score map, the int8 low score map within 1e-2 of
    its max."""
    from lc2is_tpu_torch.core.convert import seeded_init_
    from lc2is_tpu_torch.models.zoo import PromptAuxCrossA

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(class_names=("wall", "sky", "tree", "person", "road"), dec_dim=512, nhead=8,
              swin_cfg=SMALL_SWIN,
              cfg=dict(text_encoder=dict(context_length=10, vocab_size=49408,
                                         transformer_width=512, transformer_heads=8,
                                         transformer_layers=2, embed_dim=512),
                       context_decoder=dict(transformer_width=64, transformer_heads=4,
                                            transformer_layers=1),
                       context_length=5, text_dim=512))
    state = seeded_init_(PromptAuxCrossA(device="cpu", **kw), seed=5).state_dict()
    x = _rand(np.random.RandomState(6), 2, 3, 128, 128, device="cpu")
    runs = {}
    with torch.no_grad():
        for quant in (False, True):
            for dev in ("cpu", cuda):
                m = PromptAuxCrossA(device=dev, predict_masks=True, quant_int8=quant, **kw).eval()
                m.load_state_dict(state, strict=True)
                out = m({"pixel_values": x.to(dev)})
                runs[quant, str(dev)] = {k: v.cpu() for k, v in out.items()}
        full = PromptAuxCrossA(device="cpu", **kw).eval()
        full.load_state_dict(state, strict=True)
        scores = full({"pixel_values": x})["outputs"]
    top2 = scores.topk(2, dim=1).values
    differ = runs[False, "cpu"]["outputs"] != runs[False, "cuda"]["outputs"]
    assert (top2[:, 0] - top2[:, 1])[differ].le(1e-5).all()
    cpu_q, gpu_q = runs[True, "cpu"], runs[True, "cuda"]
    ref = cpu_q["low_score_map"]
    assert (gpu_q["low_score_map"] - ref).abs().max() <= 1e-2 * ref.abs().max()
    assert (gpu_q["outputs"] == cpu_q["outputs"]).float().mean() >= 0.99


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid", [13, 125])
def test_mask_head_at_grids_not_a_multiple_of_8_on_card(cuda, dtype, grid):
    """The served head of the model (``_finish`` with ``predict_masks``) at
    grids that are not a multiple of 8 (125 is a 500² image's stage-1 grid)
    launches the fused kernel on the card, and its masks equal the CPU's
    except near-ties.  The head is driven directly: the whole model's decoder
    output grid is 8x its stage-4 grid, so a forward never gives it such a
    grid."""
    from lc2is_tpu_torch.models.zoo import PromptAuxCrossA

    kw = dict(class_names=("wall", "sky", "tree", "person", "road"), swin_cfg=SMALL_SWIN,
              predict_masks=True, dtype=dtype)
    rs = np.random.RandomState(13)
    v = _rand(rs, 2, grid * grid, 512, dtype=dtype, device="cpu")
    t = _rand(rs, 2, 5, 512, dtype=dtype, device="cpu")
    want = PromptAuxCrossA(device="cpu", **kw).eval()._finish(v, t)
    before = score_upsample_argmax.launches
    got = PromptAuxCrossA(device=cuda, **kw).eval()._finish(v.to(cuda), t.to(cuda))
    assert score_upsample_argmax.launches == before + 1
    assert tuple(got.shape) == (2, 4 * grid, 4 * grid)
    _check_masks(score_upsample_argmax, got.cpu(), want,
                 upsample_blend_plain(score_map_plain(v, l2_normalize(t, 2), grid), 4), dtype)


def test_model_defaults_to_the_card(cuda):
    """Built without ``device``, every parameter and buffer is on the card."""
    from lc2is_tpu_torch.models.zoo import PromptAuxCrossA

    model = PromptAuxCrossA(class_names=("wall", "sky"), swin_cfg=SMALL_SWIN)
    assert {t.device.type for t in list(model.parameters()) + list(model.buffers())} == {"cuda"}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lq,lk,d,masked", [
    (1, 1, 64, False), (63, 77, 96, True), (65, 129, 64, True), (1025, 1025, 64, False),
    (1025, 1025, 96, True), (65, 1, 96, False), (1, 129, 96, True),
    (77, 130, 16, True), (130, 77, 40, False), (200, 1025, 48, True), (1025, 65, 128, True),
    (33, 70, 1, False), (70, 33, 33, True), (64, 64, 80, False), (90, 120, 112, True),
    # the bf16 kernel's 64-row query and 64-key tiles: lengths at tile - 1,
    # tile, tile + 1 and 2·tile + 1 (and the backward's 128-row tiles), D 8
    # and 24, keys masked in the middle of a tile
    (63, 64, 64, False), (64, 65, 96, True), (65, 63, 64, True), (129, 129, 96, False),
    (127, 257, 64, True), (128, 128, 96, False), (257, 127, 64, False), (64, 129, 8, True),
    (129, 64, 24, False), (150, 200, 64, "middle"), (200, 130, 96, "middle"),
    (65, 257, 24, "middle"),
])
def test_flash_attention_kernel(cuda, dtype, lq, lk, d, masked):
    """Ragged query and key tiles, head widths from 1 to 128 (every width the
    kernel instantiates, and widths that are no multiple of 16 or of a 16-byte
    load), key-padding masks with a fully-masked batch entry (NaN rows, lse
    −∞, in both versions), keys masked in the middle of a tile; bf16 within
    FLASH_BF16_REL of the largest output."""
    rs = np.random.RandomState(lq + lk + d)
    q = _rand(rs, 3, 2, lq, d, dtype=dtype)
    k, v = (_rand(rs, 3, 2, lk, d, dtype=dtype) for _ in range(2))
    mask = _key_mask(rs, lk, masked, cuda)
    before = flash_attention.launches
    got, lse = flash_attention(q, k, v, mask, with_stats=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want, lse_w = flash_attention_plain(q, k, v, mask, with_stats=True)
    assert got.dtype == want.dtype and got.shape == want.shape
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan) and torch.equal(torch.isneginf(lse),
                                                               torch.isneginf(lse_w))
    if masked:
        assert nan[0].all() and not nan[1:].any()
    torch.testing.assert_close(got[~nan].float(), want[~nan].float(), **flash_tol(want[~nan]))
    fin = torch.isfinite(lse_w)
    torch.testing.assert_close(lse[fin], lse_w[fin], **TOL[torch.float32])


def test_flash_attention_raises(cuda):
    """What the kernel does not take raises on the card: a head width above
    128 (the one limit the JAX kernel does not have), strided or mixed-dtype
    inputs.  A gradient through it runs the backward kernels."""
    rs = np.random.RandomState(20)
    q, k, v = (_rand(rs, 1, 2, 8, 136) for _ in range(3))
    with pytest.raises(ValueError, match="D <= 128"):
        flash_attention(q, k, v)
    q, k, v = (_rand(rs, 1, 8, 2, 64).transpose(1, 2) for _ in range(3))
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q, k, v)
    q, k, v = (_rand(rs, 1, 2, 8, 64) for _ in range(3))
    with pytest.raises(TypeError):
        flash_attention(q, k.bfloat16(), v)
    before = flash_attention_bwd.launches
    out = flash_attention(q.requires_grad_(), k, v)
    out.sum().backward()
    assert flash_attention_bwd.launches == before + 1 and torch.isfinite(q.grad).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lq,lk,d,masked", [
    (1, 2, 64, False), (63, 77, 96, True), (65, 129, 64, True), (1025, 1025, 64, True),
    (1024, 1024, 96, False), (77, 1025, 96, True), (1025, 3, 64, False), (1, 129, 16, True),
    (130, 77, 40, True), (200, 300, 48, False), (129, 65, 128, True), (33, 70, 1, True),
    (70, 33, 33, False), (64, 64, 80, True), (90, 120, 112, False),
    # the bf16 kernels' tiles: 128 own rows, 64 streamed rows; lengths at
    # tile - 1, tile, tile + 1 and 2·tile + 1, D 8 and 24, keys masked in
    # the middle of a tile
    (63, 64, 64, True), (64, 65, 96, False), (65, 63, 64, False), (129, 129, 96, True),
    (127, 257, 64, False), (128, 128, 96, True), (257, 127, 64, True), (64, 129, 8, False),
    (129, 64, 24, True), (150, 200, 64, "middle"), (200, 130, 96, "middle"),
    (257, 65, 24, "middle"),
])
def test_flash_attention_bwd_kernel(cuda, dtype, lq, lk, d, masked):
    """The backward kernels (dq; dk and dv) against the plain backward on the
    forward's own output and lse: ragged query and key tiles (at least 2
    keys: over one key dq is 0 in exact arithmetic, and both sides' values
    are f32 noise), every head width
    the kernels instantiate, key-padding masks with a fully-masked batch entry
    (whose dq rows, dk and dv are 0 in both versions, though its output is
    NaN), norm-relative within GRAD_TOL; and autograd through the kernel gives
    the same gradients."""
    rs = np.random.RandomState(lq + 3 * lk + d)
    q = _rand(rs, 3, 2, lq, d, dtype=dtype)
    k, v = (_rand(rs, 3, 2, lk, d, dtype=dtype) for _ in range(2))
    g = _rand(rs, 3, 2, lq, d, dtype=dtype)
    mask = _key_mask(rs, lk, masked, cuda)
    out, lse = flash_attention(q, k, v, mask, with_stats=True)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, mask, out, lse, g)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    want = flash_attention_backward_plain(q, k, v, mask, out, lse, g)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == b.dtype == dtype and a.shape == b.shape and torch.isfinite(a).all()
        rel = ((a.float() - b.float()).norm() / b.float().norm()).item()
        assert rel <= GRAD_TOL[dtype], (name, rel)
        if masked:
            assert not a[0].any() and not b[0].any(), name
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    auto = torch.autograd.grad(flash_attention(*leaves, mask), leaves, g)
    for a, b in zip(auto, got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)  # deterministic: no atomics


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_bwd_is_deterministic(cuda, dtype):
    """Two calls of the backward on the same inputs give bit-identical dq,
    dk and dv: each block writes whole rows of its output, no atomics."""
    rs = np.random.RandomState(25)
    q, k, v, g = (_rand(rs, 3, 2, 300, 64, dtype=dtype) for _ in range(4))
    mask = _key_mask(rs, 300, "middle", cuda)
    out, lse = flash_attention(q, k, v, mask, with_stats=True)
    first = flash_attention_bwd(q, k, v, mask, out, lse, g)
    second = flash_attention_bwd(q, k, v, mask, out, lse, g)
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


def test_flash_attention_many_heads(cuda):
    """B·H above 65535 (the old gridDim.y cap): forward and backward against
    their plain versions."""
    rs = np.random.RandomState(24)
    q, k, v, g = (_rand(rs, 2, 32800, 3, 16) for _ in range(4))
    out, lse = flash_attention(q, k, v, with_stats=True)
    want, lse_w = flash_attention_plain(q, k, v, with_stats=True)
    torch.testing.assert_close(out, want, **TOL[torch.float32])
    torch.testing.assert_close(lse, lse_w, **TOL[torch.float32])
    for a, b in zip(flash_attention_bwd(q, k, v, None, out, lse, g),
                    flash_attention_backward_plain(q, k, v, None, out, lse, g)):
        assert ((a - b).norm() / b.norm()).item() <= GRAD_TOL[torch.float32]


def test_attention_gate_on_card(cuda):
    """ops/attention.py sends a call with Lq·Lk >= 2^20 and no dense mask to
    the flash kernel on the card, and keeps a smaller one, a dense mask or
    mixed dtypes on the einsum path; each result matches the plain flash
    version (a zero dense mask is no mask)."""
    from lc2is_tpu_torch.ops.attention import scaled_dot_product_attention as sdpa

    rs = np.random.RandomState(23)
    q, k, v = (_rand(rs, 1, 2, 1024, 96) for _ in range(3))
    mask = torch.zeros(1, 1024, dtype=torch.bool, device=cuda)
    mask[0, 900:] = True
    for kw, launched in [(dict(key_padding_mask=mask), 1), (dict(), 1),
                         (dict(attn_mask=torch.zeros(1024, 1024, device=cuda)), 0)]:
        before = flash_attention.launches
        got = sdpa(q, k, v, **kw)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + launched, kw.keys()
        torch.testing.assert_close(got, flash_attention_plain(q, k, v, kw.get("key_padding_mask")),
                                   **TOL[torch.float32])
    before = flash_attention.launches
    sdpa(q[:, :, :1000], k, v)  # 1000 x 1024 < 2^20
    sdpa(q.bfloat16(), k, v)
    assert flash_attention.launches == before


def _small_v1(cls, cuda, **kw):
    """A small v1 model at 512² (1025 ViT tokens of 2 heads x 64, so the
    flash gate is crossed) on the CPU, seeded, and its twin on the card."""
    from lc2is_tpu_torch.core.convert import seeded_init_

    kw = dict(dict(in_size=512, vision_kwargs=dict(hidden_size=128, num_layers=1, num_heads=2,
                                                   mlp_dim=256),
                   text_kwargs=dict(hidden_size=64, num_layers=1, num_heads=1, mlp_dim=128)),
              **kw)
    cpu = seeded_init_(cls(device="cpu", **kw), seed=21).eval()
    gpu = cls(device=cuda, **kw).eval()
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    return cpu, gpu


def _v1_text(n, device):
    from lc2is_tpu_torch.ops.bpe import tokenize

    ids = torch.from_numpy(tokenize([f"a photo of a {w}." for w in ("wall", "sky", "tree")][:n],
                                    context_length=77))
    return {"input_ids": ids.to(device), "attention_mask": (ids != 0).long().to(device)}


def test_small_v1_models_on_card(cuda):
    """A small BaseModelWithText and DenseClip at 512² on the card against
    their plain runs on the CPU, f32, every output within 1e-3 of max |ref|;
    the flash kernel launched once per ViT layer and per fusion-decoder
    self-attention."""
    from lc2is_tpu_torch.models.zoo import BaseModelWithText, DenseClip

    torch.backends.cuda.matmul.allow_tf32 = False
    x = _rand(np.random.RandomState(22), 2, 3, 512, 512, device="cpu")
    for cls, kw, n_text, n_flash in [
            (BaseModelWithText, dict(out_size=128, nhead=2), 2, 2),
            (DenseClip, dict(embed_dim=128, decoder_layers=2, nhead=2), 3, 3)]:
        cpu, gpu = _small_v1(cls, cuda, **kw)
        before = flash_attention.launches
        with torch.no_grad():
            want = cpu({"pixel_values": x, **_v1_text(n_text, "cpu")})
            got = gpu({"pixel_values": x.to(cuda), **_v1_text(n_text, cuda)})
            torch.cuda.synchronize()
        assert flash_attention.launches == before + n_flash, cls.__name__
        for g, w in zip(got, want):
            if w is None:
                assert g is None
                continue
            assert torch.isfinite(g).all()
            torch.testing.assert_close(g.cpu(), w, rtol=0, atol=1e-3 * w.abs().max().item())


def test_v1_models_default_to_the_card(cuda):
    from lc2is_tpu_torch.models.zoo import BaseModelWithText, ContrastiveModel, DenseClip

    small = dict(in_size=32, vision_kwargs=dict(hidden_size=32, num_layers=1, num_heads=2,
                                                mlp_dim=64),
                 text_kwargs=dict(hidden_size=32, num_layers=1, num_heads=2, mlp_dim=64))
    for cls in (BaseModelWithText, ContrastiveModel, DenseClip):
        model = cls(**small)
        assert {t.device.type for t in model.parameters()} == {"cuda"}, cls.__name__


@pytest.mark.parametrize("vision,nhead", [
    (dict(hidden_size=128, num_layers=1, num_heads=2, mlp_dim=256), 2),
    (dict(hidden_size=768, num_layers=1, num_heads=12, mlp_dim=3072), 16),
])
def test_small_v1_train_step_on_card(cuda, vision, nhead):
    """One f32 training step of a small BaseModelWithText at 512² (1025 ViT
    tokens and the fusion decoder's 1024-token self-attention, both through
    the flash kernels and their backward), batch 2, 128² labels, on the card
    against the same step on the CPU: the loss (1e-4 relative), every
    gradient (norm-relative 1e-3; a key bias and the prototypes' projection
    bias, 0 in exact arithmetic, held to their partner's norm), the
    parameters after AdamW (1e-2 · lr) where the gradient is not f32 noise.
    nhead 16 over the ViT-B width gives decoder heads of 48, which is not
    one of the v1 defaults' widths (64, 96)."""
    from lc2is_tpu_torch.engine.engine import train_step
    from lc2is_tpu_torch.engine.optim import make_optimizer
    from lc2is_tpu_torch.models.zoo import BaseModelWithText

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu, gpu = _small_v1(BaseModelWithText, cuda, out_size=128, nhead=nhead,
                         vision_kwargs=vision)
    rs = np.random.RandomState(25)
    x = _rand(rs, 2, 3, 512, 512, device="cpu")
    y = torch.from_numpy(rs.randint(0, 151, size=(2, 128, 128)))
    lr = 1e-3
    runs = []
    before = [f.launches for f in (flash_attention, flash_attention_bwd)]
    for model, dev in ((cpu, "cpu"), (gpu, cuda)):
        opt = make_optimizer(model, lr=lr)
        runs.append(train_step(model, opt, {"pixel_values": x.to(dev), **_v1_text(2, dev)},
                               y.to(dev)))
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip((flash_attention, flash_attention_bwd), before)] \
        == [2, 2]
    assert abs(runs[1]["train_loss"].item() - runs[0]["train_loss"].item()) \
        <= 1e-4 * abs(runs[0]["train_loss"].item())
    gp, cp = dict(gpu.named_parameters()), dict(cpu.named_parameters())
    partners = {n: n.replace("k_proj", "q_proj") for n in cp if n.endswith("k_proj.bias")}
    partners["pixel_patch.textual.bias"] = "pixel_patch.visual.bias"
    for name, p in cpu.named_parameters():
        q = gp[name]
        if p.grad is None:  # the pooled CLS's post-LN: not read
            assert q.grad is None, name
            continue
        ref = cp[partners.get(name, name)].grad
        rel = ((q.grad.cpu() - p.grad).norm() / ref.norm()).item()
        assert rel <= 1e-3, (name, rel)
        if name in partners:
            continue
        sure = p.grad.abs() >= torch.clamp(1e-3 * p.grad.abs().max(), min=1e-6)
        torch.testing.assert_close(q.detach().cpu()[sure], p.detach()[sure], rtol=0,
                                   atol=1e-2 * lr + 1e-7)


def test_swin_base_shaped_model_serves_on_card(cuda):
    """A PromptAuxCrossA on a swin-base-shaped backbone (C 128 .. 1024, one
    block a stage): its fourth stage, C 1024, where fused_mlp takes C <= 768,
    is never run (no model reads it), so the model serves on the card, f32
    against its plain run on the CPU."""
    from lc2is_tpu_torch.core.convert import seeded_init_
    from lc2is_tpu_torch.models.zoo import PromptAuxCrossA

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(class_names=("wall", "sky", "tree"), dec_dim=512, nhead=8,
              swin_cfg=dict(embed_dim=128, depths=(1, 1, 1, 1), num_heads=(4, 8, 16, 32)),
              cfg=dict(text_encoder=dict(context_length=10, vocab_size=49408,
                                         transformer_width=512, transformer_heads=8,
                                         transformer_layers=1, embed_dim=512),
                       context_decoder=dict(transformer_width=64, transformer_heads=4,
                                            transformer_layers=1),
                       context_length=5, text_dim=512))
    cpu = seeded_init_(PromptAuxCrossA(device="cpu", **kw), seed=26).eval()
    gpu = PromptAuxCrossA(device=cuda, **kw).eval()
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    x = _rand(np.random.RandomState(27), 2, 3, 128, 128, device="cpu")
    with torch.no_grad():
        want = cpu({"pixel_values": x})
        got = gpu({"pixel_values": x.to(cuda)})
    for key in ("outputs", "low_score_map"):
        assert torch.isfinite(got[key]).all()
        torch.testing.assert_close(got[key].cpu(), want[key], atol=1e-3, rtol=0)


def _window_inputs(rs, n, p, c, heads, dtype, regions):
    q, k, v = (_rand(rs, n, p, c, dtype=dtype) for _ in range(3))
    bias = _rand(rs, heads, p, p, scale=0.5)
    reg = None
    if regions:  # a few shift regions a window, each token's own included
        reg = torch.from_numpy(rs.randint(0, 3, size=(n, p)).astype(np.int32)).cuda()
    return q, k, v, bias, reg


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("regions", [False, True])
@pytest.mark.parametrize("n,p,heads,dh", [(37, 49, 3, 32), (5, 16, 2, 16), (3, 144, 2, 64),
                                          (7, 49, 4, 16), (6, 16, 3, 64), (4, 144, 3, 32),
                                          (9, 25, 5, 1), (2, 49, 1, 128), (3, 1, 2, 8),
                                          (2, 33, 2, 40)])
def test_window_attention_kernel(cuda, dtype, regions, n, p, heads, dh):
    """window_attention (TPU row 8) against its plain version at windows of
    4, 5, 7 and 12 (p 16, 25, 49, 144) and ragged p, head widths 1 to 128,
    with and without shift-region labels."""
    from lc2is_tpu_torch.ops.window_attention import window_attention, window_attention_plain

    args = _window_inputs(np.random.RandomState(p * dh + n), n, p, heads * dh, heads, dtype,
                          regions)
    _check(window_attention, window_attention, window_attention_plain, *args, heads)


@pytest.mark.parametrize("regions", [False, True])
@pytest.mark.parametrize("p", [1, 16, 49, 64, 65, 144])
@pytest.mark.parametrize("dh", [1, 6, 16, 24, 32, 128])
def test_window_attention_kernel_tile_edges(cuda, regions, p, dh):
    """The bf16 tensor-core body of window_attention at its tile edges: p
    inside one 16-row tile, at and past the 64-key bound, at the 144-key
    one; head widths zero-filled up to a multiple of 16 (1, 6, 24) and whole
    (16, 32, 128), through element (dh 1), 4-byte (dh 6) and 16-byte copies;
    555 windows of 2 heads, an odd number for the 2 windows a block takes."""
    from lc2is_tpu_torch.ops.window_attention import window_attention, window_attention_plain

    args = _window_inputs(np.random.RandomState(p * dh + regions), 555, p, 2 * dh, 2,
                          torch.bfloat16, regions)
    _check(window_attention, window_attention, window_attention_plain, *args, 2)


def test_window_attention_raises_and_backward(cuda):
    """Outside p 1-144 or head widths 1-128 the kernel raises with a message
    (the Pallas kernel takes any); a gradient through it runs the plain
    recompute backward and matches autograd through the plain version."""
    from lc2is_tpu_torch.ops.window_attention import (region_labels, window_attention,
                                                      window_attention_plain)

    rs = np.random.RandomState(30)
    for n, p, c, heads in [(2, 145, 64, 2), (2, 49, 258, 2)]:
        args = _window_inputs(rs, n, p, c, heads, torch.float32, False)
        with pytest.raises(ValueError, match="outside what it takes"):
            window_attention(*args, heads)
    for dtype in DTYPES:
        q, k, v, bias, _ = _window_inputs(rs, 32, 16, 64, 2, dtype, False)
        reg = region_labels(2, 16, 16, 4, 2, device=cuda)
        gout = _rand(rs, 32, 16, 64, dtype=dtype)
        grads = []
        for fn in (window_attention, window_attention_plain):
            leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v, bias)]
            (fn(*leaves, reg, 2).float() * gout.float()).sum().backward()
            grads.append([t.grad for t in leaves])
        for g, w in zip(*grads):
            assert g.dtype == w.dtype and torch.isfinite(g).all()
            rel = ((g.float() - w.float()).norm() / w.float().norm()).item()
            assert rel <= GRAD_TOL[dtype], rel


def test_swin_attention_module_on_card(cuda):
    """SwinAttention.forward (the windowed route) on the card against its CPU
    run, f32, shifted: stage-3 windows of one 512² image (C 384, 12 heads)."""
    from lc2is_tpu_torch.core.convert import seeded_init_
    from lc2is_tpu_torch.nn.swin import SwinAttention, window_partition
    from lc2is_tpu_torch.ops.window_attention import window_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = seeded_init_(SwinAttention(384, 12, 7), seed=31).eval()
    gpu = SwinAttention(384, 12, 7, device=cuda).eval()
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    x = window_partition(_rand(np.random.RandomState(32), 1, 35, 35, 384, device="cpu"), 7)
    before = window_attention.launches
    with torch.no_grad():
        want, got = cpu(x, (35, 35, 7, 3)), gpu(x.to(cuda), (35, 35, 7, 3))
    assert window_attention.launches == before + 1
    torch.testing.assert_close(got.cpu(), want, **TOL[torch.float32])


@pytest.mark.parametrize("name", ["BaseCrossA", "BaseSelfA", "PromptAuxSelfA"])
def test_small_v4_model_on_card(cuda, name):
    """A small v4 model (swin widths, one block a stage, 128²) on the card
    against its plain run on the CPU, f32: score maps within 1e-3, masks
    equal to the CPU scores' argmax but where its two best scores lie within
    2e-3 (twice the score bound), on at most 1e-3 of the pixels; bf16 finite."""
    from lc2is_tpu_torch.core.convert import seeded_init_
    from lc2is_tpu_torch.models import zoo

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(class_names=("wall", "sky", "tree", "floor"), dec_dim=512, nhead=8,
              swin_cfg=SMALL_SWIN)
    if name.startswith("Prompt"):
        kw["cfg"] = dict(text_encoder=dict(context_length=10, vocab_size=49408,
                                           transformer_width=512, transformer_heads=8,
                                           transformer_layers=1, embed_dim=512),
                         context_decoder=dict(transformer_width=64, transformer_heads=4,
                                              transformer_layers=1),
                         context_length=5, text_dim=512)
    cls = getattr(zoo, name)
    cpu = seeded_init_(cls(device="cpu", **kw), seed=33).eval()
    x = _rand(np.random.RandomState(34), 2, 3, 128, 128, device="cpu")
    for head in ({}, {"predict_masks": True}):
        gpu = cls(device=cuda, **head, **kw).eval()
        gpu.load_state_dict(cpu.state_dict(), strict=True)
        with torch.no_grad():
            got = gpu({"pixel_values": x.to(cuda)})
            if not head:
                want = cpu({"pixel_values": x})
                for key in want:
                    torch.testing.assert_close(got[key].cpu(), want[key], atol=1e-3, rtol=0)
                continue
            masks = got["outputs"].cpu()
            top2 = want["outputs"].topk(2, dim=1).values
            differ = masks != want["outputs"].argmax(1)
            assert (top2[:, 0] - top2[:, 1])[differ].le(2e-3).all()
            assert differ.float().mean() <= 1e-3
    gpu16 = cls(device=cuda, dtype=torch.bfloat16, **kw).eval()
    gpu16.load_state_dict(cpu.state_dict(), strict=True)
    with torch.no_grad():
        out = gpu16({"pixel_values": x.to(cuda)})
    assert all(torch.isfinite(o).all() for o in out.values())
