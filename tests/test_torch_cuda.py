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
"""

import numpy as np
import pytest
import torch

from lc2is_tpu_torch.ops.attention_block import (fused_attn_block, fused_attn_block_bwd,
                                                 fused_attn_block_plain)
from lc2is_tpu_torch.ops.fused_ce import upsampled_cross_entropy, upsampled_cross_entropy_plain
from lc2is_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_plain
from lc2is_tpu_torch.ops.swin_window import (swin_window_block, swin_window_block_bwd,
                                             swin_window_block_plain)
from lc2is_tpu_torch.ops.upsample import (upsample_tokens, upsample_tokens_adjoint,
                                          upsample_tokens_plain)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=2e-4, rtol=2e-4), torch.bfloat16: dict(atol=5e-2, rtol=2e-2)}
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]


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
    cpu = seeded_init_(PromptAuxCrossA(**kw), seed=5).eval()
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
    cpu = seeded_init_(PromptAuxCrossA(**kw), seed=5)
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
