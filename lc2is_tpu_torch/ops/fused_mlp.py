"""Fused transformer MLP: LayerNorm + Linear + activation + Linear (+ residual).

Counterpart of ``lc2is_tpu/ops/fused_mlp.py`` (entry ``fused_mlp`` :318).
Two orderings, matching the two module families:

- ``ln_position="pre"`` (swin block):   out = x + W2·act(W1·LN(x))
- ``ln_position="post"`` (torch layer): out = LN(x + W2·act(W1·x))

On a CUDA tensor :func:`fused_mlp` launches the Hopper kernel
``csrc/fused_mlp.cu``: two products on a hand-written tensor-core GEMM, the
activation in the first one's epilogue, LayerNorm passes before or after;
the (T, F) hidden activation goes through a scratch buffer.  In bf16 the
GEMM of ``csrc/gemm_bf16.cuh`` (scratch ``lc2_fused_mlp_workspace_bf16``),
in f32 the 3xTF32 GEMM of ``csrc/gemm_f32x3.cuh`` (every product three TF32
tensor-core products, f32-accurate; scratch ``lc2_fused_mlp_workspace_f32``).
On a CPU tensor it runs :func:`fused_mlp_plain`, the same function in plain
PyTorch (the module composition of ``fused_mlp.py:146-167``).

Activation policy as in ``fused_mlp.py:89-101``: ``gelu`` is the
division-free polynomial for bf16 and exact erf for f32; ``relu`` for the
decoder layers.

Training: on a CUDA tensor the kernel runs inside a ``torch.autograd.Function``
that also saves the (T, F) pre-activation (``save_upre``, as ``_vjp_fwd`` of
``fused_mlp.py:178-183``); its backward is the analytic backward of
``fused_mlp.py:198-255`` in torch, with the exact-gelu derivative and the same
rounding points (the JAX package computes it in XLA, outside any Pallas
kernel).  On a CPU tensor autograd runs through the plain version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from lc2is_tpu_torch.ops import _build
from lc2is_tpu_torch.ops.dispatch import use_kernel

_ACT_CODES = {"relu": 0, "gelu_erf": 1, "gelu_poly": 2}
KERNEL_WIDTHS = (96, 128, 192, 256, 384, 512, 768, 1024)  # C values csrc/fused_mlp.cu instantiates


def gelu_poly(x: torch.Tensor) -> torch.Tensor:
    """Division-free f32 gelu of ``fused_mlp.py:62-86``: t/2 + t²·P(t²) on
    [-4, 4], identity above 4 (max abs error 4.1e-4 against erf-gelu)."""
    t = x.clamp(-4.0, 4.0)
    u = t * t
    p = torch.full_like(u, -1.5484756e-09)
    for c in (1.1899754e-07, -4.014895e-06, 7.932062e-05, -0.001037015,
              0.00961666, -0.066079915, 0.3987861):
        p = p * u + c
    return torch.where(x > 4.0, x, 0.5 * t + u * p)


def _act_name(activation: str, dtype: torch.dtype) -> str:
    if activation == "relu":
        return "relu"
    if activation == "gelu":
        return "gelu_poly" if dtype == torch.bfloat16 else "gelu_erf"
    raise ValueError(activation)


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "relu":
        return torch.relu(x)
    if name == "gelu_poly":
        return gelu_poly(x)
    return F.gelu(x)


def _ln(v: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm with f32 statistics, cast back to ``v``'s dtype."""
    vf = v.float()
    return F.layer_norm(vf, vf.shape[-1:], w.float(), b.float(), eps).to(v.dtype)


def fused_mlp_plain(x, ln_w, ln_b, w1, b1, w2, b2, activation="gelu",
                    ln_position="pre", residual=True, eps=1e-5):
    """Plain PyTorch version of :func:`fused_mlp` (any device)."""
    act = _act_name(activation, x.dtype)
    dt = x.dtype

    def ff(h):
        u = _act(act, F.linear(h, w1.to(dt), b1.to(dt)).float()).to(dt)
        return F.linear(u, w2.to(dt), b2.to(dt))

    if ln_position == "pre":
        y = ff(_ln(x, ln_w, ln_b, eps))
        return x + y if residual else y
    y = ff(x)
    return _ln(x + y if residual else y, ln_w, ln_b, eps)


def _act_prime(act: str, upre: torch.Tensor) -> torch.Tensor:
    """d act / d upre (f32): the exact-gelu derivative Φ(x) + x·φ(x) for
    either gelu policy, as ``fused_mlp.py:186-195``."""
    if act == "relu":
        return (upre > 0).float()
    cdf = 0.5 * (1.0 + torch.erf(upre * 0.7071067811865476))
    pdf = torch.exp(-0.5 * upre * upre) * 0.3989422804014327
    return cdf + upre * pdf


def _ln_bwd(dy, sf, w, eps):
    """LayerNorm backward from the pre-norm rows ``sf`` (f32):
    (d input, d weight, d bias)."""
    mean = sf.mean(-1, keepdim=True)
    sc = sf - mean
    rstd = torch.rsqrt((sc * sc).mean(-1, keepdim=True) + eps)
    shat = sc * rstd
    dshat = dy * w
    ds = (dshat - dshat.mean(-1, keepdim=True) - shat * (dshat * shat).mean(-1, keepdim=True)) * rstd
    return ds, (dy * shat).sum(0), dy.sum(0)


def fused_mlp_bwd(x, g, upre, ln_w, ln_b, w1, b1, w2, b2, activation="gelu", ln_position="pre",
                  residual=True, eps=1e-5):
    """Gradients of :func:`fused_mlp` w.r.t. (x, ln_w, ln_b, w1, b1, w2, b2)
    from the saved pre-activation ``upre``: ``fused_mlp.py::_vjp_bwd``
    (:198-255) in torch, rounding to x's dtype where it does.  Parameter
    gradients come back in f32."""
    dt = x.dtype
    c = x.shape[-1]
    act = _act_name(activation, dt)
    x2 = x.reshape(-1, c)
    g2 = g.reshape(-1, c).float()
    upf = upre.float()
    u = _act(act, upf).to(dt)
    lnw_f = ln_w.float()
    if ln_position == "pre":
        h = _ln(x2, ln_w, ln_b, eps)
        dy = g2
    else:
        y = F.linear(u, w2.to(dt), b2.to(dt)).float()
        sf = x2.float() + y if residual else y
        dy, dlnw, dlnb = _ln_bwd(g2, sf, lnw_f, eps)
        h = x2
    dyb = dy.to(dt)
    dw2 = (dyb.t() @ u).float()
    db2 = dy.sum(0)
    du = (dyb @ w2.to(dt)).float()
    dupre = du * _act_prime(act, upf)
    dupb = dupre.to(dt)
    dw1 = (dupb.t() @ h).float()
    db1 = dupre.sum(0)
    dh = (dupb @ w1.to(dt)).float()
    if ln_position == "pre":
        dx, dlnw, dlnb = _ln_bwd(dh, x2.float(), lnw_f, eps)
        if residual:
            dx = dx + g2
    else:
        dx = dh + dy if residual else dh
    return dx.to(dt).reshape(x.shape), dlnw, dlnb, dw1, db1, dw2, db2


def _launch(x, ln_w, ln_b, w1, b1, w2, b2, activation, ln_position, residual, eps, save_upre):
    c = x.shape[-1]
    f = w1.shape[0]
    dt = x.dtype
    xt = _build.contiguous16(x.reshape(-1, c))
    n = xt.shape[0]
    pre = int(ln_position == "pre")
    lnw, lnb, w1c, w2c = (_build.contiguous16(t.to(dt)) for t in (ln_w, ln_b, w1, w2))
    # f32 holding the biases of the dtype: the TPU kernel adds them in f32
    b1f, b2f = (t.to(dt).float().contiguous() for t in (b1, b2))
    ws_size = ("lc2_fused_mlp_workspace_bf16" if dt == torch.bfloat16
               else "lc2_fused_mlp_workspace_f32")
    ws = torch.empty(_build.size(ws_size, n, c, f, pre), dtype=torch.float32, device=x.device)
    out = torch.empty_like(xt)
    upre = torch.empty((n, f), dtype=dt, device=x.device) if save_upre else None
    _build.launch(
        "lc2_fused_mlp", xt.device, _build.dtype_code(xt),
        *(t.data_ptr() for t in (xt, lnw, lnb, w1c, b1f, w2c, b2f, out)), _build.ptr(upre),
        ws.data_ptr(), n, c, f, _ACT_CODES[_act_name(activation, dt)], pre, int(residual),
        float(eps), _build.stream_of(xt))
    fused_mlp.launches += 1
    return out.reshape(x.shape), upre


class _FusedMLP(torch.autograd.Function):
    """The kernel forward (saving the pre-activation when a gradient is
    wanted) with :func:`fused_mlp_bwd` as its backward."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w1, b1, w2, b2, activation, ln_position, residual, eps):
        train = any(ctx.needs_input_grad[:7])
        out, upre = _launch(x, ln_w, ln_b, w1, b1, w2, b2, activation, ln_position, residual,
                            eps, save_upre=train)
        if train:
            ctx.save_for_backward(x, upre, ln_w, ln_b, w1, b1, w2, b2)
        ctx.cfg = (activation, ln_position, residual, eps)
        return out

    @staticmethod
    def backward(ctx, g):
        x, upre, *params = ctx.saved_tensors
        dx, *dparams = fused_mlp_bwd(x, g, upre, *params, *ctx.cfg)
        return (dx, *(d.to(p.dtype) for d, p in zip(dparams, params)), None, None, None, None)


def fused_mlp(x, ln_w, ln_b, w1, b1, w2, b2, activation="gelu", ln_position="pre",
              residual=True, eps=1e-5):
    """out = [x +] W2·act(W1·LN(x))  (pre)  or  LN([x +] W2·act(W1·x))  (post).

    x (..., C); ln_w, ln_b (C,); w1 (F, C), w2 (C, F) torch layout; b1 (F,),
    b2 (C,).  Weights are cast to x's dtype, as the TPU entry does.
    Differentiable on both devices."""
    if ln_position not in ("pre", "post"):
        raise ValueError(ln_position)
    if not use_kernel(x):
        return fused_mlp_plain(x, ln_w, ln_b, w1, b1, w2, b2, activation,
                               ln_position, residual, eps)
    c = x.shape[-1]
    f = w1.shape[0]
    if c not in KERNEL_WIDTHS or f % 64:
        raise ValueError(f"fused_mlp kernel takes C in {KERNEL_WIDTHS} and F % 64 == 0, "
                         f"got C={c} F={f}")
    _build.check_operands(x.device, ln_w=(ln_w, (c,)), ln_b=(ln_b, (c,)), w1=(w1, (f, c)),
                          b1=(b1, (f,)), w2=(w2, (c, f)), b2=(b2, (c,)))
    return _FusedMLP.apply(x, ln_w, ln_b, w1, b1, w2, b2, activation, ln_position, residual,
                           eps)


fused_mlp.launches = 0
