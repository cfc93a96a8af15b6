"""Int8 serving: the quantisers and the int8 fused MLP.

Counterpart of ``lc2is_tpu/ops/quant.py``.  The scheme (serving only, no
backward):

- weights: per output channel, symmetric, scale max|w_row| / 127 (at least
  1e-12), quantised from the float weights at call time, so checkpoints stay
  float (``quant.py:34-42``);
- activations: per token, symmetric, quantised right before each product
  (``quant_act`` :45-52);
- product: s8 x s8 summed exactly, dequantised as (acc · s_act) · s_w in f32
  (``qdot`` :55-62).

Rounding is half to even (``torch.round``, as ``jnp.round``) after a true
division.  The plain versions sum the int8 products exactly: in int32 on the
CPU, in float64 on the card (PyTorch has no int32 matrix product there; the
sums are integers far below 2^53).

:func:`fused_mlp_q` is the int8 twin of ``ops/fused_mlp.fused_mlp`` (TPU
kernel ``_mlp_q_kernel`` :70, entry ``fused_mlp_q`` :94): pre- or post-LN,
gelu or relu, residual, with the activation policy of ``fused_mlp`` (the
polynomial gelu in bf16, erf in f32).  Unlike the float MLP it keeps the
LayerNorm output and the activation in f32 until they are quantised.  On a
CUDA tensor it launches ``csrc/fused_mlp_q.cu``: in bf16 its tensor-core
body (the weights handed over in f32 and quantised on the card, a row pass,
then the ``mma.sync`` s8 GEMM of ``csrc/gemm_s8.cuh`` three times, the hidden
activation recomputed for its row max; scratch
``lc2_fused_mlp_q_workspace_bf16``), in f32 its one-pass WMMA body, which
takes the weights quantised here as panels (:func:`k_panels`) and F <= 3072.
On a CPU tensor it runs :func:`fused_mlp_q_plain`.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from lc2is_tpu_torch.ops import _build
from lc2is_tpu_torch.ops.dispatch import use_kernel
from lc2is_tpu_torch.ops.fused_mlp import _ACT_CODES, _act, _act_name

KERNEL_WIDTHS = (96, 128, 192, 256, 384, 512, 768)  # C values csrc/fused_mlp_q.cu instantiates
# csrc/fused_mlp_q.cu's f32 body keeps 16 rows of the f32 hidden in shared memory
MAX_HIDDEN_F32 = 3072


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, in) float weights -> (int8 (out, in), f32 (1, out) scales)."""
    wf = w.float()
    s = (wf.abs().amax(dim=1, keepdim=True) / 127.0).clamp_min(1e-12)
    return torch.round(wf / s).to(torch.int8), s.reshape(1, -1)


def quant_act(h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token (last axis) symmetric int8: (..., C) -> (int8 (..., C), f32 (..., 1))."""
    hf = h.float()
    s = (hf.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-12)
    return torch.round(hf / s).to(torch.int8), s


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., K) int8 times b (N, K) int8 contracted on K -> int32 (..., N), exact."""
    if a.is_cuda:
        return (a.double() @ b.double().T).to(torch.int32)
    return a.int() @ b.int().T


def qdot(h: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """h (..., C) float x wq (F, C) int8 with ws (1, F) scales -> (..., F) f32."""
    hi, s = quant_act(h)
    return int8_matmul(hi, wq).float() * s * ws.reshape(-1)


def forward_only(name: str, *tensors: torch.Tensor) -> None:
    """Raise if autograd would need a gradient through an int8 op: the path
    is serving only, as in the JAX package (no VJP there)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} is serving only (int8, no backward): "
                           "call it under torch.no_grad()")


def _ln32(xf, w, b, eps):
    return F.layer_norm(xf, xf.shape[-1:], w.float(), b.float(), eps)


def fused_mlp_q_plain(x, ln_w, ln_b, w1, b1, w2, b2, activation="gelu", ln_position="pre",
                      residual=True, eps=1e-5):
    """Plain PyTorch version of :func:`fused_mlp_q` (any device)."""
    act = _act_name(activation, x.dtype)
    w1q, w1s = quantize_weight(w1)
    w2q, w2s = quantize_weight(w2)
    xf = x.float()

    def ff(h):
        upre = qdot(h, w1q, w1s) + b1.float()
        return qdot(_act(act, upre), w2q, w2s) + b2.float()

    if ln_position == "pre":
        y = ff(_ln32(xf, ln_w, ln_b, eps))
        out = xf + y if residual else y
    else:
        y = ff(xf)
        out = _ln32(xf + y if residual else y, ln_w, ln_b, eps)
    return out.to(x.dtype)


def k_panels(q: torch.Tensor) -> torch.Tensor:
    """int8 (N, K) -> [K/16][N][16]: each 16-wide slice of the contraction
    contiguous, so every 16 x 16 WMMA tile the f32 body loads is 256-byte
    aligned."""
    n, k = q.shape
    return q.reshape(n, k // 16, 16).transpose(0, 1).contiguous()


def fused_mlp_q(x, ln_w, ln_b, w1, b1, w2, b2, activation="gelu", ln_position="pre",
                residual=True, eps=1e-5):
    """Int8 twin of ``fused_mlp``: out = [x +] W2·act(W1·LN(x)) (pre) or
    LN([x +] W2·act(W1·x)) (post), both products in int8.  x (..., C); w1 (F, C),
    w2 (C, F) float (quantised here); ln_w, ln_b, b1, b2 float, used in f32."""
    if ln_position not in ("pre", "post"):
        raise ValueError(ln_position)
    forward_only("fused_mlp_q", x, ln_w, ln_b, w1, b1, w2, b2)
    if not use_kernel(x):
        return fused_mlp_q_plain(x, ln_w, ln_b, w1, b1, w2, b2, activation, ln_position,
                                 residual, eps)
    c = x.shape[-1]
    f = w1.shape[0]
    bf16 = x.dtype == torch.bfloat16
    if c not in KERNEL_WIDTHS or (f % 16 if bf16 else f % 64 or f > MAX_HIDDEN_F32):
        raise ValueError(f"fused_mlp_q kernel takes C in {KERNEL_WIDTHS} and F % 16 == 0 "
                         f"(bf16) or F % 64 == 0 and F <= {MAX_HIDDEN_F32} (f32), "
                         f"got C={c} F={f} {x.dtype}")
    _build.check_operands(x.device, ln_w=(ln_w, (c,)), ln_b=(ln_b, (c,)), w1=(w1, (f, c)),
                          b1=(b1, (f,)), w2=(w2, (c, f)), b2=(b2, (c,)))
    xt = _build.contiguous16(x.reshape(-1, c))
    vecs = [_build.contiguous16(t.float()) for t in (ln_w, ln_b, b1, b2)]
    if bf16:  # the tensor-core body quantises the f32 weights itself, torch layout
        w1a, w2a = (_build.contiguous16(w.float()) for w in (w1, w2))
        s1 = s2 = None
        ws = torch.empty(_build.size("lc2_fused_mlp_q_workspace_bf16", xt.shape[0], c, f,
                                     int(ln_position == "pre")),
                         dtype=torch.float32, device=x.device)
    else:
        w1q, s1 = quantize_weight(w1)
        w2q, s2 = quantize_weight(w2)
        w1a, w2a = k_panels(w1q), k_panels(w2q)
        ws = None
    out = torch.empty_like(xt)
    ptr = _build.ptr
    _build.launch(
        "lc2_fused_mlp_q", xt.device, _build.dtype_code(xt), xt.data_ptr(), vecs[0].data_ptr(),
        vecs[1].data_ptr(), w1a.data_ptr(), ptr(s1), vecs[2].data_ptr(), w2a.data_ptr(), ptr(s2),
        vecs[3].data_ptr(), out.data_ptr(), ptr(ws), xt.shape[0], c, f,
        _ACT_CODES[_act_name(activation, x.dtype)], int(ln_position == "pre"), int(residual),
        float(eps), _build.stream_of(xt))
    fused_mlp_q.launches += 1
    return out.reshape(x.shape)


fused_mlp_q.launches = 0
