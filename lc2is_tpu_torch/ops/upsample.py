"""Channels-last integer-factor bilinear upsample of (B, H·W, C) token grids.

Counterpart of ``lc2is_tpu/ops/upsample.py`` (entry ``upsample_tokens``
:167): torch half-pixel semantics with clamped edges (``upsample.py:14-16``,
``_phase_weights`` :30-39).  On a CUDA tensor :func:`upsample_tokens`
launches ``csrc/upsample.cu``, which takes every grid (the JAX wrapper's XLA
fallback for odd grids, ``upsample.py:133-142``, has no counterpart); on a
CPU tensor it runs :func:`upsample_tokens_plain`.

Both blend along W first, round the widened rows to the element type, then
blend along H, as the TPU kernel does.

The backward is the op's adjoint, rounded where the reference's backward
rounds (``_adj_kernel`` :186-229 at r = 2, XLA's VJP of ``_xla_reference``
otherwise): each output-gradient row's W-adjoint summed in f32 and rounded
to the element type, then the H-adjoint of those rows in f32, rounded once
(:func:`upsample_tokens_adjoint_plain`).  :func:`upsample_tokens` runs inside
a ``torch.autograd.Function`` on either device: on a CUDA tensor its forward
and backward launch ``csrc/upsample.cu``, on a CPU tensor they are the two
plain versions.
"""

from __future__ import annotations

from typing import Tuple

import torch

from lc2is_tpu_torch.ops import _build
from lc2is_tpu_torch.ops.dispatch import use_kernel


def _taps(n: int, r: int, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Clamped source indices (i0, i1) and the weight of i1 for each of the
    r·n outputs along one axis: src = (o + 0.5)/r - 0.5."""
    src = (torch.arange(n * r, device=device, dtype=torch.float64) + 0.5) / r - 0.5
    i0 = torch.floor(src)
    frac = (src - i0).float()
    i0 = i0.long()
    return i0.clamp(0, n - 1), (i0 + 1).clamp(0, n - 1), frac


def upsample_tokens_plain(x: torch.Tensor, grid_hw, r: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`upsample_tokens` (any device)."""
    b, p, c = x.shape
    h, w = grid_hw
    g = x.reshape(b, h, w, c)
    x0, x1, fx = _taps(w, r, x.device)
    fx = fx[None, None, :, None]
    wide = ((1.0 - fx) * g[:, :, x0].float() + fx * g[:, :, x1].float()).to(x.dtype)
    y0, y1, fy = _taps(h, r, x.device)
    fy = fy[None, :, None, None]
    out = (1.0 - fy) * wide[:, y0].float() + fy * wide[:, y1].float()
    return out.to(x.dtype).reshape(b, h * r * w * r, c)


def _adjoint_taps(n: int, r: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pos, wgt), each (n, 2r): for input i of an axis, the outputs
    o = r·i − r//2 + k (k ascending, clamped into range) whose blends can
    read i, and the weight of i in each (0 where o is out of range).  A
    clamped edge tap is folded onto the edge input, as the transposed resize
    matrix holds it: the weights of o's two taps are summed where both are i."""
    x0, x1, fx = _taps(n, r, device)
    m = torch.zeros(n * r, n, dtype=torch.float32, device=device)
    o = torch.arange(n * r, device=device)
    m.index_put_((o, x0), 1.0 - fx, accumulate=True)
    m.index_put_((o, x1), fx, accumulate=True)
    i = torch.arange(n, device=device)[:, None]
    pos = r * i - r // 2 + torch.arange(2 * r, device=device)[None]
    valid = (pos >= 0) & (pos < n * r)
    pos = pos.clamp(0, n * r - 1)
    return pos, torch.where(valid, m[pos, i], 0.0)


def _adjoint_sum(t: torch.Tensor, dim: int, n: int, r: int) -> torch.Tensor:
    """The adjoint of one axis's blend: Σ_k wgt[i, k] · t[pos[i, k]] along
    ``dim`` (r·n -> n), in f32, left to right in k."""
    pos, wgt = _adjoint_taps(n, r, t.device)
    shape = [1] * t.dim()
    shape[dim] = n
    acc = None
    for k in range(2 * r):
        term = wgt[:, k].view(shape) * t.index_select(dim, pos[:, k]).float()
        acc = term if acc is None else acc + term
    return acc


def upsample_tokens_adjoint_plain(g: torch.Tensor, grid_hw, r: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`upsample_tokens_adjoint` (any device):
    the W-adjoint of each output-gradient row, rounded to the element type,
    then the H-adjoint of those rows, rounded once."""
    b, p_out, c = g.shape
    h, w = grid_hw
    narrow = _adjoint_sum(g.reshape(b, h * r, w * r, c), 2, w, r).to(g.dtype)
    return _adjoint_sum(narrow, 1, h, r).to(g.dtype).reshape(b, h * w, c)


def upsample_tokens_adjoint(g: torch.Tensor, grid_hw, r: int) -> torch.Tensor:
    """The backward of :func:`upsample_tokens`: (B, rH·rW, C) output gradient
    -> (B, H·W, C) input gradient, ``grid_hw`` the INPUT grid.  A CUDA tensor
    launches ``csrc/upsample.cu``; a CPU tensor takes the plain version."""
    b, p_out, c = g.shape
    h, w = grid_hw
    if p_out != h * r * w * r:
        raise ValueError(f"{p_out} output tokens do not match grid {grid_hw} x {r}")
    if not use_kernel(g):
        return upsample_tokens_adjoint_plain(g, grid_hw, r)
    gc = g.contiguous()
    dx = torch.empty((b, h * w, c), dtype=g.dtype, device=g.device)
    _build.launch("lc2_upsample_adjoint", gc.device, _build.dtype_code(gc), gc.data_ptr(),
                  dx.data_ptr(), b, h, w, c, r, _build.stream_of(gc))
    upsample_tokens_adjoint.launches += 1
    return dx


upsample_tokens_adjoint.launches = 0


def _launch_fwd(x: torch.Tensor, grid_hw, r: int) -> torch.Tensor:
    b, p, c = x.shape
    h, w = grid_hw
    xc = x.contiguous()
    out = torch.empty((b, h * r * w * r, c), dtype=x.dtype, device=x.device)
    _build.launch("lc2_upsample", xc.device, _build.dtype_code(xc), xc.data_ptr(), out.data_ptr(),
                  b, h, w, c, r, _build.stream_of(xc))
    upsample_tokens.launches += 1
    return out


class _UpsampleTokens(torch.autograd.Function):
    """The forward (the kernel on a CUDA tensor, else the plain version) with
    :func:`upsample_tokens_adjoint` as its backward."""

    @staticmethod
    def forward(ctx, x, grid_hw, r):
        ctx.cfg = (tuple(grid_hw), r)
        if use_kernel(x):
            return _launch_fwd(x, grid_hw, r)
        return upsample_tokens_plain(x, grid_hw, r)

    @staticmethod
    def backward(ctx, g):
        return upsample_tokens_adjoint(g, *ctx.cfg), None, None


def upsample_tokens(x: torch.Tensor, grid_hw, r: int) -> torch.Tensor:
    """(B, H·W, C) -> (B, rH·rW, C), torch-bilinear half-pixel semantics."""
    if int(r) != r or r < 2:
        raise ValueError(f"integer factor >= 2 expected, got {r}")
    r = int(r)
    b, p, c = x.shape
    h, w = grid_hw
    if h * w != p:
        raise ValueError(f"grid {grid_hw} does not match {p} tokens")
    return _UpsampleTokens.apply(x, (h, w), r)


upsample_tokens.launches = 0
