"""The served mask head: argmax over classes of a bilinear ×r upsample of the
class scores, without the (B, K, r·h, r·w) map.

Counterpart of ``lc2is_tpu/ops/upsample_argmax.py``, with its two entry
points:

- :func:`score_upsample_argmax` (``:197``, TPU kernel ``_score_kernel``
  :117): L2-normalise the decoder tokens, cosine scores against the
  normalised class embeddings, scores rounded to the compute dtype, bilinear
  ×r, argmax;
- :func:`upsample_argmax` (``:72``, TPU kernel ``_kernel`` :33): the second
  half alone, from a (B, K, h, w) score map.

Both return int32 (B, r·h, r·w).  On a CUDA tensor each launches
``csrc/upsample_argmax.cu``; on a CPU tensor each runs its plain version.
The arithmetic is the TPU kernels': the H blend first, then the W blend, in
f32 with the phase weights of ``lc2is_tpu/ops/upsample.py:30-39``; edge rows
and columns clamp; ties go to the lowest class.  Forward only, like argmax.
"""

from __future__ import annotations

import torch

from lc2is_tpu_torch.ops import _build
from lc2is_tpu_torch.ops.dispatch import use_kernel

MAX_CLASSES = 256  # csrc/upsample_argmax.cu keeps a tile's K x 180 scores in shared memory


def l2_normalize(x: torch.Tensor, dim: int, eps: float = 1e-12) -> torch.Tensor:
    """torch F.normalize(p=2) as the JAX package writes it (``zoo.py:49-52``):
    x / max(‖x‖, eps), the norm taken in f32, the division in x's dtype."""
    n = x.float().square().sum(dim=dim, keepdim=True).sqrt()
    return (x / n.clamp_min(eps).to(x.dtype)).to(x.dtype)


def _phase_weights(r: int):
    """[(use_prev, w_other, w_cur)] per phase m: out r·i+m = w_other·x[i∓1] + w_cur·x[i]
    (``lc2is_tpu/ops/upsample.py:30-39``)."""
    out = []
    for m in range(r):
        off = (m + 0.5) / r - 0.5
        out.append((True, -off, 1.0 + off) if off < 0 else (False, off, 1.0 - off))
    return out


def upsample_blend_plain(scores: torch.Tensor, r: int) -> torch.Tensor:
    """(B, K, h, w) -> (B, K, r·h, r·w) f32: the kernels' bilinear ×r, H blend
    then W blend, each ``w_other·other + w_cur·cur`` in f32, edges clamped."""
    s = scores.float()
    b, k, h, w = s.shape

    def blend(t, dim, n):
        i = torch.arange(n, device=t.device)
        prev = t.index_select(dim, (i - 1).clamp_min(0))
        nxt = t.index_select(dim, (i + 1).clamp_max(n - 1))
        return torch.stack([wo * (prev if use_prev else nxt) + wc * t
                            for use_prev, wo, wc in _phase_weights(r)], dim=dim + 1)

    hrow = blend(s, 2, h).reshape(b, k, h * r, w)
    return blend(hrow, 3, w).reshape(b, k, h * r, w * r)


def argmax_lowest(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """int32 argmax over ``dim``, ties to the lowest index (the kernels'
    min-trick, ``upsample_argmax.py:66-68``)."""
    k = x.shape[dim]
    ids = torch.arange(k, device=x.device).reshape((k,) + (1,) * (x.dim() - dim - 1))
    sel = torch.where(x == x.amax(dim, keepdim=True), ids, k)
    return sel.amin(dim).int()


def score_map_plain(v_tokens: torch.Tensor, t_norm: torch.Tensor, grid: int,
                    eps: float = 1e-12) -> torch.Tensor:
    """(B, K, grid, grid) f32 cosine scores, rounded to v_tokens' dtype, as
    the fused kernel computes them (``upsample_argmax.py:128-139``)."""
    b, p, c = v_tokens.shape
    v = l2_normalize(v_tokens.reshape(b, grid, grid, c), -1, eps)
    s = torch.einsum("bhwc,bkc->bkhw", v.float(), t_norm.float())
    return s.to(v_tokens.dtype).float()


def _masks_plain(scores: torch.Tensor, r: int) -> torch.Tensor:
    # one image at a time: the blended map is (K, r·h, r·w) f32
    return torch.cat([argmax_lowest(upsample_blend_plain(s[None], r)) for s in scores])


def score_upsample_argmax_plain(v_tokens, t_norm, grid, r=4, eps=1e-12):
    """Plain PyTorch version of :func:`score_upsample_argmax` (any device)."""
    return _masks_plain(score_map_plain(v_tokens, t_norm, grid, eps), r)


def upsample_argmax_plain(score_map, r=4):
    """Plain PyTorch version of :func:`upsample_argmax` (any device)."""
    return _masks_plain(score_map, r)


def _check_r(r):
    if int(r) != r or r < 1:
        raise ValueError(f"integer factor >= 1 expected, got {r}")
    return int(r)


def score_upsample_argmax(v_tokens: torch.Tensor, t_norm: torch.Tensor, grid: int, r: int = 4,
                          eps: float = 1e-12) -> torch.Tensor:
    """argmax_k bilinear_up(cosine_scores)[k]: (B, r·grid, r·grid) int32.

    v_tokens (B, grid², C) decoder tokens (not normalised); t_norm (B, K, C)
    L2-normalised class embeddings in v_tokens' dtype."""
    r = _check_r(r)
    b, p, c = v_tokens.shape
    k = t_norm.shape[1]
    if p != grid * grid:
        raise ValueError(f"{p} tokens do not form a {grid}² grid")
    if not use_kernel(v_tokens):
        return score_upsample_argmax_plain(v_tokens, t_norm, grid, r, eps)
    if not 1 <= k <= MAX_CLASSES or t_norm.dtype != v_tokens.dtype:
        raise ValueError(f"score_upsample_argmax kernel takes 1 <= K <= {MAX_CLASSES} classes "
                         f"in the tokens' dtype, got K={k} {t_norm.dtype} / {v_tokens.dtype}")
    _build.check_operands(v_tokens.device, t_norm=(t_norm, (b, k, c)))
    vc, tc = v_tokens.contiguous(), t_norm.contiguous()
    out = torch.empty((b, r * grid, r * grid), dtype=torch.int32, device=vc.device)
    _build.launch("lc2_score_upsample_argmax", vc.device, _build.dtype_code(vc), vc.data_ptr(),
                  tc.data_ptr(), out.data_ptr(), b, grid, grid, c, k, r, float(eps),
                  _build.stream_of(vc))
    score_upsample_argmax.launches += 1
    return out


score_upsample_argmax.launches = 0


def upsample_argmax(score_map: torch.Tensor, r: int = 4) -> torch.Tensor:
    """argmax_k of the bilinear r× upsample of score_map (B, K, h, w): (B, r·h,
    r·w) int32, equal to argmax(resize(score_map, scale_factor=r), 1)."""
    r = _check_r(r)
    b, k, h, w = score_map.shape
    if not use_kernel(score_map):
        return upsample_argmax_plain(score_map, r)
    if not 1 <= k <= MAX_CLASSES:
        raise ValueError(f"upsample_argmax kernel takes 1 <= K <= {MAX_CLASSES}, got {k}")
    mc = score_map.contiguous()
    out = torch.empty((b, r * h, r * w), dtype=torch.int32, device=mc.device)
    _build.launch("lc2_upsample_argmax", mc.device, _build.dtype_code(mc), mc.data_ptr(),
                  out.data_ptr(), b, k, h, w, r, _build.stream_of(mc))
    upsample_argmax.launches += 1
    return out


upsample_argmax.launches = 0
