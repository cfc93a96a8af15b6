"""Swin Transformer backbone, counterpart of ``lc2is_tpu/nn/swin.py``
(``SwinModel``, HF ``SwinModel`` semantics, swin-small ``SWIN_SMALL`` :615,
swin-base ``SWIN_BASE`` :616).

Every block runs its two halves through the ported kernels: the attention
half is ``ops/swin_window.swin_window_block`` (LN, packed QKV, shifted
window attention with the relative-position bias, HF pad-after-LN,
out-projection, residual) on the raw (B, H, W, C) canvas, and the MLP half is
``ops/fused_mlp.fused_mlp`` (pre-LN, gelu, residual).  Patch merging is HF's
slices -> LayerNorm -> reduction in plain torch (the JAX package's merge-conv,
``swin.py:431-479``, is an exact reassociation of the same function).

``forward`` returns HF's ``hidden_states``: the patch embedding (after
``embed_norm``) followed by each stage's output after patch merging.  With
``num_hidden`` it runs only the stages those first entries need: every model
reads ``hidden_states[:4]`` (``lc2is_tpu/models/zoo.py:240,270,295,373``), so
the last stage of a 4-stage backbone never runs, as XLA drops its unread
blocks under ``jit``.  Its parameters stay (a strict load is unchanged).

Stochastic depth (training): ``drop_path_rate`` is spread over the blocks by
``linspace`` (``swin.py:525,534``).  In training mode with a rate above 0 the
kernels run with ``residual=False`` and the per-sample drop-path mask and the
residual add happen outside them (``swin.py:316-335``); the masks come from
the ``torch.Generator`` passed to ``forward``, never from a global state.

The windowed attention route of the JAX package (``SwinAttention`` called
on partitioned windows, ``swin.py:130-210``) is here too: ``SwinAttention.
forward`` over ``ops/window_attention.window_attention`` (the port of TPU
row 8), with ``window_partition`` / ``window_reverse`` and HF's
``_shift_attn_mask``.  ``SwinBlock`` does not take it: like the JAX block on
its fused route, it reads the attention's parameters into
``swin_window_block``.

Int8 serving (``quant=True``, ``swin.py:245,324-329,385-390``): the MLP half
goes through ``ops/quant.fused_mlp_q`` whenever drop path is off.  The
attention half is int8 (``swin_window_block_q``) only where the JAX package
takes its windowed kernel, which has the int8 branch; where it takes the
canvas kernel, which has none, the half stays float.  That is the canvas gate
of ``swin.py:290-306`` at its default values: C <= 384 and the canvas fits
(bf16, or H·W·C·4 bytes <= 4 MiB in f32), so in bf16 only stage 4 is int8,
and in f32 at 512² stage 1 is too.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from lc2is_tpu_torch.nn.layers import LayerNorm, Linear, _param, s2d_matmul
from lc2is_tpu_torch.ops.fused_mlp import fused_mlp
from lc2is_tpu_torch.ops.quant import fused_mlp_q
from lc2is_tpu_torch.ops.swin_window import swin_window_block, swin_window_block_q
from lc2is_tpu_torch.ops.window_attention import region_labels, window_attention

SWIN_SMALL = dict(embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24))
SWIN_BASE = dict(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32))

# the JAX package's canvas-kernel gate at its defaults (swin.py:290-296)
CANVAS_MAX_C = 384
CANVAS_MAX_F32_BYTES = 4 * 1024 * 1024


def takes_canvas_kernel(h: int, w: int, c: int, dtype: torch.dtype) -> bool:
    """Whether the JAX package serves this attention half with its canvas
    kernel (no int8 branch) rather than its windowed one."""
    fits = dtype == torch.bfloat16 or h * w * c * dtype.itemsize <= CANVAS_MAX_F32_BYTES
    return c <= CANVAS_MAX_C and fits


@functools.lru_cache(maxsize=32)
def _relative_position_index(window: int, table_window: Optional[int] = None) -> np.ndarray:
    """Index into a (2·tw-1)² bias table for an effective window ``window``
    (smaller than the table's when the grid is smaller than the window),
    ``swin.py:40-53``."""
    tw = table_window or window
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += tw - 1
    rel[:, :, 1] += tw - 1
    rel[:, :, 0] *= 2 * tw - 1
    return rel.sum(-1)  # (w², w²)


def _shift_attn_mask(hp: int, wp: int, window: int, shift: int) -> Optional[torch.Tensor]:
    """HF ``get_attn_mask`` (``swin.py:56-76``): (nW, w², w²) f32 additive
    mask, -100 where two tokens lie in different shift regions; None when
    ``shift`` is 0."""
    lab = region_labels(1, hp, wp, window, shift)
    if lab is None:
        return None
    return torch.where(lab[:, None, :] != lab[:, :, None], -100.0, 0.0)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B·nW, w², C) (``swin.py:79-84``)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c).transpose(2, 3)
    return x.reshape(-1, window * window, c)


def window_reverse(x: torch.Tensor, window: int, h: int, w: int) -> torch.Tensor:
    """(B·nW, w², C) -> (B, H, W, C) (``swin.py:87-93``)."""
    c = x.shape[-1]
    b = x.shape[0] // ((h // window) * (w // window))
    x = x.reshape(b, h // window, w // window, window, window, c).transpose(2, 3)
    return x.reshape(b, h, w, c)


class SwinSelfAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, device=None):
        super().__init__()
        self.num_heads, self.window = num_heads, window
        self.query = Linear(dim, dim, device=device)
        self.key = Linear(dim, dim, device=device)
        self.value = Linear(dim, dim, device=device)
        n = 2 * window - 1
        self.relative_position_bias_table = _param(n * n, num_heads, device=device)

    def bias(self, eff_window: int) -> torch.Tensor:
        """(heads, w², w²) f32 relative-position bias of an effective window."""
        p = eff_window * eff_window
        idx = torch.from_numpy(_relative_position_index(eff_window, self.window).reshape(-1))
        table = self.relative_position_bias_table
        return table[idx.to(table.device)].reshape(p, p, self.num_heads).permute(2, 0, 1).float()

    def packed(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(wqkv (3C, C), bqkv (3C,)): q|k|v packed, no other transform."""
        lins = (self.query, self.key, self.value)
        return torch.cat([m.weight for m in lins]), torch.cat([m.bias for m in lins])

    def forward(self, x, shift_info: Optional[Tuple[int, int, int, int]] = None,
                eff_window: Optional[int] = None):
        """x (B·nW, w², C) windows; ``shift_info`` (hp, wp, win, shift) of the
        padded canvas (shift 0: no region masking).  ``swin.py:130-148``: the
        projections, the bias of the effective window and
        ``ops/window_attention``'s kernel."""
        hp, wp, win, shift = shift_info if shift_info is not None else (0, 0, self.window, 0)
        regions = None
        if shift:
            n_win = (hp // win) * (wp // win)
            regions = region_labels(x.shape[0] // n_win, hp, wp, win, shift, x.device)
        return window_attention(self.query(x), self.key(x), self.value(x),
                                self.bias(eff_window or self.window), regions, self.num_heads)


class SwinSelfOutput(nn.Module):
    def __init__(self, dim: int, device=None):
        super().__init__()
        self.dense = Linear(dim, dim, device=device)

    def forward(self, x):
        return self.dense(x)


class SwinAttention(nn.Module):
    """HF's SwinAttention.  ``SwinBlock`` reads its parameters into the fused
    ``swin_window_block``; :meth:`forward` is the unfused windowed route
    (``swin.py:198-199``) over ``ops/window_attention``."""

    def __init__(self, dim: int, num_heads: int, window: int, device=None):
        super().__init__()
        self.self = SwinSelfAttention(dim, num_heads, window, device=device)  # HF's name
        self.output = SwinSelfOutput(dim, device=device)

    def forward(self, x, shift_info=None, eff_window=None):
        return self.output(self.self(x, shift_info, eff_window))


class _Dense(nn.Module):
    """HF's SwinIntermediate / SwinOutput: a module holding one ``dense``."""

    def __init__(self, d_in: int, d_out: int, device=None):
        super().__init__()
        self.dense = Linear(d_in, d_out, device=device)


def drop_path(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Per-sample stochastic depth (``swin.py:256-261``): each image's branch
    is kept with probability 1 - rate, and scaled by 1 / (1 - rate)."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape[0], generator=generator, device=x.device) < keep
    mask = mask.reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, shift: int,
                 mlp_ratio: float = 4.0, drop_path: float = 0.0, quant: bool = False,
                 device=None):
        super().__init__()
        self.num_heads, self.window, self.shift = num_heads, window, shift
        self.drop_path, self.quant = drop_path, quant
        ff = int(dim * mlp_ratio)
        self.layernorm_before = LayerNorm(dim, device=device)
        self.attention = SwinAttention(dim, num_heads, window, device=device)
        self.layernorm_after = LayerNorm(dim, device=device)
        self.intermediate = _Dense(dim, ff, device=device)
        self.output = _Dense(ff, dim, device=device)

    def forward(self, x, hw: Tuple[int, int], generator: Optional[torch.Generator] = None):
        h, w = hw
        b, p, c = x.shape
        rate = self.drop_path if self.training else 0.0
        if rate > 0.0 and generator is None:
            raise ValueError("stochastic depth in training mode needs an explicit torch.Generator")
        # HF: no shift and a smaller window when the grid is smaller (swin.py:267-268)
        shift = self.shift if min(h, w) > self.window else 0
        win = min(self.window, h, w)
        quant = self.quant and rate == 0.0  # int8 is serving only
        sa = self.attention.self
        wqkv, bqkv = sa.packed()
        dense = self.attention.output.dense
        attn = (swin_window_block_q if quant and not takes_canvas_kernel(h, w, c, x.dtype)
                else swin_window_block)
        y = attn(x.reshape(b, h, w, c), self.layernorm_before.weight, self.layernorm_before.bias,
                 wqkv, bqkv, dense.weight, dense.bias, sa.bias(win), self.num_heads, win, shift,
                 eps=self.layernorm_before.eps, residual=rate == 0.0).reshape(b, p, c)
        if rate > 0.0:
            y = x + drop_path(y, rate, generator)
        mlp = fused_mlp_q if quant else fused_mlp
        z = mlp(y, self.layernorm_after.weight, self.layernorm_after.bias,
                self.intermediate.dense.weight, self.intermediate.dense.bias,
                self.output.dense.weight, self.output.dense.bias,
                activation="gelu", ln_position="pre", residual=rate == 0.0,
                eps=self.layernorm_after.eps)
        return y + drop_path(z, rate, generator) if rate > 0.0 else z


class SwinPatchMerging(nn.Module):
    """HF SwinPatchMerging: pad odd sides, 2x2 slices concat, LN, reduction."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.reduction = Linear(4 * dim, 2 * dim, bias=False, device=device)
        self.norm = LayerNorm(4 * dim, device=device)

    def forward(self, x, hw: Tuple[int, int]):
        h, w = hw
        b, p, c = x.shape
        x = x.reshape(b, h, w, c)
        if h % 2 or w % 2:
            x = nn.functional.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1)
        return self.reduction(self.norm(x.reshape(b, -1, 4 * c)))


class SwinStage(nn.Module):
    def __init__(self, dim: int, depth: int, num_heads: int, window: int, downsample: bool,
                 drop_path_rates: Sequence[float], quant: bool = False, device=None):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window, shift=0 if i % 2 == 0 else window // 2,
                      drop_path=drop_path_rates[i], quant=quant, device=device)
            for i in range(depth))
        self.downsample_mod = SwinPatchMerging(dim, device=device) if downsample else None

    def forward(self, x, hw, generator: Optional[torch.Generator] = None):
        for blk in self.blocks:
            x = blk(x, hw, generator)
        if self.downsample_mod is not None:
            x = self.downsample_mod(x, hw)
            hw = ((hw[0] + 1) // 2, (hw[1] + 1) // 2)
        return x, hw


class SwinPatchEmbed(nn.Module):
    """stride == kernel patch conv as space-to-depth + matmul (``swin.py:571-611``);
    parameters ``projection`` (E, 3, p, p) and ``projection_bias`` (E,)."""

    def __init__(self, embed_dim: int, patch_size: int, device=None):
        super().__init__()
        self.patch_size = patch_size
        self.projection = _param(embed_dim, 3, patch_size, patch_size, device=device)
        self.projection_bias = _param(embed_dim, device=device)

    def forward(self, pixel_values):  # (B, 3, H, W)
        p = self.patch_size
        x = pixel_values.permute(0, 2, 3, 1)
        h, w = x.shape[1], x.shape[2]
        if h % p or w % p:
            x = nn.functional.pad(x, (0, 0, 0, (p - w % p) % p, 0, (p - h % p) % p))
        y = s2d_matmul(x, self.projection, p) + self.projection_bias.to(x.dtype)
        b, oh, ow, e = y.shape
        return y.reshape(b, oh * ow, e), (oh, ow)


class SwinModel(nn.Module):
    """Returns the HF hidden_states list (embedding + per-stage outputs).
    ``dtype`` is the compute dtype the pixels are cast to; ``quant`` the int8
    serving matmuls of the blocks."""

    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 18, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window: int = 7,
                 patch_size: int = 4, drop_path_rate: float = 0.1,
                 dtype: torch.dtype = torch.float32, quant: bool = False, device=None):
        super().__init__()
        self.dtype = dtype
        self.patch_proj = SwinPatchEmbed(embed_dim, patch_size, device=device)
        self.embed_norm = LayerNorm(embed_dim, device=device)
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        starts = np.cumsum((0,) + tuple(depths)).tolist()
        self.stages = nn.ModuleList(
            SwinStage(embed_dim * 2 ** i, depth, num_heads[i], window,
                      downsample=i < len(depths) - 1,
                      drop_path_rates=dpr[starts[i]:starts[i] + depth], quant=quant,
                      device=device)
            for i, depth in enumerate(depths))

    def forward(self, pixel_values, generator: Optional[torch.Generator] = None,
                num_hidden: Optional[int] = None) -> List[torch.Tensor]:
        """The first ``num_hidden`` hidden states (all of them when None),
        running only the stages they need; ``generator`` draws the drop-path
        masks in training mode."""
        x, hw = self.patch_proj(pixel_values.to(self.dtype))
        x = self.embed_norm(x)
        hidden_states = [x]
        n_stages = len(self.stages) if num_hidden is None else num_hidden - 1
        for stage in self.stages[:n_stages]:
            x, hw = stage(x, hw, generator)
            hidden_states.append(x)
        return hidden_states
