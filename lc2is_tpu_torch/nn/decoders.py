"""Decoders, counterparts of ``lc2is_tpu/nn/decoders.py``: the v1 fusion stack
``DecoderBlock`` (:43-72) and ``TextToPatch`` (:405-417); the v4 pyramid
decoders ``_HierarchicalBase`` (:226-278) with ``HierarchicalSelfA``
(:281-297, ``SelfABlock`` :159-190 over SR encoder layers) and
``HierarchicalCrossA`` (:300-316, ``CrossABlock`` :193-223 over SR decoder
layers).  ``dropout`` (0 by default, the v4 models' ``_FinalBase.dropout``)
reaches every SR layer, its masks drawn from the ``generator`` given to
``forward``.

Every ×2 upsample is ``ops/resize.resize_tokens`` (the ``upsample_tokens``
kernel on CUDA).  The last block of each stream does not upsample: the
three streams are summed at stage-2 resolution and the final ×2 runs once,
after the sum (the deferred upsample of ``decoders.py:252-263``, a linear
reassociation).  ``quant`` (int8 serving) reaches every SR decoder layer
(``decoders.py:172-250``); the top-down linears stay float.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from lc2is_tpu_torch.nn.layers import (Linear, SRTransformerDecoderLayer, SRTransformerEncoderLayer,
                                       TransformerDecoderLayer)
from lc2is_tpu_torch.ops.resize import resize_tokens


def _grid(p: int) -> int:
    h = int(round(p ** 0.5))
    if h * h != p:
        raise ValueError(f"{p} tokens do not form a square grid")
    return h


class DecoderBlock(nn.Module):
    """torch ``nn.TransformerDecoder`` over the reference's decoder layers, the
    v1 fusion block (``model/decoder.py:15-21``); layers under ``layers.{i}``."""

    def __init__(self, d_model: int, nhead: int, num_layers: int, d_kv: Optional[int] = None,
                 dropout: float = 0.0, norm_first: bool = False, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerDecoderLayer(d_model, nhead, d_kv=d_kv, dropout=dropout,
                                    norm_first=norm_first, device=device)
            for _ in range(num_layers))

    def forward(self, tgt, memory, memory_key_padding_mask=None,
                generator: Optional[torch.Generator] = None):
        """``generator`` draws the dropout masks in training mode."""
        x = tgt
        for layer in self.layers:
            x = layer(x, memory, memory_key_padding_mask=memory_key_padding_mask,
                      generator=generator)
        return x


class TextToPatch(nn.Module):
    """``model/text_patch.py:4-18``: project the visual and textual features
    into one ``out``-wide space; returns (t_feature, v_feature)."""

    def __init__(self, text_dim: int, visual_dim: int, out: int = 512, device=None):
        super().__init__()
        self.textual = Linear(text_dim, out, device=device)
        self.visual = Linear(visual_dim, out, device=device)

    def forward(self, img, text):
        return self.textual(text), self.visual(img)


class SelfABlock(nn.Module):
    """depth x SR self-attention encoder layer, then ×``upsample``
    (``decoders.py:159-190``).  ``tie_weights`` reproduces the reference's one
    shared layer instance."""

    _layer_cls = SRTransformerEncoderLayer

    def __init__(self, d_model: int, nhead: int, depth: int = 1, sr_ratio: int = 2,
                 dropout: float = 0.0, upsample: int = 2, tie_weights: bool = True,
                 quant: bool = False, device=None):
        super().__init__()
        self.depth, self.upsample, self.tie_weights = depth, upsample, tie_weights
        n_distinct = 1 if tie_weights else depth
        self.layers = nn.ModuleList(
            self._layer_cls(d_model, nhead, sr_ratio=sr_ratio, dropout=dropout, quant=quant,
                            device=device)
            for _ in range(n_distinct))

    def forward(self, x, *memory, generator: Optional[torch.Generator] = None):
        """``memory``: the cross-attended text (``CrossABlock``) or nothing;
        ``generator`` draws the dropout masks in training mode."""
        h = _grid(x.shape[1])
        for i in range(self.depth):
            x = self.layers[0 if self.tie_weights else i](x, *memory, generator=generator)
        if self.upsample == 1:
            return x
        return resize_tokens(x, (h, h), scale_factor=self.upsample)


class CrossABlock(SelfABlock):
    """depth x SR cross-attention decoder layer, then ×``upsample``
    (``decoders.py:193-223``)."""

    _layer_cls = SRTransformerDecoderLayer


class _HierarchicalBase(nn.Module):
    """``decoders.py:226-278``: the top-down linears, three streams of
    ``_block_cls`` blocks at stages 2-4, the streams summed at stage-2
    resolution and one deferred ×2."""

    _block_cls = None  # set by subclasses

    def __init__(self, in_dims: Sequence[int], depth: Sequence[int], dim: int, nhead: int = 8,
                 dropout: float = 0.0, tie_block_weights: bool = True, quant: bool = False,
                 device=None):
        super().__init__()
        if len(in_dims) != 4:
            raise ValueError(f"four pyramid stages expected, got {in_dims}")
        kw = dict(device=device)
        self.linear_stage_2 = Linear(in_dims[2], in_dims[1], **kw)
        self.linear_stage_3 = Linear(in_dims[3], in_dims[2], **kw)
        self.linear2_stage_1 = Linear(in_dims[0], dim, **kw)
        self.linear2_stage_2 = Linear(in_dims[1], dim, **kw)
        self.linear2_stage_3 = Linear(in_dims[2], dim, **kw)
        self.linear2_stage_4 = Linear(in_dims[3], dim, **kw)
        blk = dict(d_model=dim, nhead=nhead, sr_ratio=2, dropout=dropout,
                   tie_weights=tie_block_weights, quant=quant, **kw)
        cls = self._block_cls
        self.attention_stage_2 = nn.ModuleList([cls(**blk, depth=depth[0], upsample=1)])
        self.attention_stage_3 = nn.ModuleList(
            cls(**blk, depth=depth[1], upsample=1 if i == 1 else 2) for i in range(2))
        self.attention_stage_4 = nn.ModuleList(
            cls(**blk, depth=depth[2], upsample=1 if i == 2 else 2) for i in range(3))

    def _top_down(self, visual: List[torch.Tensor]):
        hs = [_grid(t.shape[1]) for t in visual]
        top_down_4 = visual[3]
        top_down_3 = self.linear_stage_3(
            resize_tokens(top_down_4, (hs[3], hs[3]), scale_factor=2))
        top_down_2 = self.linear_stage_2(
            resize_tokens(top_down_3, (hs[2], hs[2]), scale_factor=2))
        return (self.linear2_stage_1(visual[0]), self.linear2_stage_2(top_down_2),
                self.linear2_stage_3(top_down_3), self.linear2_stage_4(top_down_4))

    def _decode(self, visual: List[torch.Tensor], memory, generator):
        t1, t2, t3, t4 = self._top_down(visual)
        for mod in self.attention_stage_4:
            t4 = mod(t4, *memory, generator=generator)
        for mod in self.attention_stage_3:
            t3 = mod(t3, *memory, generator=generator)
        for mod in self.attention_stage_2:
            t2 = mod(t2, *memory, generator=generator)
        s = t2 + t3 + t4  # streams summed at stage-2 resolution, one deferred ×2
        h = _grid(s.shape[1])
        return t1 + resize_tokens(s, (h, h), scale_factor=2)


class HierarchicalSelfA(_HierarchicalBase):
    """``model/hierarchical.py:9-69`` (``decoders.py:281-297``): vision only."""

    _block_cls = SelfABlock

    def forward(self, visual: List[torch.Tensor], generator: Optional[torch.Generator] = None):
        return self._decode(visual, (), generator)


class HierarchicalCrossA(_HierarchicalBase):
    """``model/hierarchical.py:71-131``: every stream cross-attends to text."""

    _block_cls = CrossABlock

    def forward(self, visual: List[torch.Tensor], textual: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        return self._decode(visual, (textual,), generator)
