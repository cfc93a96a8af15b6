"""Decoders, counterparts of ``lc2is_tpu/nn/decoders.py``: the v1 fusion stack
``DecoderBlock`` (:43-72) and ``TextToPatch`` (:405-417); the v4 pyramid
decoders ``_HierarchicalBase`` (:226-278) with ``HierarchicalSelfA``
(:281-297, ``SelfABlock`` :159-190 over SR encoder layers) and
``HierarchicalCrossA`` (:300-316, ``CrossABlock`` :193-223 over SR decoder
layers); the v1/v3 ``FTNDecoder`` (:106-156, ``FTNBlock`` :80-103: one SR
decoder layer a block, the same pyramid as ``HierarchicalCrossA``) and the
v2 ``FTNDecoderV2`` (:364-402, ``RepeatTransformer`` :319-361).
``dropout`` (0 by default, the v4 models' ``_FinalBase.dropout``; 0.1 in
the FTN decoders, as the JAX modules default) reaches every SR layer, its
masks drawn from the ``generator`` given to ``forward``.

Every ×2 upsample is ``ops/resize.resize_tokens`` (the ``upsample_tokens``
kernel on CUDA).  The last block of each stream does not upsample: the
three streams are summed at stage-2 resolution and the final ×2 runs once,
after the sum (the deferred upsample of ``decoders.py:252-263``, a linear
reassociation).  ``quant`` (int8 serving) reaches every SR decoder layer
(``decoders.py:172-250``); the top-down linears stay float.  ``FTNDecoderV2``
upsamples after every layer of a stream, as the JAX module does.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from lc2is_tpu_torch.nn.layers import (Conv2d, LayerNorm, Linear, SRTransformerDecoderLayer,
                                       SRTransformerEncoderLayer, TransformerDecoderLayer)
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
        self._blk = dict(d_model=dim, nhead=nhead, sr_ratio=2, dropout=dropout,
                         tie_weights=tie_block_weights, quant=quant, **kw)
        self.attention_stage_2 = nn.ModuleList([self._block(depth[0], upsample=1)])
        self.attention_stage_3 = nn.ModuleList(
            self._block(depth[1], upsample=1 if i == 1 else 2) for i in range(2))
        self.attention_stage_4 = nn.ModuleList(
            self._block(depth[2], upsample=1 if i == 2 else 2) for i in range(3))

    def _block(self, depth: int, upsample: int) -> nn.Module:
        return self._block_cls(**self._blk, depth=depth, upsample=upsample)

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


class FTNBlock(nn.Module):
    """One SR decoder layer, then ×``upsample`` (``decoders.py:80-103``)."""

    def __init__(self, d_model: int, nhead: int = 8, sr_ratio: int = 2, dropout: float = 0.1,
                 upsample: int = 2, device=None):
        super().__init__()
        self.upsample = upsample
        self.attention_block = SRTransformerDecoderLayer(d_model, nhead, sr_ratio=sr_ratio,
                                                         dropout=dropout, device=device)

    def forward(self, tgt, memory, generator: Optional[torch.Generator] = None):
        h = _grid(tgt.shape[1])
        x = self.attention_block(tgt, memory, generator=generator)
        if self.upsample == 1:
            return x
        return resize_tokens(x, (h, h), scale_factor=self.upsample)


class FTNDecoder(HierarchicalCrossA):
    """``model/decoder.py:36-94`` (``decoders.py:106-156``): the pyramid of
    ``HierarchicalCrossA`` with one ``FTNBlock`` (8 heads) a block."""

    def __init__(self, in_dims: Sequence[int], dim: int, dropout: float = 0.1, device=None):
        super().__init__(in_dims, (1, 1, 1), dim, nhead=8, dropout=dropout, device=device)

    def _block(self, depth: int, upsample: int) -> nn.Module:
        b = self._blk
        return FTNBlock(b["d_model"], b["nhead"], b["sr_ratio"], b["dropout"], upsample,
                        device=b["device"])


class RepeatTransformer(nn.Module):
    """model/ftn.py's ``Transformer`` (``decoders.py:319-361``): the memory
    ``norm(sr(x))`` computed once (x itself at ``sr_ratio`` 1), then
    ``repeat`` single-layer decoders over it (dropout 0.1), each followed by
    a ×2 upsample when ``upsample``."""

    def __init__(self, dim: int, repeat: int, sr_ratio: int, nhead: int = 8,
                 upsample: bool = True, device=None):
        super().__init__()
        self.sr_ratio, self.upsample = sr_ratio, upsample
        self.trans = nn.ModuleList(DecoderBlock(dim, nhead, 1, dropout=0.1, device=device)
                                   for _ in range(repeat))
        if sr_ratio > 1:
            self.sr = Conv2d(dim, dim, sr_ratio, device=device)
            self.norm = LayerNorm(dim, device=device)

    def forward(self, x, h: int, generator: Optional[torch.Generator] = None):
        if self.sr_ratio > 1:
            b, _, c = x.shape
            mem = self.norm(self.sr(x.reshape(b, h, h, c)).reshape(b, -1, c))
        else:
            mem = x
        for layer in self.trans:
            x = layer(x, mem, generator=generator)
            if self.upsample:
                x = resize_tokens(x, (h, h), scale_factor=2)
                h *= 2
        return x


class FTNDecoderV2(nn.Module):
    """model/ftn.py's ``Decoder`` (``decoders.py:364-402``): per-stage linears
    to ``dim_out``, top-down additions of the next stage ×2 at stages 2-3,
    512-wide projections, ``RepeatTransformer`` streams at stages 2-4
    (repeat 1/2/3, sr 2) and the stream sum at the stage-1 grid.

    The JAX module builds ``attentions_0`` (repeat 1, sr 1, one head) but
    never calls it (its loop starts at 1), so flax makes no parameters for
    it; the port builds none, and a strict load holds both ways.  The grids
    are the JAX module's fixed ``H = [128, 64, 32, 16]`` (512² input)."""

    GRIDS = (128, 64, 32, 16)

    def __init__(self, dim_in: Sequence[int] = (128, 256, 512, 1024),
                 dim_out: Sequence[int] = (256, 512, 1024, 1024), device=None):
        super().__init__()
        self.linears = nn.ModuleList(Linear(i, o, device=device) for i, o in zip(dim_in, dim_out))
        self.linears2 = nn.ModuleList(Linear(o, 512, device=device) for o in dim_out)
        self.attentions = nn.ModuleDict(
            {str(i): RepeatTransformer(512, repeat=i, sr_ratio=2, device=device)
             for i in (1, 2, 3)})

    def forward(self, x: List[torch.Tensor], generator: Optional[torch.Generator] = None):
        hs = self.GRIDS
        out = [lin(v) for lin, v in zip(self.linears, x)]
        for i in (1, 2):
            out[i] = out[i] + resize_tokens(x[i + 1], (hs[i + 1], hs[i + 1]), scale_factor=2)
        total = self.linears2[0](out[0])
        for i in (1, 2, 3):
            total = total + self.attentions[str(i)](self.linears2[i](out[i]), hs[i], generator)
        return total
