"""Torch-semantics building blocks, counterparts of ``lc2is_tpu/nn/layers.py``.

Parameters keep the JAX package's torch layout and names (``weight`` is
(out, in); ``in_proj_weight`` is packed (3E, E)), so ``core/convert.py``
is a name walk.  Parameters are stored in f32 and cast to the input's dtype
at use, as the flax modules do (``w.astype(x.dtype)``).  Tokens are
channels-last (B, P, C).

A post-norm decoder or encoder layer with no masks runs through the fused
halves, as the JAX package does on the TPU (``layers.py:344-365``,
``:427-457``): each attention half is ``ops/attention_block.fused_attn_block``
(K/V projected outside the kernel, ``:437-455``; the SR layers reduce the
self-attention's K/V source first, ``:510-548``).  ``norm_first`` or a key-padding mask takes the
unfused ``MultiheadAttention`` halves (``:476-485``), whose core is
``ops/attention.scaled_dot_product_attention`` (the flash kernel where its
gate sends it).  Either way the feed-forward half is
``ops/fused_mlp.fused_mlp`` (``_ff_res_norm`` :269-301, ``pre`` for
``norm_first``).  Dropout (training): ``dropout``, ``dropout1-3`` and
``dropout_ff`` sit where the JAX layer puts them (``:376-487``), and the MHA
drops its attention probabilities (``:232-242``), every mask drawn from the
``torch.Generator`` passed to ``forward``.  The fused halves keep JAX's gate:
only out of training or at dropout 0 (``:471-472``, ``_ff_res_norm``
:276); a layer in training with dropout above 0 takes the unfused halves
and the plain feed-forward.  With ``quant=True`` (int8 serving,
``layers.py:284-290,425-458``) both attention halves take the int8 q- and
out-projections and the feed-forward half is ``ops/quant.fused_mlp_q``; the
K and V projections stay float, outside the kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from lc2is_tpu_torch.ops.attention import (dropout, merge_heads, scaled_dot_product_attention,
                                           split_heads)
from lc2is_tpu_torch.ops.attention_block import fused_attn_block, fused_attn_block_q
from lc2is_tpu_torch.ops.fused_mlp import fused_mlp
from lc2is_tpu_torch.ops.quant import fused_mlp_q


def _param(*shape, device=None) -> nn.Parameter:
    """Uninitialised f32 parameter: weights come from ``core/convert.py``
    (a JAX params tree, or values drawn from a numpy seed)."""
    return nn.Parameter(torch.empty(*shape, device=device))


class Dropout(nn.Module):
    """``layers.py:156-164``: inverted dropout in training mode, its mask from
    the generator given to ``forward``; the identity in eval mode or at 0."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator: Optional[torch.Generator] = None):
        return dropout(x, self.rate, generator) if self.training else x


class Linear(nn.Module):
    def __init__(self, in_features: int, out_features: int, bias: bool = True, device=None):
        super().__init__()
        self.weight = _param(out_features, in_features, device=device)
        self.bias = _param(out_features, device=device) if bias else None

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class LayerNorm(nn.Module):
    """LayerNorm with f32 statistics (``layers.py:60-75``)."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = _param(dim, device=device)
        self.bias = _param(dim, device=device)

    def forward(self, x):
        return F.layer_norm(x.float(), x.shape[-1:], self.weight, self.bias, self.eps).to(x.dtype)


def s2d_matmul(x: torch.Tensor, w: torch.Tensor, k: int) -> torch.Tensor:
    """stride == kernel conv on NHWC ``x`` with (O, I, k, k) weights, as
    space-to-depth + matmul (an exact reassociation, ``layers.py:78-87``)."""
    b, h, wd, c = x.shape
    oh, ow = h // k, wd // k
    p = x[:, : oh * k, : ow * k].reshape(b, oh, k, ow, k, c)
    p = p.permute(0, 1, 3, 2, 4, 5).reshape(b, oh, ow, k * k * c)
    wm = w.permute(2, 3, 1, 0).reshape(k * k * c, w.shape[0])
    return p @ wm.to(x.dtype)


class Conv2d(nn.Module):
    """stride == kernel conv, no padding, NHWC in and out (``layers.py:116-153``:
    the only convs the models use)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, device=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.weight = _param(out_channels, in_channels, kernel_size, kernel_size, device=device)
        self.bias = _param(out_channels, device=device)

    def forward(self, x):  # (B, H, W, C)
        return s2d_matmul(x, self.weight, self.kernel_size) + self.bias.to(x.dtype)


def _promoted_linear(x, w, b):
    """``x @ w.T + b`` in the promoted type of x and w, as JAX computes an f32
    key against weights rounded to a bf16 query's dtype (``layers.py:223-225``)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return F.linear(x.to(dt), w.to(dt), b.to(dt))


class MultiheadAttention(nn.Module):
    """torch ``nn.MultiheadAttention`` (batch_first), ``layers.py:167-245``.

    If kdim == vdim == embed_dim: packed ``in_proj_weight`` (3E, E);
    otherwise ``q_proj_weight`` (E, E), ``k_proj_weight`` (E, kdim),
    ``v_proj_weight`` (E, vdim)."""

    def __init__(self, embed_dim: int, num_heads: int, kdim: Optional[int] = None,
                 vdim: Optional[int] = None, dropout: float = 0.0, device=None):
        super().__init__()
        self.dropout = dropout
        e = embed_dim
        kdim = e if kdim is None else kdim
        vdim = e if vdim is None else vdim
        self.embed_dim, self.num_heads = e, num_heads
        self._same = kdim == e and vdim == e
        if self._same:
            self.in_proj_weight = _param(3 * e, e, device=device)
        else:
            self.q_proj_weight = _param(e, e, device=device)
            self.k_proj_weight = _param(e, kdim, device=device)
            self.v_proj_weight = _param(e, vdim, device=device)
        self.in_proj_bias = _param(3 * e, device=device)
        self.out_proj = Linear(e, e, device=device)

    def proj_weights(self, dt):
        """(wq, wk, wv, bq, bk, bv) in ``dt``, torch packed-QKV layout."""
        e = self.embed_dim
        if self._same:
            wq, wk, wv = self.in_proj_weight.to(dt).split(e)
        else:
            wq, wk, wv = (w.to(dt) for w in (self.q_proj_weight, self.k_proj_weight,
                                             self.v_proj_weight))
        bq, bk, bv = self.in_proj_bias.to(dt).split(e)
        return wq, wk, wv, bq, bk, bv

    def forward(self, query, key, value, key_padding_mask=None, attn_mask=None,
                generator: Optional[torch.Generator] = None):
        wq, wk, wv, bq, bk, bv = self.proj_weights(query.dtype)
        q = split_heads(F.linear(query, wq, bq), self.num_heads)
        k = split_heads(_promoted_linear(key, wk, bk), self.num_heads)
        v = split_heads(_promoted_linear(value, wv, bv), self.num_heads)
        out = scaled_dot_product_attention(q, k, v, key_padding_mask=key_padding_mask,
                                           attn_mask=attn_mask,
                                           dropout_rate=self.dropout if self.training else 0.0,
                                           generator=generator)
        return self.out_proj(merge_heads(out))


_ACTIVATIONS = {"relu": F.relu, "gelu": lambda x: F.gelu(x, approximate="tanh")}  # jax.nn's


def _ff_res_norm(layer, x, norm: LayerNorm, *, pre: bool,
                 generator: Optional[torch.Generator] = None):
    """The FF half of a transformer layer, ``x + ff(norm(x))`` (pre) or
    ``norm(x + ff(x))`` (post), through ``fused_mlp`` or, for an int8 layer,
    ``fused_mlp_q`` (``layers.py:269-301``); in training with dropout above 0
    the unfused modules with their dropouts (``:299-301``)."""
    if layer.training and layer.dropout > 0.0:
        if pre:
            return x + layer._ff_block(norm(x), generator)
        return norm(x + layer._ff_block(x, generator))
    mlp = fused_mlp_q if layer.quant else fused_mlp
    return mlp(x, norm.weight, norm.bias, layer.linear1.weight, layer.linear1.bias,
               layer.linear2.weight, layer.linear2.bias, activation=layer.activation,
               ln_position="pre" if pre else "post", eps=norm.eps)


def _fused_attn_half(layer, mha: MultiheadAttention, norm: LayerNorm, x, kv_src):
    """``norm(x + mha(x, kv_src, kv_src))`` through ``fused_attn_block`` (or
    its int8 twin), K and V projected outside the kernel (``layers.py:344-356``,
    ``:437-455``)."""
    wq, wk, wv, bq, bk, bv = mha.proj_weights(x.dtype)
    block = fused_attn_block_q if layer.quant else fused_attn_block
    return block(x, F.linear(kv_src, wk, bk), F.linear(kv_src, wv, bv), wq, bq,
                 mha.out_proj.weight, mha.out_proj.bias, norm.weight, norm.bias, layer.nhead,
                 eps=norm.eps)


class TransformerEncoderLayer(nn.Module):
    """torch ``nn.TransformerEncoderLayer`` (batch_first), ``layers.py:304-373``.
    Post-norm with no masks, out of training or at dropout 0, runs the fused
    route (``_fused_call`` :344-356, gate :358-365): ``fused_attn_block`` over
    the K/V of ``_sa_kv_source``, then the fused feed-forward; otherwise the
    unfused halves with their dropouts.  ``quant`` selects the int8 serving
    kernels.  ``dropout`` is 0 by default, as every caller passes it."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dropout: float = 0.0, activation: str = "relu", layer_norm_eps: float = 1e-5,
                 norm_first: bool = False, quant: bool = False, device=None):
        super().__init__()
        self.nhead, self.activation, self.quant = nhead, activation, quant
        self.norm_first, self.dropout = norm_first, dropout
        self.self_attn = MultiheadAttention(d_model, nhead, dropout=dropout, device=device)
        self.linear1 = Linear(d_model, dim_feedforward, device=device)
        self.linear2 = Linear(dim_feedforward, d_model, device=device)
        self.norm1 = LayerNorm(d_model, layer_norm_eps, device=device)
        self.norm2 = LayerNorm(d_model, layer_norm_eps, device=device)
        self.dropout_ff, self.dropout1, self.dropout2 = (Dropout(dropout) for _ in range(3))

    def _sa_kv_source(self, x):
        """K/V source of the self-attention (the SR subclass reduces it)."""
        return x

    def _sa_block(self, x, attn_mask, key_padding_mask, generator):
        kv = self._sa_kv_source(x)
        x = self.self_attn(x, kv, kv, key_padding_mask=key_padding_mask, attn_mask=attn_mask,
                           generator=generator)
        return self.dropout1(x, generator)

    def _ff_block(self, x, generator):
        x = self.dropout_ff(_ACTIVATIONS[self.activation](self.linear1(x)), generator)
        return self.dropout2(self.linear2(x), generator)

    def forward(self, src, src_mask=None, src_key_padding_mask=None,
                generator: Optional[torch.Generator] = None):
        """``generator`` draws the dropout masks in training mode."""
        if (not self.norm_first and src_mask is None and src_key_padding_mask is None
                and not (self.training and self.dropout)):
            x = _fused_attn_half(self, self.self_attn, self.norm1, src, self._sa_kv_source(src))
            return _ff_res_norm(self, x, self.norm2, pre=False)
        if self.norm_first:
            x = src + self._sa_block(self.norm1(src), src_mask, src_key_padding_mask, generator)
            return _ff_res_norm(self, x, self.norm2, pre=True, generator=generator)
        x = self.norm1(src + self._sa_block(src, src_mask, src_key_padding_mask, generator))
        return _ff_res_norm(self, x, self.norm2, pre=False, generator=generator)


class TransformerDecoderLayer(nn.Module):
    """torch ``nn.TransformerDecoderLayer`` (batch_first) with the reference's
    asymmetric cross-attention (``d_kv`` sets kdim = vdim), ``layers.py:376-487``.
    Post-norm with no masks runs the fused halves; ``norm_first``, a
    key-padding mask or active dropout the unfused ones.  ``quant`` selects
    the int8 serving variants of the fused halves and of the FF kernel.
    ``dropout`` is 0 by default: the v4 callers override the JAX layer's 0.1;
    the prompt decoders of ``DenseClip``, ``PromptFTNv1`` and ``PromptFTNv2``
    and the FTN decoders' layers pass it."""

    def __init__(self, d_model: int, nhead: int, d_kv: Optional[int] = None,
                 dim_feedforward: int = 2048, dropout: float = 0.0, activation: str = "relu",
                 layer_norm_eps: float = 1e-5, norm_first: bool = False, quant: bool = False,
                 device=None):
        super().__init__()
        self.nhead, self.activation, self.quant = nhead, activation, quant
        self.norm_first, self.dropout = norm_first, dropout
        self.self_attn = MultiheadAttention(d_model, nhead, dropout=dropout, device=device)
        self.multihead_attn = MultiheadAttention(d_model, nhead, kdim=d_kv, vdim=d_kv,
                                                 dropout=dropout, device=device)
        self.linear1 = Linear(d_model, dim_feedforward, device=device)
        self.linear2 = Linear(dim_feedforward, d_model, device=device)
        self.norm1 = LayerNorm(d_model, layer_norm_eps, device=device)
        self.norm2 = LayerNorm(d_model, layer_norm_eps, device=device)
        self.norm3 = LayerNorm(d_model, layer_norm_eps, device=device)
        self.dropout_ff, self.dropout1, self.dropout2, self.dropout3 = (
            Dropout(dropout) for _ in range(4))

    def _sa_kv_source(self, x):
        """K/V source of the self-attention (the SR subclass reduces it)."""
        return x

    def _sa_block(self, x, key_padding_mask, generator):
        kv = self._sa_kv_source(x)
        x = self.self_attn(x, kv, kv, key_padding_mask=key_padding_mask, generator=generator)
        return self.dropout1(x, generator)

    def _mha_block(self, x, memory, key_padding_mask, generator):
        x = self.multihead_attn(x, memory, memory, key_padding_mask=key_padding_mask,
                                generator=generator)
        return self.dropout2(x, generator)

    def _ff_block(self, x, generator):
        x = self.dropout_ff(_ACTIVATIONS[self.activation](self.linear1(x)), generator)
        return self.dropout3(self.linear2(x), generator)

    def forward(self, tgt, memory, tgt_key_padding_mask=None, memory_key_padding_mask=None,
                generator: Optional[torch.Generator] = None):
        """``generator`` draws the dropout masks in training mode."""
        if (not self.norm_first and tgt_key_padding_mask is None
                and memory_key_padding_mask is None and not (self.training and self.dropout)):
            x = _fused_attn_half(self, self.self_attn, self.norm1, tgt, self._sa_kv_source(tgt))
            x = _fused_attn_half(self, self.multihead_attn, self.norm2, x, memory.to(x.dtype))
            return _ff_res_norm(self, x, self.norm3, pre=False)
        kpm = memory_key_padding_mask
        if self.norm_first:
            # a bf16 x over f32 memory: the cross-attention half is f32 (JAX
            # promotion), and so is x from there on
            x = tgt + self._sa_block(self.norm1(tgt), tgt_key_padding_mask, generator)
            x = x + self._mha_block(self.norm2(x), memory, kpm, generator)
            return _ff_res_norm(self, x, self.norm3, pre=True, generator=generator)
        x = self.norm1(tgt + self._sa_block(tgt, tgt_key_padding_mask, generator))
        x = self.norm2(x + self._mha_block(x, memory, kpm, generator))
        return _ff_res_norm(self, x, self.norm3, pre=False, generator=generator)


class SRReduce(nn.Module):
    """Strided-conv spatial reduction + LayerNorm over a square token grid
    (``layers.py:490-507``): submodules ``sr`` and ``norm``."""

    def __init__(self, d_model: int, sr_ratio: int, device=None):
        super().__init__()
        self.sr = Conv2d(d_model, d_model, sr_ratio, device=device)
        self.norm = LayerNorm(d_model, device=device)

    def forward(self, x):  # (B, P, C), P = H·W square
        b, p, c = x.shape
        h = int(round(p ** 0.5))
        return self.norm(self.sr(x.reshape(b, h, h, c)).reshape(b, -1, c))


class SRTransformerEncoderLayer(TransformerEncoderLayer):
    """``SRTransformerSelfA`` (``layers.py:510-527``): queries at full
    resolution, the self-attention's K/V from the conv-reduced tokens."""

    def __init__(self, d_model: int, nhead: int, sr_ratio: int = 1, **kw):
        super().__init__(d_model, nhead, **kw)
        self.sr_ratio = sr_ratio
        if sr_ratio > 1:
            self.sr_reduce = SRReduce(d_model, sr_ratio, device=kw.get("device"))

    def _sa_kv_source(self, x):
        return self.sr_reduce(x) if self.sr_ratio > 1 else x


class SRTransformerDecoderLayer(TransformerDecoderLayer):
    """SR applies to the SELF-attention K/V; cross-attention is untouched
    (``layers.py:530-548``)."""

    def __init__(self, d_model: int, nhead: int, sr_ratio: int = 1, **kw):
        super().__init__(d_model, nhead, **kw)
        self.sr_ratio = sr_ratio
        if sr_ratio > 1:
            self.sr_reduce = SRReduce(d_model, sr_ratio, device=kw.get("device"))

    def _sa_kv_source(self, x):
        return self.sr_reduce(x) if self.sr_ratio > 1 else x
