"""DenseCLIP-style prompt modules, counterparts of ``lc2is_tpu/nn/denseclip.py``
(``Embedding`` and ``quick_gelu`` come from ``nn/clip.py``).

- ``CLIPTextContextEncoder``: CLIP text transformer over the SOT token, the
  learned context embeddings and the tokenized class name; causal mask, EOT
  index shifted by the context length (``denseclip.py:93-114``).
- ``ContextDecoder``: pre-LN decoder of text queries over the projected
  visual memory (``denseclip.py:174-207``), with the explicit ``text_dim``
  deviation documented there.

Plain torch: no Pallas kernel runs in these modules on the TPU either.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from lc2is_tpu_torch.nn.clip import Embedding, quick_gelu
from lc2is_tpu_torch.nn.layers import LayerNorm, Linear, MultiheadAttention, _param
from lc2is_tpu_torch.ops.attention import merge_heads, scaled_dot_product_attention, split_heads


class ResidualAttentionBlock(nn.Module):
    """CLIP pre-LN block: packed-qkv attention, QuickGELU MLP."""

    def __init__(self, width: int, heads: int, device=None):
        super().__init__()
        self.attn = MultiheadAttention(width, heads, device=device)
        self.ln_1 = LayerNorm(width, device=device)
        self.ln_2 = LayerNorm(width, device=device)
        self.c_fc = Linear(width, 4 * width, device=device)
        self.c_proj = Linear(4 * width, width, device=device)

    def forward(self, x, attn_mask=None):
        y = self.ln_1(x)
        x = x + self.attn(y, y, y, attn_mask=attn_mask)
        return x + self.c_proj(quick_gelu(self.c_fc(self.ln_2(x))))


class CLIPTextContextEncoder(nn.Module):
    def __init__(self, context_length: int = 13, vocab_size: int = 49408,
                 transformer_width: int = 512, transformer_heads: int = 8,
                 transformer_layers: int = 12, embed_dim: int = 512, device=None):
        super().__init__()
        self.token_embedding = Embedding(vocab_size, transformer_width, device=device)
        self.positional_embedding = _param(context_length, transformer_width, device=device)
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(transformer_width, transformer_heads, device=device)
            for _ in range(transformer_layers))
        self.ln_final = LayerNorm(transformer_width, device=device)
        self.text_projection = _param(transformer_width, embed_dim, device=device)

    def forward(self, text: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        """text (K, n1) token ids; context (1, n2, C) learned prompts ->
        (K, embed_dim) class embeddings."""
        k, _ = text.shape
        _, n2, c = context.shape
        x_text = self.token_embedding(text)  # (K, n1, C)
        eot = text.argmax(dim=-1) + n2  # EOT shifts right by the context length
        ctx = context.to(x_text.dtype).expand(k, n2, c)
        x = torch.cat([x_text[:, :1], ctx, x_text[:, 1:]], dim=1)
        x = x + self.positional_embedding.to(x.dtype)[None, : x.shape[1]]
        ln = x.shape[1]
        causal = torch.full((ln, ln), float("-inf"), device=x.device).triu(1)
        for blk in self.resblocks:
            x = blk(x, attn_mask=causal)
        x = self.ln_final(x)
        pooled = x[torch.arange(k, device=x.device), eot]
        return pooled @ self.text_projection.to(x.dtype)


class _PreLNAttention(nn.Module):
    """DenseCLIP's ``Attention``: bias-free q/k/v, biased out proj."""

    def __init__(self, dim: int, heads: int, device=None):
        super().__init__()
        self.heads = heads
        self.q = Linear(dim, dim, bias=False, device=device)
        self.k = Linear(dim, dim, bias=False, device=device)
        self.v = Linear(dim, dim, bias=False, device=device)
        self.proj = Linear(dim, dim, device=device)

    def forward(self, q, k, v):
        # k/v keep their own dtype (bf16 memory under f32 text queries);
        # scaled_dot_product_attention casts them where JAX promotes
        out = scaled_dot_product_attention(split_heads(self.q(q), self.heads),
                                           split_heads(self.k(k), self.heads),
                                           split_heads(self.v(v), self.heads))
        return self.proj(merge_heads(out))


class _ContextDecoderLayer(nn.Module):
    def __init__(self, dim: int, heads: int, device=None):
        super().__init__()
        self.self_attn = _PreLNAttention(dim, heads, device=device)
        self.cross_attn = _PreLNAttention(dim, heads, device=device)
        self.norm1 = LayerNorm(dim, device=device)
        self.norm2 = LayerNorm(dim, device=device)
        self.norm3 = LayerNorm(dim, device=device)
        self.fc1 = Linear(dim, 4 * dim, device=device)
        self.fc2 = Linear(4 * dim, dim, device=device)

    def forward(self, x, mem):
        y = self.norm1(x)
        x = x + self.self_attn(y, y, y)
        x = x + self.cross_attn(self.norm2(x), mem, mem)
        return x + self.fc2(F.gelu(self.fc1(self.norm3(x))))


class ContextDecoder(nn.Module):
    def __init__(self, transformer_width: int = 256, transformer_heads: int = 4,
                 transformer_layers: int = 3, visual_dim: int = 512, text_dim: int = 512,
                 device=None):
        super().__init__()
        w = transformer_width
        self.memory_norm_in = LayerNorm(visual_dim, device=device)
        self.memory_proj = Linear(visual_dim, w, device=device)
        self.memory_norm_out = LayerNorm(w, device=device)
        self.text_norm_in = LayerNorm(text_dim, device=device)
        self.text_proj = Linear(text_dim, w, device=device)
        self.decoder = nn.ModuleList(_ContextDecoderLayer(w, transformer_heads, device=device)
                                     for _ in range(transformer_layers))
        self.out_norm = LayerNorm(w, device=device)
        self.out_proj = Linear(w, text_dim, device=device)

    def forward(self, text: torch.Tensor, visual: torch.Tensor) -> torch.Tensor:
        """text (B, K, text_dim); visual (B, N, visual_dim) -> text_diff (B, K, text_dim),
        in text's dtype."""
        mem = self.memory_norm_out(self.memory_proj(self.memory_norm_in(visual)))
        x = self.text_proj(self.text_norm_in(text))
        for layer in self.decoder:
            x = layer(x, mem)
        return self.out_proj(self.out_norm(x))
