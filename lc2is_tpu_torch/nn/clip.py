"""CLIP ViT-B/16 vision and text transformers, counterparts of
``lc2is_tpu/nn/clip.py`` (HF ``CLIPVisionModel`` / ``CLIPTextModel``).

- vision: the stride == kernel patch conv (``nn/layers.s2d_matmul``, no
  bias), CLS token and learned position table, ``pre_layrnorm`` (HF's typo
  kept: the parameter names follow the JAX package), pre-LN blocks with a
  quick-gelu MLP; ``last_hidden_state`` is not post-normed, the pooled
  output is the post-LN CLS (``clip.py:110-151``).  The vision tower
  computes in ``dtype``.
- text: token and position embeddings, the causal mask with the padding
  mask, ``final_layer_norm``, pooled at the EOT token (``clip.py:188-233``).
  It has no ``dtype``: it runs in f32, as in the JAX package.
- ``interpolate_position_embedding``: the bicubic resize of a position table
  to another grid, CLS row kept (``clip.py:236-251``).

Every self-attention goes through ``ops/attention.scaled_dot_product_attention``:
on the card the vision tower's 1025² attention at 512² takes the flash kernel
(Lq·Lk >= 2^20); the text tower's causal mask keeps it on the einsum path.
The MLP is plain Linear, quick-gelu, Linear: no kernel runs there in the JAX
package either.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lc2is_tpu_torch.nn.layers import LayerNorm, Linear, _param, s2d_matmul
from lc2is_tpu_torch.ops.attention import merge_heads, scaled_dot_product_attention, split_heads
from lc2is_tpu_torch.ops.resize import resize


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class Embedding(nn.Module):
    def __init__(self, num_embeddings: int, features: int, device=None):
        super().__init__()
        self.weight = _param(num_embeddings, features, device=device)

    def forward(self, ids):
        return F.embedding(ids, self.weight)


class CLIPAttention(nn.Module):
    """HF CLIPAttention: separate q/k/v/out Linears."""

    def __init__(self, embed_dim: int, num_heads: int, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = Linear(embed_dim, embed_dim, device=device)
        self.k_proj = Linear(embed_dim, embed_dim, device=device)
        self.v_proj = Linear(embed_dim, embed_dim, device=device)
        self.out_proj = Linear(embed_dim, embed_dim, device=device)

    def forward(self, x, attn_mask=None, key_padding_mask=None):
        q, k, v = (split_heads(p(x), self.num_heads) for p in (self.q_proj, self.k_proj,
                                                               self.v_proj))
        out = scaled_dot_product_attention(q, k, v, key_padding_mask=key_padding_mask,
                                           attn_mask=attn_mask)
        return self.out_proj(merge_heads(out))


class CLIPMLP(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, device=None):
        super().__init__()
        self.fc1 = Linear(dim, hidden_dim, device=device)
        self.fc2 = Linear(hidden_dim, dim, device=device)

    def forward(self, x):
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, mlp_dim: int, device=None):
        super().__init__()
        self.self_attn = CLIPAttention(embed_dim, num_heads, device=device)
        self.layer_norm1 = LayerNorm(embed_dim, device=device)
        self.layer_norm2 = LayerNorm(embed_dim, device=device)
        self.mlp = CLIPMLP(embed_dim, mlp_dim, device=device)

    def forward(self, x, attn_mask=None, key_padding_mask=None):
        x = x + self.self_attn(self.layer_norm1(x), attn_mask=attn_mask,
                               key_padding_mask=key_padding_mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPVisionEmbeddings(nn.Module):
    """Patch embedding (a stride == kernel conv without bias), CLS token and a
    position table for (image_size / patch_size)² + 1 tokens."""

    def __init__(self, image_size: int, patch_size: int, hidden_size: int, device=None):
        super().__init__()
        self.patch_size = patch_size
        num_pos = (image_size // patch_size) ** 2 + 1
        self.class_embedding = _param(hidden_size, device=device)
        self.position_embedding = _param(num_pos, hidden_size, device=device)
        self.patch_embedding = _param(hidden_size, 3, patch_size, patch_size, device=device)

    def forward(self, pixel_values):  # (B, 3, H, W)
        x = pixel_values.permute(0, 2, 3, 1)  # NHWC
        patches = s2d_matmul(x, self.patch_embedding, self.patch_size)
        b, e = patches.shape[0], patches.shape[-1]
        cls = self.class_embedding.to(x.dtype).expand(b, 1, e)
        tokens = torch.cat([cls, patches.reshape(b, -1, e)], dim=1)
        return tokens + self.position_embedding.to(x.dtype)[None]


class CLIPVisionTransformer(nn.Module):
    """HF ``CLIPVisionModel.vision_model``, ViT-B/16 (openai defaults);
    layers under ``encoder_layers.{i}``."""

    def __init__(self, image_size: int = 224, patch_size: int = 16, hidden_size: int = 768,
                 num_layers: int = 12, num_heads: int = 12, mlp_dim: int = 3072,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.hidden_size, self.dtype = hidden_size, dtype
        self.embeddings = CLIPVisionEmbeddings(image_size, patch_size, hidden_size, device=device)
        self.pre_layrnorm = LayerNorm(hidden_size, device=device)  # HF typo kept
        self.encoder_layers = nn.ModuleList(
            CLIPEncoderLayer(hidden_size, num_heads, mlp_dim, device=device)
            for _ in range(num_layers))
        self.post_layernorm = LayerNorm(hidden_size, device=device)

    def forward(self, pixel_values) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, 3, H, W) -> (last_hidden_state (B, 1 + P, C), pooled CLS (B, C))."""
        x = self.pre_layrnorm(self.embeddings(pixel_values.to(self.dtype)))
        for layer in self.encoder_layers:
            x = layer(x)
        return x, self.post_layernorm(x[:, 0, :])


class CLIPTextTransformer(nn.Module):
    """HF ``CLIPTextModel.text_model`` (openai/clip-vit-base-patch16), in f32."""

    def __init__(self, vocab_size: int = 49408, hidden_size: int = 512, num_layers: int = 12,
                 num_heads: int = 8, mlp_dim: int = 2048, max_positions: int = 77,
                 eos_token_id: int = 49407, device=None):
        super().__init__()
        self.hidden_size, self.eos_token_id = hidden_size, eos_token_id
        self.token_embedding = Embedding(vocab_size, hidden_size, device=device)
        self.position_embedding = Embedding(max_positions, hidden_size, device=device)
        self.encoder_layers = nn.ModuleList(
            CLIPEncoderLayer(hidden_size, num_heads, mlp_dim, device=device)
            for _ in range(num_layers))
        self.final_layer_norm = LayerNorm(hidden_size, device=device)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, L) ids -> (last_hidden_state (B, L, C), pooler_output (B, C))."""
        b, n = input_ids.shape
        dev = input_ids.device
        x = self.token_embedding(input_ids) + self.position_embedding(
            torch.arange(n, device=dev))[None]
        causal = torch.full((n, n), float("-inf"), device=dev).triu(1)
        kpm = None if attention_mask is None else attention_mask == 0  # HF 1 = keep
        for layer in self.encoder_layers:
            x = layer(x, attn_mask=causal, key_padding_mask=kpm)
        x = self.final_layer_norm(x)
        # pooled at the first EOT token; legacy configs (eos_token_id = 2) take
        # the argmax of the ids, as HF does
        if self.eos_token_id == 2:
            eot = input_ids.argmax(-1)
        else:
            eot = (input_ids == self.eos_token_id).int().argmax(-1)
        return x, x[torch.arange(b, device=dev), eot]


def interpolate_position_embedding(pos: np.ndarray, patch_size: int, new_size: int) -> np.ndarray:
    """Bicubic 2-D interpolation of a ViT position table (1 + g², C) to the
    grid of ``new_size`` at ``patch_size``, CLS row kept (the reference's
    ``model/encoder.py:32-44``, ``F.interpolate(mode="bicubic")`` to the size)."""
    old_grid = int(round(np.sqrt(pos.shape[0] - 1)))
    new_grid = new_size // patch_size
    if new_grid == old_grid:
        return pos
    grid = torch.from_numpy(np.asarray(pos[1:], np.float32).reshape(1, old_grid, old_grid, -1))
    new = resize(grid.permute(0, 3, 1, 2), size=(new_grid, new_grid), method="bicubic")
    new = new.permute(0, 2, 3, 1).reshape(new_grid * new_grid, -1).numpy()
    return np.concatenate([pos[:1], new.astype(pos.dtype)], axis=0)
