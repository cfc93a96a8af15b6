"""The flagship ``PromptAuxCrossA``, serving and training forward, counterpart of
``lc2is_tpu/models/zoo.py`` (``_norm``/``_score_map``/``default_denseclip_cfg``
:49-76, ``PromptContextBase`` :311-349, ``_FinalBase`` :389-443,
``_PromptFinalBase`` :490-506, ``_AuxMixin`` :541-545, ``PromptAuxCrossA``
:569-587).

Inputs are the reference's dict: ``pixel_values`` (B, 3, H, W) and an
optional ``text_static`` (K, C) from :meth:`embed_text`.  Outputs keep the
NCHW score-map layout: ``outputs`` (B, K, H, W) and ``low_score_map``
(B, K, H/16, W/16).

Dtypes follow the JAX package: the backbone and decoder compute in
``dtype``; the prompt tower is built without one, so ``embed_text`` runs in
f32.  Under bf16 the ContextDecoder mixes the f32 text with the bf16 stage-3
memory; JAX type promotion makes that cross-attention f32, and the port
casts at the same point (``ops/attention.scaled_dot_product_attention``).
The prompt result is cast to the compute dtype where JAX casts it
(``zoo.py:583-584``).

Heads: the default returns the ×4-upsampled score map; ``return_score_map=True``
(the training head, ``zoo.py:438-442``) returns the low-res score map
(B, K, H/4, W/4), whose ×4 upsample folds into the fused upsample-CE loss
(``ops/fused_ce.py``).  ``predict_masks=True`` (the ``score_upsample_argmax``
kernel) is not ported yet and raises, naming the ROADMAP item that ports it.

Training: ``forward(inputs, generator=...)`` in training mode draws the swin
drop-path masks from that generator (``nn/swin.py``); ``FROZEN_PREFIXES``
names the parameters the reference freezes (``zoo.py:617-625``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from lc2is_tpu_torch.nn.decoders import HierarchicalCrossA
from lc2is_tpu_torch.nn.denseclip import CLIPTextContextEncoder, ContextDecoder
from lc2is_tpu_torch.nn.layers import Linear, _param
from lc2is_tpu_torch.nn.swin import SWIN_SMALL, SwinModel
from lc2is_tpu_torch.ops.bpe import tokenize
from lc2is_tpu_torch.ops.resize import resize

ADE20K_NUM_CLASSES = 151

# parameter prefixes the reference freezes (requires_grad=False), zoo.py:617-625
FROZEN_PREFIXES = {"prompt_aux_cross_a": ("prompt.text_encoder",)}


def _norm(x: torch.Tensor, dim: int) -> torch.Tensor:
    """torch F.normalize(p=2): x / max(||x||, eps), norm taken in f32."""
    n = x.float().square().sum(dim=dim, keepdim=True).sqrt()
    return (x / n.clamp_min(1e-12).to(x.dtype)).to(x.dtype)


def _score_map(v_tokens: torch.Tensor, t: torch.Tensor, grid: int) -> torch.Tensor:
    """L2-normalised cosine classification: (B,P,C) x (B,K,C) -> (B,K,H,W)."""
    b, p, c = v_tokens.shape
    v = _norm(v_tokens.reshape(b, grid, grid, c), dim=-1)
    return torch.einsum("bhwc,bkc->bkhw", v, _norm(t, dim=2))


def default_denseclip_cfg() -> Dict[str, Any]:
    """The cfg-dict contract of the prompt models (``final.py:91-105``)."""
    return dict(
        text_encoder=dict(context_length=13, vocab_size=49408, transformer_width=512,
                          transformer_heads=8, transformer_layers=12, embed_dim=512),
        context_decoder=dict(transformer_width=256, transformer_heads=4, transformer_layers=3),
        context_length=5,
        text_dim=512,
    )


class PromptContextBase(nn.Module):
    """Frozen CLIPTextContextEncoder + learned contexts + gamma-scaled
    ContextDecoder residual.  The ``texts`` token buffer is rebuilt from
    ``tokenize`` (not a parameter, not in the state_dict)."""

    def __init__(self, cfg: Dict[str, Any], class_names: Sequence[str], visual_dim: int,
                 device=None):
        super().__init__()
        self.text_encoder = CLIPTextContextEncoder(**cfg["text_encoder"], device=device)
        texts = np.concatenate([tokenize(c, context_length=cfg["context_length"])
                                for c in class_names])
        self.register_buffer("texts", torch.from_numpy(texts).to(device), persistent=False)
        n_ctx = cfg["text_encoder"]["context_length"] - cfg["context_length"]
        self.contexts = _param(1, n_ctx, 512, device=device)  # 512 as in zoo.py:328
        self.gamma = _param(cfg["text_dim"], device=device)
        self.context_decoder = ContextDecoder(**cfg["context_decoder"], visual_dim=visual_dim,
                                              text_dim=cfg["text_dim"], device=device)

    def embed_text(self) -> torch.Tensor:
        """Image-independent half of the tower: (K, C) prompted class
        embeddings, constant for fixed weights, so a server computes it once
        and passes it back as ``text_static``."""
        return self.text_encoder(self.texts, self.contexts)

    def forward(self, visual_context: torch.Tensor,
                text_static: Optional[torch.Tensor] = None) -> torch.Tensor:
        b = visual_context.shape[0]
        t = self.embed_text() if text_static is None else text_static  # (K, C)
        t = t[None].expand(b, *t.shape)
        text_diff = self.context_decoder(t, visual_context)
        return t + self.gamma.to(t.dtype) * text_diff


class _FinalBase(nn.Module):
    """Shared wiring of the v4 models: swin backbone, pyramid decoder, head."""

    def __init__(self, class_names: Sequence[str] = tuple(f"class {i}" for i in range(ADE20K_NUM_CLASSES)),
                 dec_dim: int = 512, dec_depth: Sequence[int] = (1, 1, 1), nhead: int = 8,
                 tie_block_weights: bool = True, dtype: torch.dtype = torch.float32,
                 swin_cfg: Optional[Dict[str, Any]] = None, predict_masks: bool = False,
                 return_score_map: bool = False, device=None):
        super().__init__()
        if predict_masks:
            raise NotImplementedError(
                "predict_masks=True needs the score_upsample_argmax kernel "
                "(ROADMAP.md §2, to-port item 1: the next slice); this port serves the score map")
        self.return_score_map = return_score_map
        self.class_names = tuple(class_names)
        self.swin_cfg = dict(swin_cfg or SWIN_SMALL)
        self.in_dims = tuple(self.swin_cfg["embed_dim"] * 2 ** i
                             for i in range(len(self.swin_cfg["depths"])))
        self.vision_encoder = SwinModel(dtype=dtype, device=device, **self.swin_cfg)
        self._decoder_kw = dict(depth=tuple(dec_depth), dim=dec_dim, nhead=nhead,
                                tie_block_weights=tie_block_weights, device=device)

    def _finish(self, v_tokens: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Score-map head: cosine scores at the stage-1 grid, bilinear ×4 (or
        the low-res map itself with ``return_score_map``)."""
        grid = int(round(v_tokens.shape[1] ** 0.5))
        score_map = _score_map(v_tokens, t, grid)
        if self.return_score_map:
            return score_map
        return resize(score_map, scale_factor=4, method="bilinear")


class _PromptFinalBase(_FinalBase):
    def __init__(self, cfg: Optional[Dict[str, Any]] = None, device=None, **kw):
        super().__init__(device=device, **kw)
        self.cfg = cfg or default_denseclip_cfg()
        self.prompt = PromptContextBase(self.cfg, self.class_names,
                                        visual_dim=self.in_dims[-2],  # stage 3 (final.py:109)
                                        device=device)

    def embed_text(self) -> torch.Tensor:
        """Serving precompute: run once per checkpoint and feed the result
        back as ``inputs["text_static"]``."""
        return self.prompt.embed_text()


class _AuxMixin:
    def _aux_map(self, v_stage3, t):
        v_low = self.aux_linear(v_stage3)  # (B, (H/16)², text_dim)
        grid = int(round(v_low.shape[1] ** 0.5))
        return _score_map(v_low, t, grid)


class PromptAuxCrossA(_PromptFinalBase, _AuxMixin):
    """``final.py:288-361``, the canonical model: prompt tower on stage 3, aux
    score map on stage 3, every decoder stream cross-attends to the classes."""

    def __init__(self, device=None, **kw):
        super().__init__(device=device, **kw)
        # the reference hardcodes nn.Linear(in_dims[-2], 512); 512 == text_dim
        self.aux_linear = Linear(self.in_dims[-2], self.cfg["text_dim"], device=device)
        self.vision_decoder = HierarchicalCrossA(self.in_dims, **self._decoder_kw)

    def forward(self, inputs: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """``generator`` draws the swin drop-path masks in training mode."""
        v = self.vision_encoder(inputs["pixel_values"], generator)[:4]
        t = self.prompt(v[2], text_static=inputs.get("text_static")).to(v[-1].dtype)
        low = self._aux_map(v[2], t)
        x = self.vision_decoder(v, t)
        return dict(outputs=self._finish(x, t), low_score_map=low)
