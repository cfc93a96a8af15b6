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
(``ops/fused_ce.py``).  ``predict_masks=True`` (the served head,
``zoo.py:423-437``) returns int32 masks (B, H, W) through
``ops/upsample_argmax.score_upsample_argmax`` at every grid, which never
writes the (B, K, H, W) map.  The JAX package sends a grid that is not a
multiple of 8 through argmax(resize(score map, ×4)) only because its TPU
kernel works in blocks of 8 rows; the card's kernel takes any grid, and on
the CPU the op's plain version computes the same masks.

``quant_int8=True`` (``zoo.py:401,408-418``) is the int8 serving row: int8
matmuls in the swin blocks and the decoder layers (``ops/quant.py``); the
prompt tower, the aux linear, the SR reduce convs and the head stay float.
It is serving only: a forward in training mode raises.

Parameters and buffers live on ``device``, the card by default; a caller
that wants the CPU passes ``device="cpu"``.  Without a card the default
raises.

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
from lc2is_tpu_torch.ops.upsample_argmax import l2_normalize, score_upsample_argmax

ADE20K_NUM_CLASSES = 151

# parameter prefixes the reference freezes (requires_grad=False), zoo.py:617-625
FROZEN_PREFIXES = {"prompt_aux_cross_a": ("prompt.text_encoder",)}


def _score_map(v_tokens: torch.Tensor, t: torch.Tensor, grid: int) -> torch.Tensor:
    """L2-normalised cosine classification: (B,P,C) x (B,K,C) -> (B,K,H,W)."""
    b, p, c = v_tokens.shape
    v = l2_normalize(v_tokens.reshape(b, grid, grid, c), dim=-1)
    return torch.einsum("bhwc,bkc->bkhw", v, l2_normalize(t, dim=2))


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


def _model_device(device) -> torch.device:
    """The models' device: the card unless the caller names another; no
    quiet move to the CPU when there is no card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the models live on the card by default; "
                           "pass device='cpu' to build one on the CPU")
    return device


class _FinalBase(nn.Module):
    """Shared wiring of the v4 models: swin backbone, pyramid decoder, head."""

    def __init__(self, class_names: Sequence[str] = tuple(f"class {i}" for i in range(ADE20K_NUM_CLASSES)),
                 dec_dim: int = 512, dec_depth: Sequence[int] = (1, 1, 1), nhead: int = 8,
                 tie_block_weights: bool = True, dtype: torch.dtype = torch.float32,
                 swin_cfg: Optional[Dict[str, Any]] = None, predict_masks: bool = False,
                 return_score_map: bool = False, quant_int8: bool = False, device="cuda"):
        super().__init__()
        device = _model_device(device)
        self.predict_masks, self.return_score_map = predict_masks, return_score_map
        self.quant_int8 = quant_int8
        self.class_names = tuple(class_names)
        self.swin_cfg = dict(swin_cfg or SWIN_SMALL)
        self.in_dims = tuple(self.swin_cfg["embed_dim"] * 2 ** i
                             for i in range(len(self.swin_cfg["depths"])))
        self.vision_encoder = SwinModel(dtype=dtype, quant=quant_int8, device=device,
                                        **self.swin_cfg)
        self._decoder_kw = dict(depth=tuple(dec_depth), dim=dec_dim, nhead=nhead,
                                tie_block_weights=tie_block_weights, quant=quant_int8,
                                device=device)

    def _check_serving(self):
        if self.quant_int8 and self.training:
            raise RuntimeError("quant_int8 is serving only: call .eval() (no int8 training)")

    def _finish(self, v_tokens: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """The head at the stage-1 grid: int32 masks (``predict_masks``), the
        low-res score map (``return_score_map``) or the score map ×4."""
        grid = int(round(v_tokens.shape[1] ** 0.5))
        if self.predict_masks:
            return score_upsample_argmax(v_tokens, l2_normalize(t, 2), grid, r=4)
        score_map = _score_map(v_tokens, t, grid)
        if self.return_score_map:
            return score_map
        return resize(score_map, scale_factor=4, method="bilinear")


class _PromptFinalBase(_FinalBase):
    def __init__(self, cfg: Optional[Dict[str, Any]] = None, device="cuda", **kw):
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

    def __init__(self, device="cuda", **kw):
        super().__init__(device=device, **kw)
        # the reference hardcodes nn.Linear(in_dims[-2], 512); 512 == text_dim
        self.aux_linear = Linear(self.in_dims[-2], self.cfg["text_dim"], device=device)
        self.vision_decoder = HierarchicalCrossA(self.in_dims, **self._decoder_kw)

    def forward(self, inputs: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """``generator`` draws the swin drop-path masks in training mode."""
        self._check_serving()
        v = self.vision_encoder(inputs["pixel_values"], generator)[:4]
        t = self.prompt(v[2], text_static=inputs.get("text_static")).to(v[-1].dtype)
        low = self._aux_map(v[2], t)
        x = self.vision_decoder(v, t)
        return dict(outputs=self._finish(x, t), low_score_map=low)
