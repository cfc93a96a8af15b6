"""The v4 family (the flagship ``PromptAuxCrossA``, ``BaseSelfA``,
``BaseCrossA``, ``PromptSelfA``, ``PromptCrossA``, ``PromptAuxSelfA``:
serving and training forward), the v1 CLIP family (serving;
``BaseModelWithText`` also trains) and the swin-base FTN family (serving and
training: the v1 ``PromptFTNv1``, the v2 ``BaseFTN`` and ``PromptFTNv2``, the v3
``DenseCLIPFTN``), counterparts of ``lc2is_tpu/models/zoo.py``
(``_norm``/``_score_map``/``default_denseclip_cfg`` :49-76,
``BaseModelWithText`` :84-143, ``ContrastiveModel`` :146-176, ``DenseClip``
:179-214, ``PromptFTNv1`` :217-249, ``BaseFTN`` :257-276, ``PromptFTNv2``
:279-303, ``PromptContextBase`` :311-349, ``DenseCLIPFTN`` :352-381,
``_FinalBase`` :389-443, ``ClassWeightTable`` :446-457, ``BaseSelfA`` /
``BaseCrossA`` :460-488, ``_PromptFinalBase`` :490-506, ``PromptSelfA`` /
``PromptCrossA`` :509-538, ``_AuxMixin`` :541-545, ``PromptAuxSelfA``
:548-566, ``PromptAuxCrossA`` :569-587, ``ZOO`` / ``FROZEN_PREFIXES``
:594-626: all thirteen models).  The Base models take their class embeddings from a learned
``classes.weight`` table (K, decoder width); the SelfA models decode the
pyramid without the classes (``HierarchicalSelfA``).

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
drop-path masks and, at ``dropout`` > 0, the decoder's dropout masks from
that generator (``nn/swin.py``, ``nn/layers.py``); ``FROZEN_PREFIXES``
names the parameters the reference freezes (``zoo.py:617-625``).

The v1 models take ``pixel_values`` with ``input_ids`` and an optional
``attention_mask`` (1 = keep) and return the JAX package's tuples, maps in
NCHW.  The CLIP ViT computes in ``dtype``, the text tower in f32, and mixed
operands are promoted where JAX promotes them: under bf16 the first v1
decoder layer's cross-attention projects the f32 text with bf16-rounded
weights, so from there on the decoder, the bicubic ×4 and the scores are f32
(``nn/layers.py``).  ``BaseModelWithText`` trains (``engine/engine.py``): the
flash kernels have their backward, and ``dropout`` (0 by default, as
``zoo.py:90``) reaches its fusion decoder, its masks drawn from the generator
given to ``forward``; no parameter of it is frozen (``FROZEN_PREFIXES`` has no
``base_with_text`` entry, ``zoo.py:617-626``).

The FTN family runs swin-base (``swin_variant="small"`` takes swin-small
where the JAX model offers it) and reads ``hidden_states[:4]``: the patch
embedding and stages 1-3 after their patch merging, C 128 to 1024; the
swin's fourth stage does not run, as for every model.  ``PromptFTNv1`` and
``PromptFTNv2`` take the v1 inputs (``pixel_values``, ``input_ids``, an
optional ``attention_mask``) and pool the frozen CLIP text tower;
``BaseFTN`` and ``DenseCLIPFTN`` take ``pixel_values`` (and
``DenseCLIPFTN`` an optional ``text_static`` from :meth:`embed_text`).  Each
returns the JAX package's ``(None, score map ×4)``, (B, K, H, W).
``BaseFTN`` and ``PromptFTNv2`` decode with ``FTNDecoderV2``, whose grids
are fixed for 512² input, as in the JAX package.  Dtypes as in the JAX
package: the backbone computes in ``dtype``, the text towers in f32, the
decoders in the dtype of what they are given.  They train through
``engine/engine.py::train_step`` as the JAX engine trains them: no
``return_score_map``, so the plain CE of the (B, K, H, W) map against labels
at the map's size (labels of another size raise, as in JAX); the generator
draws the swin's drop path (0.1) and the decoders' hardwired dropout (0.1,
``DenseCLIPFTN``'s ``FTNDecoder`` 0), which sends those layers to the
unfused halves (JAX's gate, ``nn/layers.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from lc2is_tpu_torch.nn.clip import CLIPTextTransformer, CLIPVisionTransformer
from lc2is_tpu_torch.nn.decoders import (DecoderBlock, FTNDecoder, FTNDecoderV2,
                                         HierarchicalCrossA, HierarchicalSelfA, TextToPatch)
from lc2is_tpu_torch.nn.denseclip import CLIPTextContextEncoder, ContextDecoder
from lc2is_tpu_torch.nn.layers import Dropout, Linear, MultiheadAttention, _param
from lc2is_tpu_torch.nn.swin import SWIN_BASE, SWIN_SMALL, SwinBlock, SwinModel
from lc2is_tpu_torch.ops.bpe import tokenize
from lc2is_tpu_torch.ops.resize import resize
from lc2is_tpu_torch.ops.upsample_argmax import l2_normalize, score_upsample_argmax

ADE20K_NUM_CLASSES = 151

# parameter prefixes the reference freezes (requires_grad=False), zoo.py:617-625
FROZEN_PREFIXES = {
    "dense_clip": ("text_encoder",),
    "prompt_ftn_v1": ("textual_encoder",),
    "prompt_ftn": ("text_encoder",),
    "denseclip_ftn": ("prompt.text_encoder",),
    "prompt_self_a": ("prompt.text_encoder",),
    "prompt_cross_a": ("prompt.text_encoder",),
    "prompt_aux_self_a": ("prompt.text_encoder",),
    "prompt_aux_cross_a": ("prompt.text_encoder",),
}


def _score_map(v_tokens: torch.Tensor, t: torch.Tensor, grid: int) -> torch.Tensor:
    """L2-normalised cosine classification: (B,P,C) x (B,K,C) -> (B,K,H,W),
    each side normalised in its own dtype, the product in the promoted one."""
    b, p, c = v_tokens.shape
    v = l2_normalize(v_tokens.reshape(b, grid, grid, c), dim=-1)
    t = l2_normalize(t, dim=2)
    dt = torch.promote_types(v.dtype, t.dtype)
    return torch.einsum("bhwc,bkc->bkhw", v.to(dt), t.to(dt))


def _promoted_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


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


# ---------------------------------------------------------------------------
# v1: the CLIP dual-encoder family (model/model.py), serving
# ---------------------------------------------------------------------------


class _ClipBase(nn.Module):
    """The CLIP ViT (at ``in_size``) and text tower of every v1 model;
    ``vision_kwargs`` / ``text_kwargs`` override their widths (tests)."""

    def __init__(self, patch_size: int, in_size: int, out_size: int, dtype: torch.dtype,
                 vision_kwargs: Optional[Dict[str, Any]], text_kwargs: Optional[Dict[str, Any]],
                 device):
        super().__init__()
        self.patch_size, self.in_size, self.out_size = patch_size, in_size, out_size
        self.vision_encoder = CLIPVisionTransformer(image_size=in_size, patch_size=patch_size,
                                                   dtype=dtype, device=device,
                                                   **(vision_kwargs or {}))
        self.text_encoder = CLIPTextTransformer(device=device, **(text_kwargs or {}))

    def _upsample4(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, g², C) tokens -> (B, out_size², C) by the bicubic ×4 of ``model.py:43``."""
        h = self.in_size // self.patch_size
        b, _, c = tokens.shape
        x = resize(tokens.reshape(b, h, h, c).permute(0, 3, 1, 2), scale_factor=4,
                   method="bicubic")
        return x.permute(0, 2, 3, 1).reshape(b, self.out_size * self.out_size, c)


class BaseModelWithText(_ClipBase):
    """``model/model.py:12-56``: CLIP towers, a ``norm_first`` fusion decoder of
    the image tokens over the text (key-padding mask from ``attention_mask``),
    bicubic ×4, and the per-pixel product with the 151 class prototypes.
    Returns (feature_t (151, C), feature_v (B, P, C), feature_mm (B, 151, H, W)).

    ``class_prototypes`` is a parameter: ``prototypes`` (151, C), the
    reference's ``ade20k_prototypes.pt``, fills it; otherwise it comes from a
    state dict or ``core/convert.seeded_init_``."""

    def __init__(self, patch_size: int = 16, in_size: int = 224, out_size: int = 224,
                 dropout: float = 0.0, num_layers: int = 1,
                 prototypes: Optional[np.ndarray] = None,
                 vision_kwargs: Optional[Dict[str, Any]] = None,
                 text_kwargs: Optional[Dict[str, Any]] = None, nhead: int = 8,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        device = _model_device(device)
        super().__init__(patch_size, in_size, out_size, dtype, vision_kwargs, text_kwargs, device)
        text_dim = self.text_encoder.hidden_size
        vis_dim = self.vision_encoder.hidden_size
        self.class_prototypes = _param(ADE20K_NUM_CLASSES, text_dim, device=device)
        if prototypes is not None:
            with torch.no_grad():
                self.class_prototypes.copy_(torch.as_tensor(np.asarray(prototypes, np.float32)))
        self.vision_decoder = DecoderBlock(vis_dim, nhead, num_layers, d_kv=text_dim,
                                           dropout=dropout, norm_first=True, device=device)
        self.pixel_patch = TextToPatch(text_dim, vis_dim, out=text_dim, device=device)

    def forward(self, inputs: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None):
        """``generator`` draws the fusion decoder's dropout masks in training
        mode (needed only when ``dropout`` > 0)."""
        mask = inputs.get("attention_mask")
        enc_t, _ = self.text_encoder(inputs["input_ids"], mask)
        enc_v = self.vision_encoder(inputs["pixel_values"])[0][:, 1:]  # CLS dropped
        kpm = None if mask is None else mask != 1  # polarity flip (model.py:38)
        dec_v = self._upsample4(self.vision_decoder(enc_v, enc_t, memory_key_padding_mask=kpm,
                                                    generator=generator))
        feature_t, feature_v = self.pixel_patch(dec_v, self.class_prototypes.to(dec_v.dtype))
        mm = _promoted_matmul(feature_v, feature_t.T)  # (B, P, 151)
        mm = mm.reshape(mm.shape[0], self.out_size, self.out_size, -1).permute(0, 3, 1, 2)
        return feature_t, feature_v, mm


class ContrastiveModel(_ClipBase):
    """``model/model.py:59-103``: no fusion decoder; the bicubic ×4 image
    tokens against the pooled text.  Returns (feature_t (K, E),
    feature_v (B, P, E), logits (B, P, K))."""

    def __init__(self, patch_size: int = 16, in_size: int = 224, out_size: int = 224,
                 embed_dim: int = 512, vision_kwargs: Optional[Dict[str, Any]] = None,
                 text_kwargs: Optional[Dict[str, Any]] = None,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        device = _model_device(device)
        super().__init__(patch_size, in_size, out_size, dtype, vision_kwargs, text_kwargs, device)
        self.pixel_patch = TextToPatch(self.text_encoder.hidden_size,
                                       self.vision_encoder.hidden_size, out=embed_dim,
                                       device=device)

    def forward(self, inputs: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None):
        """``generator``: taken as the other models take it; nothing here
        draws from it (no dropout)."""
        _, pooled_t = self.text_encoder(inputs["input_ids"], inputs.get("attention_mask"))
        enc_v = self._upsample4(self.vision_encoder(inputs["pixel_values"])[0][:, 1:])
        feature_t, feature_v = self.pixel_patch(enc_v, pooled_t)
        return feature_t, feature_v, _promoted_matmul(feature_v, feature_t.T)


class DenseClip(_ClipBase):
    """``model/model.py:106-171``: CLS kept; a post-norm ``prompt_decoder`` of
    the pooled text over the projected image tokens, then a ``norm_first``
    ``vision_decoder`` of the image tokens over the prompted text.  Returns
    (None, score_map (B, K, g, g), out (B, 1 + g², C))."""

    def __init__(self, patch_size: int = 16, in_size: int = 224, out_size: int = 224,
                 embed_dim: int = 512, decoder_layers: int = 8, nhead: int = 8,
                 vision_kwargs: Optional[Dict[str, Any]] = None,
                 text_kwargs: Optional[Dict[str, Any]] = None,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        device = _model_device(device)
        super().__init__(patch_size, in_size, out_size, dtype, vision_kwargs, text_kwargs, device)
        vis_dim = self.vision_encoder.hidden_size
        self.text_patch = TextToPatch(self.text_encoder.hidden_size, vis_dim, out=embed_dim,
                                      device=device)
        self.prompt_decoder = DecoderBlock(embed_dim, nhead, decoder_layers, dropout=0.1,
                                           device=device)
        self.vision_decoder = DecoderBlock(vis_dim, nhead, decoder_layers, d_kv=embed_dim,
                                           norm_first=True, device=device)

    def forward(self, inputs: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None):
        """``generator`` draws the prompt decoder's dropout masks (0.1, as
        ``zoo.py:197-198``) in training mode."""
        b = inputs["pixel_values"].shape[0]
        _, pooled_t = self.text_encoder(inputs["input_ids"], inputs.get("attention_mask"))
        enc_v, _ = self.vision_encoder(inputs["pixel_values"])
        feature_t, feature_v = self.text_patch(enc_v, pooled_t)
        feature_t = feature_t[None].expand(b, *feature_t.shape)
        v_context = self.prompt_decoder(feature_t, feature_v, generator=generator)
        text_embeddings = feature_t + 1e-5 * v_context  # model.py:151
        score_map = _score_map(feature_v[:, 1:], text_embeddings,
                               self.in_size // self.patch_size)
        return None, score_map, self.vision_decoder(enc_v, text_embeddings)


# ---------------------------------------------------------------------------
# v1-v3: the swin-base FTN family (model/model.py, model/ftn.py, model/new.py),
# serving and training
# ---------------------------------------------------------------------------


def _swin(variant: str) -> Dict[str, Any]:
    return SWIN_BASE if variant == "base" else SWIN_SMALL


def _pyramid_dims(cfg: Dict[str, Any]) -> tuple:
    return tuple(cfg["embed_dim"] * 2 ** i for i in range(4))


def _upsampled_scores(v_tokens: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The cosine score map at the tokens' grid, then the bilinear ×4."""
    grid = int(round(v_tokens.shape[1] ** 0.5))
    return resize(_score_map(v_tokens, t, grid), scale_factor=4, method="bilinear")


class PromptFTNv1(nn.Module):
    """``model/model.py:174-214``: the frozen CLIP text tower's pooled
    prompts, a post-norm prompt decoder (8 layers, 8 heads, dropout 0.1) of
    the prompts over the swin's last pyramid level (``d_kv`` its width),
    prompts + 1e-4 · context, an ``FTNDecoder`` over the pyramid and the
    score map ×4.  Returns (None, score_map (B, K, H, W))."""

    def __init__(self, swin_variant: str = "base", dtype: torch.dtype = torch.float32,
                 device="cuda"):
        super().__init__()
        device = _model_device(device)
        cfg = _swin(swin_variant)
        dims = _pyramid_dims(cfg)
        self.textual_encoder = CLIPTextTransformer(device=device)  # frozen
        self.visual_encoder = SwinModel(dtype=dtype, device=device, **cfg)
        self.prompt_decoder = DecoderBlock(512, 8, 8, d_kv=dims[3], dropout=0.1, device=device)
        self.decoder = FTNDecoder(dims, 512, device=device)

    def forward(self, inputs: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None):
        """``generator`` draws the drop-path and dropout masks in training mode."""
        b = inputs["pixel_values"].shape[0]
        _, pooled = self.textual_encoder(inputs["input_ids"], inputs.get("attention_mask"))
        text = pooled[None].expand(b, *pooled.shape)
        stages = self.visual_encoder(inputs["pixel_values"], generator, num_hidden=4)
        text = text + 1e-4 * self.prompt_decoder(text, stages[-1],
                                                 generator=generator)  # model.py:200
        return None, _upsampled_scores(self.decoder(stages, text, generator=generator), text)


class BaseFTN(nn.Module):
    """``model/ftn.py:9-27``: swin-base, ``FTNDecoderV2``, a linear
    classifier per token and its (B, K, 128, 128) map ×4.  Returns
    (None, logits (B, K, 512, 512))."""

    def __init__(self, num_classes: int = ADE20K_NUM_CLASSES, dtype: torch.dtype = torch.float32,
                 device="cuda"):
        super().__init__()
        device = _model_device(device)
        self.backbone = SwinModel(dtype=dtype, device=device, **SWIN_BASE)
        self.decoder = FTNDecoderV2(device=device)
        self.classif = Linear(512, num_classes, device=device)

    def forward(self, inputs: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None):
        """``generator`` draws the drop-path and dropout masks in training mode."""
        stages = self.backbone(inputs["pixel_values"], generator, num_hidden=4)
        cls = self.classif(self.decoder(stages, generator))  # (B, 128², K)
        g = FTNDecoderV2.GRIDS[0]
        cls = cls.reshape(cls.shape[0], g, g, -1).permute(0, 3, 1, 2)
        return None, resize(cls, scale_factor=4, method="bilinear")


class PromptFTNv2(nn.Module):
    """``model/ftn.py:29-64``: swin-base and ``FTNDecoderV2``, then a
    post-norm prompt decoder (8 layers, 8 heads, dropout 0.1) of the frozen
    CLIP text tower's pooled prompts over the decoded 128² map, prompts +
    1e-5 · context, and the score map ×4.  Returns (None, score_map)."""

    def __init__(self, dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        device = _model_device(device)
        self.text_encoder = CLIPTextTransformer(device=device)  # frozen
        self.backbone = SwinModel(dtype=dtype, device=device, **SWIN_BASE)
        self.prompt_decoder = DecoderBlock(512, 8, 8, d_kv=512, dropout=0.1, device=device)
        self.decoder = FTNDecoderV2(device=device)

    def forward(self, inputs: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None):
        """``generator`` draws the drop-path and dropout masks in training mode."""
        b = inputs["pixel_values"].shape[0]
        _, classes = self.text_encoder(inputs["input_ids"], inputs.get("attention_mask"))
        v = self.decoder(self.backbone(inputs["pixel_values"], generator, num_hidden=4),
                         generator)
        classes = classes[None].expand(b, *classes.shape)
        text = classes + 1e-5 * self.prompt_decoder(classes, v,
                                                    generator=generator)  # ftn.py:53
        return None, _upsampled_scores(v, text)


class DenseCLIPFTN(nn.Module):
    """``model/new.py:13-73`` (class ``Base``): the prompt tower
    (``PromptContextBase``) on the swin's last pyramid level, an
    ``FTNDecoder`` (dropout 0) over the pyramid and the prompted classes,
    and the score map ×4.  Returns (None, score_map (B, K, H, W))."""

    def __init__(self, cfg: Optional[Dict[str, Any]] = None,
                 class_names: Optional[Sequence[str]] = None, swin_variant: str = "base",
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        device = _model_device(device)
        names = class_names or [f"class {i}" for i in range(ADE20K_NUM_CLASSES)]
        swin = _swin(swin_variant)
        dims = _pyramid_dims(swin)
        self.vision_encoder = SwinModel(dtype=dtype, device=device, **swin)
        self.prompt = PromptContextBase(cfg or default_denseclip_cfg(), tuple(names),
                                        visual_dim=dims[3], device=device)
        self.decoder = FTNDecoder(dims, 512, dropout=0.0, device=device)

    def embed_text(self) -> torch.Tensor:
        """Serving precompute: run once per checkpoint and feed the result
        back as ``inputs["text_static"]``."""
        return self.prompt.embed_text()

    def forward(self, inputs: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None):
        """``generator`` draws the drop-path masks in training mode (the
        decoder's dropout is 0, and the prompt tower's ContextDecoder has none:
        the JAX module hardwires it at 0)."""
        stages = self.vision_encoder(inputs["pixel_values"], generator, num_hidden=4)
        text = self.prompt(stages[-1], text_static=inputs.get("text_static"))  # new.py:40
        return None, _upsampled_scores(self.decoder(stages, text, generator=generator), text)


# ---------------------------------------------------------------------------
# v4: the FINAL family (model/final.py)
# ---------------------------------------------------------------------------


class _FinalBase(nn.Module):
    """Shared wiring of the v4 models: swin backbone, pyramid decoder, head.
    ``dropout`` (``zoo.py:394``, 0 by default) reaches every SR layer of the
    decoder; in training its masks, like the swin drop-path masks, come from
    the generator given to ``forward``."""

    def __init__(self, class_names: Sequence[str] = tuple(f"class {i}" for i in range(ADE20K_NUM_CLASSES)),
                 dec_dim: int = 512, dec_depth: Sequence[int] = (1, 1, 1), nhead: int = 8,
                 dropout: float = 0.0, tie_block_weights: bool = True,
                 dtype: torch.dtype = torch.float32, swin_cfg: Optional[Dict[str, Any]] = None,
                 predict_masks: bool = False, return_score_map: bool = False,
                 quant_int8: bool = False, device="cuda"):
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
                                dropout=dropout, tie_block_weights=tie_block_weights,
                                quant=quant_int8, device=device)

    def _check_serving(self):
        if self.quant_int8 and self.training:
            raise RuntimeError("quant_int8 is serving only: call .eval() (no int8 training)")

    def _pyramid(self, inputs, generator):
        """The swin's first four hidden states (stage 4 is never run)."""
        self._check_serving()
        return self.vision_encoder(inputs["pixel_values"], generator, num_hidden=4)

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


class ClassWeightTable(nn.Module):
    """The reference's bias-free ``nn.Linear(512, K)`` used as a (K, C)
    class-embedding table (``zoo.py:446-457``), parameter ``classes.weight``."""

    def __init__(self, num_classes: int, dim: int = 512, device=None):
        super().__init__()
        self.weight = _param(num_classes, dim, device=device)

    def forward(self, b: int, dtype: torch.dtype) -> torch.Tensor:
        """(b, K, C) class embeddings in ``dtype``."""
        return self.weight.to(dtype)[None].expand(b, *self.weight.shape)


class _BaseFinal(_FinalBase):
    """``BaseSelfA`` / ``BaseCrossA`` (``zoo.py:460-488``): class embeddings
    from a learned table, no prompt tower."""

    _decoder_cls = None  # set by subclasses

    def __init__(self, device="cuda", **kw):
        super().__init__(device=device, **kw)
        self.vision_decoder = self._decoder_cls(self.in_dims, **self._decoder_kw)
        self.classes = ClassWeightTable(len(self.class_names), self._decoder_kw["dim"],
                                        device=device)

    def forward(self, inputs: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """``generator`` draws the drop-path and dropout masks in training mode."""
        v = self._pyramid(inputs, generator)
        t = self.classes(v[-1].shape[0], v[-1].dtype)
        x = self._decode(v, t, generator)
        return dict(outputs=self._finish(x, t))


class BaseSelfA(_BaseFinal):
    """``final.py:13-49``: a vision-only pyramid decoder."""

    _decoder_cls = HierarchicalSelfA

    def _decode(self, v, t, generator):
        return self.vision_decoder(v, generator=generator)


class BaseCrossA(_BaseFinal):
    """``final.py:51-87``: every pyramid stream cross-attends to the classes;
    the CLI's default model (``cli/common.py:30``)."""

    _decoder_cls = HierarchicalCrossA

    def _decode(self, v, t, generator):
        return self.vision_decoder(v, t, generator=generator)


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

    def _prompted(self, inputs, generator):
        """(pyramid, class embeddings from the prompt tower on stage 3, in
        the compute dtype, ``zoo.py:514-515``)."""
        v = self._pyramid(inputs, generator)
        t = self.prompt(v[2], text_static=inputs.get("text_static")).to(v[-1].dtype)
        return v, t


class _AuxMixin:
    def _aux_map(self, v_stage3, t):
        v_low = self.aux_linear(v_stage3)  # (B, (H/16)², text_dim)
        grid = int(round(v_low.shape[1] ** 0.5))
        return _score_map(v_low, t, grid)

    def _add_aux(self, device):
        # the reference hardcodes nn.Linear(in_dims[-2], 512); 512 == text_dim
        self.aux_linear = Linear(self.in_dims[-2], self.cfg["text_dim"], device=device)


class PromptSelfA(_PromptFinalBase):
    """``final.py:89-149``: the prompt tower on stage 3, a vision-only decoder."""

    def __init__(self, device="cuda", **kw):
        super().__init__(device=device, **kw)
        self.vision_decoder = HierarchicalSelfA(self.in_dims, **self._decoder_kw)

    def forward(self, inputs: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        v, t = self._prompted(inputs, generator)
        return dict(outputs=self._finish(self.vision_decoder(v, generator=generator), t))


class PromptCrossA(_PromptFinalBase):
    """``final.py:151-211``: the prompt tower on stage 3, every decoder stream
    cross-attends to the prompted classes."""

    def __init__(self, device="cuda", **kw):
        super().__init__(device=device, **kw)
        self.vision_decoder = HierarchicalCrossA(self.in_dims, **self._decoder_kw)

    def forward(self, inputs: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        v, t = self._prompted(inputs, generator)
        return dict(outputs=self._finish(self.vision_decoder(v, t, generator=generator), t))


class PromptAuxSelfA(_PromptFinalBase, _AuxMixin):
    """``final.py:213-286``: ``PromptSelfA`` plus the aux score map on stage 3."""

    def __init__(self, device="cuda", **kw):
        super().__init__(device=device, **kw)
        self._add_aux(device)
        self.vision_decoder = HierarchicalSelfA(self.in_dims, **self._decoder_kw)

    def forward(self, inputs: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        v, t = self._prompted(inputs, generator)
        low = self._aux_map(v[2], t)
        x = self.vision_decoder(v, generator=generator)
        return dict(outputs=self._finish(x, t), low_score_map=low)


class PromptAuxCrossA(_PromptFinalBase, _AuxMixin):
    """``final.py:288-361``, the canonical model: prompt tower on stage 3, aux
    score map on stage 3, every decoder stream cross-attends to the classes."""

    def __init__(self, device="cuda", **kw):
        super().__init__(device=device, **kw)
        self._add_aux(device)
        self.vision_decoder = HierarchicalCrossA(self.in_dims, **self._decoder_kw)

    def forward(self, inputs: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """``generator`` draws the swin drop-path and the decoder dropout
        masks in training mode."""
        v, t = self._prompted(inputs, generator)
        low = self._aux_map(v[2], t)
        x = self.vision_decoder(v, t, generator=generator)
        return dict(outputs=self._finish(x, t), low_score_map=low)


# the registry, under the JAX package's names (zoo.py:594-611)
ZOO = {
    "base_with_text": BaseModelWithText,
    "contrastive": ContrastiveModel,
    "dense_clip": DenseClip,
    "prompt_ftn_v1": PromptFTNv1,
    "base_ftn": BaseFTN,
    "prompt_ftn": PromptFTNv2,
    "denseclip_ftn": DenseCLIPFTN,
    "base_self_a": BaseSelfA,
    "base_cross_a": BaseCrossA,
    "prompt_self_a": PromptSelfA,
    "prompt_cross_a": PromptCrossA,
    "prompt_aux_self_a": PromptAuxSelfA,
    "prompt_aux_cross_a": PromptAuxCrossA,
}


def without_dropout(model: nn.Module) -> nn.Module:
    """``model`` with every ``Dropout`` rate, MHA dropout and swin drop-path
    rate set to 0, for a training step that another device or package must
    repeat; the transformer layers keep their own ``dropout``, so they take
    the unfused halves the real step takes (``lc2is_tpu/nn/layers.py:469-477``)."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
        elif isinstance(m, MultiheadAttention):
            m.dropout = 0.0
        elif isinstance(m, SwinBlock):
            m.drop_path = 0.0
    return model
