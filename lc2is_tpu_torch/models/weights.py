"""HF checkpoints -> the port's state_dicts for the CLIP and swin towers,
counterpart of ``lc2is_tpu/models/weights.py``.

The reference pulls ``openai/clip-vit-base-patch16`` and
``microsoft/swin-small-patch4-window7-224`` from the HF hub
(``model/encoder.py:19,96,126``; swin-base at ``model/ftn.py:12``).  Each
loader takes such a ``state_dict`` (torch tensors or numpy arrays: a live
``transformers`` model's, or a file read with ``torch.load``) and returns a
state_dict under the port's keys for ``load_state_dict(..., strict=True)``:
JAX's renames (:func:`_clip_rename`, :func:`_swin_rename`), then the name
walk of ``core/convert.py`` (a digit segment joins the one before it, then
:func:`~lc2is_tpu_torch.core.convert.torch_key`).  A CLIP vision table is
resized bicubically to the grid of ``in_size`` where that is not 224
(``model/encoder.py:24-27,32-44``).  This module does not import
``transformers``.

One difference from JAX: :func:`load_swin_params` drops HF's final
``layernorm``.  JAX's loader keeps it, but JAX's ``SwinModel`` never calls
its ``layernorm`` (every model reads ``hidden_states[:4]``), so flax creates
no such parameter and ``apply`` ignores the extra; the port's ``SwinModel``
has none, and its loads are strict.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from lc2is_tpu_torch.core.convert import flax_path, port_key
from lc2is_tpu_torch.nn.clip import interpolate_position_embedding

_LAYERS = re.compile(r"encoder\.layers\.(\d+)\.")
_SWIN_BLOCK = re.compile(r"encoder\.layers\.(\d+)\.blocks\.(\d+)\.")
_SWIN_DS = re.compile(r"encoder\.layers\.(\d+)\.downsample\.")
# the parts of a reference BaseModelWithText kept beside its towers
# (``model/model.py:20-25``)
_BASE_PARTS = ("class_prototypes", "vision_decoder", "pixel_patch")


def _clip_rename(key: str, prefix: str) -> Optional[str]:
    if not key.startswith(prefix):
        return None
    k = key[len(prefix):]
    if k.endswith("position_ids"):
        return None
    k = _LAYERS.sub(lambda m: f"encoder_layers_{m.group(1)}.", k)
    k = k.replace("embeddings.patch_embedding.weight", "embeddings.patch_embedding")
    k = k.replace("embeddings.position_embedding.weight", "embeddings.position_embedding")
    k = k.replace("embeddings.token_embedding.", "token_embedding.")
    # the text tower's positions are an embedding table of their own
    if k.startswith("embeddings.position_embedding") and prefix == "text_model.":
        k = k.replace("embeddings.position_embedding", "position_embedding.weight")
    return k


def _swin_rename(key: str) -> Optional[str]:
    k = key
    if k.startswith("swin."):
        k = k[len("swin."):]
    if "relative_position_index" in k or k.startswith(("pooler", "layernorm.")):
        return None  # HF's final norm too: no model reads it (module docstring)
    if k.startswith("embeddings.patch_embeddings.projection.weight"):
        return "patch_proj.projection"
    if k.startswith("embeddings.patch_embeddings.projection.bias"):
        return "patch_proj.projection_bias"
    if k.startswith("embeddings.norm."):
        return k.replace("embeddings.norm.", "embed_norm.")
    if k.startswith("embeddings.position_embeddings"):
        return None  # absolute embeddings unused by the reference checkpoints
    k = _SWIN_BLOCK.sub(lambda m: f"stages_{m.group(1)}.blocks_{m.group(2)}.", k)
    k = _SWIN_DS.sub(lambda m: f"stages_{m.group(1)}.downsample_mod.", k)
    k = k.replace("attention.self.", "attention.self_.")
    return k


def _tensor(v) -> torch.Tensor:
    """A CPU tensor of ``v`` (a tensor, or an array of any dtype kept)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    return torch.from_numpy(np.array(v))


def _renamed(state_dict: Mapping, rename: Callable[[str], Optional[str]]
             ) -> Dict[str, torch.Tensor]:
    """``state_dict`` through ``rename`` (None drops a key; buffers the JAX
    import skips, ``num_batches_tracked`` and ``position_ids``, dropped) and
    onto the port's keys."""
    out = {}
    for key, val in state_dict.items():
        if key.endswith(("num_batches_tracked", "position_ids")):
            continue
        k = rename(key)
        if k is not None:
            out[port_key(k)] = _tensor(val)
    return out


def load_clip_vision_params(state_dict: Mapping, in_size: int = 224,
                            patch_size: int = 16) -> Dict[str, torch.Tensor]:
    """A ``CLIPVisionModel`` (or whole ``CLIPModel``) state_dict -> the
    port's ``CLIPVisionTransformer`` keys, the position table resized to
    ``in_size``."""
    sd = _renamed(state_dict, lambda k: _clip_rename(k, "vision_model."))
    if in_size != 224:
        key = "embeddings.position_embedding"
        sd[key] = torch.from_numpy(np.ascontiguousarray(interpolate_position_embedding(
            sd[key].numpy(), patch_size, in_size)))
    return sd


def load_clip_text_params(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """A ``CLIPTextModel`` (or whole ``CLIPModel``) state_dict -> the port's
    ``CLIPTextTransformer`` keys."""
    return _renamed(state_dict, lambda k: _clip_rename(k, "text_model."))


def load_swin_params(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """A ``SwinModel`` state_dict -> the port's ``SwinModel`` keys."""
    return _renamed(state_dict, _swin_rename)


def load_base_model_with_text_params(state_dict: Mapping, in_size: int = 224,
                                     patch_size: int = 16) -> Dict[str, torch.Tensor]:
    """A whole reference ``BaseModelWithText`` checkpoint
    (``torch.save(model.state_dict())``, ``evaluate.sh``'s ``step-400.pt``)
    -> the port's ``BaseModelWithText`` keys: split by the reference's
    submodule prefixes (``model/model.py:20-25``), each tower through its
    loader, and the class prototypes, the vision decoder and the pixel patch
    as they are.  ``in_size`` is the checkpoint's own: a reference trained
    at another size already holds its resized table (the reference resizes
    when it is built, ``encoder.py:24-27``)."""
    def part(prefix):
        return {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}

    out = {f"vision_encoder.{k}": v for k, v in load_clip_vision_params(
        part("vision_encoder.enc."), in_size=in_size, patch_size=patch_size).items()}
    out.update({f"text_encoder.{k}": v
                for k, v in load_clip_text_params(part("text_encoder.enc.")).items()})
    rest = {k: v for k, v in state_dict.items()
            if not k.startswith(("vision_encoder.", "text_encoder."))}
    out.update({k: v for k, v in _renamed(rest, lambda k: k).items()
                if flax_path(k)[0] in _BASE_PARTS})
    return out
