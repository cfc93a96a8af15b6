"""Torch-default initialisers for a model trained from scratch, counterpart of
``lc2is_tpu/nn/init.py`` and of the initialiser each JAX module declares.

The port's constructors leave their parameters uninitialised
(``nn/layers.py::_param``): every path that loads weights stays as it is.
:func:`init_parameters_` gives each parameter the law its JAX module draws
it from, by module type and parameter name:

- ``Linear``: weight and bias U(±1/√fan_in), fan_in = in_features
  (``layers.py:49-50``, torch's ``kaiming_uniform(a=√5)``);
- ``MultiheadAttention``: the in-projections xavier_uniform, ``in_proj_bias``
  zeros (``layers.py:189-195``), the out-projection's weight U(±1/√E) and its
  bias zeros (``OutProj``, ``layers.py:256-257``);
- ``Conv2d`` and the swin patch embedding: weight U(±1/√(C_in·k·k)), bias the
  same bound (``layers.py:135,151``, ``swin.py:581-582``); the CLIP patch
  embedding (no bias) likewise (``clip.py:167-172``);
- ``LayerNorm``: ones and zeros (``layers.py:67-68``);
- the swin relative-position table: zeros (``swin.py:109-110``);
- the CLIP token embedding N(0, 1) (``clip.py:48``), class and position
  embeddings N(0, 0.02²) (``clip.py:165-166``);
- the prompt tower's positional embedding N(0, 0.01²) and text projection
  N(0, 1/width) (``denseclip.py:77-90``), its contexts N(0, 1) truncated to
  ±2 and ``gamma`` 1e-4 (``zoo.py:328-330``);
- ``class_prototypes`` N(0, 1) unless the model was given the reference's
  table (``zoo.py:108-115``); the class-weight table U(±1/√dim)
  (``zoo.py:456``).

A parameter that no rule covers raises: nothing stays uninitialised.  Every
draw comes from ``generator``, in ``named_modules`` order.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch
from torch import nn

from lc2is_tpu_torch.models.zoo import BaseModelWithText, ClassWeightTable, PromptContextBase
from lc2is_tpu_torch.nn.clip import CLIPVisionEmbeddings, Embedding
from lc2is_tpu_torch.nn.denseclip import CLIPTextContextEncoder
from lc2is_tpu_torch.nn.layers import Conv2d, LayerNorm, Linear, MultiheadAttention
from lc2is_tpu_torch.nn.swin import SwinPatchEmbed, SwinSelfAttention

Init = Callable[[torch.Tensor, torch.Generator], None]


def uniform(bound: float) -> Init:
    return lambda p, g: p.uniform_(-bound, bound, generator=g)


def normal(std: float) -> Init:
    return lambda p, g: p.normal_(0.0, std, generator=g)


def constant(value: float) -> Init:
    return lambda p, g: p.fill_(value)


def trunc_normal(std: float) -> Init:
    """N(0, std²) truncated to ±2 std (``jax.random.truncated_normal``)."""
    return lambda p, g: nn.init.trunc_normal_(p, 0.0, std, -2.0 * std, 2.0 * std, generator=g)


def torch_linear_weight(p: torch.Tensor, g: torch.Generator) -> None:
    """U(±1/√fan_in), fan_in the product of every axis but the first (a
    Linear's in_features, a conv's C_in·k·k)."""
    uniform(1.0 / math.sqrt(math.prod(p.shape[1:])))(p, g)


def xavier_uniform(p: torch.Tensor, g: torch.Generator) -> None:
    fan_out, fan_in = p.shape[0], p.shape[1]
    uniform(math.sqrt(6.0 / (fan_in + fan_out)))(p, g)


def _rules(module: nn.Module) -> Dict[str, Init]:
    """{parameter name: initialiser} for ``module``'s own parameters."""
    if isinstance(module, Linear):
        bound = 1.0 / math.sqrt(module.weight.shape[1])
        return {"weight": torch_linear_weight, "bias": uniform(bound)}
    if isinstance(module, MultiheadAttention):
        return {"in_proj_weight": xavier_uniform, "q_proj_weight": xavier_uniform,
                "k_proj_weight": xavier_uniform, "v_proj_weight": xavier_uniform,
                "in_proj_bias": constant(0.0)}
    if isinstance(module, (Conv2d, SwinPatchEmbed)):
        w = module.weight if isinstance(module, Conv2d) else module.projection
        bound = 1.0 / math.sqrt(math.prod(w.shape[1:]))
        return {"weight": torch_linear_weight, "bias": uniform(bound),
                "projection": torch_linear_weight, "projection_bias": uniform(bound)}
    if isinstance(module, LayerNorm):
        return {"weight": constant(1.0), "bias": constant(0.0)}
    if isinstance(module, SwinSelfAttention):
        return {"relative_position_bias_table": constant(0.0)}
    if isinstance(module, Embedding):
        return {"weight": normal(1.0)}
    if isinstance(module, CLIPVisionEmbeddings):
        return {"class_embedding": normal(0.02), "position_embedding": normal(0.02),
                "patch_embedding": torch_linear_weight}
    if isinstance(module, CLIPTextContextEncoder):
        width = module.positional_embedding.shape[1]
        return {"positional_embedding": normal(0.01), "text_projection": normal(width ** -0.5)}
    if isinstance(module, PromptContextBase):
        return {"contexts": trunc_normal(1.0), "gamma": constant(1e-4)}
    if isinstance(module, BaseModelWithText):
        return {"class_prototypes": normal(1.0)}
    if isinstance(module, ClassWeightTable):
        return {"weight": torch_linear_weight}
    return {}


@torch.no_grad()
def init_parameters_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter of ``model`` from its JAX module's initialiser
    (module docstring), in place, from ``generator`` (on the parameters'
    device).  A model built with the reference's ``prototypes`` keeps them."""
    keep = {id(model.class_prototypes)} if getattr(model, "prototypes_given", False) else set()
    done = set(keep)
    for mname, module in model.named_modules():
        if isinstance(module, MultiheadAttention):  # OutProj: a zero bias
            torch_linear_weight(module.out_proj.weight, generator)
            module.out_proj.bias.zero_()
            done.update({id(module.out_proj.weight), id(module.out_proj.bias)})
        rules = _rules(module)
        for pname, p in module.named_parameters(recurse=False):
            if id(p) in done:
                continue
            if pname not in rules:
                raise KeyError(f"no initialiser for {mname}.{pname} ({type(module).__name__})")
            rules[pname](p, generator)
            done.add(id(p))
    return model
