"""Parameters for the port's modules: from a ``lc2is_tpu`` params tree, or
drawn from a numpy seed.

Counterpart of ``lc2is_tpu/core/torch_import.py`` in the other direction.
The port keeps the flax module names, so a flax path maps to a torch key by
four rules, and nothing else changes:

- a list element ``<list>_<i>`` becomes ``<list>.<i>``, for the lists
  listed in ``LIST_NAMES`` only.  ``torch_import.params_to_state_dict``
  splits every ``name_<digit>``, which is wrong for ``linear_stage_2`` /
  ``_3`` and ``linear2_stage_1`` .. ``linear2_stage_4`` (plain attributes,
  ``decoders.py:120-125,244-247``);
- ``RepeatTransformer``'s ``trans_<i>_layers_<j>`` (one flax name for the
  reference's ``trans[i].layers[j]``, ``decoders.py:337-341``) becomes
  ``trans.<i>.layers.<j>``;
- swin's ``self_`` becomes HF's ``self``;
- the SR reduction stays nested as ``sr_reduce`` (the port keeps the flax
  nesting; ``torch_import`` flattens it to the reference's layout).

Load the result with ``module.load_state_dict(..., strict=True)`` so every
parameter is covered both ways.  Buffers are not parameters: the prompt
tower's ``texts`` is rebuilt from ``ops/bpe.tokenize``.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from lc2is_tpu_torch.nn.layers import LayerNorm

LIST_NAMES = frozenset({"stages", "blocks", "resblocks", "decoder", "layers", "encoder_layers",
                        "attention_stage_2", "attention_stage_3", "attention_stage_4",
                        "linears", "linears2", "attentions"})


def torch_key(path: Tuple[str, ...]) -> str:
    """Flax params path -> the port's state_dict key."""
    out = []
    for seg in path:
        m = re.fullmatch(r"(.+)_(\d+)", seg)
        nested = re.fullmatch(r"trans_(\d+)_layers_(\d+)", seg)
        if nested:
            out += ["trans", nested.group(1), "layers", nested.group(2)]
        elif m and m.group(1) in LIST_NAMES:
            out += [m.group(1), m.group(2)]
        elif seg == "self_":
            out.append("self")
        else:
            out.append(seg)
    return ".".join(out)


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def params_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """A ``lc2is_tpu`` params tree (``{"params": ...}`` or its inside; leaves
    numpy or jax arrays) -> the port's state_dict (f32 CPU tensors)."""
    if set(params) == {"params"}:
        params = params["params"]
    return {torch_key(path): torch.from_numpy(np.array(leaf, dtype=np.float32))
            for path, leaf in _leaves(params)}


def seeded_init_(module: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter from ``numpy.random.RandomState(seed)``, in
    state_dict order: matrices and convs ~ N(0, 1/fan_in); LayerNorm weights
    1 + 0.1·N(0, 1); other vectors and tables 0.02·N(0, 1).  The same seed
    gives the same weights on every device."""
    rs = np.random.RandomState(seed)
    norms = {id(m.weight) for m in module.modules() if isinstance(m, LayerNorm)}
    with torch.no_grad():
        for name, p in module.named_parameters():
            shape = tuple(p.shape)
            if id(p) in norms:
                v = 1.0 + 0.1 * rs.standard_normal(shape)
            elif p.dim() >= 2 and name.endswith("weight"):
                v = rs.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
            else:
                v = 0.02 * rs.standard_normal(shape)
            p.copy_(torch.from_numpy(v.astype(np.float32)))
    return module
