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

The reference ``.pt`` names are those the JAX package's export writes
(``torch_import.params_to_state_dict`` :93-110, the names its import reads
back): every ``name_<digit>`` of the flax path split at its last underscore
(``linear_stage.2``, ``trans_0_layers.1``), ``sr_reduce`` flattened into its
layer, ``self_`` kept.  :func:`reference_key` and :func:`port_key` map a name
between the two, through the flax path (:func:`flax_path` inverts
:func:`torch_key`).
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Iterator, Mapping, Optional, Tuple

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


def flax_path(key: str) -> Tuple[str, ...]:
    """The port's state_dict key -> the flax params path (inverse of
    :func:`torch_key`)."""
    segs, out, i = key.split("."), [], 0
    while i < len(segs):
        seg = segs[i]
        if seg == "trans" and i + 3 < len(segs) and segs[i + 2] == "layers":
            out.append(f"trans_{segs[i + 1]}_layers_{segs[i + 3]}")
            i += 4
        elif i + 1 < len(segs) and segs[i + 1].isdigit():
            out.append(f"{seg}_{segs[i + 1]}")
            i += 2
        else:
            out.append("self_" if seg == "self" else seg)
            i += 1
    return tuple(out)


def reference_key(key: str) -> str:
    """The port's key -> the name the JAX package's export writes."""
    out = []
    for seg in flax_path(key):
        if seg == "sr_reduce":
            continue
        m = re.fullmatch(r"(.*)_(\d+)", seg)
        out.append(f"{m.group(1)}.{m.group(2)}" if m else seg)
    return ".".join(out)


_SR_PARAM = re.compile(r"(^|.*\.)(sr|norm)\.(weight|bias)$")


def port_key(key: str, sr_prefixes: frozenset = frozenset()) -> str:
    """A reference name -> the port's key, as the JAX package's import reads
    it (``torch_import.state_dict_to_params``: a digit segment joins the one
    before it; the ``sr`` / ``norm`` of a layer in ``sr_prefixes`` move into
    ``sr_reduce``)."""
    m = _SR_PARAM.fullmatch(key)
    if m and m.group(1) in sr_prefixes:
        key = f"{m.group(1)}sr_reduce.{m.group(2)}.{m.group(3)}"
    path = []
    for seg in key.split("."):
        if seg.isdigit() and path:
            path[-1] = f"{path[-1]}_{seg}"
        else:
            path.append(seg)
    return torch_key(tuple(path))


def from_reference_names(state_dict: Mapping[str, torch.Tensor],
                         keys: Optional[Iterable[str]] = None) -> Dict[str, torch.Tensor]:
    """A state_dict under the reference names -> the port's keys (buffers the
    JAX import skips, ``num_batches_tracked`` and ``position_ids``, dropped).

    A layer's ``sr`` and ``norm`` read two ways: an SR layer's reduction
    (``sr_reduce``) or a module's own (``RepeatTransformer``'s).  Given the
    model's ``keys``, each name takes the reading the model has; without
    them, the JAX import's rule: every layer with an ``sr.weight`` is an SR
    layer (which misreads ``RepeatTransformer``, as the JAX import does)."""
    sd = {k: v for k, v in state_dict.items()
          if not k.endswith(("num_batches_tracked", "position_ids"))}
    srp = frozenset(k[:-len("sr.weight")] for k in sd if k.endswith("sr.weight"))
    if keys is None:
        return {port_key(k, srp): v for k, v in sd.items()}
    keys = set(keys)
    out = {}
    for k, v in sd.items():
        nested = port_key(k, srp)
        out[nested if nested in keys else port_key(k)] = v
    return out


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
