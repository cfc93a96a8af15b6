"""The model axis's placement rules, counterpart of
``lc2is_tpu/parallel/sharding.py``.

JAX places every 2-D ``*weight`` over the mesh's ``model`` axis by name
(megatron-style, torch layout ``(out, in)``) and lets GSPMD insert the
collectives:

- column-parallel ``("model", None)`` (the out dim split): attention q/k/v
  projections, MLP up-projections, feature entry projections;
- row-parallel ``(None, "model")`` (the in dim split): attention output
  projections and MLP down-projections;
- the token embedding's embed dim ``(None, "model")``;
- everything else replicated ``()``: norms, biases, tables, dims the axis
  does not divide; the 2-D weights replicated by design are listed in
  :data:`JUSTIFIED_REPLICATED`.

The rules are JAX's regexes, applied to the flax path of each of the port's
names (``".".join(core/convert.py::flax_path(name))``, the string JAX's
``_path_str`` sees), so both packages shard the same tensors.  A spec is a
tuple: ``()``, ``(MODEL_AXIS, None)`` or ``(None, MODEL_AXIS)``.

:func:`shard` cuts one model-axis shard of a tensor, and :func:`gather`
all-gathers a shard over the mesh's model group into the whole tensor
(``engine/optim.py`` steps AdamW on the shards and gathers the module's
whole weights from them).
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn

from lc2is_tpu_torch.core.convert import flax_path
from lc2is_tpu_torch.core.mesh import MODEL_AXIS, Mesh

Spec = Tuple

REPLICATED: Spec = ()
COLUMN: Spec = (MODEL_AXIS, None)
ROW: Spec = (None, MODEL_AXIS)

_COLUMN = re.compile(
    r"(in_proj_weight|q_proj|k_proj|v_proj|q_proj_weight|k_proj_weight|v_proj_weight"
    r"|linear1|fc1|c_fc|intermediate|query|key|value"
    r"|(self_attn|cross_attn)\.(q|k|v)\.weight$"
    r"|memory_proj|text_proj|linear_stage|reduction|aux_linear)"
)
_ROW = re.compile(
    r"(out_proj|linear2|fc2|c_proj|output|(self_attn|cross_attn)\.proj\.weight$)"
)
_EMBED = re.compile(r"token_embedding")

# 2-D weights intentionally replicated: pattern -> one-line justification
# (spec_census reports these as "justified" instead of "unmatched")
JUSTIFIED_REPLICATED = {
    re.compile(r"text_projection$"):
        "CLIP pooled-text head: applied once per class set (K×width), "
        "activation smaller than one collective would cost",
    re.compile(r"(gamma|logit_scale)$"):
        "scalar/vector modulation parameters",
}

Shapes = Union[nn.Module, Mapping[str, object]]


def rule_name(name: str) -> str:
    """The dotted flax path of the port's parameter ``name``: the string the
    rules are matched against."""
    return ".".join(flax_path(name))


def _shapes(params: Shapes) -> Iterable[Tuple[str, Tuple[int, ...]]]:
    items = params.named_parameters() if isinstance(params, nn.Module) else params.items()
    for name, v in items:
        yield name, tuple(v.shape)


def _model_size(mesh: Union[Mesh, int, None]) -> int:
    if mesh is None:
        return 1
    return mesh if isinstance(mesh, int) else mesh.model


def spec_of(name: str, shape: Sequence[int], m: int) -> Spec:
    """The spec of one parameter on a model axis of size ``m``."""
    path = rule_name(name)
    if m > 1 and len(shape) == 2 and path.endswith("weight"):
        if _EMBED.search(path) and shape[1] % m == 0:
            return ROW  # the embed dim (the vocab dim stays whole)
        if _COLUMN.search(path) and shape[0] % m == 0:
            return COLUMN
        if _ROW.search(path) and shape[1] % m == 0:
            return ROW
    return REPLICATED


def infer_param_specs(params: Shapes, mesh: Union[Mesh, int, None]) -> Dict[str, Spec]:
    """{parameter name: spec} of a module's parameters (or of a mapping of
    names to tensors or anything with a ``shape``) on ``mesh``'s model axis
    (or a size).  Only 2-D weights whose split dim the axis divides are
    sharded; a model axis of 1 replicates everything."""
    m = _model_size(mesh)
    return {name: spec_of(name, shape, m) for name, shape in _shapes(params)}


def spec_census(params: Shapes, mesh: Union[Mesh, int, None]) -> Dict[str, list]:
    """Which rule matched which parameter: ``{"column": [...], "row": [...],
    "justified": [(name, reason), ...], "replicated_2d_weight": [...]}`` of
    the port's names; the last bucket lists the 2-D ``*weight`` parameters no
    rule matched and no justification covers (candidates for review)."""
    census: Dict[str, list] = {"column": [], "row": [], "justified": [],
                               "replicated_2d_weight": []}
    m = _model_size(mesh)
    for name, shape in _shapes(params):
        spec, path = spec_of(name, shape, m), rule_name(name)
        if spec == COLUMN:
            census["column"].append(name)
        elif spec == ROW:
            census["row"].append(name)
        elif len(shape) == 2 and path.endswith("weight"):
            for pat, why in JUSTIFIED_REPLICATED.items():
                if pat.search(path):
                    census["justified"].append((name, why))
                    break
            else:
                census["replicated_2d_weight"].append(name)
    return census


def infer_opt_specs(state: Mapping, names: Sequence[str],
                    param_specs: Mapping[str, Spec]) -> Dict[int, Dict[str, Spec]]:
    """Specs of an AdamW ``state_dict()``'s per-parameter state (``names[i]``
    the parameter of index ``i``): each moment buffer whose shape is its
    parameter's (``exp_avg``, ``exp_avg_sq``, ``max_exp_avg_sq``) inherits the
    parameter's spec, so a sharded weight keeps sharded moments; the step
    counts and anything else are replicated."""
    out: Dict[int, Dict[str, Spec]] = {}
    for i, entry in state["state"].items():
        spec = param_specs.get(names[i], REPLICATED)
        out[i] = {k: spec if k != "step" and torch.is_tensor(v) and v.dim() > 0 else REPLICATED
                  for k, v in entry.items()}
    return out


def _split_dim(spec: Spec) -> int:
    return spec.index(MODEL_AXIS)


def shard(t: torch.Tensor, spec: Spec, index: int, m: int) -> torch.Tensor:
    """Shard ``index`` of ``m`` of ``t`` under ``spec`` (a contiguous copy;
    ``t`` itself where the spec is replicated or ``m`` is 1)."""
    if spec == REPLICATED or m == 1:
        return t
    return t.chunk(m, dim=_split_dim(spec))[index].clone(memory_format=torch.contiguous_format)


def shard_params(params: Shapes, mesh: Mesh, specs: Optional[Mapping[str, Spec]] = None
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Spec]]:
    """(this rank's shard of each tensor of a module or state_dict, the
    specs): the rank's model index picks the shard."""
    tensors = dict(params.named_parameters() if isinstance(params, nn.Module) else params)
    specs = dict(specs) if specs is not None else infer_param_specs(tensors, mesh)
    return ({k: shard(v.detach(), specs[k], mesh.model_index, mesh.model)
             for k, v in tensors.items()}, specs)


def gather(mesh: Mesh, part: torch.Tensor, spec: Spec,
           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The whole tensor of every model-axis rank's shard ``part`` (into
    ``out`` where given): an all-gather over ``mesh``'s model group.  A
    column shard is a block of rows, so the gathered list is concatenated;
    a row shard is a block of columns, strided in the whole tensor: the
    parts land in an (m, out, in/m) buffer, copied out with a permute."""
    m = mesh.model
    if spec == REPLICATED or m == 1:
        if out is not None and out is not part:
            out.copy_(part)
        return part if out is None else out
    part = part.contiguous()
    buf = torch.empty((m, *part.shape), dtype=part.dtype, device=part.device)
    dist.all_gather(list(buf.unbind(0)), part, group=mesh.model_group)
    d = _split_dim(spec)
    whole = buf.movedim(0, d).reshape(*part.shape[:d], m * part.shape[d], *part.shape[d + 1:])
    if out is None:
        return whole
    out.copy_(whole)
    return out
