"""Checkpoints, counterpart of ``lc2is_tpu/engine/checkpoint.py``, in two
formats:

- native: ``{dir}/step-{N}.pth`` holds the model's ``state_dict`` and the
  optimizer's (AdamW moments, the update count the schedule reads, the clip),
  beside ``{dir}/step-{N}.json`` metadata (``checkpoint.py:73-84``); the
  training run resumes from it;
- reference ``.pt``: a bare ``state_dict`` under the names the JAX package's
  export writes (the reference saves ``model.state_dict()``,
  ``engine.py:186-190``), so a file goes both ways between the packages
  (``core/convert.py``: :func:`reference_key`, :func:`from_reference_names`).

Files are read with ``torch.load(..., weights_only=True)``.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from lc2is_tpu_torch.core.convert import from_reference_names, reference_key

_STEP_FILE = re.compile(r"step-(\d+)\.pth")


def save_checkpoint(path: str, state: Dict, step: int, metadata: Optional[Dict] = None) -> str:
    """Write ``state`` (tensors, numbers, nested dicts and lists) to
    ``{path}/step-{step}.pth`` and ``dict(step=step, **metadata)`` to
    ``step-{step}.json``; returns the ``.pth`` name."""
    os.makedirs(path, exist_ok=True)
    fname = os.path.join(path, f"step-{step}.pth")
    torch.save(state, fname)
    with open(os.path.join(path, f"step-{step}.json"), "w") as f:
        json.dump(dict(step=step, **(metadata or {})), f)
    return fname


def load_checkpoint(fname: str, map_location="cpu") -> Tuple[Dict, Dict]:
    """(state, metadata) of a native checkpoint; metadata ``{}`` where the
    ``.json`` is missing."""
    state = torch.load(fname, map_location=map_location, weights_only=True)
    meta_path = fname[:-len(".pth")] + ".json"
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return state, meta


def latest_checkpoint(path: str) -> Optional[str]:
    """The ``step-{N}.pth`` of ``path`` with the largest N, or None."""
    if not os.path.isdir(path):
        return None
    steps = [int(m.group(1)) for m in map(_STEP_FILE.fullmatch, os.listdir(path)) if m]
    return os.path.join(path, f"step-{max(steps)}.pth") if steps else None


def export_reference_pt(model_or_state: nn.Module | Mapping[str, torch.Tensor], path: str) -> None:
    """Write the parameters as a bare ``state_dict`` under the reference
    names (CPU tensors of the parameters' dtype)."""
    sd = (dict(model_or_state.named_parameters()) if isinstance(model_or_state, nn.Module)
          else model_or_state)
    torch.save({reference_key(k): v.detach().cpu().contiguous() for k, v in sd.items()}, path)


def import_reference_pt(path: str, model: Optional[nn.Module] = None) -> Dict[str, torch.Tensor]:
    """A reference ``.pt`` -> the port's state_dict, for
    ``load_state_dict(..., strict=True)``; with ``model``, each ``sr`` /
    ``norm`` name takes the reading that model has (``from_reference_names``)."""
    keys = None if model is None else [k for k, _ in model.named_parameters()]
    return from_reference_names(torch.load(path, map_location="cpu", weights_only=True), keys)
