"""Typed configuration dataclasses, counterpart of
``lc2is_tpu/core/config.py`` (:17-108).

Field names mirror the reference's argparse surface (``evaluate.py:18-51``,
``all_args.sh:10-35``) so shell configs translate 1:1; model hyperparameters
mirror the reference constructor defaults (``model/model.py:14``,
``model/final.py:15,53,91``).  The fields and their defaults are the JAX
package's, so one config file or override list means the same run in both.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class DataConfig:
    data_name: str = "ade20k"
    data_size: Optional[int] = None  # subset size (reference: DATA_SIZE=64)
    split: str = "validation"
    img_size: int = 512
    label_size: int = 128
    batch_size: int = 16
    num_workers: int = 0
    on_device_preprocess: bool = True  # resize/normalize/remap on the device
    synthetic: bool = False  # deterministic fake data (CI / no-download mode)


@dataclass
class ModelConfig:
    name: str = "prompt_aux_cross_a"  # zoo key, see lc2is_tpu_torch.models.zoo
    patch_size: int = 16
    in_size: int = 512
    out_size: int = 128
    dropout: float = 0.0
    num_layers: int = 1  # v1 DecoderBlock depth (model/model.py:14)
    dec_dim: int = 512
    dec_depth: List[int] = field(default_factory=lambda: [1, 1, 1])
    nhead: int = 8
    num_classes: int = 151
    # DenseCLIP-style prompt cfg (model/final.py:91-105 contract)
    context_length: int = 5  # tokens reserved for the class name
    text_dim: int = 512
    # dtype policy: "float32" for parity, "bfloat16" for speed
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # preserve the reference's weight-tying quirk (hierarchical.py:137,157)
    tie_block_weights: bool = True


@dataclass
class TrainConfig:
    name: str = "default-name"
    out_dir: str = "./experience/"
    seed: int = 1024
    lr: float = 1e-5
    weight_decay: float = 0.0
    max_epoch: int = 5
    max_steps: Optional[int] = 100
    log_step: Optional[int] = 100
    eval_step: Optional[int] = 100
    save_step: Optional[int] = 100
    fp16: bool = False  # bf16 compute, f32 parameters (engine.py:59-60 equivalent)
    aux_weight: float = 0.4  # engine.py:86,98
    logger: str = "csv"  # "wandb" | "csv" | "null"
    wandb_project: Optional[str] = None
    donate_step: bool = True  # the JAX engine's buffer donation; the port ignores it
    remat: bool = False  # recompute the encoder stages in the backward


@dataclass
class MeshConfig:
    """Device-mesh layout (``core/mesh.py``): data axis = DP, model axis =
    TP (``parallel/sharding.py``)."""

    data: int = -1  # -1: all devices
    model: int = 1


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def apply_overrides(cfg: Config, overrides: List[str]) -> Config:
    """Apply ``section.key=value`` CLI overrides onto a Config, typed by the
    field's current value: booleans from 1/true/yes, ints, floats, int lists
    ``[a,b,c]``, strings; a None field takes an int where the value is
    digits, else the string."""
    for ov in overrides:
        key, _, raw = ov.partition("=")
        section, _, name = key.partition(".")
        sub = getattr(cfg, section)
        old = getattr(sub, name)
        if isinstance(old, bool):
            val = raw.lower() in ("1", "true", "yes")
        elif isinstance(old, int) or old is None and raw.isdigit():
            val = int(raw)
        elif isinstance(old, float):
            val = float(raw)
        elif isinstance(old, list):
            val = [int(x) for x in raw.strip("[]").split(",")]
        else:
            val = raw
        setattr(sub, name, val)
    return cfg
