"""``lc2is_tpu_torch/core/config.py`` against ``lc2is_tpu/core/config.py``:
the same fields and defaults, and ``apply_overrides`` giving the same config
for the same override lists (every field type: bool, int, float, list,
str, and the None fields' two readings)."""

import dataclasses

import pytest

from lc2is_tpu.core import config as J
from lc2is_tpu_torch.core import config as C

OVERRIDES = [
    [],
    ["data.img_size=640", "train.lr=0.001", "model.dropout=0.1", "train.fp16=true",
     "model.dec_depth=[2,2,2]", "mesh.model=2"],
    ["mesh.data=4", "mesh.model=2", "train.max_steps=7", "data.data_size=64",
     "train.wandb_project=proj", "model.name=base_cross_a", "model.dtype=float32"],
    ["train.fp16=0", "data.synthetic=yes", "data.on_device_preprocess=false",
     "train.remat=1", "model.tie_block_weights=no", "train.weight_decay=0.05"],
    ["data.data_size=abc", "train.log_step=10", "model.dec_depth=[3]", "train.seed=7",
     "train.aux_weight=0.25"],
]


def test_fields_and_defaults_match_jax():
    for name in ("DataConfig", "ModelConfig", "TrainConfig", "MeshConfig", "Config"):
        got = [(f.name, f.type) for f in dataclasses.fields(getattr(C, name))]
        want = [(f.name, f.type) for f in dataclasses.fields(getattr(J, name))]
        assert got == want, name
    assert dataclasses.asdict(C.Config()) == dataclasses.asdict(J.Config())


@pytest.mark.parametrize("overrides", OVERRIDES)
def test_apply_overrides_matches_jax(overrides):
    got = C.apply_overrides(C.Config(), overrides)
    want = J.apply_overrides(J.Config(), overrides)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for section in ("data", "model", "train", "mesh"):  # the same Python types
        for f in dataclasses.fields(getattr(got, section)):
            assert type(getattr(getattr(got, section), f.name)) is \
                type(getattr(getattr(want, section), f.name)), (section, f.name)


def test_replace_and_unknown_fields():
    cfg = C.Config().replace(mesh=C.MeshConfig(data=2, model=2))
    assert (cfg.mesh.data, cfg.mesh.model) == (2, 2)
    with pytest.raises(AttributeError):
        C.apply_overrides(C.Config(), ["train.nope=1"])
    with pytest.raises(AttributeError):
        J.apply_overrides(J.Config(), ["train.nope=1"])
