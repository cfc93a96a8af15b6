"""lc2is_tpu_torch imports neither jax nor lc2is_tpu, and its device dispatch has exactly
two branches."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from lc2is_tpu_torch.ops.dispatch import use_kernel

REPO = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import lc2is_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(lc2is_tpu_torch.__path__, "lc2is_tpu_torch.")]
for name in mods:
    importlib.import_module(name)
assert len(mods) >= 18, mods
new = {"lc2is_tpu_torch.nn.clip", "lc2is_tpu_torch.ops.flash_attention",  # the v1 slice
       "lc2is_tpu_torch.ops.window_attention"}  # row 8, the windowed swin route
assert new <= set(mods), sorted(new - set(mods))
from lc2is_tpu_torch.models import zoo
v4 = {"BaseSelfA", "BaseCrossA", "PromptSelfA", "PromptCrossA", "PromptAuxSelfA"}
assert v4 <= {c.__name__ for c in zoo.ZOO.values()}, sorted(zoo.ZOO)
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
ref = sorted(m for m in sys.modules if m.split(".")[0] == "lc2is_tpu")
assert not ref, ref  # nothing of the JAX package either
print("ok", len(mods))
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_dispatch_branches():
    assert use_kernel(torch.zeros(1)) is False
    with pytest.raises(ValueError):
        use_kernel(torch.zeros(1, device="meta"))
