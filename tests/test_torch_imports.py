"""lc2is_tpu_torch imports neither jax nor lc2is_tpu (every module, the CLI's
among them), its CLI starts, and its device dispatch has exactly two
branches."""

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
assert len(mods) >= 30, mods
new = {"lc2is_tpu_torch.nn.clip", "lc2is_tpu_torch.ops.flash_attention",  # the v1 slice
       "lc2is_tpu_torch.ops.window_attention",  # row 8, the windowed swin route
       "lc2is_tpu_torch.nn.init", "lc2is_tpu_torch.engine.checkpoint",  # the CLI slice
       "lc2is_tpu_torch.engine.loggers", "lc2is_tpu_torch.engine.profiler",
       "lc2is_tpu_torch.data.ade20k", "lc2is_tpu_torch.data.transforms",
       "lc2is_tpu_torch.data.collators", "lc2is_tpu_torch.data.loader",
       "lc2is_tpu_torch.data.preprocess", "lc2is_tpu_torch.cli.common",
       "lc2is_tpu_torch.cli.train", "lc2is_tpu_torch.cli.evaluate",
       "lc2is_tpu_torch.cli.prepare_data",
       "lc2is_tpu_torch.core.mesh",  # the data axis
       "lc2is_tpu_torch.parallel.sharding",  # the model axis
       "lc2is_tpu_torch.models.weights", "lc2is_tpu_torch.data.native_loader",
       "lc2is_tpu_torch.core.config"}  # the last modules
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


@pytest.mark.parametrize("cli", ["train", "evaluate", "prepare_data"])
def test_cli_help(cli):
    """``python -m lc2is_tpu_torch.cli.<cli> --help`` starts without jax."""
    code = (f"import runpy, sys; sys.argv = ['{cli}', '--help']\n"
            f"try:\n    runpy.run_module('lc2is_tpu_torch.cli.{cli}', run_name='__main__')\n"
            "except SystemExit as e:\n    assert e.code == 0, e.code\n"
            "assert 'jax' not in sys.modules\n"
            "assert not [m for m in sys.modules if m.split('.')[0] == 'lc2is_tpu']\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "usage:" in out.stdout


def test_dispatch_branches():
    assert use_kernel(torch.zeros(1)) is False
    with pytest.raises(ValueError):
        use_kernel(torch.zeros(1, device="meta"))
