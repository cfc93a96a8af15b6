"""The port's CLI (``python -m lc2is_tpu_torch.cli.train`` / ``.evaluate``)
with the JAX CLI's argv and ``--device cpu``:

- the dress-rehearsal flags of ``tests/test_dress_rehearsal.py`` (the
  flagship ``prompt_aux_cross_a`` at full width, 64² images): 2 training
  steps, a native checkpoint and its reference ``.pt`` export, the evaluation
  of each to the same metrics (abs 1e-7);
- ``scripts/parity_eval.sh``'s flags, parsed from the script as
  ``tests/test_dress_rehearsal.py::test_parity_eval_sh_code_path`` parses
  them, through the port's evaluate module for ``base_with_text`` with a
  JAX-written reference ``.pt``: finite label, GT and dataset mIoU;
- the parser's dests and defaults equal the JAX CLI's but ``--device``
  (``cuda``; without a card the CLI raises); ``--dp 0`` and ``--tp 0``
  raise, ``--dp 2`` and ``--tp 2`` parse.

``tests/test_torch_cli_vs_jax.py`` holds the evaluate CLI to the JAX
package's on one argv.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lc2is_tpu.cli.common import build_arg_parser as jax_parser
from lc2is_tpu.cli.common import build_model as jax_build_model
from lc2is_tpu.data.ade20k import SyntheticADE20K
from lc2is_tpu.engine.checkpoint import export_reference_pt as jax_export
from lc2is_tpu_torch.cli import evaluate as evaluate_cli
from lc2is_tpu_torch.cli import train as train_cli
from lc2is_tpu_torch.cli.common import build_arg_parser, parse_args
from lc2is_tpu_torch.engine.checkpoint import export_reference_pt, latest_checkpoint

REPO = os.path.join(os.path.dirname(__file__), "..")


def test_rehearsal_train_then_evaluate_both_formats(tmp_path):
    out_dir = str(tmp_path / "run")
    common = ["--name", "rehearsal", "--out_dir", out_dir, "--seed", "7",
              "--data_name", "synthetic", "--data_size", "8", "--model", "prompt_aux_cross_a",
              "--img_size", "64", "--label_size", "16", "--batch_size", "8", "--dropout", "0",
              "--logger", "null", "--device", "cpu"]
    metrics = train_cli.main(common + ["--max_epoch", "1", "--max_steps", "2", "--exact_steps",
                                       "--save_step", "2", "--eval_step", "1000",
                                       "--log_step", "1"])
    assert metrics["train_step"] == 2 and np.isfinite(metrics["train_loss"])
    native = latest_checkpoint(os.path.join(out_dir, "rehearsal", "checkpoints"))
    assert native is not None and native.endswith("step-2.pth")
    state = torch.load(native, weights_only=True)
    pt_path = str(tmp_path / "step-2.pt")
    export_reference_pt(state["model"], pt_path)
    m_native = evaluate_cli.main(common + ["--checkpoint", native])
    m_pt = evaluate_cli.main(common + ["--checkpoint", pt_path])
    assert set(m_native) == set(m_pt) >= {"eval_loss", "eval_mIOU_label", "eval_mIOU_dataset"}
    for k in m_native:
        assert m_native[k] == pytest.approx(m_pt[k], abs=1e-7), k


def _jax_checkpoint(argv, path, seed=0):
    """A reference ``.pt`` written by the JAX package for the model of
    ``argv``: every parameter 1-D ones + 0.1·N or N / sqrt(fan_in)."""
    args = jax_parser().parse_args(argv)
    names = SyntheticADE20K(length=1, img_size=args.img_size).class_names
    model = jax_build_model(args, names)
    inputs = {"pixel_values": jnp.zeros((1, 3, args.img_size, args.img_size), jnp.float32)}
    if args.model == "base_with_text":
        inputs.update(input_ids=jnp.zeros((1, 9), jnp.int32),
                      attention_mask=jnp.ones((1, 9), jnp.int32))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), inputs)["params"]
    rs = np.random.RandomState(seed)

    def fill(kp, s):
        if len(s.shape) == 1:
            v = (1.0 if str(kp[-1].key) == "weight" else 0.0) + 0.1 * rs.randn(*s.shape)
        else:
            v = rs.randn(*s.shape) / np.sqrt(np.prod(s.shape[1:]))
        return v.astype(np.float32)

    jax_export(jax.tree_util.tree_map_with_path(fill, shapes), path)


def test_parity_eval_sh_flags_through_the_port(tmp_path):
    sh = open(os.path.join(REPO, "scripts", "parity_eval.sh")).read()
    block = sh[sh.index("python -m lc2is_tpu.cli.evaluate"):]
    script_flags = re.findall(r"(--[a-z0-9_]+)", block)
    assert "--gt_metrics" in script_flags and "--gt_bucket" in script_flags
    # sizes for the CPU and the synthetic dataset in place of ADE20K, as the
    # JAX rehearsal substitutes them; every other flag as the script passes it
    resized = {"--data_size": "4", "--img_size": "64", "--label_size": "16",
               "--batch_size": "4", "--gt_bucket": "16"}
    substituted = {"--data_name": "synthetic", "--data_root": None, "--split": None}
    ckpt = str(tmp_path / "step-400.pt")
    values = {"--name": "parity-eval", "--checkpoint": ckpt, "--seed": "1024",
              "--model": "base_with_text", "--patch_size": "16", "--dropout": "0",
              "--fp16": "False", "--logger": "csv", **resized}
    values.update({k: v for k, v in substituted.items() if v is not None})
    argv = []
    for flag in dict.fromkeys(script_flags):
        if flag in substituted and substituted[flag] is None:
            continue
        argv.append(flag)
        if flag in values:
            argv.append(values[flag])
        elif flag != "--gt_metrics":
            raise AssertionError(f"parity_eval.sh passes {flag} with no value here")
    argv += ["--out_dir", str(tmp_path / "out"), "--device", "cpu"]
    _jax_checkpoint(argv, ckpt)
    metrics = evaluate_cli.main(argv)
    for key in ("eval_mIOU_label", "eval_mIOU_gt", "eval_mIOU_dataset"):
        assert np.isfinite(metrics[key]), (key, metrics)


def _defaults(parser):
    return {a.dest: (a.default, a.type, a.choices, a.required, a.nargs, type(a).__name__)
            for a in parser._actions}


def test_parser_matches_the_jax_cli():
    got, want = _defaults(build_arg_parser()), _defaults(jax_parser())
    assert set(got) == set(want)
    assert got.pop("device")[0] == "cuda" and want.pop("device")[0] == "tpu"
    fp16 = got.pop("fp16"), want.pop("fp16")  # each its own lambda
    assert fp16[0][0] is fp16[1][0] is False
    assert got == want
    args = parse_args(["--name", "x", "--fp16", "true", "--dp", "1"])
    assert args.fp16 is True and args.device == "cuda"


@pytest.mark.parametrize("flags", [["--dp", "2"], ["--tp", "2"], ["--dp", "0"], ["--tp", "0"]])
def test_more_than_one_device_raises(flags):
    """``--dp 0`` and ``--tp 0`` raise; ``--dp 2`` and ``--tp 2`` parse, the
    batch the global one (``tests/test_torch_dp.py`` and
    ``tests/test_torch_tp.py`` train with them)."""
    argv = ["--name", "x", "--batch_size", "8"] + flags
    if flags[1] == "2":
        args = parse_args(argv)
        assert (args.dp, args.tp, args.batch_size) == ((2, 1, 8) if flags[0] == "--dp"
                                                       else (-1, 2, 8))
        return
    with pytest.raises(ValueError, match=r"--dp 0: the data axis|--tp 0: the model axis"):
        parse_args(argv)


def test_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_cli.main(["--name", "x", "--out_dir", str(tmp_path), "--data_name", "synthetic",
                           "--data_size", "2", "--img_size", "32", "--batch_size", "2"])
