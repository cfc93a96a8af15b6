"""The port's evaluate CLI against ``lc2is_tpu.cli.evaluate.main`` on the same
argv: a reference ``.pt`` written by the JAX package for ``base_cross_a`` (the
CLI's default model, full width, 64²), each CLI's eval-step logits recorded.
Losses within 1e-4 relative, logits within 1e-3 of max |JAX|, the mIoUs
within 1e-6 where no pixel's argmax flips (each flip a near-tie of JAX's
logits, two best within 1e-5, counted at the logits' size and bicubic x4, as
``tests/test_torch_eval.py`` counts them).
"""

import numpy as np
import torch
from test_torch_cli import _jax_checkpoint

import lc2is_tpu.cli.evaluate as jax_evaluate_cli
import lc2is_tpu.engine.engine as jax_engine_module
from lc2is_tpu_torch.cli import evaluate as evaluate_cli
from lc2is_tpu_torch.engine import engine as port_engine_module
from lc2is_tpu_torch.ops.resize import resize

NEAR_TIE, MIOU_TOL = 1e-5, 1e-6


def _x4(logits):
    return resize(torch.from_numpy(np.array(logits)), scale_factor=4, method="bicubic")


def _near_tie_flips(got, want):
    want = torch.from_numpy(np.array(want))
    differ = torch.from_numpy(np.array(got)).argmax(1) != want.argmax(1)
    top2 = want.topk(2, dim=1).values
    assert bool((top2[:, 0] - top2[:, 1])[differ].le(NEAR_TIE).all())
    return int(differ.sum())


def test_evaluate_matches_the_jax_cli(tmp_path, monkeypatch):
    ckpt = str(tmp_path / "step-1.pt")
    argv = ["--name", "cmp", "--out_dir", str(tmp_path), "--seed", "3", "--data_name",
            "synthetic", "--data_size", "2", "--model", "base_cross_a", "--img_size", "64",
            "--label_size", "16", "--batch_size", "2", "--logger", "null", "--checkpoint", ckpt]
    _jax_checkpoint(argv, ckpt)
    logits = {}

    class Recording(jax_engine_module.Engine):  # the JAX eval step's logits
        def _build_steps(self, donate):
            super()._build_steps(donate)
            step = self._eval_step

            def recorded(*a):
                out = step(*a)
                logits["jax"] = np.asarray(out[3])
                return out

            self._eval_step = recorded

    def recorded_port_step(*a, **kw):
        out = port_eval_step(*a, **kw)
        logits["port"] = out[3].numpy()
        return out

    port_eval_step = port_engine_module.eval_step
    monkeypatch.setattr(jax_evaluate_cli, "Engine", Recording)
    monkeypatch.setattr(port_engine_module, "eval_step", recorded_port_step)
    want = jax_evaluate_cli.main(argv)
    got = evaluate_cli.main(argv + ["--device", "cpu"])
    assert set(got) == set(want) == {"eval_loss", "eval_mIOU_label", "eval_mIOU_dataset"}
    np.testing.assert_allclose(got["eval_loss"], want["eval_loss"], rtol=1e-4)
    mine, ref = logits["port"], logits["jax"]
    np.testing.assert_allclose(mine, ref, atol=1e-3 * np.abs(ref).max())
    # the dataset mIoU counts at the logits' size, the per-image one at x4
    if _near_tie_flips(mine, ref) == 0:
        assert abs(got["eval_mIOU_dataset"] - want["eval_mIOU_dataset"]) <= MIOU_TOL
    if _near_tie_flips(_x4(mine), _x4(ref)) == 0:
        assert abs(got["eval_mIOU_label"] - want["eval_mIOU_label"]) <= MIOU_TOL
