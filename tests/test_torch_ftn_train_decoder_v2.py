"""``FTNDecoderV2``'s gradients at its fixed grids (512² input) in the port
against ``jax.vjp`` of lc2is_tpu's module on the same numpy parameters
(tests/ftn_train_util.py says how the FTN tests compare)."""

import numpy as np
import pytest
import torch
from ftn_train_util import _grad_close, _relu_fed, compiled_runs
from torch_port_util import load_jax_params, t

from lc2is_tpu_torch.core.convert import params_to_state_dict
from lc2is_tpu_torch.models.zoo import without_dropout
from lc2is_tpu_torch.nn import decoders


@pytest.fixture(scope="module")
def jax_runs():
    """``FTNDecoderV2``'s vjp, compiled once."""
    return compiled_runs(["FTNDecoderV2"])


def test_ftn_decoder_v2_gradients_match_jax(jax_runs):
    """``FTNDecoderV2`` at its fixed grids (512² input), batch 1: the
    gradients of every parameter and of the four pyramid inputs under one
    cotangent, the port in training mode with its dropouts zeroed (the
    unfused layers) against ``jax.vjp`` of the deterministic module."""
    compiled, case = jax_runs.pop("FTNDecoderV2")
    want_p, want_v = compiled(*case["args"])
    port = without_dropout(load_jax_params(decoders.FTNDecoderV2(), case["params"])).train()
    xs = [t(v).requires_grad_() for v in case["visual"]]
    port(xs, torch.Generator().manual_seed(0)).backward(t(case["cot"]))
    want, relu_fed = params_to_state_dict(want_p), _relu_fed(port)
    assert set(want) == {n for n, _ in port.named_parameters()}
    assert len(relu_fed) == 2 * 6, relu_fed  # the 1 + 2 + 3 layers of its RepeatTransformers
    for name, p in port.named_parameters():
        w = want[name].numpy()
        _grad_close(p.grad.numpy(), w, name, w, name in relu_fed)
    for i, (x, w) in enumerate(zip(xs, want_v)):
        # a switched unit moves its token's input row
        w = np.asarray(w)
        _grad_close(x.grad.numpy(), w, f"input {i}", w, True)
