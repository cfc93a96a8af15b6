"""The int8 serving row (``quant_int8=True``, served masks) of a v4 model
with the SelfA decoder, whose SR encoder layers take ``fused_attn_block_q``
and ``fused_mlp_q``: the tiny ``BaseSelfA`` against the JAX package's Pallas
path in interpret mode (one jitted forward), as
``tests/test_torch_serve.py::test_slice_int8`` holds the flagship.  Stated
bound, that test's: masks agree on >= 0.98 of the pixels (an int8 code that
rounds the other way on one side moves a score by one step of its scale)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import TINY_SWIN, load_jax_params, numpy_params, t

from lc2is_tpu.models import zoo as jzoo
from lc2is_tpu_torch.models import zoo
from lc2is_tpu_torch.nn import layers

KW = dict(class_names=tuple(f"c{i}" for i in range(7)), swin_cfg=TINY_SWIN, dec_dim=64, nhead=4)


def test_base_self_a_int8(monkeypatch):
    monkeypatch.setenv("LC2IS_PALLAS_INTERPRET", "1")
    x = np.random.RandomState(9).randn(2, 3, 64, 64).astype(np.float32)
    jm = jzoo.BaseSelfA(predict_masks=True, quant_int8=True, **KW)
    px = jnp.asarray(x)
    params = numpy_params(jm, {"pixel_values": px})
    want = jax.jit(lambda p, a: jm.apply(p, {"pixel_values": a}))(params, px)
    port = load_jax_params(zoo.BaseSelfA(predict_masks=True, quant_int8=True, device="cpu", **KW),
                           params)
    calls = []
    for name in ("fused_attn_block_q", "fused_mlp_q"):
        op = getattr(layers, name)
        monkeypatch.setattr(layers, name,
                            lambda *a, _op=op, _n=name, **k: calls.append(_n) or _op(*a, **k))
    with torch.no_grad():
        got = port({"pixel_values": t(x)})["outputs"]
    assert calls.count("fused_attn_block_q") == 6 and calls.count("fused_mlp_q") == 6
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 64, 64)
    agree = (got.numpy() == np.asarray(want["outputs"])).mean()
    assert agree >= 0.98, agree
    port.train()
    with pytest.raises(RuntimeError, match="serving only"):
        port({"pixel_values": t(x)})
