"""The port's modules and the whole PromptAuxCrossA serving forward against
lc2is_tpu on the same parameters (carried across by core/convert.py) and the
same numpy-seeded inputs.  JAX runs its XLA path (attn_impl="xla", which
tests/test_fused_paths.py pins to the Pallas path); the port runs its plain
versions (CPU tensors).  f32: 2e-4 per module, 1e-3 on the whole slice."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import (SLICE_ATOL, TINY_SWIN, close, load_jax_params, numpy_params,
                             small_denseclip_cfg, t)

from lc2is_tpu.models import zoo as jzoo
from lc2is_tpu.nn.decoders import HierarchicalCrossA as JHierarchicalCrossA
from lc2is_tpu.nn.swin import SwinModel as JSwinModel
from lc2is_tpu_torch.models import zoo
from lc2is_tpu_torch.nn.decoders import HierarchicalCrossA
from lc2is_tpu_torch.nn.swin import SwinModel
from lc2is_tpu_torch.ops.resize import resize

# window 7 on a 72² input: 18² -> 21² HF-padded canvas, shifted blocks, odd
# merges (9² -> 5²) and the shrunken window of the small late stages
WIN7_SWIN = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8), window=7)


@pytest.mark.parametrize("cfg,img", [(TINY_SWIN, 64), (WIN7_SWIN, 72)])
def test_swin_model(cfg, img):
    x = np.random.RandomState(0).randn(2, 3, img, img).astype(np.float32)
    jm = JSwinModel(attn_impl="xla", drop_path_rate=0.0, **cfg)
    params = numpy_params(jm, jnp.asarray(x))
    want = jax.jit(jm.apply)(params, jnp.asarray(x))
    port = load_jax_params(SwinModel(**cfg), params)
    with torch.no_grad():
        got = port(t(x))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        close(g, w)


def test_hierarchical_cross_a():
    rs = np.random.RandomState(1)
    in_dims, dim, b, k = (16, 32, 64, 128), 64, 2, 5
    visual = [rs.randn(b, g * g, c).astype(np.float32)
              for g, c in zip((16, 8, 4, 2), in_dims)]
    text = rs.randn(b, k, dim).astype(np.float32)
    jm = JHierarchicalCrossA(in_dims=in_dims, depth=(1, 1, 1), dim=dim, nhead=4, dropout=0.0,
                             attn_impl="xla")
    jv = [jnp.asarray(v) for v in visual]
    params = numpy_params(jm, jv, jnp.asarray(text))
    want = jax.jit(jm.apply)(params, jv, jnp.asarray(text))
    port = load_jax_params(HierarchicalCrossA(in_dims, (1, 1, 1), dim, nhead=4), params)
    with torch.no_grad():
        got = port([t(v) for v in visual], t(text))
    close(got, want)


@pytest.fixture(scope="module")
def slice_run():
    """The whole tiny PromptAuxCrossA on one input: (port model, input, JAX
    outputs of the per-step text path, JAX embed_text, JAX outputs of the
    text_static path), JAX in one jitted call."""
    kw = dict(cfg=small_denseclip_cfg(), class_names=tuple(f"c{i}" for i in range(7)),
              swin_cfg=TINY_SWIN)
    jm = jzoo.PromptAuxCrossA(attn_impl="xla", **kw)
    x = np.random.RandomState(3).randn(2, 3, 64, 64).astype(np.float32)
    params = numpy_params(jm, {"pixel_values": jnp.asarray(x)})

    def both_paths(p, px):
        ts = jm.apply(p, method="embed_text")
        return (jm.apply(p, {"pixel_values": px}), ts,
                jm.apply(p, {"pixel_values": px, "text_static": ts}))

    want = jax.jit(both_paths)(params, jnp.asarray(x))
    return (load_jax_params(zoo.PromptAuxCrossA(**kw), params), x) + tuple(want)


@pytest.mark.parametrize("cached_text", [False, True])
def test_prompt_aux_cross_a(slice_run, cached_text):
    """Whole slice, both the per-step text path and the text_static path."""
    port, x, want_step, want_ts, want_cached = slice_run
    tin = {"pixel_values": t(x)}
    with torch.no_grad():
        if cached_text:
            tin["text_static"] = port.embed_text()
            close(tin["text_static"], want_ts)
        got = port(tin)
    want = want_cached if cached_text else want_step
    assert set(got) == set(want) == {"outputs", "low_score_map"}
    assert tuple(got["outputs"].shape) == (2, 7, 64, 64)
    assert tuple(got["low_score_map"].shape) == (2, 7, 4, 4)
    for key in want:
        close(got[key], want[key], rtol=0, atol=SLICE_ATOL)


@pytest.mark.parametrize("head", ["predict_masks", "return_score_map"])
def test_unported_heads_raise(head, slice_run):
    """The argmax head (``predict_masks``) is not ported: asking for it fails
    loudly instead of serving another head.  The training head
    (``return_score_map``) is ported: it returns the low-res score map
    (B, K, H/4, W/4), whose bilinear ×4 is the default head's output, and the
    same low_score_map."""
    kw = dict(cfg=small_denseclip_cfg(), swin_cfg=TINY_SWIN,
              class_names=tuple(f"c{i}" for i in range(7)))
    if head == "predict_masks":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            zoo.PromptAuxCrossA(predict_masks=True, **kw)
        return
    port, x = slice_run[:2]
    train_head = zoo.PromptAuxCrossA(return_score_map=True, **kw).eval()
    train_head.load_state_dict(port.state_dict(), strict=True)
    with torch.no_grad():
        full, low = port({"pixel_values": t(x)}), train_head({"pixel_values": t(x)})
    assert tuple(low["outputs"].shape) == (2, 7, 16, 16)
    close(resize(low["outputs"], scale_factor=4, method="bilinear"), full["outputs"].numpy(),
          rtol=0, atol=1e-6)
    close(low["low_score_map"], full["low_score_map"].numpy(), rtol=0, atol=0)
