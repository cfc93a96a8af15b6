"""The other five v4 models of the port (``BaseSelfA``, ``BaseCrossA``,
``PromptSelfA``, ``PromptCrossA``, ``PromptAuxSelfA``) against lc2is_tpu on
the same parameters (loaded with ``strict=True``) and the same numpy-seeded
input, at a tiny size: TINY_SWIN, decoder width 64 (the Base models) or the
text width 512 (the prompt models, whose class embeddings are the decoder's
memory), 7 classes.  JAX runs its XLA path (``attn_impl="xla"``), the port its
plain versions (CPU tensors).

Stated tolerances: f32 score maps and ``low_score_map`` within SLICE_ATOL
(1e-3); masks (``predict_masks``) equal to the argmax over the classes of
JAX's score map ×4 except at near-ties (the two best scores within 1e-5: the
two heads blend in another order); bf16: each output's dtype equal to JAX's,
and its values within BF16_MAX / BF16_MEAN of max |ref| (each side rounds
its own accumulations to bf16).  Also: the registry against JAX's, the SR
encoder layer and the SelfA pyramid decoder alone, a full-width strict load
of ``BaseCrossA``, and dropout in training."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import (SLICE_ATOL, TINY_SWIN, close, load_jax_params, numpy_params,
                             small_denseclip_cfg, t)

from lc2is_tpu.models import zoo as jzoo
from lc2is_tpu.nn.decoders import HierarchicalSelfA as JHierarchicalSelfA
from lc2is_tpu.nn.layers import SRTransformerEncoderLayer as JSREncoderLayer
from lc2is_tpu_torch.core.convert import seeded_init_, torch_key
from lc2is_tpu_torch.models import zoo
from lc2is_tpu_torch.nn import layers
from lc2is_tpu_torch.nn.decoders import HierarchicalSelfA
from lc2is_tpu_torch.nn.layers import SRTransformerEncoderLayer

NAMES = ("BaseSelfA", "BaseCrossA", "PromptSelfA", "PromptCrossA", "PromptAuxSelfA")
CLASSES = tuple(f"c{i}" for i in range(7))
IMG = 64
BF16_MAX, BF16_MEAN = 5e-2, 1e-2


def model_kw(name):
    kw = dict(class_names=CLASSES, swin_cfg=TINY_SWIN)
    if name.startswith("Prompt"):
        return dict(kw, cfg=small_denseclip_cfg())
    return dict(kw, dec_dim=64, nhead=4)


def out_keys(name):
    return ("outputs", "low_score_map") if name == "PromptAuxSelfA" else ("outputs",)


@pytest.fixture(scope="module", params=NAMES)
def v4_run(request):
    """(name, params, input, JAX f32 outputs, JAX bf16 outputs), JAX in one
    jitted call."""
    name = request.param
    jcls = getattr(jzoo, name)
    kw = model_kw(name)
    x = np.random.RandomState(3).randn(2, 3, IMG, IMG).astype(np.float32)
    params = numpy_params(jcls(attn_impl="xla", **kw), {"pixel_values": jnp.asarray(x)})

    def both(p, px):
        return (jcls(attn_impl="xla", **kw).apply(p, {"pixel_values": px}),
                jcls(attn_impl="xla", dtype=jnp.bfloat16, **kw).apply(p, {"pixel_values": px}))

    want32, want16 = jax.jit(both)(params, jnp.asarray(x))
    return name, params, x, want32, want16


def _port(name, params, **kw):
    return load_jax_params(getattr(zoo, name)(device="cpu", **model_kw(name), **kw), params)


def test_v4_model_f32(v4_run):
    name, params, x, want, _ = v4_run
    port = _port(name, params)
    with torch.no_grad():
        got = port({"pixel_values": t(x)})
    assert set(got) == set(want) == set(out_keys(name))
    assert tuple(got["outputs"].shape) == (2, 7, IMG, IMG)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
        close(got[key], want[key], rtol=0, atol=SLICE_ATOL)


def test_v4_model_masks(v4_run):
    """``predict_masks``: int32 masks, the argmax of JAX's score map ×4 except
    at near-ties; ``low_score_map`` unchanged by the head."""
    name, params, x, want, _ = v4_run
    port = _port(name, params, predict_masks=True)
    with torch.no_grad():
        got = port({"pixel_values": t(x)})
    masks = got["outputs"]
    assert masks.dtype == torch.int32 and tuple(masks.shape) == (2, IMG, IMG)
    scores = torch.from_numpy(np.asarray(want["outputs"]))
    top2 = scores.topk(2, dim=1).values
    differ = masks != scores.argmax(1)
    assert (top2[:, 0] - top2[:, 1])[differ].le(1e-5).all()
    assert differ.float().mean() <= 1e-3
    if "low_score_map" in want:
        close(got["low_score_map"], want["low_score_map"], rtol=0, atol=SLICE_ATOL)


def test_v4_model_bf16(v4_run):
    name, params, x, _, want = v4_run
    port = _port(name, params, dtype=torch.bfloat16)
    with torch.no_grad():
        got = port({"pixel_values": t(x)})
    assert set(got) == set(want)
    for key in want:
        g = got[key]
        assert str(g.dtype).replace("torch.", "") == str(want[key].dtype), key
        ref = np.asarray(want[key].astype(jnp.float32))
        d = np.abs(g.float().numpy() - ref)
        lim = np.abs(ref).max()
        assert d.max() <= BF16_MAX * lim and d.mean() <= BF16_MEAN * lim, (
            key, d.max() / lim, d.mean() / lim)


def test_registry_matches_jax():
    """The port's ``ZOO`` names the JAX package's classes under the same keys,
    and ``FROZEN_PREFIXES`` equals JAX's for every key the port has."""
    assert set(zoo.ZOO) <= set(jzoo.ZOO) and len(zoo.ZOO) == 13
    assert {k: c.__name__ for k, c in zoo.ZOO.items()} == \
        {k: jzoo.ZOO[k].__name__ for k in zoo.ZOO}
    assert zoo.FROZEN_PREFIXES == {k: v for k, v in jzoo.FROZEN_PREFIXES.items()
                                   if k in zoo.ZOO}
    for k in ("base_self_a", "base_cross_a"):
        assert k not in zoo.FROZEN_PREFIXES  # nothing frozen: no prompt tower


@pytest.mark.parametrize("norm_first,sr", [(False, 2), (True, 2), (False, 1)])
def test_sr_encoder_layer_matches_jax(norm_first, sr):
    """The port's SR encoder layer (fused route when post-norm) against JAX's
    (XLA route), f32."""
    x = np.random.RandomState(6).randn(2, 64, 32).astype(np.float32)
    jm = JSREncoderLayer(d_model=32, nhead=4, dim_feedforward=48, dropout=0.0,
                         norm_first=norm_first, sr_ratio=sr, attn_impl="xla")
    params = numpy_params(jm, jnp.asarray(x))
    want = jax.jit(jm.apply)(params, jnp.asarray(x))
    port = load_jax_params(SRTransformerEncoderLayer(32, 4, sr_ratio=sr, dim_feedforward=48,
                                                     norm_first=norm_first), params)
    with torch.no_grad():
        close(port(t(x)), want)


def test_hierarchical_self_a():
    rs = np.random.RandomState(1)
    in_dims, dim, b = (16, 32, 64, 128), 64, 2
    visual = [rs.randn(b, g * g, c).astype(np.float32)
              for g, c in zip((16, 8, 4, 2), in_dims)]
    jm = JHierarchicalSelfA(in_dims=in_dims, depth=(1, 2, 1), dim=dim, nhead=4, dropout=0.0,
                            tie_block_weights=False, attn_impl="xla")
    jv = [jnp.asarray(v) for v in visual]
    params = numpy_params(jm, jv)
    want = jax.jit(jm.apply)(params, jv)
    port = load_jax_params(HierarchicalSelfA(in_dims, (1, 2, 1), dim, nhead=4,
                                             tie_block_weights=False), params)
    with torch.no_grad():
        got = port([t(v) for v in visual])
    close(got, want)


def test_full_width_base_cross_a_state_dict():
    """swin-small, decoder 512, 151 classes (the CLI's default model): the JAX
    tree's keys and shapes load into the port with strict=True (flax makes no
    parameter for a submodule it never calls)."""
    inputs = {"pixel_values": jax.ShapeDtypeStruct((1, 3, 64, 64), jnp.float32)}
    shapes = jax.eval_shape(jzoo.BaseCrossA().init, jax.random.PRNGKey(0), inputs)["params"]
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    state = {torch_key(tuple(str(p.key) for p in path)): torch.empty(s.shape, device="meta")
             for path, s in flat}
    port = zoo.BaseCrossA(device="meta")
    port.load_state_dict(state, strict=True)
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == {k: tuple(v.shape) for k, v in state.items()}
    assert got["classes.weight"] == (151, 512)
    assert got["vision_decoder.attention_stage_4.2.layers.0.sr_reduce.sr.weight"] == \
        (512, 512, 2, 2)


def test_v4_dropout_in_training(monkeypatch):
    """dropout > 0 in training: the SR encoder layers take the unfused route
    (no fused_attn_block, no fused_mlp call), the output repeats from one
    generator seed and differs under another; in eval mode the fused route
    runs and the output equals the dropout-0 model's."""
    calls = []
    for fn in ("fused_attn_block", "fused_mlp"):
        op = getattr(layers, fn)
        monkeypatch.setattr(layers, fn, lambda *a, _op=op, _n=fn, **kw: calls.append(_n)
                            or _op(*a, **kw))
    kw = dict(model_kw("BaseSelfA"), swin_cfg=dict(TINY_SWIN, drop_path_rate=0.0))
    drop = seeded_init_(zoo.BaseSelfA(device="cpu", dropout=0.2, **kw), seed=4)
    none = zoo.BaseSelfA(device="cpu", **kw)
    none.load_state_dict(drop.state_dict(), strict=True)
    x = {"pixel_values": t(np.random.RandomState(8).randn(1, 3, IMG, IMG))}
    with torch.no_grad():
        drop.train()
        a = drop(x, generator=torch.Generator().manual_seed(1))["outputs"]
        assert not calls
        b = drop(x, generator=torch.Generator().manual_seed(1))["outputs"]
        c = drop(x, generator=torch.Generator().manual_seed(2))["outputs"]
        ref = none.eval()(x)["outputs"]
        n_fused = len(calls)
        assert torch.equal(drop.eval()(x)["outputs"], ref)
    assert n_fused == 12  # 6 SR encoder layers: one attention half and one MLP each
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, ref)
