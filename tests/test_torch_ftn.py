"""The swin-base FTN family of the port (``PromptFTNv1``, ``BaseFTN``,
``PromptFTNv2``, ``DenseCLIPFTN``) and its decoders (``FTNBlock``,
``FTNDecoder``, ``RepeatTransformer``, ``FTNDecoderV2``) against lc2is_tpu
on the same parameters (loaded with ``strict=True``) and the same
numpy-seeded inputs, on the CPU.  JAX runs its XLA path
(``attn_impl="xla"``, jitted once), the port its plain versions.  The two
whole models share one swin-base (its params and input): JAX computes its
outputs once in each dtype and the models take them in place of their own
swin call; the port runs each model whole.

Stated tolerances: each decoder module within TOL (2e-4 relative and
absolute), f32; the whole models' f32 score maps within SLICE_ATOL (1e-3),
as the v4 models; their bf16 runs (bf16 swin and decoders, f32 text) in
JAX's output dtype and within BF16_MAX / BF16_MEAN (5e-2 / 1e-2) of max
|ref| of JAX's bf16 run.  The decoder modules run at narrow widths (d_model
32); the models as ``tests/test_zoo.py`` builds them: ``DenseCLIPFTN``
(small prompt cfg) and ``PromptFTNv1`` at 64² on full-width swin-base,
``FTNDecoderV2`` at its fixed 512² grids, batch 1.  ``BaseFTN`` and
``PromptFTNv2`` need 512² input; their heads run on one decoder output, the
backbone and the decoder replaced on both sides (flax ``intercept_methods``)
by that output.  Also: a strict full-width load of ``DenseCLIPFTN``'s
default cfg (the other three load at full width above) and the key rule of
``RepeatTransformer``."""

from concurrent.futures import ThreadPoolExecutor

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import (SLICE_ATOL, close, load_jax_params, numpy_params,
                             small_denseclip_cfg, t)

from lc2is_tpu.models import zoo as jzoo
from lc2is_tpu.nn import decoders as jdec
from lc2is_tpu.nn.swin import SwinModel as JSwinModel
from lc2is_tpu.ops.bpe import tokenize_batch_padded
from lc2is_tpu_torch.core.convert import torch_key
from lc2is_tpu_torch.models import zoo
from lc2is_tpu_torch.nn import decoders

IMG = 64
CLASSES = ("wall", "sky", "tree")
BF16_MAX, BF16_MEAN = 5e-2, 1e-2


def _jit_apply(module, params, *args):
    return jax.jit(lambda p, *a: module.apply(p, *a))(params, *(jnp.asarray(a) for a in args))


@pytest.mark.parametrize("upsample", [1, 2])
def test_ftn_block_matches_jax(upsample):
    rs = np.random.RandomState(1)
    x, mem = rs.randn(2, 64, 32).astype(np.float32), rs.randn(2, 7, 32).astype(np.float32)
    jm = jdec.FTNBlock(d_model=32, nhead=4, upsample=upsample, attn_impl="xla")
    params = numpy_params(jm, jnp.asarray(x), jnp.asarray(mem))
    want = _jit_apply(jm, params, x, mem)
    port = load_jax_params(decoders.FTNBlock(32, 4, upsample=upsample), params)
    with torch.no_grad():
        got = port(t(x), t(mem))
    assert tuple(got.shape) == want.shape == (2, 64 * upsample ** 2, 32)
    close(got, want)


def test_ftn_decoder_matches_jax():
    rs = np.random.RandomState(2)
    in_dims = (16, 32, 64, 128)
    visual = [rs.randn(2, g * g, c).astype(np.float32) for g, c in zip((16, 8, 4, 2), in_dims)]
    text = rs.randn(2, 7, 32).astype(np.float32)
    jm = jdec.FTNDecoder(in_dims=in_dims, dim=32, attn_impl="xla")
    jv = [jnp.asarray(v) for v in visual]
    params = numpy_params(jm, jv, jnp.asarray(text))
    want = jax.jit(jm.apply)(params, jv, jnp.asarray(text))
    port = load_jax_params(decoders.FTNDecoder(in_dims, 32), params)
    with torch.no_grad():
        got = port([t(v) for v in visual], t(text))
    assert tuple(got.shape) == want.shape == (2, 256, 32)
    close(got, want)


@pytest.mark.parametrize("repeat,sr,upsample", [(2, 2, True), (1, 1, False), (3, 2, False)])
def test_repeat_transformer_matches_jax(repeat, sr, upsample):
    x = np.random.RandomState(3).randn(2, 64, 32).astype(np.float32)
    jm = jdec.RepeatTransformer(dim=32, repeat=repeat, sr_ratio=sr, nhead=4, upsample=upsample,
                                attn_impl="xla")
    shapes = jax.eval_shape(lambda v: jm.init(jax.random.PRNGKey(0), v, 8), jnp.asarray(x))
    params = _fill(shapes)
    want = jax.jit(lambda p, v: jm.apply(p, v, 8))(params, jnp.asarray(x))
    port = load_jax_params(decoders.RepeatTransformer(32, repeat, sr, nhead=4, upsample=upsample),
                           params)
    with torch.no_grad():
        got = port(t(x), 8)
    assert tuple(got.shape) == want.shape == (2, 64 * (4 ** repeat if upsample else 1), 32)
    close(got, want)


def _fill(shapes, seed=0, zero=()):
    """``numpy_params``' rule over an already traced shape tree, drawn in f32
    from ``numpy.random.default_rng(seed)`` (twice as fast at full width);
    the top-level sub-trees named in ``zero`` (parameters a test never
    reads) are zeros."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        if str(path[1].key) in zero:
            return np.zeros(s.shape, np.float32)
        v = rng.standard_normal(s.shape, dtype=np.float32)
        if len(s.shape) == 1:
            return np.float32(1.0 if str(path[-1].key) == "weight" else 0.0) + np.float32(0.1) * v
        v *= np.float32(1.0 / np.sqrt(np.prod(s.shape[1:])))
        return v

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _stage_inputs(rs, b=1):
    return [rs.randn(b, g * g, c).astype(np.float32)
            for g, c in zip((128, 64, 32, 16), (128, 256, 512, 1024))]


def test_ftn_decoder_v2_matches_jax():
    """At its fixed grids (512² input), batch 1, as tests/test_zoo.py:94-104;
    the port builds no ``attentions.0`` (flax made no parameters for it)."""
    visual = _stage_inputs(np.random.RandomState(4))
    jm = jdec.FTNDecoderV2(attn_impl="xla")
    jv = [jnp.asarray(v) for v in visual]
    params = numpy_params(jm, jv)
    assert "attentions_0" not in params["params"]
    want = jax.jit(jm.apply)(params, jv)
    port = load_jax_params(decoders.FTNDecoderV2(), params)
    assert sorted(port.attentions) == ["1", "2", "3"]
    with torch.no_grad():
        got = port([t(v) for v in visual])
    assert tuple(got.shape) == want.shape == (1, 128 * 128, 512)
    close(got, want)


def _text_inputs():
    ids, mask = tokenize_batch_padded(["wall, sky", "tree"])
    return np.asarray(ids), np.asarray(mask)


MODELS = {  # name: (JAX kwargs, port kwargs, inputs with text)
    "DenseCLIPFTN": (dict(cfg=small_denseclip_cfg(), class_names=CLASSES),
                     dict(cfg=small_denseclip_cfg(), class_names=CLASSES), False),
    "PromptFTNv1": (dict(), dict(), True),
}


SWIN_NAME = {"DenseCLIPFTN": "vision_encoder", "PromptFTNv1": "visual_encoder"}


def _swin_replaced(stages):
    """Interceptor: the model's swin returns ``stages`` (its first four
    hidden states), computed outside."""

    def intercept(next_fun, args, kwargs, context):
        if context.method_name == "__call__" and isinstance(context.module, JSwinModel):
            return list(stages) + [None]
        return next_fun(*args, **kwargs)

    return intercept


@pytest.fixture(scope="module")
def ftn_runs():
    """name -> (name, params, port inputs, JAX f32 and bf16 outputs) of the
    whole model at 64² on full-width swin-base.  The two models share one
    swin (its params and input): one jitted call computes its first four
    hidden states in both dtypes, and each model's jitted call takes them in
    place of its own swin call (``intercept_methods``); the three are traced
    in turn and compiled together."""
    x = np.random.RandomState(5).randn(1, 3, IMG, IMG).astype(np.float32)
    mods = [JSwinModel(attn_impl="xla", dtype=dt, **jzoo.SWIN_BASE)
            for dt in (jnp.float32, jnp.bfloat16)]
    swin_params = _fill(jax.eval_shape(mods[0].init, jax.random.PRNGKey(0), jnp.asarray(x)))
    swin_args = (swin_params, jnp.asarray(x))
    lowered = {"swin": jax.jit(lambda p, v: [m.apply(p, v)[:4] for m in mods]).lower(*swin_args)}
    cases = {}
    for name, (jkw, _, text) in sorted(MODELS.items()):
        jin = {"pixel_values": jnp.asarray(x)}
        pin = {"pixel_values": t(x)}
        if text:
            ids, mask = _text_inputs()
            jin.update(input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask))
            pin.update(input_ids=torch.from_numpy(ids).long(),
                       attention_mask=torch.from_numpy(mask))
        jcls = getattr(jzoo, name)
        params = _fill(jax.eval_shape(jcls(attn_impl="xla", **jkw).init, jax.random.PRNGKey(0),
                                      jin), zero=(SWIN_NAME[name],))
        params["params"][SWIN_NAME[name]] = swin_params["params"]

        def both(p, inputs, s32, s16, jcls=jcls, jkw=jkw):
            with fnn.intercept_methods(_swin_replaced(s32)):
                out32 = jcls(attn_impl="xla", **jkw).apply(p, inputs)
            with fnn.intercept_methods(_swin_replaced(s16)):
                out16 = jcls(attn_impl="xla", dtype=jnp.bfloat16, **jkw).apply(p, inputs)
            return out32, out16

        lowered[name] = jax.jit(both).lower(params, jin, *lowered["swin"].out_info)
        cases[name] = (params, jin, pin)
    with ThreadPoolExecutor(len(lowered)) as pool:
        compiled = dict(zip(lowered, pool.map(lambda lw: lw.compile(), lowered.values())))
    stages = compiled["swin"](*swin_args)
    return {name: (name, params, pin) + tuple(compiled[name](params, jin, *stages))
            for name, (params, jin, pin) in cases.items()}


@pytest.fixture(params=sorted(MODELS))
def ftn_run(request, ftn_runs):
    return ftn_runs[request.param]


def _port_model(name, params, **kw):
    return load_jax_params(getattr(zoo, name)(device="cpu", **MODELS[name][1], **kw), params)


def test_ftn_model_matches_jax(ftn_run):
    """f32: score map (B, K, 64, 64) within SLICE_ATOL."""
    name, params, pin, (none_j, want), _ = ftn_run
    with torch.no_grad():
        none_p, got = _port_model(name, params)(pin)
    k = len(CLASSES) if name == "DenseCLIPFTN" else 2
    assert none_j is None and none_p is None
    assert tuple(got.shape) == want.shape == (1, k, IMG, IMG)
    close(got, want, rtol=0, atol=SLICE_ATOL)


def test_ftn_model_bf16_matches_jax(ftn_run):
    """bf16 swin and decoders under the f32 text: the score map's dtype is
    JAX's (the promoted f32) and its values within BF16_MAX / BF16_MEAN of
    max |ref| of JAX's bf16 run (each side rounds its own sums to bf16)."""
    name, params, pin, _, (_, want) = ftn_run
    with torch.no_grad():
        _, got = _port_model(name, params, dtype=torch.bfloat16)(pin)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    ref = np.asarray(want.astype(jnp.float32))
    d = np.abs(got.float().numpy() - ref)
    lim = np.abs(ref).max()
    assert d.max() <= BF16_MAX * lim and d.mean() <= BF16_MEAN * lim, (d.max() / lim,
                                                                         d.mean() / lim)


def _replace_trunk(dec_out):
    """Interceptor: the swin returns nothing read and ``FTNDecoderV2``
    returns ``dec_out``, so only the model's own head runs."""

    def intercept(next_fun, args, kwargs, context):
        if context.method_name == "__call__" and isinstance(context.module, JSwinModel):
            return [None] * 5
        if context.method_name == "__call__" and isinstance(context.module, jdec.FTNDecoderV2):
            return dec_out
        return next_fun(*args, **kwargs)

    return intercept


@pytest.mark.parametrize("name", ["BaseFTN", "PromptFTNv2"])
def test_ftn_v2_head_matches_jax(name):
    """The head of a 512² model on one decoder output (B 1, 128², 512):
    ``BaseFTN``'s classifier map ×4, ``PromptFTNv2``'s prompt decoder over
    the map and its score map ×4."""
    rs = np.random.RandomState(6)
    dec_out = rs.randn(1, 128 * 128, 512).astype(np.float32)
    jin = {"pixel_values": jax.ShapeDtypeStruct((1, 3, 512, 512), jnp.float32)}
    pin = {}
    if name == "PromptFTNv2":
        ids, mask = _text_inputs()
        jin.update(input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask))
        pin.update(input_ids=torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask))
    jm = getattr(jzoo, name)(attn_impl="xla")
    params = _fill(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jin),
                   zero=("backbone", "decoder"))
    px = jnp.zeros((1, 3, 512, 512), jnp.float32)

    def head(p, d):
        with fnn.intercept_methods(_replace_trunk(d)):
            return jm.apply(p, dict(jin, pixel_values=px))[1]

    want = jax.jit(head)(params, jnp.asarray(dec_out))
    port = load_jax_params(getattr(zoo, name)(device="cpu"), params)
    port.backbone.forward = lambda *a, **k: [None] * 4
    port.decoder.forward = lambda *a, **k: t(dec_out)
    with torch.no_grad():
        none, got = port(dict(pin, pixel_values=torch.zeros(1, 3, 512, 512)))
    k = 151 if name == "BaseFTN" else 2
    assert none is None and tuple(got.shape) == want.shape == (1, k, 512, 512)
    close(got, want, rtol=0, atol=SLICE_ATOL)


# the other three load at full width in the model and head tests
@pytest.mark.parametrize("key", ["denseclip_ftn"])
def test_full_width_ftn_state_dict(key):
    """swin-base, 151 classes, the default prompt cfg: the JAX tree's keys
    and shapes load into the port with strict=True."""
    text = key in ("prompt_ftn_v1", "prompt_ftn")
    size = 512 if key in ("base_ftn", "prompt_ftn") else 64
    inputs = {"pixel_values": jax.ShapeDtypeStruct((1, 3, size, size), jnp.float32)}
    if text:
        inputs.update(input_ids=jax.ShapeDtypeStruct((2, 77), jnp.int32),
                      attention_mask=jax.ShapeDtypeStruct((2, 77), jnp.int32))
    shapes = jax.eval_shape(jzoo.ZOO[key]().init, jax.random.PRNGKey(0), inputs)["params"]
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    state = {torch_key(tuple(str(p.key) for p in path)): torch.empty(s.shape, device="meta")
             for path, s in flat}
    port = zoo.ZOO[key](device="meta")
    port.load_state_dict(state, strict=True)
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in state.items()}


def test_torch_key_of_repeat_transformer():
    """``trans_<i>_layers_<j>`` holds two indices; ``linear_stage_2`` and
    ``linear2_stage_4`` stay attributes; ``linears2_3`` is a list element."""
    path = ("decoder", "attentions_3", "trans_2_layers_0", "multihead_attn", "in_proj_bias")
    assert torch_key(path) == "decoder.attentions.3.trans.2.layers.0.multihead_attn.in_proj_bias"
    assert torch_key(("decoder", "linears2_3", "weight")) == "decoder.linears2.3.weight"
    assert torch_key(("decoder", "linear_stage_2", "bias")) == "decoder.linear_stage_2.bias"
    assert torch_key(("decoder", "linear2_stage_4", "bias")) == "decoder.linear2_stage_4.bias"
