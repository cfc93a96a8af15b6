"""The port's CLIP towers (``nn/clip.py``), bicubic resize, position-table
interpolation, the ``norm_first`` / key-padding decoder layer and the v1
decoder blocks against lc2is_tpu on the same numpy-seeded parameters and
inputs, at a small size (hidden 32, 2 layers, 2 heads, 32² images at patch
16).  f32: rtol = atol = 2e-4 per op and module.  The bf16 dtype-flow case
states its own tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import TOL, close, jax_ref, load_jax_params, numpy_params, t

from lc2is_tpu.nn.clip import CLIPTextTransformer as JText
from lc2is_tpu.nn.clip import CLIPVisionTransformer as JVision
from lc2is_tpu.nn.clip import interpolate_position_embedding as jax_interp
from lc2is_tpu.nn.decoders import DecoderBlock as JDecoderBlock
from lc2is_tpu.nn.decoders import TextToPatch as JTextToPatch
from lc2is_tpu.nn.layers import TransformerDecoderLayer as JDecoderLayer
from lc2is_tpu.ops.resize import resize as jax_resize
from lc2is_tpu_torch.nn import clip, denseclip
from lc2is_tpu_torch.nn.decoders import DecoderBlock, TextToPatch
from lc2is_tpu_torch.nn.layers import TransformerDecoderLayer
from lc2is_tpu_torch.ops.resize import resize

VISION = dict(hidden_size=32, num_layers=2, num_heads=2, mlp_dim=64)


def _port_apply(jmodule, port, *args, **kw):
    """(JAX output, the port's output) of the same numpy-seeded parameters."""
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    jkw = {k: None if v is None else jnp.asarray(v) for k, v in kw.items()}
    params = numpy_params(jmodule, *jargs)  # masks do not shape the parameters
    want = jax.jit(lambda p, *a: jmodule.apply(p, *a, **jkw))(params, *jargs)
    port = load_jax_params(port, params)
    targs = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args]
    tkw = {k: None if v is None else torch.from_numpy(v) for k, v in kw.items()}
    with torch.no_grad():
        return want, port(*targs, **tkw)


def _ids(rs, b, n):
    """Padded ids: SOT 998, tokens, EOT 999, zeros; mask = ids != 0."""
    ids = np.zeros((b, n), np.int64)
    for i in range(b):
        m = rs.randint(1, n - 2)
        ids[i, 0], ids[i, 1:m + 1], ids[i, m + 1] = 998, rs.randint(1, 900, size=m), 999
    return ids, (ids != 0).astype(np.int64)


def test_vision_tower():
    x = np.random.RandomState(0).randn(2, 3, 32, 32).astype(np.float32)
    want, got = _port_apply(JVision(image_size=32, patch_size=16, attn_impl="xla", **VISION),
                            clip.CLIPVisionTransformer(image_size=32, patch_size=16,
                                                       device="cpu", **VISION), x)
    assert tuple(got[0].shape) == (2, 5, 32) and tuple(got[1].shape) == (2, 32)
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("eos", [999, 2])
@pytest.mark.parametrize("with_mask", [True, False])
def test_text_tower(eos, with_mask):
    """Causal + padding masks; pooled at the EOT id (999) or, for the legacy
    eos_token_id = 2, at the argmax of the ids."""
    ids, mask = _ids(np.random.RandomState(1), 3, 11)
    kw = dict(vocab_size=1000, hidden_size=32, num_layers=2, num_heads=2, mlp_dim=64,
              max_positions=16, eos_token_id=eos)
    want, got = _port_apply(JText(attn_impl="xla", **kw), clip.CLIPTextTransformer(
        device="cpu", **kw), ids, mask if with_mask else None)
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("kw", [dict(scale_factor=4), dict(size=(7, 13)), dict(size=3)])
def test_bicubic_resize(kw):
    x = np.random.RandomState(2).randn(2, 3, 6, 9).astype(np.float32)
    close(resize(t(x), method="bicubic", **kw),
          jax_ref(lambda a: jax_resize(a, method="bicubic", **kw), x))


def test_interpolate_position_embedding():
    """A 14 x 14 (+ CLS) table at patch 16 to the 32 x 32 grid of 512²."""
    pos = np.random.RandomState(3).randn(197, 24).astype(np.float32)
    got = clip.interpolate_position_embedding(pos, 16, 512)
    want = jax_interp(pos, 16, 512)
    assert got.shape == want.shape == (1025, 24)
    np.testing.assert_array_equal(got[0], pos[0])
    np.testing.assert_allclose(got, want, **TOL)


def test_quick_gelu_and_embedding_have_one_copy():
    assert denseclip.quick_gelu is clip.quick_gelu and denseclip.Embedding is clip.Embedding


def _decoder_inputs(seed, b=2, p=9, lm=7, c=32, d_kv=24):
    rs = np.random.RandomState(seed)
    mkpm = np.zeros((b, lm), bool)
    mkpm[1, 4:] = True
    return rs.randn(b, p, c).astype(np.float32), rs.randn(b, lm, d_kv).astype(np.float32), mkpm


@pytest.mark.parametrize("norm_first", [True, False])
def test_decoder_layer_with_memory_mask(norm_first):
    """``norm_first`` or a key-padding mask: the unfused halves, with the
    asymmetric d_kv cross-attention (q/k/v_proj_weight)."""
    x, mem, mkpm = _decoder_inputs(4)
    jl = JDecoderLayer(d_model=32, nhead=2, d_kv=24, dim_feedforward=64, dropout=0.0,
                       norm_first=norm_first, attn_impl="xla")
    port = TransformerDecoderLayer(32, 2, d_kv=24, dim_feedforward=64, norm_first=norm_first,
                                   device="cpu")
    want, got = _port_apply(jl, port, x, mem, memory_key_padding_mask=mkpm)
    close(got, want)


def test_norm_first_bf16_promotes_to_f32():
    """A bf16 layer input over f32 memory: JAX promotes the cross-attention to
    f32, so the layer returns f32; the port follows.  Tolerance: bf16 (2^-8
    relative) rounding of the self-attention half, atol = rtol = 2e-2."""
    x, mem, mkpm = _decoder_inputs(5)
    jl = JDecoderLayer(d_model=32, nhead=2, d_kv=24, dim_feedforward=64, dropout=0.0,
                       norm_first=True, attn_impl="xla")
    params = numpy_params(jl, jnp.asarray(x), jnp.asarray(mem))
    want = jax.jit(lambda p, a, m, k: jl.apply(p, a.astype(jnp.bfloat16), m,
                                               memory_key_padding_mask=k))(
        params, jnp.asarray(x), jnp.asarray(mem), jnp.asarray(mkpm))
    port = load_jax_params(TransformerDecoderLayer(32, 2, d_kv=24, dim_feedforward=64,
                                                   norm_first=True, device="cpu"), params)
    with torch.no_grad():
        got = port(t(x).bfloat16(), t(mem), memory_key_padding_mask=torch.from_numpy(mkpm))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    close(got, want, rtol=2e-2, atol=2e-2)


def test_decoder_block_and_text_to_patch():
    x, mem, mkpm = _decoder_inputs(6)
    jb = JDecoderBlock(d_model=32, nhead=2, num_layers=2, d_kv=24, norm_first=True,
                       attn_impl="xla")
    port = DecoderBlock(32, 2, 2, d_kv=24, norm_first=True, device="cpu")
    want, got = _port_apply(jb, port, x, mem, memory_key_padding_mask=mkpm)
    close(got, want)
    want, got = _port_apply(JTextToPatch(out=16), TextToPatch(24, 32, out=16, device="cpu"),
                            x, mem)
    for g, w in zip(got, want):
        close(g, w)
