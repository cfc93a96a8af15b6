"""The v1 CLIP family of the port (``BaseModelWithText``, ``ContrastiveModel``,
``DenseClip``) against lc2is_tpu on the same parameters and inputs, at a tiny
size, f32: every output of the tuple within the slice tolerance (1e-3); bf16:
the dtype of every module's output as JAX's promotion gives it, and every
output within a bf16 tolerance.

The JAX ``ContrastiveModel`` and ``DenseClip`` build full-width towers; the
tiny twins below only override their ``setup`` with narrow towers (the
``__call__`` is the JAX package's own), as the port's ``vision_kwargs`` /
``text_kwargs`` / ``embed_dim`` / ``decoder_layers`` do.  A full-width
``BaseModelWithText`` is checked for its state-dict keys and shapes only (a
strict load on the meta device, no forward)."""

from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import SLICE_ATOL, close, load_jax_params, numpy_params

from lc2is_tpu.models import zoo as jzoo
from lc2is_tpu.nn.clip import CLIPTextTransformer as JText
from lc2is_tpu.nn.clip import CLIPVisionTransformer as JVision
from lc2is_tpu.nn.decoders import DecoderBlock as JDecoderBlock
from lc2is_tpu.nn.decoders import TextToPatch as JTextToPatch
from lc2is_tpu_torch.core.convert import torch_key
from lc2is_tpu_torch.models import zoo

IMG, PATCH, B = 32, 16, 2
VISION = dict(hidden_size=32, num_layers=2, num_heads=2, mlp_dim=64)


def _text(eos):
    return dict(vocab_size=1000, hidden_size=32, num_layers=2, num_heads=2, mlp_dim=64,
                eos_token_id=eos)


class TinyContrastive(jzoo.ContrastiveModel):
    vision_kwargs: Optional[Dict[str, Any]] = None
    text_kwargs: Optional[Dict[str, Any]] = None
    embed_dim: int = 32

    def setup(self):
        self.vision_encoder = JVision(image_size=self.in_size, patch_size=self.patch_size,
                                      attn_impl=self.attn_impl, dtype=self.dtype,
                                      **self.vision_kwargs)
        self.text_encoder = JText(attn_impl=self.attn_impl, **self.text_kwargs)
        self.pixel_patch = JTextToPatch(out=self.embed_dim)


class TinyDenseClip(jzoo.DenseClip):
    vision_kwargs: Optional[Dict[str, Any]] = None
    text_kwargs: Optional[Dict[str, Any]] = None
    embed_dim: int = 32
    decoder_layers: int = 2
    nhead: int = 2

    def setup(self):
        self.vision_encoder = JVision(image_size=self.in_size, patch_size=self.patch_size,
                                      attn_impl=self.attn_impl, dtype=self.dtype,
                                      **self.vision_kwargs)
        self.text_encoder = JText(attn_impl=self.attn_impl, **self.text_kwargs)
        self.text_patch = JTextToPatch(out=self.embed_dim)
        self.prompt_decoder = JDecoderBlock(d_model=self.embed_dim, nhead=self.nhead,
                                            num_layers=self.decoder_layers, dropout=0.1,
                                            attn_impl=self.attn_impl)
        self.vision_decoder = JDecoderBlock(d_model=self.vision_kwargs["hidden_size"],
                                            d_kv=self.embed_dim, nhead=self.nhead,
                                            num_layers=self.decoder_layers, norm_first=True,
                                            attn_impl=self.attn_impl)


def _inputs(n_text, seed=0):
    """Images and padded text: SOT 998, random tokens, EOT 999, zeros after;
    attention_mask = ids != 0."""
    rs = np.random.RandomState(seed)
    ids = np.zeros((n_text, 12), np.int64)
    for i in range(n_text):
        n = rs.randint(1, 9)
        ids[i, 0], ids[i, 1:n + 1], ids[i, n + 1] = 998, rs.randint(1, 900, size=n), 999
    return dict(pixel_values=rs.randn(B, 3, IMG, IMG).astype(np.float32), input_ids=ids,
                attention_mask=(ids != 0).astype(np.int64))


def _run(jmodel, port, inputs):
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    params = numpy_params(jmodel, jin)
    want = jax.jit(jmodel.apply)(params, jin)
    port = load_jax_params(port, params)
    with torch.no_grad():
        got = port({k: torch.from_numpy(v) for k, v in inputs.items()})
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert tuple(g.shape) == w.shape, (tuple(g.shape), w.shape)
        close(g, w, rtol=SLICE_ATOL, atol=SLICE_ATOL)
    return got


@pytest.mark.parametrize("eos", [999, 2])
def test_base_model_with_text(eos):
    protos = np.random.RandomState(5).randn(151, 32).astype(np.float32)
    kw = dict(in_size=IMG, out_size=4 * IMG // PATCH, patch_size=PATCH, num_layers=2, nhead=2,
              vision_kwargs=VISION, text_kwargs=_text(eos))
    port = zoo.BaseModelWithText(device="cpu", **kw)
    t, v, mm = _run(jzoo.BaseModelWithText(**kw), port, _inputs(B))
    assert tuple(mm.shape) == (B, 151, 8, 8)
    with_table = zoo.BaseModelWithText(device="cpu", prototypes=protos, **kw)
    assert np.array_equal(with_table.class_prototypes.detach().numpy(), protos)


@pytest.mark.parametrize("eos", [999, 2])
def test_contrastive_model(eos):
    kw = dict(in_size=IMG, out_size=4 * IMG // PATCH, patch_size=PATCH,
              vision_kwargs=VISION, text_kwargs=_text(eos))
    t, v, logits = _run(TinyContrastive(**kw), zoo.ContrastiveModel(device="cpu", embed_dim=32,
                                                                     **kw), _inputs(3))
    assert tuple(logits.shape) == (B, 64, 3)


def test_dense_clip():
    kw = dict(in_size=IMG, out_size=4 * IMG // PATCH, patch_size=PATCH,
              vision_kwargs=VISION, text_kwargs=_text(999))
    port = zoo.DenseClip(device="cpu", embed_dim=32, decoder_layers=2, nhead=2, **kw)
    none, score, out = _run(TinyDenseClip(**kw), port, _inputs(5))
    assert none is None and tuple(score.shape) == (B, 5, 2, 2) and tuple(out.shape) == (B, 5, 32)


# bf16, port against JAX bf16, as shares of max |ref|: above the JAX package's
# own bf16-vs-f32 gap on these models (max 7.8e-3, mean 2.8e-3), since each
# side rounds its own accumulations to bf16
BF16_MAX, BF16_MEAN = 3e-2, 6e-3


def _tensor_dtypes(out):
    if isinstance(out, torch.Tensor):
        return [str(out.dtype).replace("torch.", "")]
    if isinstance(out, (tuple, list)):
        return [d for o in out for d in _tensor_dtypes(o)]
    return []


@pytest.mark.parametrize("name", ["BaseModelWithText", "ContrastiveModel", "DenseClip"])
def test_v1_models_bf16_follow_jax(name):
    """dtype=bf16: the ViT in bf16, the text tower in f32, and every module
    after the promotion (the first decoder layer's cross-attention over the
    f32 text, DenseClip's later decoder layers) in the dtype JAX gives it.
    Each port module's output dtypes equal those of the JAX module of the same
    name (flax ``capture_intermediates``); the outputs agree within the bf16
    tolerance."""
    kw = dict(in_size=IMG, out_size=4 * IMG // PATCH, patch_size=PATCH, vision_kwargs=VISION,
              text_kwargs=_text(999))
    jcls, pkw, n = {
        "BaseModelWithText": (jzoo.BaseModelWithText, dict(num_layers=2, nhead=2), B),
        "ContrastiveModel": (TinyContrastive, dict(embed_dim=32), 3),
        "DenseClip": (TinyDenseClip, dict(embed_dim=32, decoder_layers=2, nhead=2), 5)}[name]
    if name == "BaseModelWithText":
        kw.update(pkw)
        pkw = {}
    inputs = _inputs(n)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    params = numpy_params(jcls(**kw), jin)
    want, state = jax.jit(lambda p, x: jcls(dtype=jnp.bfloat16, **kw).apply(
        p, x, capture_intermediates=True, mutable=["intermediates"]))(params, jin)
    jdt = {}
    for path, out in jax.tree_util.tree_flatten_with_path(
            state["intermediates"], is_leaf=lambda x: isinstance(x, tuple))[0]:
        keys = tuple(str(p.key) for p in path)
        jdt[torch_key(keys[:-1])] = [str(a.dtype) for a in jax.tree_util.tree_leaves(out)]
    port = load_jax_params(getattr(zoo, name)(device="cpu", dtype=torch.bfloat16, **pkw, **kw),
                           params)
    pdt = {}
    for key, module in port.named_modules():
        module.register_forward_hook(
            lambda m, a, out, key=key: pdt.setdefault(key, _tensor_dtypes(out)) and None)
    with torch.no_grad():
        got = port({k: torch.from_numpy(v) for k, v in inputs.items()})
    assert set(pdt) <= set(jdt), sorted(set(pdt) - set(jdt))
    assert {k: pdt[k] for k in pdt} == {k: jdt[k] for k in pdt}
    assert {"vision_encoder", "text_encoder"} <= set(pdt)
    assert name == "ContrastiveModel" or any(k.endswith("layers.0.multihead_attn") for k in pdt)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
        ref = np.asarray(w.astype(jnp.float32))
        d = np.abs(g.float().numpy() - ref)
        lim = np.abs(ref).max()
        assert d.max() <= BF16_MAX * lim and d.mean() <= BF16_MEAN * lim, (d.max() / lim,
                                                                          d.mean() / lim)


def _meta_state(jmodel, inputs):
    """The JAX model's parameter tree as meta tensors under the port's keys."""
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), inputs)["params"]
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    return {torch_key(tuple(str(p.key) for p in path)): torch.empty(s.shape, device="meta")
            for path, s in flat}


def test_full_width_base_model_state_dict():
    """ViT-B/16 at 512², the 12-layer text tower, the d_kv = 512 decoder: the
    JAX tree's keys and shapes load into the port with strict=True."""
    inputs = {k: jnp.asarray(v) for k, v in _inputs(1).items()}
    inputs["pixel_values"] = jax.ShapeDtypeStruct((1, 3, 512, 512), jnp.float32)
    state = _meta_state(jzoo.BaseModelWithText(in_size=512, out_size=128), inputs)
    port = zoo.BaseModelWithText(in_size=512, out_size=128, device="meta")
    port.load_state_dict(state, strict=True)
    shapes = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert shapes == {k: tuple(v.shape) for k, v in state.items()}
    for key, shape in [("vision_encoder.embeddings.class_embedding", (768,)),
                       ("vision_encoder.embeddings.position_embedding", (1025, 768)),
                       ("vision_encoder.embeddings.patch_embedding", (768, 3, 16, 16)),
                       ("vision_encoder.pre_layrnorm.weight", (768,)),
                       ("vision_encoder.encoder_layers.11.mlp.fc2.weight", (768, 3072)),
                       ("text_encoder.encoder_layers.11.self_attn.q_proj.weight", (512, 512)),
                       ("vision_decoder.layers.0.multihead_attn.q_proj_weight", (768, 768)),
                       ("vision_decoder.layers.0.multihead_attn.k_proj_weight", (768, 512)),
                       ("vision_decoder.layers.0.multihead_attn.v_proj_weight", (768, 512)),
                       ("class_prototypes", (151, 512))]:
        assert shapes[key] == shape, key


def test_v1_models_default_to_the_card():
    """Built without ``device``, a v1 model lives on the card; here, with no
    card, that raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py checks the default there")
    for cls in (zoo.BaseModelWithText, zoo.ContrastiveModel, zoo.DenseClip):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(in_size=IMG, out_size=8, vision_kwargs=VISION, text_kwargs=_text(999))
