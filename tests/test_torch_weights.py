"""``lc2is_tpu_torch/models/weights.py`` (the HF importers) against
``lc2is_tpu/models/weights.py`` on random-init ``transformers`` models built
from configs as ``tests/test_encoders.py:29,109`` builds them (nothing is
downloaded):

- each loader's state_dict equal bit for bit to
  ``core/convert.params_to_state_dict`` of the JAX loader's tree, from the
  HF torch tensors and from numpy arrays alike (the swin loader without
  HF's final ``layernorm``, which JAX's loader keeps and no module of
  either package holds: ``models/weights.py``'s docstring);
- a ``strict=True`` load into the port's CLIP vision and text towers, its
  ``SwinModel`` and ``BaseModelWithText``;
- the towers' hidden states against HF's within ``test_encoders.py``'s
  tolerances (CLIP 2e-5, swin 5e-5);
- the CLIP table resized to ``in_size`` 512: against JAX's bicubic within
  1e-6 of its max (the two resizes sum their taps in their own orders), the
  tower built at 512² loading it strict and running.
"""

import numpy as np
import pytest
import torch
import transformers
from torch_port_util import t

from lc2is_tpu.models import weights as JW
from lc2is_tpu_torch.core.convert import params_to_state_dict, reference_key
from lc2is_tpu_torch.models import weights as PW
from lc2is_tpu_torch.models import zoo
from lc2is_tpu_torch.nn.clip import CLIPTextTransformer, CLIPVisionTransformer
from lc2is_tpu_torch.nn.swin import SwinModel

VISION = dict(hidden_size=64, num_layers=3, num_heads=4, mlp_dim=128)
TEXT = dict(vocab_size=1000, hidden_size=48, num_layers=3, num_heads=4, mlp_dim=96,
            eos_token_id=999)


@pytest.fixture(scope="module")
def hf_clip_vision():
    cfg = transformers.CLIPVisionConfig(hidden_size=64, intermediate_size=128,
                                        num_hidden_layers=3, num_attention_heads=4,
                                        image_size=64, patch_size=16)
    torch.manual_seed(0)
    return transformers.CLIPVisionModel(cfg).eval()


@pytest.fixture(scope="module")
def hf_clip_text():
    cfg = transformers.CLIPTextConfig(hidden_size=48, intermediate_size=96, num_hidden_layers=3,
                                      num_attention_heads=4, max_position_embeddings=77,
                                      vocab_size=1000, eos_token_id=999, bos_token_id=998)
    torch.manual_seed(1)
    return transformers.CLIPTextModel(cfg).eval()


def _hf_swin():
    """Function-scoped, as in ``test_encoders.py``: HF's swin changes its
    shift when a forward sees a small grid."""
    cfg = transformers.SwinConfig(image_size=64, patch_size=4, embed_dim=24, depths=[2, 2, 2],
                                  num_heads=[2, 4, 8], window_size=4, drop_path_rate=0.0)
    torch.manual_seed(2)
    return transformers.SwinModel(cfg).eval()


def _numpy(sd):
    return {k: v.detach().numpy() for k, v in sd.items()}


def _same(got, want):
    assert got.keys() == want.keys(), sorted(set(got) ^ set(want))
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


@pytest.mark.parametrize("source", ["torch", "numpy"])
def test_loaders_equal_the_jax_loaders(hf_clip_vision, hf_clip_text, source):
    sds = {"vision": hf_clip_vision.state_dict(), "text": hf_clip_text.state_dict(),
           "swin": _hf_swin().state_dict()}
    if source == "numpy":
        sds = {k: _numpy(v) for k, v in sds.items()}
    pairs = [(PW.load_clip_vision_params, JW.load_clip_vision_params, "vision", {}),
             (PW.load_clip_text_params, JW.load_clip_text_params, "text", {}),
             (PW.load_swin_params, JW.load_swin_params, "swin", {})]
    for port, jax_fn, key, kw in pairs:
        want = params_to_state_dict(jax_fn(_numpy(sds[key]) if source == "torch" else sds[key],
                                           **kw))
        if key == "swin":
            assert {"layernorm.weight", "layernorm.bias"} <= set(want)
            want = {k: v for k, v in want.items() if not k.startswith("layernorm.")}
        _same(port(sds[key], **kw), want)


def test_clip_towers_load_strict_and_match_hf(hf_clip_vision, hf_clip_text):
    rs = np.random.RandomState(0)
    x = rs.randn(2, 3, 64, 64).astype(np.float32)
    vision = CLIPVisionTransformer(image_size=64, patch_size=16, device="cpu", **VISION)
    vision.load_state_dict(PW.load_clip_vision_params(hf_clip_vision.state_dict(), in_size=64),
                           strict=True)
    with torch.no_grad():
        ref = hf_clip_vision(pixel_values=t(x)).last_hidden_state
        out = vision(t(x))[0]
    assert (out - ref).abs().max().item() < 2e-5

    ids = rs.randint(1, 900, size=(2, 12)).astype(np.int64)
    ids[:, -3:] = 0
    ids[0, 9], ids[1, 7] = 999, 999  # HF pools at the first eos_token_id
    mask = (ids != 0).astype(np.int64)
    text = CLIPTextTransformer(device="cpu", **TEXT)
    text.load_state_dict(PW.load_clip_text_params(hf_clip_text.state_dict()), strict=True)
    with torch.no_grad():
        ref = hf_clip_text(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask))
        out, pooled = text(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask))
    assert (out - ref.last_hidden_state).abs().max().item() < 2e-5
    assert (pooled - ref.pooler_output).abs().max().item() < 2e-5


def test_swin_loads_strict_and_matches_hf():
    hf = _hf_swin()
    x = np.random.RandomState(1).randn(2, 3, 64, 64).astype(np.float32)
    port = SwinModel(embed_dim=24, depths=(2, 2, 2), num_heads=(2, 4, 8), window=4,
                     patch_size=4, drop_path_rate=0.0, device="cpu")
    port.load_state_dict(PW.load_swin_params(hf.state_dict()), strict=True)
    with torch.no_grad():
        ref = hf(pixel_values=t(x), output_hidden_states=True).hidden_states
        hs = port(t(x))
    assert len(hs) == len(ref)
    for i, (mine, theirs) in enumerate(zip(hs, ref)):
        assert (mine - theirs).abs().max().item() < 5e-5, i


def test_base_model_with_text_checkpoint(hf_clip_vision, hf_clip_text):
    """A reference ``BaseModelWithText`` checkpoint (the HF towers under
    ``vision_encoder.enc.`` / ``text_encoder.enc.``, the rest under the
    reference names): equal to the JAX import, strict into the port's
    model."""
    model = zoo.BaseModelWithText(in_size=64, out_size=16, vision_kwargs=VISION,
                                  text_kwargs=TEXT, device="cpu")
    torch.manual_seed(3)
    rest = {reference_key(k): torch.randn_like(v) for k, v in model.state_dict().items()
            if not k.startswith(("vision_encoder.", "text_encoder."))}
    ckpt = {**{f"vision_encoder.enc.{k}": v for k, v in hf_clip_vision.state_dict().items()},
            **{f"text_encoder.enc.{k}": v for k, v in hf_clip_text.state_dict().items()},
            **rest}
    got = PW.load_base_model_with_text_params(ckpt, in_size=64)
    _same(got, params_to_state_dict(JW.load_base_model_with_text_params(_numpy(ckpt),
                                                                        in_size=64)))
    model.load_state_dict(got, strict=True)


def test_position_table_resized_to_512(hf_clip_vision):
    got = PW.load_clip_vision_params(hf_clip_vision.state_dict(), in_size=512, patch_size=16)
    want = params_to_state_dict(JW.load_clip_vision_params(
        _numpy(hf_clip_vision.state_dict()), in_size=512, patch_size=16))
    assert got.keys() == want.keys()
    key = "embeddings.position_embedding"
    assert got[key].shape == (32 * 32 + 1, 64)
    for k, v in want.items():
        if k != key:
            assert torch.equal(got[k], v), k
    lim = want[key].abs().max().item()
    assert torch.equal(got[key][0], want[key][0])  # the CLS row as it was
    assert (got[key] - want[key]).abs().max().item() <= 1e-6 * lim
    vision = CLIPVisionTransformer(image_size=512, patch_size=16, device="cpu", **VISION)
    vision.load_state_dict(got, strict=True)
    with torch.no_grad():
        out = vision(torch.zeros(1, 3, 512, 512))[0]
    assert out.shape == (1, 32 * 32 + 1, 64) and torch.isfinite(out).all()
