"""JAX params tree -> the port's state_dict: every parameter covered under
strict=True, including the traps of lc2is_tpu/core/torch_import.py
(linear2_stage_N is not a list, sr_reduce stays nested, self_ -> self,
the texts buffer is not a parameter)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import TINY_SWIN, load_jax_params, numpy_params, small_denseclip_cfg

from lc2is_tpu.models import zoo as jzoo
from lc2is_tpu_torch.core.convert import params_to_state_dict, seeded_init_, torch_key
from lc2is_tpu_torch.models import zoo
from lc2is_tpu_torch.nn.swin import SwinModel

CFG = small_denseclip_cfg()
KW = dict(cfg=CFG, class_names=("wall", "sky", "tree"), swin_cfg=TINY_SWIN)


@pytest.fixture(scope="module")
def jax_params():
    model = jzoo.PromptAuxCrossA(attn_impl="xla", **KW)
    x = jnp.zeros((1, 3, 64, 64), jnp.float32)
    return numpy_params(model, {"pixel_values": x})


def test_every_parameter_loads_strict(jax_params):
    sd = params_to_state_dict(jax_params)
    port = zoo.PromptAuxCrossA(device="cpu", **KW)
    assert set(sd) == set(port.state_dict())
    load_jax_params(port, jax_params)
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(jax_params))
    assert n_jax == sum(p.numel() for p in port.parameters())


@pytest.mark.parametrize("key", [
    "vision_decoder.linear2_stage_1.weight",
    "vision_decoder.linear2_stage_4.bias",
    "vision_decoder.attention_stage_4.2.layers.0.sr_reduce.sr.weight",
    "vision_decoder.attention_stage_2.0.layers.0.sr_reduce.norm.bias",
    "vision_encoder.stages.3.blocks.0.attention.self.relative_position_bias_table",
    "prompt.text_encoder.resblocks.0.attn.in_proj_weight",
    "prompt.context_decoder.decoder.0.cross_attn.q.weight",
])
def test_trap_keys_present(jax_params, key):
    assert key in params_to_state_dict(jax_params)


def test_texts_buffer_is_rebuilt_not_loaded(jax_params):
    port = zoo.PromptAuxCrossA(device="cpu", **KW)
    assert "prompt.texts" not in params_to_state_dict(jax_params)
    assert "prompt.texts" not in port.state_dict()
    assert tuple(port.prompt.texts.shape) == (3, CFG["context_length"])


@pytest.mark.parametrize("path,key", [
    (("stages_0", "blocks_1", "attention", "self_", "query", "weight"),
     "stages.0.blocks.1.attention.self.query.weight"),
    (("linear2_stage_3", "bias"), "linear2_stage_3.bias"),
    (("attention_stage_3_1", "layers_0", "sr_reduce", "sr", "weight"),
     "attention_stage_3.1.layers.0.sr_reduce.sr.weight"),
    (("decoder_2", "fc1", "weight"), "decoder.2.fc1.weight"),
])
def test_torch_key(path, key):
    assert torch_key(path) == key


def test_seeded_init_is_deterministic_and_complete():
    a, b, c = (seeded_init_(SwinModel(**TINY_SWIN), seed=s) for s in (3, 3, 4))
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(), c.parameters()):
        assert torch.isfinite(pa).all(), name
        assert torch.equal(pa, pb), name
    assert not all(torch.equal(pa, pc) for pa, pc in zip(a.parameters(), c.parameters()))
    norm_w = a.embed_norm.weight
    assert abs(float(norm_w.detach().mean()) - 1.0) < 0.1  # LayerNorm gains around 1
