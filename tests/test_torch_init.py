"""``lc2is_tpu_torch/nn/init.py::init_parameters_`` against the JAX modules'
own initialisers (``model.init``): tiny models of the v4 family
(``PromptAuxCrossA``: swin, SR decoders, prompt tower; the Base models'
class-weight table), the v1 family (``BaseModelWithText``: the CLIP towers,
the class prototypes) and the FTN family (``FTNDecoder``).  The random
streams of the two packages differ, so the laws are compared, not the values.

Stated rule, for every parameter (port key = ``core/convert.torch_key`` of
the flax path): a constant of JAX's (zeros, ones, 1e-4) is the port's value
exactly; with 1000 elements or more, the port's std within 10 % of JAX's and
its mean within five standard errors of the difference of two sample means
(5 · std · sqrt(2 / n)) of JAX's mean, and, where the law is bounded
(uniform, truncated normal: max |p| / std < 2.5 in JAX's draw), max |p| within
5 % of JAX's (a normal's sample maximum moves by more than that between two
draws, so it is not compared).  A control that draws every Linear weight
xavier-uniform must fail the rule.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import TINY_SWIN, small_denseclip_cfg

from lc2is_tpu.models import zoo as jzoo
from lc2is_tpu.nn import decoders as jdec
from lc2is_tpu_torch.core.convert import torch_key
from lc2is_tpu_torch.models import zoo
from lc2is_tpu_torch.nn import decoders, init

NAMES7 = tuple(f"c{i}" for i in range(7))
IN_DIMS = (16, 32, 64, 128)
V1 = dict(in_size=32, out_size=8,
          vision_kwargs=dict(hidden_size=32, num_layers=2, num_heads=2, mlp_dim=64),
          text_kwargs=dict(vocab_size=1000, hidden_size=32, num_layers=2, num_heads=2,
                           mlp_dim=64, eos_token_id=999))


def _cfg():
    cfg = small_denseclip_cfg()
    cfg["text_encoder"]["vocab_size"] = 2000
    return cfg


def _px(n):
    return {"pixel_values": jnp.zeros((1, 3, n, n), jnp.float32)}


# name: (JAX module, its init inputs, the port's module)
CASES = {
    "v4_prompt_aux_cross_a": (
        lambda: jzoo.PromptAuxCrossA(class_names=NAMES7, swin_cfg=TINY_SWIN, cfg=_cfg(),
                                     attn_impl="xla"),
        lambda: (_px(64),),
        lambda: zoo.PromptAuxCrossA(class_names=NAMES7, swin_cfg=TINY_SWIN, cfg=_cfg(),
                                    device="cpu")),
    "v4_class_table": (
        lambda: jzoo.ClassWeightTable(num_classes=151, dim=64),
        lambda: (2, jnp.float32),
        lambda: zoo.ClassWeightTable(151, 64)),
    "v1_base_with_text": (
        lambda: jzoo.BaseModelWithText(attn_impl="xla", **V1),
        lambda: ({"pixel_values": jnp.zeros((1, 3, 32, 32), jnp.float32),
                  "input_ids": jnp.zeros((1, 5), jnp.int32),
                  "attention_mask": jnp.ones((1, 5), jnp.int32)},),
        lambda: zoo.BaseModelWithText(device="cpu", **V1)),
    "ftn_decoder": (
        lambda: jdec.FTNDecoder(in_dims=IN_DIMS, dim=32, attn_impl="xla"),
        lambda: ([jnp.zeros((1, g * g, c), jnp.float32) for g, c in zip((16, 8, 4, 2), IN_DIMS)],
                 jnp.zeros((1, 7, 32), jnp.float32)),
        lambda: decoders.FTNDecoder(IN_DIMS, 32)),
}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield torch_key(prefix + (k,)), np.asarray(v, np.float64)


@pytest.fixture(scope="module")
def jax_inits():
    """{case: {port key: JAX's initial value}}, the inits compiled together
    (with XLA's own bit generator, which compiles faster than threefry: only
    the laws are compared)."""
    def run(name):
        jm, args, _ = CASES[name]
        module = jm()
        variables = jax.jit(lambda key: module.init(key, *args()))(
            jax.random.key(0, impl="unsafe_rbg"))
        return name, dict(_flat(variables["params"]))

    with ThreadPoolExecutor(len(CASES)) as pool:
        return dict(pool.map(run, CASES))


def law_mismatches(port: dict, ref: dict) -> list:
    """The parameters whose port value breaks the stated rule."""
    bad = []
    for key, want in ref.items():
        got = port[key]
        if np.all(want == want.flat[0]):
            if not np.array_equal(got, want):
                bad.append((key, "constant", float(want.flat[0]), float(got.flat[0])))
            continue
        if want.size < 1000:
            continue
        sw, sg = want.std(), got.std()
        mean_bound = 5 * sw * np.sqrt(2 / want.size)
        if abs(sg - sw) > 0.1 * sw or abs(got.mean() - want.mean()) > mean_bound:
            bad.append((key, "std/mean", sw, sg))
        elif np.abs(want).max() / sw < 2.5 \
                and abs(np.abs(got).max() - np.abs(want).max()) > 0.05 * np.abs(want).max():
            bad.append((key, "max", np.abs(want).max(), np.abs(got).max()))
    return bad


def _port_init(name, seed=0):
    model = CASES[name][2]()
    init.init_parameters_(model, torch.Generator().manual_seed(seed))
    return {k: v.detach().double().numpy() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("name", list(CASES))
def test_init_laws_match_jax(jax_inits, name):
    ref = jax_inits[name]
    port = _port_init(name)
    assert set(port) == set(ref)
    large = sum(v.size >= 1000 for v in ref.values())
    assert large >= (1 if name == "v4_class_table" else 5)
    assert law_mismatches(port, ref) == []


def test_wrong_initialiser_fails(jax_inits, monkeypatch):
    """The control: every Linear weight drawn xavier-uniform."""
    monkeypatch.setattr(init, "torch_linear_weight", init.xavier_uniform)
    bad = law_mismatches(_port_init("v4_prompt_aux_cross_a"), jax_inits["v4_prompt_aux_cross_a"])
    assert any(k.endswith("linear1.weight") for k, *_ in bad), bad


def test_init_is_seeded_and_keeps_given_prototypes():
    a, b = _port_init("ftn_decoder", 3), _port_init("ftn_decoder", 3)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    protos = np.random.RandomState(0).randn(151, 32).astype(np.float32)
    model = zoo.BaseModelWithText(device="cpu", prototypes=protos, **V1)
    init.init_parameters_(model, torch.Generator().manual_seed(0))
    assert np.array_equal(model.class_prototypes.detach().numpy(), protos)
