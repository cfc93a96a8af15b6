"""``lc2is_tpu_torch/engine/checkpoint.py`` and the reference-name maps of
``core/convert.py`` against the JAX package's checkpoint code.

- A reference ``.pt`` written by the JAX package's ``export_reference_pt``,
  read by the port's ``import_reference_pt`` for the port's module, is
  ``convert.params_to_state_dict`` of the same tree, value for value, and
  loads strictly.
- The port's ``export_reference_pt``, read by the JAX package's
  ``import_reference_pt``, gives what the JAX import gives for the JAX
  export of the same tree, bit for bit: the original tree for the flagship.
  (The JAX import moves ``RepeatTransformer``'s own ``sr`` / ``norm`` into an
  ``sr_reduce`` its module does not have, so ``FTNDecoderV2``'s tree does not
  come back from the JAX package's own round trip either.)
- For every parameter of all 13 ``ZOO`` models (full width, built on the
  meta device): ``reference_key`` is the JAX export's name; read back for the
  model it is the port's key again, and read without the model it is the
  JAX import's path.
- The native format: save, load, ``latest_checkpoint``, and the optimizer's
  state (AdamW moments, update count, clip) bit for bit after a round trip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import TINY_SWIN, numpy_params, small_denseclip_cfg

from lc2is_tpu.core.torch_import import params_to_state_dict as jax_export_names
from lc2is_tpu.core.torch_import import state_dict_to_params as jax_import_names
from lc2is_tpu.engine.checkpoint import export_reference_pt as jax_export
from lc2is_tpu.engine.checkpoint import import_reference_pt as jax_import
from lc2is_tpu.models import zoo as jzoo
from lc2is_tpu.nn import decoders as jdec
from lc2is_tpu_torch.core.convert import (flax_path, from_reference_names, params_to_state_dict,
                                          reference_key)
from lc2is_tpu_torch.engine import checkpoint as ckpt
from lc2is_tpu_torch.engine.engine import train_step
from lc2is_tpu_torch.engine.optim import make_optimizer
from lc2is_tpu_torch.models import zoo
from lc2is_tpu_torch.nn import decoders

NAMES7 = tuple(f"c{i}" for i in range(7))


def _cfg():
    cfg = small_denseclip_cfg()
    cfg["text_encoder"]["vocab_size"] = 2000
    return cfg


@pytest.fixture(scope="module", params=["prompt_aux_cross_a", "ftn_decoder_v2"])
def pair(request):
    """(JAX params tree from a numpy seed, the port's module): the flagship
    (``sr_reduce``, ``linear_stage_N``, ``self_``) and the FTN family's
    ``FTNDecoderV2`` (``trans_<i>_layers_<j>``)."""
    if request.param == "prompt_aux_cross_a":
        jm = jzoo.PromptAuxCrossA(class_names=NAMES7, swin_cfg=TINY_SWIN, cfg=_cfg(),
                                  attn_impl="xla")
        params = numpy_params(jm, {"pixel_values": jnp.zeros((1, 3, 64, 64), jnp.float32)})
        port = zoo.PromptAuxCrossA(class_names=NAMES7, swin_cfg=TINY_SWIN, cfg=_cfg(),
                                   device="cpu")
    else:
        jm = jdec.FTNDecoderV2(attn_impl="xla")
        stages = [jnp.zeros((1, g * g, c), jnp.float32)
                  for g, c in zip((128, 64, 32, 16), (128, 256, 512, 1024))]
        params = numpy_params(jm, stages)
        port = decoders.FTNDecoderV2()
    return params["params"], port


def _trees_equal(a, b):
    assert set(a) == set(b), sorted(set(a) ^ set(b))
    for k in a:
        if isinstance(a[k], dict):
            _trees_equal(a[k], b[k])
        else:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def test_jax_pt_into_the_port(pair, tmp_path):
    params, port = pair
    path = str(tmp_path / "jax.pt")
    jax_export(params, path)
    got = ckpt.import_reference_pt(path, port)
    want = params_to_state_dict(params)
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    port.load_state_dict(got, strict=True)


def test_port_pt_into_jax(pair, tmp_path):
    params, port = pair
    port.load_state_dict(params_to_state_dict(params), strict=True)
    path, own = str(tmp_path / "port.pt"), str(tmp_path / "jax.pt")
    ckpt.export_reference_pt(port, path)
    jax_export(params, own)
    got = jax_import(path)
    _trees_equal(got, jax_import(own))
    if "vision_encoder" in params:  # the flagship: the JAX round trip is the identity
        _trees_equal(got, jax.tree_util.tree_map(np.asarray, params))


def _tree_of(keys):
    tree = {}
    for k in keys:
        node, path = tree, flax_path(k)
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        node[path[-1]] = np.zeros(1, np.float32)
    return tree


def _flat_keys(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_keys(v, prefix + (k,))
        else:
            yield prefix + (k,)


@pytest.mark.parametrize("key", sorted(zoo.ZOO))
def test_reference_names_of_every_model(key):
    """Both ways, every parameter of the full-width model: the port's key ->
    the JAX export's name, and that name -> through the JAX import's path
    rule and ``from_reference_names`` -> the port's key again."""
    names = [k for k, _ in zoo.ZOO[key](device="meta").named_parameters()]
    want = jax_export_names(_tree_of(names))  # the JAX package's export names
    assert sorted(reference_key(k) for k in names) == sorted(want)
    back = from_reference_names({reference_key(k): k for k in names}, names)
    assert all(back[k] == k for k in names) and len(back) == len(names)
    jax_read = sorted(_flat_keys(jax_import_names(want)))
    assert sorted(flax_path(k) for k in from_reference_names(want)) == jax_read


def _tiny_step(seed=0):
    model = zoo.BaseCrossA(class_names=NAMES7, swin_cfg=TINY_SWIN, dec_dim=32, nhead=4,
                           return_score_map=True, device="cpu")
    from lc2is_tpu_torch.nn.init import init_parameters_

    init_parameters_(model, torch.Generator().manual_seed(seed))
    opt = make_optimizer(model, lr=1e-3, grad_clip=1.0)
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(2, 3, 64, 64).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 7, size=(2, 64, 64)))
    train_step(model, opt, {"pixel_values": x}, y, generator=torch.Generator().manual_seed(seed))
    return model, opt


def test_native_save_load_latest(tmp_path):
    model, opt = _tiny_step()
    d = str(tmp_path / "checkpoints")
    assert ckpt.latest_checkpoint(d) is None
    state = dict(model=model.state_dict(), optimizer=opt.state_dict(), step=7)
    ckpt.save_checkpoint(d, state, 7, dict(note="x"))
    ckpt.save_checkpoint(d, state, 12)
    (tmp_path / "checkpoints" / "step-30.pt").write_bytes(b"")  # not a native checkpoint
    assert ckpt.latest_checkpoint(d).endswith("step-12.pth")
    got, meta = ckpt.load_checkpoint(d + "/step-7.pth")
    assert meta == dict(step=7, note="x") and got["step"] == 7
    fresh, opt2 = _tiny_step(seed=1)
    fresh.load_state_dict(got["model"], strict=True)
    opt2.load_state_dict(got["optimizer"])
    assert all(torch.equal(a, b) for a, b in zip(fresh.state_dict().values(),
                                                 model.state_dict().values()))
    assert opt2.count == opt.count == 1 and opt2.grad_clip == 1.0
    a, b = opt.adamw.state_dict()["state"], opt2.adamw.state_dict()["state"]
    assert a.keys() == b.keys()
    assert all(torch.equal(a[i][n], b[i][n]) for i in a for n in a[i])
