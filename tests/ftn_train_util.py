"""One training step of each swin-base FTN model in the port
(``engine/engine.py::train_step``: no ``return_score_map``, so the plain CE of
the full-resolution map against labels at its size, AdamW, the frozen text
towers) against lc2is_tpu's step built as ``lc2is_tpu/engine/engine.py:283-303``
builds it (``loss_fn`` with the frozen leaves under ``stop_gradient``,
``_normalize_output``, the criterion, ``jax.value_and_grad`` and the optax
AdamW of ``make_optimizer``), on the same numpy parameters (loaded with
``strict=True``) and batch, batch 1, on the CPU.

Dropout masks cannot match across the two packages, and the JAX modules
hardwire their rates (0.1), so JAX runs ``deterministic=True`` and the port
runs with every ``Dropout`` rate, MHA dropout and swin drop-path rate set to 0
on the built model; the layers keep their own ``dropout`` attribute, so they
take the unfused halves the real step takes (JAX's gate).

How much of each model runs (a full-depth swin-base under ``value_and_grad``
takes JAX ~40 s to compile, so it runs once): ``DenseCLIPFTN`` (small prompt
cfg) whole at 128² (at 64² the stage-4 SR attention has one key, and its q
and k gradients are f32 noise); ``PromptFTNv1`` with its swin returning one
fixed pyramid of a 128² image and its frozen text tower one fixed pooled
output;
``BaseFTN`` and ``PromptFTNv2`` at 512² with the swin and ``FTNDecoderV2``
returning one fixed decoder output (and ``PromptFTNv2``'s text tower one
pooled output), both sides replaced by flax ``intercept_methods`` and by the
port's module forwards, so their heads and prompt decoder train; and
``FTNDecoderV2``'s own gradients at its fixed grids.  Also: ``PromptFTNv1``'s
step with dropout on repeats bit for bit from the same generator seed; a
training forward follows its generator and an eval forward ignores it; labels
of the wrong size raise in both packages.

Stated tolerances: losses rtol 1e-5 and parameters after the step within
1e-2 · lr + 1e-7 wherever |g| >= 1e-3 · max |g|, as
``tests/test_torch_v4_train.py``, and |g| >= 1e-6 as ``chip_smoke.py``'s
card step holds them (Adam's first update lr · g / (|g| + 1e-8) follows the
f32 noise of a smaller g: the swin patch projection's gradient reaches
1e-8 here), the swin key biases not compared; the frozen towers unchanged
bit for bit.  Gradients: the v4 rule (|Δ| <= 1e-3 · |ref| + 1e-3 · max |ref|;
a swin key bias, zero in exact arithmetic, against its query bias) on every
element, but for the gradients a relu unit switching moves.  A unit whose
pre-activation lies within f32 noise of 0 can switch between the two
packages; that moves the one row of ``linear1``'s weight and the one
element of its bias that feed the unit, and the input row of its token, by
a whole term each.  So the ``linear1`` weight and bias of a relu layer and
``FTNDecoderV2``'s input gradients are held to the v4 rule on all but
RELU_FLIP_SHARE of their elements and to RELU_NORM_REL of their norm.
Readings on this CPU, beside those limits: the four models' steps had no
element outside the v4 rule and every gradient within 3.2e-5 of its norm;
in ``FTNDecoderV2`` (six relu layers over up to 4096 tokens) three of the
six relu layers' ``linear1`` had elements out (up to 635 of 1,048,576 weight
elements, 6.1e-4, and 2 of 2048 bias elements, 9.8e-4; norm up to 6.3e-4),
two of its four input gradients up to 3.5e-4 of theirs (185 of 524,288;
norm up to 3.7e-4), and every other gradient none (norm up to 4.0e-4).

The tests live in one file a model (``tests/test_torch_ftn_train_*.py``:
``denseclipftn``, ``promptftnv1``, ``baseftn``, ``promptftnv2`` and
``decoder_v2``), so that the test runner can spread them over its workers;
this module holds what they share, their step tests among it, and each file
compiles its own JAX computations once, in a module fixture
(:func:`step_fixtures`, :func:`compiled_runs`)."""


import copy
from concurrent.futures import ThreadPoolExecutor

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_ftn import _fill
from torch_port_util import load_jax_params, small_denseclip_cfg, t

from lc2is_tpu.engine.engine import _normalize_output as jax_normalize_output
from lc2is_tpu.engine.optim import frozen_mask as jax_frozen_mask
from lc2is_tpu.engine.optim import make_optimizer as jax_make_optimizer
from lc2is_tpu.models import zoo as jzoo
from lc2is_tpu.nn import decoders as jdec
from lc2is_tpu.nn.clip import CLIPTextTransformer as JTextTower
from lc2is_tpu.nn.losses import cross_entropy as jax_cross_entropy
from lc2is_tpu.nn.swin import SwinModel as JSwinModel
from lc2is_tpu.ops.bpe import tokenize_batch_padded
from lc2is_tpu_torch.core.convert import params_to_state_dict, seeded_init_
from lc2is_tpu_torch.engine.engine import train_step
from lc2is_tpu_torch.engine.optim import make_optimizer
from lc2is_tpu_torch.models import zoo
from lc2is_tpu_torch.models.zoo import without_dropout
from lc2is_tpu_torch.nn.layers import TransformerDecoderLayer, TransformerEncoderLayer

LR = 1e-3
CLASSES = ("wall", "sky", "tree")
KEYS = {cls.__name__: key for key, cls in zoo.ZOO.items()}
RELU_FLIP_SHARE, RELU_NORM_REL = 3e-3, 2e-3
MODEL_KW = {"DenseCLIPFTN": dict(cfg=small_denseclip_cfg(), class_names=CLASSES)}
# name: (image size, the JAX modules replaced by fixed outputs); the port
# replaces the same ones
RUNS = {"DenseCLIPFTN": (128, ()),
        "PromptFTNv1": (128, (JSwinModel, JTextTower)),
        "BaseFTN": (512, (JSwinModel, jdec.FTNDecoderV2)),
        "PromptFTNv2": (512, (JSwinModel, jdec.FTNDecoderV2, JTextTower))}
PORT_NAMES = {JSwinModel: ("visual_encoder", "backbone"), jdec.FTNDecoderV2: ("decoder",),
              JTextTower: ("textual_encoder", "text_encoder")}


def _params(jm, *inputs, zero=()):
    """The params tree of flax module ``jm`` filled by ``test_torch_ftn._fill``
    (``numpy_params``' rule from ``numpy.random.default_rng``); the top-level
    sub-trees named in ``zero`` (replaced in the step) are zeros."""
    return _fill(jax.eval_shape(jm.init, jax.random.PRNGKey(0), *inputs), zero=zero)["params"]


def _lower_jax_step(jm, params, inputs, labels, frozen, intercept, outs):
    """The JAX engine's step (``deterministic=True``, flax methods through
    ``intercept(outs)``, the fixed outputs passed as arguments, not folded in
    as constants): ``jax.value_and_grad`` of ``loss_fn`` lowered, and its
    arguments."""
    fmask = jax_frozen_mask(params, frozen)

    def loss_fn(p, inp, lab, o):
        p = jax.tree_util.tree_map(lambda leaf, tr: leaf if tr else jax.lax.stop_gradient(leaf),
                                   p, fmask)
        with fnn.intercept_methods(intercept(o)):
            out = jm.apply({"params": p}, inp, deterministic=True)
        return jax_cross_entropy(jax_normalize_output(out)["outputs"], lab)

    args = (params, inputs, jnp.asarray(labels), outs)
    return jax.jit(jax.value_and_grad(loss_fn)).lower(*args), args


def _finish_jax_step(compiled, args, frozen):
    """(loss, grads, params after one AdamW step) of the compiled step, as
    torch keys; the updated parameters those with a gradient only (AdamW
    updates each leaf alone)."""
    loss, grads = compiled(*args)
    grads = {k: v.numpy() for k, v in params_to_state_dict(grads).items()}
    flat = params_to_state_dict(args[0])
    keys = [k for k, g in grads.items()
            if g.any() and not any(k.startswith(f + ".") for f in frozen)]
    sub_g, sub_p = ({k: jnp.asarray(d[k]) for k in keys} for d in (grads, flat))
    tx = jax_make_optimizer(sub_p, lr=LR)
    new = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(sub_g,
                                                                                      sub_p)
    return loss, grads, {k: np.asarray(v) for k, v in new.items()}


def _port_step(port, pin, labels, frozen, generator=None):
    before = {k: v.clone() for k, v in port.state_dict().items()}
    opt = make_optimizer(port, lr=LR, frozen_prefixes=frozen)
    losses = train_step(port, opt, pin, torch.from_numpy(labels).long(), generator=generator)
    return before, losses


def _text_inputs():
    ids, mask = tokenize_batch_padded(["wall, sky", "tree"])
    return np.asarray(ids), np.asarray(mask)


def _model_inputs(name, seed, img):
    """JAX and port inputs and labels at the map's size (classes: the
    prompts, ``BaseFTN``'s 151 or ``DenseCLIPFTN``'s names)."""
    rs = np.random.RandomState(seed)
    x = rs.randn(1, 3, img, img).astype(np.float32)
    jin, pin = {"pixel_values": jnp.asarray(x)}, {"pixel_values": t(x)}
    k = {"BaseFTN": 151, "DenseCLIPFTN": len(CLASSES)}.get(name)
    if k is None:
        ids, mask = _text_inputs()
        jin.update(input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask))
        pin.update(input_ids=torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask))
        k = len(ids)
    return jin, pin, rs.randint(0, k, size=(1, img, img)).astype(np.int32)


def _port_forward(cls, out):
    """The port's stand-in for a replaced module: the same fixed output."""
    if cls is JSwinModel:
        return lambda *a, **k: [t(v) for v in out]
    if cls is JTextTower:
        return lambda *a, **k: (None, t(out))
    return lambda *a, **k: t(out)


def _lower_model(name):
    """The JAX side of one model's step, lowered: its module, numpy
    parameters, inputs, labels and fixed outputs (the modules of ``RUNS``
    replaced)."""
    img, replaced = RUNS[name]
    frozen = zoo.FROZEN_PREFIXES.get(KEYS[name], ())
    jin, pin, y = _model_inputs(name, 7, img)
    jm = getattr(jzoo, name)(attn_impl="xla", **MODEL_KW.get(name, {}))
    params = _params(jm, jin, zero={n for cls in replaced for n in PORT_NAMES[cls]})
    rs = np.random.RandomState(8)
    outs = {JSwinModel: [rs.randn(1, (img // 4 // 2 ** i) ** 2, 128 * 2 ** i).astype(np.float32)
                         for i in range(4)],
            jdec.FTNDecoderV2: rs.randn(1, (img // 4) ** 2, 512).astype(np.float32),
            JTextTower: rs.randn(2, 512).astype(np.float32)}

    def intercept(o):
        def replace(next_fun, args, kwargs, context):
            cls = type(context.module)
            if context.method_name != "__call__" or cls not in replaced:
                return next_fun(*args, **kwargs)
            if cls is JSwinModel:
                return list(o["swin"]) + [None]
            return (None, o["text"]) if cls is JTextTower else o["decoder"]

        return replace

    jouts = {"swin": [jnp.asarray(v) for v in outs[JSwinModel]],
             "decoder": jnp.asarray(outs[jdec.FTNDecoderV2]),
             "text": jnp.asarray(outs[JTextTower])}
    lowered, args = _lower_jax_step(jm, params, jin, y, frozen, intercept, jouts)
    return lowered, dict(args=args, frozen=frozen, pin=pin, y=y, outs=outs, params=params)


def _lower_decoder_v2():
    """``jax.vjp`` of ``FTNDecoderV2`` at its fixed grids (512² input),
    batch 1, under one cotangent, lowered."""
    rs = np.random.RandomState(9)
    visual = [rs.randn(1, g * g, c).astype(np.float32)
              for g, c in zip((128, 64, 32, 16), (128, 256, 512, 1024))]
    cot = rs.randn(1, 128 * 128, 512).astype(np.float32)
    jm = jdec.FTNDecoderV2(attn_impl="xla")
    jv = [jnp.asarray(v) for v in visual]
    params = {"params": _params(jm, jv)}

    def vjp(p, vs, g):
        _, back = jax.vjp(lambda p_, v_: jm.apply(p_, v_, deterministic=True), p, vs)
        return back(g)

    args = (params, jv, jnp.asarray(cot))
    return jax.jit(vjp).lower(*args), dict(args=args, visual=visual, cot=cot, params=params)


def compiled_runs(names):
    """name -> (the compiled JAX computation, its case) for the models of
    ``RUNS`` named (their steps) and "FTNDecoderV2" (its vjp), traced in
    turn and compiled together on a thread pool (XLA's compile releases the
    GIL)."""
    lowered = {name: _lower_decoder_v2() if name == "FTNDecoderV2" else _lower_model(name)
               for name in names}
    with ThreadPoolExecutor(len(lowered)) as pool:
        compiled = dict(zip(lowered, pool.map(lambda lc: lc[0].compile(), lowered.values())))
    return {name: (compiled[name], case) for name, (_, case) in lowered.items()}


def step_of(name, jax_runs):
    """One JAX step and one port step of a model from the same numpy
    parameters and batch, the modules of ``RUNS`` replaced on both sides."""
    compiled, case = jax_runs.pop(name)
    frozen, outs, replaced = case["frozen"], case["outs"], RUNS[name][1]
    loss, grads, new = _finish_jax_step(compiled, case["args"], frozen)
    port = without_dropout(load_jax_params(
        getattr(zoo, name)(device="cpu", **MODEL_KW.get(name, {})), case["params"]))
    for cls in replaced:
        for attr in PORT_NAMES[cls]:
            if hasattr(port, attr):
                getattr(port, attr).forward = _port_forward(cls, outs[cls])
    before, losses = _port_step(port, case["pin"], case["y"], frozen)
    return dict(name=name, frozen=frozen, port=port, before=before, losses=losses, loss=loss,
                grads=grads, new=new, relu_fed=_relu_fed(port),
                replaced={n for cls in replaced for n in PORT_NAMES[cls]})


def step_fixtures(name):
    """A model file's module fixtures: ``jax_runs`` (the model's JAX step,
    compiled once) and ``step_run`` (:func:`step_of`, parametrized by the
    model's name)."""
    @pytest.fixture(scope="module")
    def jax_runs():
        return compiled_runs([name])

    @pytest.fixture(scope="module", params=[name])
    def step_run(request, jax_runs):
        return step_of(request.param, jax_runs)

    return jax_runs, step_run


def _relu_fed(module):
    """Names of the ``linear1`` weights and biases of ``module``'s relu
    transformer layers: the gradients a relu unit switching moves."""
    return {f"{prefix}.linear1.{leaf}" for prefix, m in module.named_modules()
            if isinstance(m, (TransformerEncoderLayer, TransformerDecoderLayer))
            and m.activation == "relu" for leaf in ("weight", "bias")}


def _grad_close(got, want, name, scale, relu_fed):
    """The v4 rule, |Δ| <= 1e-3 · |ref| + 1e-3 · max |scale| + 1e-10, on
    every element; a gradient a relu unit switching moves (``relu_fed``) on
    all but RELU_FLIP_SHARE of its elements, with ‖Δ‖ <= RELU_NORM_REL ·
    ‖scale‖."""
    atol = 1e-3 * float(np.abs(scale).max()) + 1e-10
    if not relu_fed:
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=atol, err_msg=name)
        return
    out = (np.abs(got - want) > 1e-3 * np.abs(want) + atol).mean()
    rel = float(np.linalg.norm(got - want)) / max(float(np.linalg.norm(scale)), 1e-30)
    assert out <= RELU_FLIP_SHARE and rel <= RELU_NORM_REL, (name, out, rel)


def _frozen(run, name):
    return any(name.startswith(f + ".") for f in run["frozen"])


def test_ftn_loss(step_run):
    assert set(step_run["losses"]) == {"train_loss"}
    np.testing.assert_allclose(step_run["losses"]["train_loss"].item(), float(step_run["loss"]),
                               rtol=1e-5)


def test_ftn_every_trainable_gradient(step_run):
    """Every parameter the step reaches has JAX's gradient; the frozen
    towers, swin stage 4 (never run) and the replaced modules get none in
    the port and zeros in JAX."""
    n = 0
    for name, p in step_run["port"].named_parameters():
        want = step_run["grads"][name]
        if _frozen(step_run, name):
            assert p.grad is None, name
            continue
        if p.grad is None:
            assert (".stages.3.blocks." in name or name.split(".")[0] in step_run["replaced"]
                    ) and not want.any(), name
            continue
        scale = want
        if name.endswith("attention.self.key.bias"):
            # zero in exact arithmetic (softmax is invariant to the q·bk a row's
            # logits share): f32 noise on both sides, held to its partner's scale
            scale = step_run["grads"][name.replace("key.bias", "query.bias")]
        _grad_close(p.grad.numpy(), want, name, scale, name in step_run["relu_fed"])
        n += 1
    port = step_run["port"]
    counts = {"DenseCLIPFTN": 250, "PromptFTNv1": 100, "BaseFTN": 2, "PromptFTNv2": 100}
    assert n >= counts[step_run["name"]], n
    if step_run["name"] == "DenseCLIPFTN":  # the contexts learn through the frozen tower
        assert port.prompt.contexts.grad.abs().sum() > 0
        assert port.vision_encoder.stages[2].blocks[17].attention.self.query.weight.grad.any()
    elif step_run["name"] != "BaseFTN":
        assert port.prompt_decoder.layers[7].norm3.weight.grad.abs().sum() > 0


def test_ftn_params_after_one_adamw_step(step_run):
    port, before, new = step_run["port"], step_run["before"], step_run["new"]
    n = 0
    for name, p in port.named_parameters():
        if _frozen(step_run, name) or p.grad is None:
            assert torch.equal(p.detach(), before[name]), name  # unchanged bit for bit
            continue
        if name.endswith("attention.self.key.bias"):
            continue  # Adam's first update follows the sign of its f32-noise gradient
        g = step_run["grads"][name]
        sure = np.abs(g) >= max(1e-3 * np.abs(g).max(), 1e-6)
        np.testing.assert_allclose(p.detach().numpy()[sure], new[name][sure], rtol=0,
                                   atol=1e-2 * LR + 1e-7, err_msg=name)
        n += 1
    assert n >= 2


@pytest.fixture(scope="module")
def seeded():
    """name -> (a seeded port model, its 64² inputs and labels), each model
    built once."""
    cache = {}

    def get(name):
        if name not in cache:
            _, pin, y = _model_inputs(name, 10, 64)
            model = getattr(zoo, name)(device="cpu", **MODEL_KW.get(name, {}))
            cache[name] = seeded_init_(model, 3), pin, y
        return cache[name]

    return get


def check_forward_follows_its_generator(seeded, name):
    """In training mode (drop path 0.1; ``PromptFTNv1``'s decoders' dropout
    0.1) the same generator seed gives the same map, another seed another;
    in eval mode the generator draws nothing."""
    model, pin, _ = seeded(name)
    model = copy.deepcopy(model)
    with torch.no_grad():
        a, b, c = (model.train()(pin, generator=torch.Generator().manual_seed(s))[1]
                   for s in (1, 1, 2))
        model.eval()
        none_d, d = model(pin)
        none_e, e = model(pin, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, d)
    assert none_d is None and none_e is None and torch.equal(d, e)
