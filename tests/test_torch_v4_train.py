"""One training step of five v4 models on the CPU against lc2is_tpu's on the
same parameters and batch: ``BaseCrossA`` (the CLI's default model: the fused
upsample-CE main loss only, nothing frozen), ``BaseSelfA`` (the same with the
SelfA decoder), ``PromptSelfA`` and ``PromptCrossA`` (the main loss, the
frozen text tower) and ``PromptAuxSelfA`` (main + 0.4 x aux loss, the SelfA
decoder, the frozen text tower), tiny (TINY_SWIN, 7 classes), drop path off,
labels at the image size (r = 4, as the CLI builds swin-family labels).  JAX:
the engine's loss (``engine.py:283-303``: frozen leaves under
``stop_gradient``, ``upsampled_cross_entropy`` in interpret mode),
``value_and_grad`` and the optax AdamW step of its ``make_optimizer``.

Stated tolerances, those of ``tests/test_torch_train_step.py``: losses rtol
1e-5; every trainable gradient rtol 1e-3, atol 1e-3 · max |ref| + 1e-10
(a swin key bias, whose gradient is zero in exact arithmetic: 1e-3 · max |ref|
of its block's query bias);
after the step, parameters within 1e-2 · lr + 1e-7 wherever
|g| >= 1e-3 · max |g| (the swin key biases not compared: Adam's first update
lr · g / (|g| + eps) follows the sign of their noise); the frozen tower
unchanged bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_port_util import TINY_SWIN, load_jax_params, numpy_params, small_denseclip_cfg, t

from lc2is_tpu.engine.optim import frozen_mask as jax_frozen_mask
from lc2is_tpu.engine.optim import make_optimizer as jax_make_optimizer
from lc2is_tpu.models import zoo as jzoo
from lc2is_tpu.ops.fused_ce import upsampled_cross_entropy as jax_upsampled_ce
from lc2is_tpu_torch.core.convert import params_to_state_dict
from lc2is_tpu_torch.engine.engine import train_step
from lc2is_tpu_torch.engine.optim import make_optimizer
from lc2is_tpu_torch.models import zoo

LR = 1e-3
MODELS = {
    "BaseCrossA": ("base_cross_a", dict(dec_dim=64, nhead=4)),
    "BaseSelfA": ("base_self_a", dict(dec_dim=64, nhead=4)),
    "PromptSelfA": ("prompt_self_a", dict(cfg=small_denseclip_cfg())),
    "PromptCrossA": ("prompt_cross_a", dict(cfg=small_denseclip_cfg())),
    "PromptAuxSelfA": ("prompt_aux_self_a", dict(cfg=small_denseclip_cfg())),
}


@pytest.fixture(scope="module", params=list(MODELS))
def step_run(request):
    name = request.param
    key, extra = MODELS[name]
    frozen = zoo.FROZEN_PREFIXES.get(key, ())
    kw = dict(class_names=tuple(f"c{i}" for i in range(7)),
              swin_cfg=dict(TINY_SWIN, drop_path_rate=0.0), **extra)
    jm = getattr(jzoo, name)(attn_impl="xla", return_score_map=True, **kw)
    rs = np.random.RandomState(12)
    x = rs.randn(2, 3, 64, 64).astype(np.float32)
    y = rs.randint(0, 7, size=(2, 64, 64)).astype(np.int32)
    params = numpy_params(jm, {"pixel_values": jnp.asarray(x)})["params"]
    fmask = jax_frozen_mask(params, frozen)

    def loss_fn(p, px, lab):
        p = jax.tree_util.tree_map(lambda leaf, tr: leaf if tr else jax.lax.stop_gradient(leaf),
                                   p, fmask)
        out = jm.apply({"params": p}, {"pixel_values": px}, deterministic=False,
                       rngs={"dropout": jax.random.PRNGKey(0)})
        losses = {"train_loss": jax_upsampled_ce(out["outputs"], lab, 4, interpret=True)}
        if "low_score_map" in out:
            losses["train_aux_loss"] = jax_upsampled_ce(out["low_score_map"], lab, 16,
                                                        interpret=True) * 0.4
        return sum(losses.values()), losses

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, jnp.asarray(x), jnp.asarray(y))
    tx = jax_make_optimizer(params, lr=LR, frozen_prefixes=frozen)
    updates, _ = tx.update(grads, tx.init(params), params)
    new = optax.apply_updates(params, updates)

    port = load_jax_params(getattr(zoo, name)(return_score_map=True, device="cpu", **kw), params)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    opt = make_optimizer(port, lr=LR, frozen_prefixes=frozen)
    got = train_step(port, opt, {"pixel_values": t(x)}, torch.from_numpy(y).long())
    return dict(name=name, frozen=frozen, port=port, before=before, losses=got, want=losses,
                grads=params_to_state_dict(grads), new=params_to_state_dict(new))


def _frozen(run, name):
    return any(name.startswith(f + ".") for f in run["frozen"])


def test_v4_losses(step_run):
    want = step_run["want"]
    assert set(step_run["losses"]) == set(want) == (
        {"train_loss", "train_aux_loss"} if step_run["name"] == "PromptAuxSelfA"
        else {"train_loss"})
    for key in want:
        np.testing.assert_allclose(step_run["losses"][key].item(), float(want[key]), rtol=1e-5)


def test_v4_every_trainable_gradient(step_run):
    n = 0
    for name, p in step_run["port"].named_parameters():
        want = step_run["grads"][name].numpy()
        if _frozen(step_run, name):
            assert p.grad is None, name  # the frozen tower gets no gradient
            continue
        if name.startswith("vision_encoder.stages.3.blocks."):
            # stage 4's blocks are dead code: no gradient in the port, zeros in JAX
            assert p.grad is None and not want.any(), name
            continue
        scale = want
        if name.endswith("attention.self.key.bias"):
            # zero in exact arithmetic (softmax is invariant to the q·bk a row's
            # logits share): f32 noise on both sides, held to its partner's scale
            scale = step_run["grads"][name.replace("key.bias", "query.bias")].numpy()
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-3,
                                   atol=1e-3 * float(np.abs(scale).max()) + 1e-10, err_msg=name)
        n += 1
    assert n > 60
    if step_run["name"].startswith("Prompt"):  # the contexts learn through the frozen tower
        assert step_run["port"].prompt.contexts.grad.abs().sum() > 0
    else:
        assert not step_run["frozen"] and step_run["port"].classes.weight.grad.abs().sum() > 0


def test_v4_params_after_one_adamw_step(step_run):
    port, before = step_run["port"], step_run["before"]
    for name, p in port.named_parameters():
        if _frozen(step_run, name):
            assert torch.equal(p.detach(), before[name]), name  # unchanged bit for bit
            continue
        if name.endswith("attention.self.key.bias"):
            continue  # Adam's first update follows the sign of its f32-noise gradient
        g = step_run["grads"][name].numpy()
        sure = np.abs(g) >= 1e-3 * np.abs(g).max()
        got, want = p.detach().numpy(), step_run["new"][name].numpy()
        np.testing.assert_allclose(got[sure], want[sure], rtol=0, atol=1e-2 * LR + 1e-7,
                                   err_msg=name)
