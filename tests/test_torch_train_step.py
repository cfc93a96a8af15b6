"""The port's training step on the CPU against lc2is_tpu's on the same
parameters and batch: a tiny PromptAuxCrossA (TINY_SWIN, the small prompt
cfg) with drop path off, main CE + 0.4 x aux CE through the fused upsample-CE
(JAX: ``upsampled_cross_entropy`` in interpret mode), frozen text tower,
AdamW.  Also the optimizer pieces against optax, and the drop path's
explicit generator.

Stated tolerances (f32): losses rtol 1e-5; every trainable gradient rtol
1e-3, atol 1e-3 · max |ref| + 1e-10 (a few stage-4 gradients are f32 noise
around 1e-13 in both; the slice's forward agrees to SLICE_ATOL = 1e-3
on the score maps, and the two frameworks order their sums differently
through 10 modules); AdamW on the same gradients rtol 1e-5, atol 1e-9 (one
update of at most lr); after the whole step, parameters within
1e-2 · lr + 1e-7 wherever |g| >= 1e-3 · max |g| (Adam's first update is
lr · g / (|g| + eps): where g is near 0 its sign is f32 noise)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_port_util import TINY_SWIN, load_jax_params, numpy_params, small_denseclip_cfg, t

from lc2is_tpu.engine.optim import frozen_mask as jax_frozen_mask
from lc2is_tpu.engine.optim import make_optimizer as jax_make_optimizer
from lc2is_tpu.engine.optim import make_schedule as jax_make_schedule
from lc2is_tpu.models import zoo as jzoo
from lc2is_tpu.ops.fused_ce import upsampled_cross_entropy as jax_upsampled_ce
from lc2is_tpu_torch.core.convert import params_to_state_dict
from lc2is_tpu_torch.engine.engine import train_step
from lc2is_tpu_torch.engine.optim import frozen_mask, make_optimizer, make_schedule
from lc2is_tpu_torch.models import zoo
from lc2is_tpu_torch.nn.swin import SwinModel, drop_path

LR = 1e-3
FROZEN = zoo.FROZEN_PREFIXES["prompt_aux_cross_a"]
KW = dict(cfg=small_denseclip_cfg(), class_names=tuple(f"c{i}" for i in range(7)),
          swin_cfg=dict(TINY_SWIN, drop_path_rate=0.0))


@pytest.fixture(scope="module")
def step_run():
    """One JAX step (losses, grads, AdamW-updated params) and one port step
    from the same numpy parameters and batch."""
    jm = jzoo.PromptAuxCrossA(attn_impl="xla", return_score_map=True, **KW)
    rs = np.random.RandomState(11)
    x = rs.randn(2, 3, 64, 64).astype(np.float32)
    y = rs.randint(0, 7, size=(2, 64, 64)).astype(np.int32)
    params = numpy_params(jm, {"pixel_values": jnp.asarray(x)})["params"]
    fmask = jax_frozen_mask(params, FROZEN)

    def loss_fn(p, px, lab):
        p = jax.tree_util.tree_map(lambda leaf, tr: leaf if tr else jax.lax.stop_gradient(leaf),
                                   p, fmask)
        out = jm.apply({"params": p}, {"pixel_values": px}, deterministic=False,
                       rngs={"dropout": jax.random.PRNGKey(0)})
        main = jax_upsampled_ce(out["outputs"], lab, 4, interpret=True)
        aux = jax_upsampled_ce(out["low_score_map"], lab, 16, interpret=True) * 0.4
        return main + aux, (main, aux)

    (_, (main, aux)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, jnp.asarray(x), jnp.asarray(y))
    tx = jax_make_optimizer(params, lr=LR, frozen_prefixes=FROZEN)
    updates, _ = tx.update(grads, tx.init(params), params)
    new = optax.apply_updates(params, updates)

    port = load_jax_params(zoo.PromptAuxCrossA(return_score_map=True, **KW), params)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    opt = make_optimizer(port, lr=LR, frozen_prefixes=FROZEN)
    losses = train_step(port, opt, {"pixel_values": t(x)}, torch.from_numpy(y).long())
    return dict(port=port, before=before, losses=losses, main=main, aux=aux,
                grads=params_to_state_dict(grads), new=params_to_state_dict(new))


def test_losses(step_run):
    np.testing.assert_allclose(step_run["losses"]["train_loss"].item(), float(step_run["main"]),
                               rtol=1e-5)
    np.testing.assert_allclose(step_run["losses"]["train_aux_loss"].item(),
                               float(step_run["aux"]), rtol=1e-5)


def test_every_trainable_gradient(step_run):
    n = 0
    for name, p in step_run["port"].named_parameters():
        if name.startswith(FROZEN[0] + "."):
            assert p.grad is None, name  # the frozen tower gets no gradient
            continue
        want = step_run["grads"][name].numpy()
        if name.startswith("vision_encoder.stages.3.blocks."):
            # the model reads hidden_states[:4]: the last stage's blocks are
            # dead code, with no gradient in the port and zeros in JAX
            assert p.grad is None and not want.any(), name
            continue
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-3,
                                   atol=1e-3 * float(np.abs(want).max()) + 1e-10, err_msg=name)
        n += 1
    assert n > 100
    assert step_run["port"].prompt.contexts.grad.abs().sum() > 0  # learns through the tower


def test_params_after_one_adamw_step(step_run):
    port, before = step_run["port"], step_run["before"]
    for name, p in port.named_parameters():
        if name.startswith(FROZEN[0] + "."):
            assert torch.equal(p.detach(), before[name]), name  # unchanged bit for bit
            continue
        g = step_run["grads"][name].numpy()
        sure = np.abs(g) >= 1e-3 * np.abs(g).max()
        got, want = p.detach().numpy(), step_run["new"][name].numpy()
        if np.abs(g).max() > 1e-6:  # below that, lr · g / (|g| + eps) is under f32 resolution
            assert not np.array_equal(got, before[name].numpy()), name
        np.testing.assert_allclose(got[sure], want[sure], rtol=0, atol=1e-2 * LR + 1e-7,
                                   err_msg=name)


@pytest.mark.parametrize("wd,clip", [(0.0, None), (0.05, 0.5)])
def test_adamw_matches_optax(wd, clip):
    """Two AdamW steps on the same gradients, weight decay and global-norm
    clip included, against optax through lc2is_tpu's make_optimizer."""
    rs = np.random.RandomState(3)
    w0 = {"a": rs.randn(5, 4).astype(np.float32), "b": rs.randn(3).astype(np.float32)}
    grads = [{k: (0.3 * rs.randn(*v.shape)).astype(np.float32) for k, v in w0.items()}
             for _ in range(2)]
    tx = jax_make_optimizer(w0, lr=LR, weight_decay=wd, grad_clip=clip, schedule="cosine",
                            total_steps=4, warmup=1)
    state, jp = tx.init(w0), {k: jnp.asarray(v) for k, v in w0.items()}
    module = torch.nn.Module()
    for k, v in w0.items():
        module.register_parameter(k, torch.nn.Parameter(t(v)))
    opt = make_optimizer(module, lr=LR, weight_decay=wd, grad_clip=clip, schedule="cosine",
                         total_steps=4, warmup=1)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.zero_grad()
        for k, v in g.items():
            getattr(module, k).grad = t(v)
        opt.step()
    for k in w0:
        np.testing.assert_allclose(getattr(module, k).detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("kind,total,warmup", [("constant", 10, 0), ("cosine", 10, 3),
                                               ("cosine", 10, 0), ("linear", 10, 4)])
def test_schedules_match_optax(kind, total, warmup):
    ours, ref = make_schedule(kind, 2e-3, total, warmup), jax_make_schedule(kind, 2e-3, total,
                                                                            warmup)
    for count in range(total + 3):
        np.testing.assert_allclose(ours(count), float(ref(count)), rtol=1e-6, atol=1e-12)


def test_frozen_mask_matches_jax():
    jm = jzoo.PromptAuxCrossA(attn_impl="xla", **KW)
    params = numpy_params(jm, {"pixel_values": jnp.zeros((1, 3, 64, 64))})["params"]
    want = params_to_state_dict(jax.tree_util.tree_map(
        lambda tr: np.float32(tr), jax_frozen_mask(params, FROZEN)))
    got = frozen_mask(zoo.PromptAuxCrossA(**KW), FROZEN)
    assert set(got) == set(want)
    assert all(got[k] == bool(want[k]) for k in got)
    assert not all(got.values()) and any(got.values())


def test_drop_path_generator():
    """Masks come from the explicit generator: reproducible, per sample,
    and a kept sample is scaled by 1 / keep."""
    x = torch.randn(64, 5, 3)
    a = drop_path(x, 0.25, torch.Generator().manual_seed(4))
    b = drop_path(x, 0.25, torch.Generator().manual_seed(4))
    c = drop_path(x, 0.25, torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = (a != 0).flatten(1).any(1)
    assert torch.equal(a[kept], x[kept] / 0.75)
    assert torch.all(a[~kept] == 0)
    assert 0 < int(kept.sum()) < 64


def test_swin_drop_path_in_training():
    """SwinModel in training mode: the same generator seed gives the same
    output, another seed another; no generator raises; eval ignores it."""
    torch.manual_seed(0)
    m = SwinModel(**dict(TINY_SWIN, drop_path_rate=0.5))
    for p in m.parameters():
        torch.nn.init.normal_(p, std=0.1)
    x = torch.randn(4, 3, 32, 32)
    m.train()
    with torch.no_grad():
        a = m(x, torch.Generator().manual_seed(1))[-1]
        b = m(x, torch.Generator().manual_seed(1))[-1]
        c = m(x, torch.Generator().manual_seed(2))[-1]
        assert torch.equal(a, b) and not torch.equal(a, c)
        with pytest.raises(ValueError, match="Generator"):
            m(x)
        m.eval()
        assert torch.equal(m(x)[-1], m(x, torch.Generator().manual_seed(1))[-1])
