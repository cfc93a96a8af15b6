"""v1 training in the port: a tiny ``BaseModelWithText`` through
``engine/engine.py::train_step`` (plain cross-entropy of ``feature_mm`` on the
labels, AdamW, nothing frozen) against lc2is_tpu's step built as
``lc2is_tpu/engine/engine.py:283-313`` builds it (``loss_fn`` applying the
model with ``deterministic=False``, ``_normalize_output``, the criterion,
``jax.value_and_grad`` and the optax AdamW of ``make_optimizer``), on the same
numpy parameters and batch; the engine's pieces (``_normalize_output``, the
resize + CE fallback for labels that are no integer multiple of the map);
and the dropout the v1 decoders train with.

Stated tolerances, as ``tests/test_torch_train_step.py`` states them (f32):
the loss rtol 1e-5; every gradient rtol 1e-3, atol 1e-3 · max |ref| + 1e-10;
after the AdamW step the parameters within 1e-2 · lr + 1e-7 wherever |g| >=
1e-3 · max |g| (Adam's first update is lr · g / (|g| + eps): where g is near 0
its sign is f32 noise).  The fallback loss rtol 1e-5 and its gradient TOL
(2e-4).  Dropout: the keep share within 3σ of 1 − p over 10^5 draws."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_port_util import TOL, close, load_jax_params, numpy_params, t

from lc2is_tpu.engine.engine import _normalize_output as jax_normalize_output
from lc2is_tpu.engine.optim import make_optimizer as jax_make_optimizer
from lc2is_tpu.models import zoo as jzoo
from lc2is_tpu.nn.losses import cross_entropy as jax_cross_entropy
from lc2is_tpu.ops.fused_ce import upsampled_cross_entropy as jax_upsampled_ce
from lc2is_tpu.ops.resize import resize as jax_resize
from lc2is_tpu_torch.core.convert import params_to_state_dict, seeded_init_
from lc2is_tpu_torch.engine import engine
from lc2is_tpu_torch.engine.optim import make_optimizer
from lc2is_tpu_torch.models import zoo
from lc2is_tpu_torch.nn import layers
from lc2is_tpu_torch.ops.attention import dropout

LR = 1e-3
IMG, PATCH, B, OUT = 32, 16, 2, 8
KW = dict(in_size=IMG, out_size=OUT, patch_size=PATCH, num_layers=2, nhead=2,
          vision_kwargs=dict(hidden_size=32, num_layers=2, num_heads=2, mlp_dim=64),
          text_kwargs=dict(vocab_size=1000, hidden_size=32, num_layers=2, num_heads=2,
                           mlp_dim=64, eos_token_id=999))


def _batch(seed=0):
    """Images, padded ids (SOT 998, random tokens, EOT 999, zeros after),
    attention_mask = ids != 0, and labels at the output size."""
    rs = np.random.RandomState(seed)
    ids = np.zeros((B, 12), np.int64)
    for i in range(B):
        n = rs.randint(1, 9)
        ids[i, 0], ids[i, 1:n + 1], ids[i, n + 1] = 998, rs.randint(1, 900, size=n), 999
    inputs = dict(pixel_values=rs.randn(B, 3, IMG, IMG).astype(np.float32), input_ids=ids,
                  attention_mask=(ids != 0).astype(np.int64))
    return inputs, rs.randint(0, 151, size=(B, OUT, OUT)).astype(np.int32)


def exact_zero_partner(name):
    """For a parameter whose gradient is 0 in exact arithmetic, so f32 noise
    on both sides, the parameter whose gradient norm the noise is held to:
    a key bias (softmax is invariant to the q·bk that a row's logits share)
    against its layer's query bias; the prototypes' projection bias (it adds
    feature_v·b to every class's logit alike) against the visual one."""
    if name.endswith("k_proj.bias"):
        return name.replace("k_proj", "q_proj")
    if name == "pixel_patch.textual.bias":
        return "pixel_patch.visual.bias"
    return None


@pytest.fixture(scope="module")
def step_run():
    """One JAX step (loss, grads, AdamW-updated params) and one port step from
    the same numpy parameters and batch."""
    inputs, y = _batch()
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    jm = jzoo.BaseModelWithText(**KW)
    params = numpy_params(jm, jin)["params"]

    def loss_fn(p, x, lab):
        out = jm.apply({"params": p}, x, deterministic=False,
                       rngs={"dropout": jax.random.PRNGKey(0)})
        out = jax_normalize_output(out)
        return jax_cross_entropy(out["outputs"], lab)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, jin, jnp.asarray(y))
    tx = jax_make_optimizer(params, lr=LR)
    updates, _ = tx.update(grads, tx.init(params), params)
    new = optax.apply_updates(params, updates)

    port = load_jax_params(zoo.BaseModelWithText(device="cpu", **KW), params)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    opt = make_optimizer(port, lr=LR)
    losses = engine.train_step(port, opt, {k: torch.from_numpy(v) for k, v in inputs.items()},
                               torch.from_numpy(y).long())
    return dict(port=port, before=before, losses=losses, loss=loss,
                grads=params_to_state_dict(grads), new=params_to_state_dict(new))


def test_v1_loss(step_run):
    assert set(step_run["losses"]) == {"train_loss"}
    np.testing.assert_allclose(step_run["losses"]["train_loss"].item(), float(step_run["loss"]),
                               rtol=1e-5)


def test_v1_every_gradient(step_run):
    """Every parameter trains (nothing is frozen for this model), the ViT's
    q/k/v weights, the text tower and the prototypes included; the gradients
    that are 0 in exact arithmetic are held to a partner's norm."""
    names = []
    for name, p in step_run["port"].named_parameters():
        want = step_run["grads"][name].numpy()
        names.append(name)
        if name.startswith("vision_encoder.post_layernorm."):
            # the pooled CLS is not read: no gradient in the port, zeros in JAX
            assert p.grad is None and not want.any(), name
            continue
        partner = exact_zero_partner(name)
        if partner:
            ref = np.linalg.norm(step_run["grads"][partner].numpy())
            assert np.linalg.norm(p.grad.numpy() - want) <= 1e-3 * ref, name
            continue
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-3,
                                   atol=1e-3 * float(np.abs(want).max()) + 1e-10, err_msg=name)
    assert set(names) == set(step_run["grads"])
    for key in ("vision_encoder.encoder_layers.1.self_attn.q_proj.weight",
                "vision_encoder.encoder_layers.0.self_attn.k_proj.weight",
                "vision_encoder.encoder_layers.0.self_attn.v_proj.weight",
                "text_encoder.encoder_layers.0.mlp.fc1.weight", "class_prototypes"):
        assert step_run["port"].get_parameter(key).grad.abs().sum() > 0, key


def test_v1_params_after_one_adamw_step(step_run):
    port, before = step_run["port"], step_run["before"]
    for name, p in port.named_parameters():
        if exact_zero_partner(name):  # its gradient is f32 noise (above)
            continue
        g = step_run["grads"][name].numpy()
        sure = np.abs(g) >= 1e-3 * np.abs(g).max()
        got, want = p.detach().numpy(), step_run["new"][name].numpy()
        if np.abs(g).max() > 1e-6:
            assert not np.array_equal(got, before[name].numpy()), name
        np.testing.assert_allclose(got[sure], want[sure], rtol=0, atol=1e-2 * LR + 1e-7,
                                   err_msg=name)


def test_normalize_output_matches_jax():
    """The last non-None item of a tuple is ``outputs``; a dict passes."""
    a, b = np.ones((1, 2)), np.zeros((1, 3))
    for out in [(a, b), (None, a, b), (a, None, b), (a, b, None)]:
        got = engine._normalize_output(tuple(None if o is None else t(o) for o in out))
        want = jax_normalize_output(tuple(None if o is None else jnp.asarray(o) for o in out))
        assert set(got) == set(want) == {"outputs"}
        close(got["outputs"], want["outputs"])
    d = {"outputs": t(a), "low_score_map": t(b)}
    assert engine._normalize_output(d) is d


@pytest.mark.parametrize("label_hw", [(60, 60), (37, 50), (64, 64)])
def test_fused_or_plain_ce_matches_jax(label_hw):
    """The loss of a score-map model on labels that are no integer multiple
    of its map: a bilinear resize of the map to the labels, then CE, as
    ``lc2is_tpu/engine/engine.py:271-281`` (at 64² labels over a 16² map, the
    fused upsample-CE at r = 4).  Loss and gradient against JAX."""
    rs = np.random.RandomState(sum(label_hw))
    sm = rs.randn(2, 7, 16, 16).astype(np.float32)
    y = rs.randint(0, 7, size=(2,) + label_hw).astype(np.int32)

    def jloss(s, lab):
        r = lab.shape[-1] // s.shape[-1]
        if r * s.shape[-1] == lab.shape[-1] and r * s.shape[-2] == lab.shape[-2]:
            return jax_upsampled_ce(s, lab, r, interpret=True)
        return jax_cross_entropy(jax_resize(s, size=lab.shape[-2:], method="bilinear"), lab)

    want, want_g = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(sm), jnp.asarray(y))
    x = t(sm).requires_grad_()
    got = engine._fused_or_plain_ce(x, torch.from_numpy(y).long())
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    close(x.grad, want_g)


def test_dropout_statistics():
    """Kept entries are scaled by 1 / (1 − p), the rest are 0; the keep share
    lies within 3σ of 1 − p; the same generator seed gives the same mask,
    another seed another; rate 0 is the identity."""
    x = torch.rand(100_000) + 0.5
    p = 0.3
    a = dropout(x, p, torch.Generator().manual_seed(3))
    kept = a != 0
    assert torch.equal(a[kept], x[kept] / (1 - p))
    share = kept.float().mean().item()
    assert abs(share - (1 - p)) <= 3 * (p * (1 - p) / x.numel()) ** 0.5, share
    assert torch.equal(a, dropout(x, p, torch.Generator().manual_seed(3)))
    assert not torch.equal(a, dropout(x, p, torch.Generator().manual_seed(4)))
    assert dropout(x, 0.0, None) is x
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, p, None)


def _seeded_v1(dropout_rate):
    model = zoo.BaseModelWithText(device="cpu", dropout=dropout_rate, **KW)
    return seeded_init_(model, seed=7)


def test_v1_dropout_modes():
    """Eval mode with dropout equals dropout 0; in training the same generator
    seed gives the same output, another seed another, and at dropout 0 the
    training forward equals the eval forward."""
    inputs, _ = _batch(1)
    x = {k: torch.from_numpy(v) for k, v in inputs.items()}
    drop, none = _seeded_v1(0.3), _seeded_v1(0.0)
    with torch.no_grad():
        ref = none.eval()(x)[-1]
        assert torch.equal(drop.eval()(x)[-1], ref)
        assert torch.equal(none.train()(x)[-1], ref)
        drop.train()
        a = drop(x, generator=torch.Generator().manual_seed(1))[-1]
        b = drop(x, generator=torch.Generator().manual_seed(1))[-1]
        c = drop(x, generator=torch.Generator().manual_seed(2))[-1]
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, ref)


@pytest.mark.parametrize("norm_first", [False, True])
def test_training_layer_with_dropout_takes_the_unfused_halves(monkeypatch, norm_first):
    """A decoder layer in training with dropout above 0 calls neither fused
    attention half nor the fused MLP (``layers.py:471-472``, ``_ff_res_norm``);
    out of training, or at dropout 0, it takes them as before (post-norm:
    both; norm_first: the MLP)."""
    calls = []
    for name in ("fused_attn_block", "fused_mlp"):
        op = getattr(layers, name)

        def rec(*a, _op=op, _name=name, **kw):
            calls.append(_name)
            return _op(*a, **kw)
        monkeypatch.setattr(layers, name, rec)
    x, mem = torch.randn(2, 9, 16), torch.randn(2, 5, 16)
    gen = torch.Generator().manual_seed(0)
    for rate, training, fused in [(0.1, True, False), (0.1, False, True), (0.0, True, True)]:
        layer = seeded_init_(layers.TransformerDecoderLayer(16, 2, dim_feedforward=32,
                                                            dropout=rate, norm_first=norm_first),
                             seed=1).train(training)
        calls.clear()
        with torch.no_grad():
            out = layer(x, mem, generator=gen)
        assert out.shape == x.shape and torch.isfinite(out).all()
        want = ({"fused_attn_block", "fused_mlp"} if not norm_first else {"fused_mlp"}) \
            if fused else set()
        assert set(calls) == want, (rate, training, calls)


def test_unfused_layer_equals_fused_without_dropout():
    """The unfused post-norm layer (the path dropout takes) at rate 0 computes
    what the fused halves compute: training mode at rate 1e-30 (unfused, no
    element dropped in practice) against eval mode (fused), TOL."""
    x, mem = torch.randn(2, 9, 16), torch.randn(2, 5, 16)
    layer = seeded_init_(layers.TransformerDecoderLayer(16, 2, dim_feedforward=32,
                                                        dropout=1e-30), seed=2)
    with torch.no_grad():
        fused = layer.eval()(x, mem)
        unfused = layer.train()(x, mem, generator=torch.Generator().manual_seed(0))
    close(unfused, fused.numpy(), **TOL)


@pytest.mark.parametrize("name", ["ContrastiveModel", "DenseClip"])
def test_contrastive_and_dense_clip_steps_raise_as_in_jax(name):
    """``train_step`` on ``ContrastiveModel`` and ``DenseClip`` against the
    (B, L, L) labels the data pipeline gives: their last output, the CE's
    target under ``_normalize_output``, holds patches or tokens at dim 1
    ((B, 64, K) logits, (B, 1 + 4, C) tokens), so the CE raises, in the port
    as JAX's ``cross_entropy`` raises on outputs of the same shapes."""
    from test_torch_v1 import VISION, TinyContrastive, TinyDenseClip, _text

    inputs, y = _batch()
    kw = dict(in_size=IMG, out_size=OUT, patch_size=PATCH, vision_kwargs=VISION,
              text_kwargs=_text(999))
    jcls, extra = {"ContrastiveModel": (TinyContrastive, dict(embed_dim=32)),
                   "DenseClip": (TinyDenseClip, dict(embed_dim=32, decoder_layers=2,
                                                     nhead=2))}[name]
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    shapes = jax.eval_shape(lambda: jcls(**kw).init_with_output(jax.random.PRNGKey(0), jin))[0]
    target = jax_normalize_output(shapes)["outputs"]
    with pytest.raises(ValueError):
        jax_cross_entropy(jnp.zeros(target.shape, target.dtype), jnp.asarray(y))
    port = seeded_init_(getattr(zoo, name)(device="cpu", **extra, **kw), 0).eval()
    pin = {k: torch.from_numpy(v) for k, v in inputs.items()}
    with torch.no_grad():
        got = engine._normalize_output(port(pin))["outputs"]
    assert tuple(got.shape) == target.shape and tuple(got.shape[1:2]) != (151,)
    with pytest.raises(ValueError, match="does not match"):
        engine.train_step(port, make_optimizer(port, lr=LR), pin, torch.from_numpy(y).long(),
                          generator=torch.Generator().manual_seed(0))
