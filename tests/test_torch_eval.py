"""The port's evaluation (``engine/engine.py::eval_step`` and ``evaluate``,
``engine/sliding.py``) against lc2is_tpu's on the same parameters (loaded
with ``strict=True``) and the same numpy-seeded batches, on the CPU: a tiny
``BaseCrossA`` and ``PromptAuxCrossA`` (TINY_SWIN, 7 classes, as
``tests/test_torch_v4.py`` builds them), JAX on its XLA path through
``lc2is_tpu.engine.engine.Engine`` (its jitted eval step, ``evaluate`` with
``keep_eval_outputs`` and ``segmentation_metrics``) and through
``lc2is_tpu/cli/evaluate.py::evaluate_sliding``.

Stated tolerances: losses rtol 1e-5; logits within SLICE_ATOL (1e-3), the v4
forward rule; integer and mIoU outputs equal (mIoU within 1e-6) except at
near-ties: every pixel whose argmax differs between the two sides' maps
(at the logits' size, and bicubic ×4 for the per-image mIoU) has its two best
JAX scores within NEAR_TIE, and each side's metrics are held within 1e-6 to
JAX's metric functions on that side's own logits; sliding probabilities
within 1e-4.  The sliding sizes mirror the card's 640² sweep (crop 512,
stride 341, scales 0.75 / 1 / 1.25): base 128, crop 128, stride 85, scales
0.75 (96², the crop cut to the image: grids 24, 12, 6 and 3, odd at the
coarsest, as 480² gives 15) and 1.25 (160²: two windows an axis), with flip."""

import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import (SLICE_ATOL, TINY_SWIN, close, load_jax_params, numpy_params,
                             small_denseclip_cfg, t)

import lc2is_tpu.metrics.miou as jmiou
from lc2is_tpu.cli import evaluate as jcli
from lc2is_tpu.core.mesh import make_mesh
from lc2is_tpu.engine import sliding as jsliding
from lc2is_tpu.engine.engine import Engine
from lc2is_tpu.metrics.gt import segmentation_metrics as jax_segmentation_metrics
from lc2is_tpu.models import zoo as jzoo
from lc2is_tpu_torch.engine import engine, sliding
from lc2is_tpu_torch.metrics.gt import segmentation_metrics
from lc2is_tpu_torch.models import zoo
from lc2is_tpu_torch.ops.resize import resize

NAMES = ("BaseCrossA", "PromptAuxCrossA")
K = 7
CLASSES = tuple(f"c{i}" for i in range(K))
IMG, B = 64, 2
LOSS_RTOL, MIOU_TOL, NEAR_TIE = 1e-5, 1e-6, 1e-5
SLIDE = dict(model="BaseCrossA", base=128, crop=128, stride=85, scales=(0.75, 1.25))


def model_kw(name):
    kw = dict(class_names=CLASSES, swin_cfg=TINY_SWIN)
    if name.startswith("Prompt"):
        return dict(kw, cfg=small_denseclip_cfg())
    return dict(kw, dec_dim=64, nhead=4)


def _batch(seed, img=IMG, b=B):
    """(dict(pixel_values, label), metas with each image's GT and size), as
    the JAX loaders give them; labels hold class 0 (ignored) too."""
    rs = np.random.RandomState(seed)
    x = rs.randn(b, 3, img, img).astype(np.float32)
    labels = rs.randint(0, K, size=(b, img, img)).astype(np.int32)
    sizes = [(80 + 16 * i, 96 - 8 * i) for i in range(b)]
    metas = [dict(size=s, gt=rs.randint(0, K, size=s).astype(np.int32)) for s in sizes]
    return dict(pixel_values=x, label=labels), metas


def _engine(name, batches, tmp):
    jm = getattr(jzoo, name)(attn_impl="xla", **model_kw(name))
    params = numpy_params(jm, {"pixel_values": jnp.asarray(batches[0][0]["pixel_values"])})
    return Engine(name="eval", model=jm, params=params, mesh=make_mesh(), eval_loader=batches,
                  out_dir=str(tmp), logger="null", num_classes=K, keep_eval_outputs=True,
                  compute_metrics=jax_segmentation_metrics, progress=False,
                  checkpoint_on_preemption=False)


def _jax_eval(name, tmp):
    """``Engine.evaluate`` over two batches, the kept logits (``eval_loop``),
    and the eval step on the first batch: one compile of the step."""
    batches = [_batch(0), _batch(1)]
    eng = _engine(name, batches, tmp)
    want_eval = eng.evaluate()
    inputs = eng._put_batch(eng._cast({"pixel_values": batches[0][0]["pixel_values"]}))
    step = eng._eval_step(eng.params, inputs, eng._put_batch(jnp.asarray(batches[0][0]["label"])))
    losses, miou, cm, logits = jax.device_get(step)
    return dict(name=name, batches=batches, params=eng.params, want_eval=want_eval,
                want_logits=eng.eval_loop()[1]["outputs"],
                want_step=({k: float(v) for k, v in losses.items()}, float(miou), cm, logits))


def _jax_slide(tmp):
    """``cli/evaluate.py::evaluate_sliding`` of ``SLIDE["model"]`` on an
    ``Engine``, two batches of one image."""
    batches = [_batch(10 + i, img=SLIDE["base"], b=1) for i in range(2)]
    eng = _engine(SLIDE["model"], batches, tmp)
    args = types.SimpleNamespace(scales=",".join(str(s) for s in SLIDE["scales"]),
                                 crop=SLIDE["crop"], stride=SLIDE["stride"])
    return dict(batches=batches, params=eng.params, want=jcli.evaluate_sliding(eng, batches, args))


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX runs, traced in turn and compiled together on a thread pool:
    each model's evaluation, and the sliding evaluation with the
    probabilities it hands to ``per_image_miou`` recorded."""
    seen, orig = [], jmiou.per_image_miou

    def record(probs, *a, **kw):
        if tuple(probs.shape[-2:]) == (SLIDE["base"],) * 2:
            seen.append(np.asarray(probs))
        return orig(probs, *a, **kw)

    jmiou.per_image_miou = record
    try:
        with ThreadPoolExecutor(len(NAMES) + 1) as pool:
            runs = {n: pool.submit(_jax_eval, n, tmp_path_factory.mktemp(n)) for n in NAMES}
            slide = pool.submit(_jax_slide, tmp_path_factory.mktemp("slide"))
            out = {n: r.result() for n, r in runs.items()}
            out["slide"] = dict(slide.result(), probs=seen)
    finally:
        jmiou.per_image_miou = orig
    return out


@pytest.fixture(scope="module", params=NAMES)
def run(request, jax_side):
    """A model's JAX evaluation and the port model on the same params."""
    name = request.param
    r = jax_side[name]
    port = load_jax_params(getattr(zoo, name)(device="cpu", **model_kw(name)), r["params"])
    return dict(r, port=port)


@jax.jit
def _jax_metrics(logits, labels):
    return jmiou.per_image_miou(logits, labels, num_classes=K), jmiou.batch_confusion(logits,
                                                                                       labels, K)


def near_tie_flips(got_scores, want_scores):
    """Pixels whose argmax over dim 1 differs between the two score maps;
    each must be a near-tie of ``want_scores`` (two best within NEAR_TIE)."""
    want = torch.as_tensor(np.asarray(want_scores))
    differ = torch.as_tensor(np.asarray(got_scores)).argmax(1) != want.argmax(1)
    top2 = want.topk(2, dim=1).values
    gaps = (top2[:, 0] - top2[:, 1])[differ]
    assert bool(gaps.le(NEAR_TIE).all()), gaps.max()
    return int(differ.sum())


def _x4(logits):
    return resize(torch.as_tensor(np.asarray(logits)), scale_factor=4, method="bicubic")


def test_eval_step_matches_jax(run):
    """Losses, logits; the confusion counts and the per-image mIoU equal to
    JAX's metric functions on the port's logits, and to JAX's step's except
    where a near-tie flips a pixel's argmax."""
    (inputs, metas), port = run["batches"][0], run["port"]
    losses, miou, cm, logits = engine.eval_step(port, {"pixel_values": t(inputs["pixel_values"])},
                                                torch.from_numpy(inputs["label"]).long(),
                                                num_classes=K)
    w_losses, w_miou, w_cm, w_logits = run["want_step"]
    assert set(losses) == set(w_losses) == ({"eval_loss", "eval_aux_loss"}
                                            if run["name"] == "PromptAuxCrossA" else {"eval_loss"})
    for k in losses:
        np.testing.assert_allclose(float(losses[k]), w_losses[k], rtol=LOSS_RTOL)
    assert logits.dtype == torch.float32 and tuple(logits.shape) == w_logits.shape
    close(logits, w_logits, rtol=0, atol=SLICE_ATOL)
    own_miou, own_cm = _jax_metrics(jnp.asarray(logits.numpy()), jnp.asarray(inputs["label"]))
    np.testing.assert_array_equal(cm.numpy(), np.asarray(own_cm))
    assert abs(float(miou) - float(own_miou)) <= MIOU_TOL
    if near_tie_flips(logits, w_logits) == 0:
        np.testing.assert_array_equal(cm.numpy(), w_cm)
    if near_tie_flips(_x4(logits), _x4(w_logits)) == 0:
        assert abs(float(miou) - w_miou) <= MIOU_TOL


def test_evaluate_matches_jax_engine(run):
    """``evaluate`` over two batches (dicts with their metas), keeping the
    outputs for ``segmentation_metrics`` with the GT path: every key of JAX's
    ``Engine.evaluate``."""
    got = engine.evaluate(run["port"], run["batches"], num_classes=K, keep_eval_outputs=True,
                          compute_metrics=lambda **kw: segmentation_metrics(
                              n_clas=K, device="cpu", **kw))
    want = run["want_eval"]
    assert set(got) == set(want) >= {"eval_loss", "eval_mIOU_label", "eval_mIOU_dataset",
                                     "eval_mIOU_gt"}
    with torch.no_grad():
        mine = torch.cat([run["port"]({"pixel_values": t(x["pixel_values"])})["outputs"]
                          for x, _ in run["batches"]]).numpy()
    ref = run["want_logits"]
    flips = near_tie_flips(mine, ref) + near_tie_flips(_x4(mine), _x4(ref))
    sizes = [m["size"] for _, metas in run["batches"] for m in metas]
    for i, size in enumerate(sizes):
        up = [resize(torch.as_tensor(v[i:i + 1]), size=size, method="bicubic")
              for v in (mine, ref)]
        flips += near_tie_flips(*up)
    for k in want:
        if "loss" in k:
            np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL)
        elif flips == 0:
            assert abs(got[k] - want[k]) <= MIOU_TOL, k


def _probe(k_cls, seed):
    w = np.random.RandomState(seed).randn(k_cls, 3).astype(np.float32)
    return (lambda x: jnp.einsum("kc,nchw->nkhw", jnp.asarray(w), x),
            lambda x: torch.einsum("kc,nchw->nkhw", torch.from_numpy(w), x))


@pytest.mark.parametrize("hw,crop,stride", [((96, 96), 64, 32), ((80, 112), 64, 48)])
def test_sliding_window_logits_probe_matches_jax(hw, crop, stride):
    """tests/test_sliding_utils.py:30-44's pixel-local linear probe, against
    JAX's sliding_window_logits (and the probe applied whole)."""
    jf, pf = _probe(4, 0)
    img = np.random.RandomState(1).randn(2, 3, *hw).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: jsliding.sliding_window_logits(jf, v, crop, stride))(
        jnp.asarray(img)))
    got = sliding.sliding_window_logits(pf, t(img), crop, stride)
    close(got, want, rtol=0, atol=1e-5)
    close(got, pf(t(img)), rtol=0, atol=1e-5)
    assert sliding._window_origins(640, 512, 341) == jsliding._window_origins(640, 512, 341)


@pytest.mark.parametrize("flip", [True, False])
def test_multi_scale_probe_matches_jax(flip):
    """tests/test_sliding_utils.py:47-57's case: probabilities at the base
    size, scales 0.75 (the crop cut to 60²) and 1 (two windows an axis)."""
    jf, pf = _probe(5, 2)
    img = np.random.RandomState(3).randn(1, 3, 80, 80).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: jsliding.multi_scale_sliding_eval(
        jf, v, (0.75, 1.0), 64, 48, flip))(jnp.asarray(img)))
    got = sliding.multi_scale_sliding_eval(pf, t(img), (0.75, 1.0), 64, 48, flip)
    close(got, want, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def slide_run(jax_side):
    """The port's ``evaluate_sliding`` of the JAX run's model and batches,
    its probabilities recorded where it hands them to ``per_image_miou``."""
    r = jax_side["slide"]
    port = load_jax_params(getattr(zoo, SLIDE["model"])(device="cpu", **model_kw(SLIDE["model"])),
                           r["params"])
    seen, orig = [], sliding.per_image_miou

    def record(probs, *a, **kw):
        seen.append(probs.numpy())
        return orig(probs, *a, **kw)

    sliding.per_image_miou = record
    try:
        got = sliding.evaluate_sliding(port, r["batches"], scales=SLIDE["scales"],
                                       crop=SLIDE["crop"], stride=SLIDE["stride"], num_classes=K)
    finally:
        sliding.per_image_miou = orig
    return got, r["want"], dict(port=seen, jax=r["probs"])


def test_sliding_model_matches_jax(slide_run):
    got, want, seen = slide_run
    assert got["scales"] == want["scales"] == SLIDE["scales"]
    assert len(seen["port"]) == len(seen["jax"]) == 2
    flips = 0
    for mine, ref in zip(seen["port"], seen["jax"]):
        assert mine.shape == ref.shape == (1, K, SLIDE["base"], SLIDE["base"])
        np.testing.assert_allclose(mine, ref, rtol=0, atol=1e-4)
        flips += near_tie_flips(mine, ref)
    if flips == 0:
        assert abs(got["eval_mIOU_sliding"] - want["eval_mIOU_sliding"]) <= MIOU_TOL
