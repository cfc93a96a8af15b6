"""The port's evaluation metrics against lc2is_tpu's on the same numpy-seeded
inputs, on the CPU: ``ops/resize.py``'s nearest resize, ``metrics/miou.py``,
``metrics/gt.py`` and ``utils.py``.

Stated tolerances: the nearest resize bit for bit (values and labels);
integer outputs (confusion counts, masks, padded labels, colours) equal;
mIoU values, IoU and pixel accuracy within 1e-6; resized float maps within
2e-4 (``tests/torch_port_util.py``'s TOL).  The logits carry forced ties
(two identical class channels, and a block of pixels where two classes tie)
and one image's label is all ``ignore_index``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch_port_util import TOL, jax_ref

from lc2is_tpu import utils as jutils
from lc2is_tpu.metrics import gt as jgt
from lc2is_tpu.metrics import miou as jmiou
from lc2is_tpu.ops.resize import resize as jax_resize
from lc2is_tpu_torch import utils
from lc2is_tpu_torch.metrics import gt, miou
from lc2is_tpu_torch.ops.resize import resize

MIOU_TOL = 1e-6
K = 7


@pytest.mark.parametrize("scale", [2, 4])
def test_nearest_scale_matches_jax(scale):
    """tests/test_resize.py:48-53's case: floats and int labels, bit for bit."""
    x = np.random.RandomState(0).randint(0, 151, size=(2, 1, 33, 57))
    want = np.asarray(jax_resize(jnp.asarray(x, jnp.float32), scale_factor=scale,
                                 method="nearest"))
    got = resize(torch.from_numpy(x).float(), scale_factor=scale, method="nearest")
    np.testing.assert_array_equal(got.numpy(), want)
    labels = resize(torch.from_numpy(x).int(), scale_factor=scale, method="nearest")
    assert labels.dtype == torch.int32
    np.testing.assert_array_equal(labels.numpy(), want.astype(np.int32))


@pytest.mark.parametrize("size", [(128, 128), (100, 77)])
def test_nearest_size_matches_jax(size):
    """tests/test_resize.py:56-61's case, down to any size."""
    x = np.random.RandomState(1).randint(0, 151, size=(2, 1, 313, 457)).astype(np.float32)
    want = np.asarray(jax_resize(jnp.asarray(x), size=size, method="nearest"))
    got = resize(torch.from_numpy(x), size=size, method="nearest")
    np.testing.assert_array_equal(got.numpy(), want)


def test_other_methods_raise():
    with pytest.raises(ValueError, match="data/preprocess.py"):
        resize(torch.zeros(1, 1, 4, 4), size=(8, 8), method="lanczos")


@pytest.fixture(scope="module")
def batch():
    """(logits (4, K, 16, 16), labels (4, 16, 16)): classes 3 and 5 share one
    channel (ties everywhere they lead, after any resize), image 0 has a
    4 x 4 block where classes 2 and 4 tie above the rest, image 2's label is
    all ignore_index (0).  The shapes of ``segmentation_metrics``' label path
    below, whose JAX ops run eagerly (their compiles are then shared)."""
    rs = np.random.RandomState(2)
    logits = rs.randn(4, K, 16, 16).astype(np.float32)
    logits[:, 5] = logits[:, 3]
    logits[0, 2, :4, :4] = logits[0, 4, :4, :4] = 5.0
    labels = rs.randint(0, K, size=(4, 16, 16)).astype(np.int32)
    labels[2] = 0
    return logits, labels


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_confusion_and_iou_match_jax(batch):
    logits, labels = batch
    pred = logits.argmax(1)
    want = np.asarray(jmiou.confusion_matrix(jnp.asarray(pred), jnp.asarray(labels), K))
    got = miou.confusion_matrix(_t(pred), _t(labels), K)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(miou.iou_from_confusion(got).numpy(),
                               np.asarray(jmiou.iou_from_confusion(jnp.asarray(want))),
                               rtol=0, atol=MIOU_TOL)


@pytest.mark.parametrize("upsample", [True, False])
@pytest.mark.parametrize("reduce", [True, False])
def test_per_image_miou_matches_jax(batch, upsample, reduce):
    logits, labels = batch
    want = np.asarray(jmiou.per_image_miou(jnp.asarray(logits), jnp.asarray(labels),
                                           num_classes=K, upsample_logits_to_label=upsample,
                                           reduce=reduce))
    got = miou.per_image_miou(logits, labels, num_classes=K, upsample_logits_to_label=upsample,
                              reduce=reduce, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=MIOU_TOL)
    if not reduce:
        assert got[2] == 0.0  # the all-ignore image


def test_pixel_accuracy_and_confusion_match_jax(batch):
    """At the logits' size and, labels nearest-resized, from 24² labels; with
    and without ignore_index."""
    logits, labels = batch
    big = np.repeat(np.repeat(labels, 2, 1), 2, 2)
    for lab in (labels, big):
        for ignore in (0, None):
            want = float(jmiou.pixel_accuracy(jnp.asarray(logits), jnp.asarray(lab), ignore))
            got = miou.pixel_accuracy(_t(logits), _t(lab), ignore)
            assert abs(float(got) - want) <= MIOU_TOL
        want = np.asarray(jmiou.batch_confusion(jnp.asarray(logits), jnp.asarray(lab), K))
        cm = miou.batch_confusion(_t(logits), _t(lab), K)
        np.testing.assert_array_equal(cm.numpy(), want)
        d_want = float(jmiou.dataset_miou(jnp.asarray(want)))
        assert abs(float(miou.dataset_miou(cm.long())) - d_want) <= MIOU_TOL


def test_metrics_on_numpy_default_to_the_card(batch):
    logits, labels = batch
    if torch.cuda.is_available():
        assert miou.per_image_miou(logits, labels, num_classes=K).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            miou.per_image_miou(logits, labels, num_classes=K)


@pytest.fixture(scope="module")
def gt_case():
    """Four images' logits (4, K, 16, 16), their GT at sizes two of which
    are shared, a third below the logits' grid."""
    rs = np.random.RandomState(3)
    logits = rs.randn(4, K, 16, 16).astype(np.float32)
    sizes = [(40, 52), (40, 52), (13, 21), (64, 64)]
    gts = [rs.randint(0, K, size=s).astype(np.int32) for s in sizes]
    return logits, gts, sizes


@pytest.mark.parametrize("bucket", [None, 16])
def test_gt_miou_matches_both_jax_paths(gt_case, bucket):
    logits, gts, sizes = gt_case
    exact = jgt.compute_gt_miou(logits, gts, sizes, num_classes=K)["mIOU_gt"]
    bucketed = jgt.compute_gt_miou(logits, gts, sizes, num_classes=K, bucket=16)["mIOU_gt"]
    got = gt.compute_gt_miou(logits, gts, sizes, num_classes=K, bucket=bucket, device="cpu")
    assert abs(got["mIOU_gt"] - exact) <= MIOU_TOL
    assert abs(got["mIOU_gt"] - bucketed) <= MIOU_TOL


def test_segmentation_metrics_matches_jax(gt_case):
    logits, gts, sizes = gt_case
    labels = np.stack([gts[0][:16, :16], gts[1][:16, :16], np.zeros((16, 16), np.int32),
                       gts[3][:16, :16]])
    for extra in ({}, dict(gt_list=gts, sizes=sizes)):
        want = jgt.segmentation_metrics(logits, labels, n_clas=K, **extra)
        got = gt.segmentation_metrics(logits, labels, n_clas=K, device="cpu", **extra)
        assert set(got) == set(want)
        for key in want:
            assert abs(got[key] - want[key]) <= MIOU_TOL, key


def test_mask_utils_match_jax(gt_case):
    """generate_masks and original_size_interpolate at the GT sizes, then
    pad_and_concat (both pads) and unpad of the masks."""
    logits, _, sizes = gt_case
    pads = (("max", 0), ("fixed", 255))

    def jax_side(x):
        masks = jutils.generate_masks(x, sizes)
        padded = [jutils.pad_and_concat(masks, sizes, pad=p, value=v) for p, v in pads]
        return (jutils.original_size_interpolate(x, sizes), masks, padded,
                jutils.unpad(padded[-1], sizes))

    up_w, masks_w, padded_w, cut_w = jax_ref(jax_side, logits)
    for g, w in zip(utils.original_size_interpolate(_t(logits), sizes), up_w):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    masks = utils.generate_masks(_t(logits), sizes)
    for g, w in zip(masks, masks_w):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for (pad, value), want in zip(pads, padded_w):
        got = utils.pad_and_concat(masks, sizes, pad=pad, value=value)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for g, w in zip(utils.unpad(got, sizes), cut_w):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_apply_color_matches_jax():
    """Ids the table covers take its colour; id 9, which it lacks, keeps its
    value on all three channels."""
    rs = np.random.RandomState(4)
    mask = rs.randint(0, 10, size=(9, 11)).astype(np.int32)
    colors = np.concatenate([np.arange(9)[:, None], rs.randint(0, 256, size=(9, 3))],
                            1).astype(np.int32)
    want = np.asarray(jutils.apply_color(jnp.asarray(mask), jnp.asarray(colors)))
    got = utils.apply_color(_t(mask), _t(colors))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["float", "mask"])
def test_save_img_matches_jax(tmp_path, kind):
    rs = np.random.RandomState(5)
    img = (rs.rand(3, 10, 12).astype(np.float32) if kind == "float"
           else rs.randint(0, 151, size=(10, 12)).astype(np.int32))
    jutils.save_img(str(tmp_path / "jax.png"), jnp.asarray(img), size=(8, 9))
    utils.save_img(str(tmp_path / "port.png"), _t(img), size=(8, 9))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port.png")),
                                  np.asarray(Image.open(tmp_path / "jax.png")))


def test_count_params_matches_jax():
    """A module's parameters in millions, all and trainable only (a frozen
    layer's as JAX's trainable mask leaves them out)."""
    net = torch.nn.Sequential(torch.nn.Linear(30, 40), torch.nn.Linear(40, 5))
    tree = {k: jnp.zeros(tuple(v.shape)) for k, v in net.state_dict().items()}
    assert utils.count_params(net) == pytest.approx(jutils.count_params(tree), abs=0)
    net[0].requires_grad_(False)
    mask = {k: not k.startswith("0.") for k in tree}
    assert utils.count_params(net, trainable_only=True) == pytest.approx(
        jutils.count_params(tree, mask), abs=0)
