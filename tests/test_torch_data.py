"""The port's data pipeline (``lc2is_tpu_torch/data/*``, ``ops/bpe.py``'s
``tokenize_batch_padded``, PIL-semantics ``ops/resize.py``) against the JAX
package's on the same inputs.

Bit for bit: ``SyntheticADE20K`` items; ``ADE20KDataset`` (with a seeded
flip), ``ADE20KClassDataset`` and ``ADE20KFullClassDataset`` items on the
miniature ADE20K tree of ``tests/test_data.py``; the five collators;
``tokenize_batch_padded``; the loader's batches in order over two epochs,
threaded and not; ``compact_ids``; the labels of ``preprocess_batch``.
Against JAX's and PIL's float resize, at ``tests/test_resize.py``'s
tolerances: the PIL-semantics bicubic resize within 1e-3 on 0-255 values,
its uint8 rounding within 1 of PIL's uint8 path, PIL's nearest exactly, and
the images of ``preprocess_batch`` back on the 0-255 scale within 1e-3.
"""

import numpy as np
import pytest
import torch
from PIL import Image
from test_data import fake_ade20k  # noqa: F401  (the miniature tree fixture)

import jax
import jax.numpy as jnp

from lc2is_tpu.data import ade20k as JA
from lc2is_tpu.data import collators as JC
from lc2is_tpu.data.loader import DataLoader as JLoader
from lc2is_tpu.data.preprocess import compact_ids as jax_compact_ids
from lc2is_tpu.data.preprocess import preprocess_batch as jax_preprocess
from lc2is_tpu.data.transforms import Compose as JCompose
from lc2is_tpu.data.transforms import RandomHorizontalFlip as JFlip
from lc2is_tpu.data.transforms import Resize as JResize
from lc2is_tpu.ops.bpe import tokenize_batch_padded as jax_tokenize_padded
from lc2is_tpu.ops.resize import resize as jax_resize
from lc2is_tpu_torch.data import ade20k as A
from lc2is_tpu_torch.data import collators as C
from lc2is_tpu_torch.data.loader import DataLoader
from lc2is_tpu_torch.data.preprocess import compact_ids, preprocess_batch
from lc2is_tpu_torch.data.transforms import Compose, RandomHorizontalFlip, Resize
from lc2is_tpu_torch.ops.bpe import tokenize_batch_padded
from lc2is_tpu_torch.ops.resize import resize


def jax_pil_resize(x, size, method):
    """The JAX package's PIL-semantics resize under one ``jax.jit`` (eager,
    each of its ops would compile alone)."""
    return np.asarray(jax.jit(lambda v: jax_resize(v, size=size, method=method,
                                                   semantics="pil"))(jnp.asarray(x)))


def assert_same(a, b):
    """Nested tuples / lists / dicts of arrays and numbers, equal bit for bit."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype and a.shape == np.asarray(b).shape
        assert np.array_equal(a, b)
    else:
        assert a == b


def test_synthetic_items():
    for tr, jtr in ((None, None), (Compose([Resize(24)]), JCompose([JResize(24)]))):
        port = A.SyntheticADE20K(length=3, img_size=32, seed=7, transform=tr)
        ref = JA.SyntheticADE20K(length=3, img_size=32, seed=7, transform=jtr)
        assert port.class_names == ref.class_names
        for i in range(3):
            assert_same(port[i], ref[i])


def _datasets(root, split="validation"):
    tr = Compose([Resize(48), RandomHorizontalFlip(0.5)])
    jtr = JCompose([JResize(48), JFlip(0.5)])
    return [(A.ADE20KDataset(root=root, split=split, transform=tr, seed=3),
             JA.ADE20KDataset(root=root, split=split, transform=jtr, seed=3)),
            (A.ADE20KClassDataset(root=root, split=split),
             JA.ADE20KClassDataset(root=root, split=split)),
            (A.ADE20KFullClassDataset(root=root, split=split),
             JA.ADE20KFullClassDataset(root=root, split=split))]


def test_ade20k_items(fake_ade20k):  # noqa: F811
    for port, ref in _datasets(fake_ade20k):
        assert port.class_names == ref.class_names and len(port) == len(ref) == 4
        for epoch in (0, 1):
            port.set_epoch(epoch)
            ref.set_epoch(epoch)
            for i in range(4):
                assert_same(port[i], ref[i])


def test_collators(fake_ade20k):  # noqa: F811
    newest, classes, full = _datasets(fake_ade20k)
    cases = [(C.ADE20KCollator(), JC.ADE20KCollator(), newest),
             (C.ADE20KTextCollator(context_length=32), JC.ADE20KTextCollator(context_length=32),
              newest),
             (C.OldCollator(img_size=32, label_size=16), JC.OldCollator(img_size=32, label_size=16),
              classes),
             (C.JoinTextCollator(img_size=32, label_size=16),
              JC.JoinTextCollator(img_size=32, label_size=16), classes),
             (C.FullClassesCollator(img_size=32, label_size=16),
              JC.FullClassesCollator(img_size=32, label_size=16), full)]
    for coll, jcoll, (port, ref) in cases:
        assert_same(coll([port[0], port[2], port[3]]), jcoll([ref[0], ref[2], ref[3]]))


def test_tokenize_batch_padded():
    texts = ["wall", "a photo of a windowpane", "sky, tree, road", "x " * 100]
    assert_same(tokenize_batch_padded(texts), jax_tokenize_padded(texts))
    assert_same(tokenize_batch_padded(texts, max_length=8),
                jax_tokenize_padded(texts, max_length=8))


@pytest.mark.parametrize("num_workers", [0, 2])
def test_loader_order(fake_ade20k, num_workers):  # noqa: F811
    (port, ref), *_ = _datasets(fake_ade20k)
    kw = dict(batch_size=3, shuffle=True, seed=11, num_workers=num_workers)
    dl = DataLoader(port, collate_fn=C.ADE20KCollator(), **kw)
    jdl = JLoader(ref, collate_fn=JC.ADE20KCollator(), **kw)
    assert len(dl) == len(jdl) == 2
    for _ in range(2):  # two epochs: the shuffle and the flips move with the epoch
        assert_same(list(dl), list(jdl))


@pytest.mark.parametrize("size", [(512, 512), (128, 128), (700, 300)])
def test_pil_bicubic_float(size):
    x = np.random.RandomState(0).rand(300, 400).astype(np.float32) * 255
    ref = np.asarray(Image.fromarray(x, mode="F").resize((size[1], size[0]), Image.BICUBIC))
    got = resize(torch.from_numpy(x), size=size, method="bicubic", semantics="pil").numpy()
    want = jax_pil_resize(x, size, "bicubic")
    assert np.abs(got - ref).max() < 1e-3
    assert np.abs(got - want).max() < 1e-3


@pytest.mark.parametrize("method", ["bilinear", "lanczos", "box"])
def test_pil_other_filters(method):
    x = np.random.RandomState(1).rand(90, 70).astype(np.float32) * 255
    flt = {"bilinear": Image.BILINEAR, "lanczos": Image.LANCZOS, "box": Image.BOX}[method]
    for size in ((40, 33), (150, 121)):
        ref = np.asarray(Image.fromarray(x, mode="F").resize((size[1], size[0]), flt))
        got = resize(torch.from_numpy(x), size=size, method=method, semantics="pil").numpy()
        want = jax_pil_resize(x, size, method)
        assert np.abs(got - ref).max() < 1e-3, size
        assert np.abs(got - want).max() < 1e-3, size


def test_pil_bicubic_uint8():
    x8 = (np.random.RandomState(2).rand(300, 400) * 255).astype(np.uint8)
    ref = np.asarray(Image.fromarray(x8).resize((128, 128), Image.BICUBIC)).astype(np.float32)
    got = resize(torch.from_numpy(x8.astype(np.float32)), size=(128, 128), method="bicubic",
                 semantics="pil").numpy()
    assert np.abs(np.clip(np.round(got), 0, 255) - ref).max() <= 1.0


def test_pil_nearest():
    x = np.random.RandomState(3).randint(0, 151, size=(300, 400)).astype(np.uint8)
    ref = np.asarray(Image.fromarray(x).resize((128, 128), Image.NEAREST))
    got = resize(torch.from_numpy(x.astype(np.int32)), size=(128, 128), method="nearest",
                 semantics="pil").numpy()
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("stats", ["clip", "imagenet"])
@pytest.mark.parametrize("hw", [(100, 140), (150, 90)])
def test_preprocess_batch(stats, hw):
    rs = np.random.RandomState(4)
    imgs = (rs.rand(2, 3, *hw) * 255).astype(np.float32)
    labels = rs.randint(0, 151, size=(2, *hw)).astype(np.int32)
    x, y = preprocess_batch(torch.from_numpy(imgs), torch.from_numpy(labels), img_size=64,
                            label_size=32, stats=stats)
    jx, jy = jax_preprocess(jnp.asarray(imgs), jnp.asarray(labels), img_size=64, label_size=32,
                            stats=stats)
    assert x.shape == (2, 3, 64, 64) and x.dtype == torch.float32
    assert y.dtype == torch.int32 and np.array_equal(y.numpy(), np.asarray(jy))
    std = (A.CLIP_STD if stats == "clip" else A.IMAGENET_STD)[None, :, None, None]
    assert np.abs((x.numpy() - np.asarray(jx)) * std * 255).max() < 1e-3


def test_compact_ids():
    labels = np.random.RandomState(5).choice([0, 5, 17, 92], size=(2, 16, 16)).astype(np.int32)
    got = compact_ids(torch.from_numpy(labels), num_classes=151)
    want = jax_compact_ids(jnp.asarray(labels), num_classes=151)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert int(got[2]) == 4 and np.array_equal(got[1].numpy()[got[0].numpy()], labels)
