"""``lc2is_tpu_torch/data/native_loader.py`` (the port's C++ decode pool,
built from ``lc2is_tpu_torch/native/loader.cpp``) against
``lc2is_tpu/data/native_loader.py`` on a JPEG/PNG tree the test writes:

- images (bilinear, RGB) and labels (nearest, grayscale) equal to JAX's
  native output bit for bit, at several sizes and thread counts, and the
  batcher's arrays too;
- against the port's PIL function by ``tests/test_native_loader.py:53-62``'s
  rule: a lossless PNG at its own size decodes to its pixels exactly; a
  nearest label resize invents no class id;
- a missing file raises ``IOError``, a channel count or size the C code
  does not take ``ValueError``; a source that does not compile raises with
  g++'s output (no quiet switch to PIL, unlike JAX).
"""

import numpy as np
import pytest
from PIL import Image

from lc2is_tpu.data import native_loader as JN
from lc2is_tpu_torch.data import native_loader as N


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("native")
    rng = np.random.RandomState(0)
    jpgs, pngs, rgb_pngs = [], [], []
    for i in range(5):
        arr = (rng.rand(120 + i * 17, 90 + i * 23, 3) * 255).astype(np.uint8)
        p = str(tmp / f"img{i}.jpg")
        Image.fromarray(arr).save(p, quality=90)
        jpgs.append(p)
        q = str(tmp / f"rgb{i}.png")
        Image.fromarray(arr).save(q)
        rgb_pngs.append(q)
        lab = rng.randint(0, 151, (70 + i * 9, 100 - i * 5)).astype(np.uint8)
        q = str(tmp / f"lab{i}.png")
        Image.fromarray(lab).save(q)
        pngs.append(q)
    return jpgs, rgb_pngs, pngs


def test_jax_reference_is_native():
    assert JN.native_available(), "the JAX package's native library should build here"


@pytest.mark.parametrize("size,threads", [((64, 64), 1), ((128, 96), 4), ((200, 150), 0)])
def test_equal_to_jax_native(files, size, threads):
    jpgs, rgb_pngs, pngs = files
    assert JN.native_available()
    for paths, channels, nearest in ((jpgs, 3, False), (rgb_pngs, 3, False), (jpgs, 3, True),
                                     (pngs, 1, True), (pngs, 1, False)):
        got = N.decode_resize_batch(paths, size, channels, nearest=nearest, num_threads=threads)
        want = JN.decode_resize_batch(paths, size, channels, nearest=nearest,
                                      num_threads=threads)
        assert got.shape == (len(paths), *size, channels) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_batcher_equal_to_jax(files):
    jpgs, _, pngs = files
    got = N.NativeADE20KBatcher(img_size=96, label_size=48, num_threads=2)(jpgs[:4], pngs[:4])
    want = JN.NativeADE20KBatcher(img_size=96, label_size=48, num_threads=2)(jpgs[:4], pngs[:4])
    assert got[0].shape == (4, 3, 96, 96) and got[1].shape == (4, 48, 48)
    assert got[1].dtype == np.int32
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_against_pil(files, tmp_path):
    """A lossless PNG at its own size: the pixels exactly, natively and by
    PIL; a nearest label resize keeps to the label's ids."""
    arr = (np.random.RandomState(1).rand(64, 48, 3) * 255).astype(np.uint8)
    p = str(tmp_path / "x.png")
    Image.fromarray(arr).save(p)
    for nearest in (True, False):
        np.testing.assert_array_equal(N.decode_resize_batch([p], (64, 48), 3, nearest)[0], arr)
        np.testing.assert_array_equal(N.decode_resize_batch_pil([p], (64, 48), 3, nearest)[0],
                                      arr)
    _, _, pngs = files
    orig = np.asarray(Image.open(pngs[0]))
    for fn in (N.decode_resize_batch, N.decode_resize_batch_pil):
        labs = fn(pngs[:1], (40, 40), 1, True)
        assert labs.shape == (1, 40, 40, 1)
        assert set(np.unique(labs)) <= set(np.unique(orig))


def test_missing_file_raises(files, tmp_path):
    jpgs, _, _ = files
    missing = str(tmp_path / "nope.jpg")
    with pytest.raises(IOError, match="nope.jpg"):
        N.decode_resize_batch([jpgs[0], missing], (32, 32), 3)
    for channels, size in ((2, (32, 32)), (3, (0, 32))):  # checked before the C call
        with pytest.raises(ValueError, match="channels"):
            N.decode_resize_batch(jpgs[:1], size, channels)


def test_build_failure_raises(tmp_path, monkeypatch):
    broken = tmp_path / "loader.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(N, "SOURCE", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        N.build()
    assert not N.library_path().exists()
