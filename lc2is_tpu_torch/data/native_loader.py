"""The native C++ decode pool, counterpart of
``lc2is_tpu/data/native_loader.py``: JPEG/PNG decode and resize of a whole
batch on C++ threads into one caller-owned ``uint8`` buffer
(``lc2is_tpu_torch/native/loader.cpp``, bound with ``ctypes``).

The library is built from the package's own source at first use with g++
and ``native/build.sh``'s flags (``-O3 -march=native``, libjpeg, libpng,
zlib, pthreads) into ``build/lc2is_tpu_torch/`` at the repository root
(git-ignored), named by a hash of the source, the flags and the host's CPU
(a ``-march=native`` library is built for the CPU it runs on), and rebuilt
only when one of them changes.

One difference from JAX, by design: where the library cannot be built or
loaded, :func:`decode_resize_batch` raises with the compiler's output
instead of switching quietly to PIL.  The PIL path is a function of its
own, :func:`decode_resize_batch_pil`, which a caller picks by name.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from lc2is_tpu_torch.ops._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[1] / "native" / "loader.cpp"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
LINK_LIBS = ("-ljpeg", "-lpng", "-lz", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _cpu_model() -> str:
    """The host CPU's model name ("" where /proc/cpuinfo has none)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return ""


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS + LINK_LIBS).encode())
    h.update(_cpu_model().encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"liblc2is_loader_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the decode pool unless the library for this source exists;
    raises ``RuntimeError`` with the compiler's output where g++ fails."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        out = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE), *LINK_LIBS],
                             capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"building the native decode pool ({SOURCE}) failed: {e}") from e
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({out.returncode}) building the native decode pool "
                           f"from {SOURCE}:\n{out.stdout}\n{out.stderr}")
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded decode pool (built at first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.lc2is_decode_resize_batch.restype = ctypes.c_int
            lib.lc2is_decode_resize_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
            _lib = lib
    return _lib


def decode_resize_batch(paths: Sequence[str], out_hw: Tuple[int, int], channels: int = 3,
                        nearest: bool = False, num_threads: int = 0) -> np.ndarray:
    """Decode and resize a batch into one (N, H, W, C) ``uint8`` array on the
    C++ threads (``num_threads`` 0: one a core): channels 3 RGB, 1
    grayscale; bilinear at half-pixel centres, or ``nearest``
    (``floor(i · in / out)``, labels).  Raises ``IOError`` naming the first
    file that fails to decode."""
    n = len(paths)
    oh, ow = out_hw
    if channels not in (1, 3) or oh < 1 or ow < 1:
        raise ValueError(f"channels must be 1 or 3 and the size positive, got {channels}, "
                         f"{out_hw}")
    out = np.empty((n, oh, ow, channels), dtype=np.uint8)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    rc = library().lc2is_decode_resize_batch(
        arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), oh, ow, channels,
        int(nearest), num_threads)
    if rc != 0:
        raise IOError(f"native decode failed for {paths[-rc - 1]}")
    return out


def decode_resize_batch_pil(paths: Sequence[str], out_hw: Tuple[int, int], channels: int = 3,
                            nearest: bool = False) -> np.ndarray:
    """The same batch decoded and resized by PIL, one image after another
    (JAX's fallback, ``lc2is_tpu/data/native_loader.py:82-92``): PIL's
    bilinear filters over the source's extent where it shrinks, so it
    agrees with :func:`decode_resize_batch` exactly on a lossless image at
    its own size and within a few levels elsewhere."""
    from PIL import Image

    n = len(paths)
    oh, ow = out_hw
    out = np.empty((n, oh, ow, channels), dtype=np.uint8)
    for i, p in enumerate(paths):
        im = Image.open(p).convert("RGB" if channels == 3 else "L")
        im = im.resize((ow, oh), Image.NEAREST if nearest else Image.BILINEAR)
        a = np.asarray(im, dtype=np.uint8)
        out[i] = a if channels == 3 else a[..., None]
    return out


class NativeADE20KBatcher:
    """The fixed-shape fast path: image and label paths -> (pixels uint8
    (N, 3, H, W), labels int32 (N, h, w)), ready for the on-device
    preprocessing (``data/preprocess.py``)."""

    def __init__(self, img_size: int = 512, label_size: Optional[int] = None,
                 num_threads: int = 0):
        self.img_size = img_size
        self.label_size = label_size or img_size
        self.num_threads = num_threads

    def __call__(self, img_paths: List[str], label_paths: List[str]):
        imgs = decode_resize_batch(img_paths, (self.img_size, self.img_size), 3,
                                   nearest=False, num_threads=self.num_threads)
        labels = decode_resize_batch(label_paths, (self.label_size, self.label_size), 1,
                                     nearest=True, num_threads=self.num_threads)
        return imgs.transpose(0, 3, 1, 2), labels[..., 0].astype(np.int32)
