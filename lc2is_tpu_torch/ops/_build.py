"""Build the Hopper kernels of ``lc2is_tpu_torch/csrc`` and bind them.

Each ``csrc/*.cu`` file compiles to an object with its own ``nvcc``
process, all started together, and one more ``nvcc`` links them into one
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds to a minute or two, not many minutes), which ``ctypes``
loads.  The library is named by a hash of the sources and flags and kept in
``build/lc2is_tpu_torch/`` at the repository root (git-ignored): it is built
at first use and rebuilt only when a source changes.

Every C entry point takes its pointers and the stream as ``c_void_p`` and
returns ``cudaGetLastError()`` after its launch (or its first failing
launch, for an entry point that launches a sequence); :func:`launch` raises
when that is not 0, so a launch that CUDA refuses never passes silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "lc2is_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of every entry point (see the extern "C" signatures in csrc/)
SIGNATURES = {
    "lc2_fused_mlp": [_I] + [_P] * 10 + [_I] * 6 + [_F, _P],
    "lc2_attn_block": [_I] + [_P] * 11 + [_I] * 5 + [_F, _P],
    "lc2_attn_block_bwd": [_I] + [_P] * 19 + [_I] * 5 + [_F, _P],
    "lc2_upsample": [_I, _P, _P] + [_I] * 5 + [_P],
    "lc2_upsample_adjoint": [_I, _P, _P] + [_I] * 5 + [_P],
    "lc2_swin_window": [_I] + [_P] * 10 + [_I] * 8 + [_F, _P],
    "lc2_swin_window_bwd": [_I] + [_P] * 17 + [_I] * 8 + [_F, _P],
    "lc2_fused_ce": [_I, _P, _P, _I] + [_P] * 3 + [_I] * 7 + [_P],
    "lc2_score_upsample_argmax": [_I] + [_P] * 4 + [_I] * 6 + [_F, _P],
    "lc2_upsample_argmax": [_I, _P, _P, _P] + [_I] * 5 + [_P],
    "lc2_fused_mlp_q": [_I] + [_P] * 11 + [_I] * 6 + [_F, _P],
    "lc2_attn_block_q": [_I] + [_P] * 13 + [_I] * 5 + [_F, _P],
    "lc2_swin_window_q": [_I] + [_P] * 11 + [_I] * 8 + [_F, _P],
    "lc2_flash_attention": [_I] + [_P] * 6 + [_I] * 5 + [_F, _P],
    "lc2_flash_attention_bwd": [_I] + [_P] * 10 + [_I] * 5 + [_F, _P],
    "lc2_window_attention": [_I] + [_P] * 6 + [_I] * 4 + [_P],
}
# entry points returning a size (floats of scratch a kernel needs)
SIZE_SIGNATURES = {
    "lc2_swin_window_workspace_bf16": [_I] * 6,
    "lc2_swin_window_workspace_f32": [_I] * 6,
    "lc2_swin_window_bwd_workspace": [_I] * 5,
    "lc2_swin_window_bwd_workspace_bf16": [_I] * 5,
    "lc2_attn_block_bwd_workspace": [_I] * 5,
    "lc2_attn_block_bwd_workspace_bf16": [_I] * 5,
    "lc2_attn_block_fwd_workspace_bf16": [_I] * 5,
    "lc2_attn_block_fwd_workspace_f32": [_I] * 5,
    "lc2_fused_mlp_workspace_bf16": [_I] * 4,
    "lc2_fused_mlp_workspace_f32": [_I] * 4,
    "lc2_fused_mlp_q_workspace_bf16": [_I] * 4,
    "lc2_attn_block_q_workspace_bf16": [_I] * 5,
    "lc2_fused_ce_partials": [_I] * 6,
    "lc2_upsample_argmax_workspace": [_I] * 5,
}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "Hopper kernels are built on the machine with the card")
    return path


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"liblc2is_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Tuple[Path, str]:
    """Compile the kernels unless the library for these sources exists.
    Returns (library path, compiler output); ``verbose`` adds ptxas's
    per-kernel register / shared-memory / spill report to the output."""
    so = _library_path()
    if so.exists():
        return so, ""
    objdir = BUILD_DIR / f"{so.stem}.{os.getpid()}.obj"
    objdir.mkdir(parents=True, exist_ok=True)
    tool = nvcc()
    extra = ("-Xptxas", "-v") if verbose else ()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = objdir / f"{src.stem}.o"
        jobs.append((obj, subprocess.Popen(
            [tool, *NVCC_FLAGS, *extra, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for obj, proc in jobs:
        out = proc.communicate()[0]
        log.append(out)
        if proc.returncode != 0:
            failed.append(f"{obj.stem}.cu ({proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    link = subprocess.run([tool, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o",
                           str(tmp), *(str(obj) for obj, _ in jobs)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}\n{link.stderr}")
    os.replace(tmp, so)
    shutil.rmtree(objdir, ignore_errors=True)
    return so, "".join(log) + link.stdout + link.stderr


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()[0]))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            for name, argtypes in SIZE_SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_longlong
            lib.lc2_error_string.argtypes = [ctypes.c_int]
            lib.lc2_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call entry point ``name`` with ``device`` current (the entry points
    launch on the current device); raise if it reports a CUDA error."""
    lib = library()
    with torch.cuda.device(device):
        err = getattr(lib, name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} ({lib.lc2_error_string(err).decode()})")


def size(name: str, *args) -> int:
    """Value of size entry point ``name`` (scratch floats for a launch)."""
    return int(getattr(library(), name)(*args))


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def contiguous16(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and starting on a 16-byte boundary, as the bf16
    bodies' 16-byte ``cp.async`` loads need: a copy only where it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """``t``'s data pointer, or None (a null pointer) for no tensor."""
    return None if t is None else t.data_ptr()


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[t.dtype]


def check_operands(device: torch.device, **operands) -> None:
    """Raise unless each ``name=(tensor, shape)`` lies on ``device`` with that
    shape: a kernel trusts the pointers and sizes it is given."""
    for name, (t, shape) in operands.items():
        if t.device != device or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected {tuple(shape)} on {device}, "
                             f"got {tuple(t.shape)} on {t.device}")
