#!/usr/bin/env python3
"""Time the port's flash-attention kernels (lc2is_tpu_torch, forward and
backward) at the v1 shapes on one NVIDIA GPU, beside one PyTorch SDPA call
(and its backward) on the same inputs: CUDA-event medians.

    python3 scripts/torch_flash_ab.py [ROOT] [--tag NAME] [--dtype bf16|f32]

ROOT is a checkout of this repository (default: the one holding this
script); only its flash sources are built (``csrc/flash_attention*.cu``,
``runtime.cu`` and the headers, into ``build/flash_ab/`` of that checkout),
so two versions compare on one card by running the script on each in
turns, e.g. parent, change, change, parent.  Each case is also held
against the plain versions: the forward's largest error relative to
max|plain| and the backward's worst ‖Δ‖/‖plain‖ of dq, dk, dv are printed,
in f32 beside the 3xTF32 rule (1e-5 of each).  ``--dtype f32`` times the f32
bodies with TF32 off (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` False), SDPA too, and names the backend
SDPA chose for each case.  The sums over the 13 launches of a batch-16 512²
BaseModelWithText forward (12 ViT-B/16 layers and the decoder's
self-attention) and of a v1 training step are printed last.
Fails without a CUDA device.
"""

from __future__ import annotations

import argparse
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

# (B, H, Lq, Lk, D, masked): the ViT-B/16 layer and the v1 decoder's
# self-attention of a batch-16 512² BaseModelWithText, a key-padding mask
# keeping 512-1024 keys, the v1 cross-attention over 77 text keys, D 48, 128
SHAPES = [(16, 12, 1025, 1025, 64, False), (16, 8, 1024, 1024, 96, False),
          (16, 8, 1024, 1024, 96, True), (16, 8, 1024, 77, 96, True),
          (16, 8, 1024, 1024, 48, False), (16, 8, 1024, 1024, 128, False)]
# launches of each shape per BaseModelWithText forward and per v1 step
PER_PASS = {SHAPES[0]: 12, SHAPES[1]: 1}
F32X3_REL = 1e-5  # the 3xTF32 rule of chip_smoke.py: forward and each gradient
PEAK_F32_OPS = 495e12 / 3  # 3xTF32: a third of the H100's dense TF32 rate


def sdpa_backend(q, k, v, am):
    """The name of the backend SDPA picks for these inputs."""
    try:
        from torch.nn.attention import SDPBackend
        return SDPBackend(torch._fused_sdp_choice(q, k, v, am, 0.0, False)).name
    except Exception as e:  # an older torch: say so
        return f"unknown ({type(e).__name__})"


def time_ms(fn, reps=20, warmup=3):
    """Median of ``reps`` CUDA-event timings of fn() after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def load_port(root: Path):
    """Import ROOT's lc2is_tpu_torch with a library built from its flash
    sources only."""
    sys.path.insert(0, str(root))
    from lc2is_tpu_torch.ops import _build
    src = root / "build" / "flash_ab" / "csrc"
    shutil.rmtree(src, ignore_errors=True)
    src.mkdir(parents=True)
    for p in list(_build.CSRC.glob("*.cuh")) + [_build.CSRC / "runtime.cu"] + \
            list(_build.CSRC.glob("flash_attention*.cu")):
        shutil.copy(p, src / p.name)
    _build.CSRC = src
    _build.BUILD_DIR = src.parent / "lib"
    _build.SIGNATURES = {k: v for k, v in _build.SIGNATURES.items() if "flash" in k}
    _build.SIZE_SIGNATURES = {}
    _build.library()
    from lc2is_tpu_torch.ops import flash_attention as fa
    return fa


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--tag", default="")
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_flash_ab: no CUDA device", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    root = Path(args.root).resolve()
    tag = args.tag or root.name
    fa = load_port(root)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    dt = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[{tag}] {root} on {smi}, {dt}, TF32 off", flush=True)
    rs = np.random.RandomState(0)
    totals = np.zeros(6)  # forward, SDPA, backward, SDPA's backward, their f32 bounds
    for b, h, lq, lk, d, masked in SHAPES:
        q, k, v, g = (torch.from_numpy(rs.standard_normal((b, h, n, d)).astype(np.float32))
                      .to("cuda", dt) for n in (lq, lk, lk, lq))
        mask = None
        if masked:
            keep = torch.from_numpy(rs.randint(lk // 2, lk + 1, size=b)).cuda()
            mask = torch.arange(lk, device="cuda")[None] >= keep[:, None]
        am = None if mask is None else ~mask[:, None, None, :]
        with torch.no_grad():
            out, lse = fa.flash_attention(q, k, v, mask, with_stats=True)
            want = fa.flash_attention_plain(q, k, v, mask).float()
            err = ((out.float() - want).abs().max() / want.abs().max()).item()
            f_ms = time_ms(lambda: fa.flash_attention(q, k, v, mask))
            s_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am))
            got = fa.flash_attention_bwd(q, k, v, mask, out, lse, g)
            ref = fa.flash_attention_backward_plain(q, k, v, mask, out, lse, g)
            rel = max(((a.float() - r.float()).norm() / r.float().norm()).item()
                      for a, r in zip(got, ref))
            b_ms = time_ms(lambda: fa.flash_attention_bwd(q, k, v, mask, out, lse, g), reps=10)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o = F.scaled_dot_product_attention(*leaves, attn_mask=am)
        sb_ms = time_ms(lambda: torch.autograd.grad(o, leaves, g, retain_graph=True), reps=10)
        keys = b * lk if mask is None else int((~mask).sum())
        fwd_ops = 4 * h * lq * d * keys
        rule = ""
        if dt == torch.float32:
            rule = (f" [3xTF32 rule {F32X3_REL}: forward "
                    f"{'ok' if err <= F32X3_REL else 'FAIL'}, backward "
                    f"{'ok' if rel <= F32X3_REL else 'FAIL'}]")
        print(f"[{tag}] ({b},{h},{lq},{lk},{d}){' masked' if masked else '':7s} forward "
              f"{f_ms:.3f} ms ({fwd_ops / f_ms / 1e9:.1f} TFLOP/s) SDPA {s_ms:.3f} "
              f"({f_ms / s_ms:.2f}x, {sdpa_backend(q, k, v, am)}) err {err:.2e} | backward "
              f"{b_ms:.3f} ms ({2.5 * fwd_ops / b_ms / 1e9:.1f} TFLOP/s over 5 products) SDPA's "
              f"backward {sb_ms:.3f} ({b_ms / sb_ms:.2f}x) rel {rel:.2e}{rule}", flush=True)
        n = PER_PASS.get((b, h, lq, lk, d, masked), 0)
        bound = fwd_ops / PEAK_F32_OPS * 1e3  # ms; the backward's five products: 2.5x
        totals += n * np.array([f_ms, s_ms, b_ms, sb_ms, bound, 2.5 * bound])
        del q, k, v, g, out, lse, want, got, ref, leaves, o
        torch.cuda.empty_cache()
    print(f"[{tag}] {dt} sums over the 13 launches (12 ViT-B/16 layers, the decoder's "
          f"self-attention): forward {totals[0]:.3f} ms (SDPA {totals[1]:.3f}), backward "
          f"{totals[2]:.3f} ms (SDPA's backward {totals[3]:.3f}); f32 bounds (operations at "
          f"{PEAK_F32_OPS / 1e12:.0f} T/s) {totals[4]:.3f} and {totals[5]:.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
