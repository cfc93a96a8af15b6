#!/usr/bin/env python3
"""Time the port's decoder attention backward (``fused_attn_block_bwd``, TPU
row 3) and swin window block (``swin_window_block``, TPU rows 6 and 9) at the
main-path shapes on one NVIDIA GPU, with rows 2 (``fused_attn_block``) and 7
(``swin_window_block_bwd``) and the f32 bodies as controls: CUDA-event
medians of a call, and the device time of its kernels (torch.profiler; the
event time also holds the wrapper's host work when the kernels are
shorter than it).

    python3 scripts/torch_block_ab.py [ROOT] [--tag NAME]

ROOT is a checkout of this repository (default: the one holding this
script); only the sources of those kernels are built (``attention_block*.cu``,
``swin_window*.cu``, ``runtime.cu`` and the headers, into
``build/block_ab/`` of that checkout), so two versions compare on one card
by running the script on each in turns, e.g. parent, change, change,
parent.  Each bf16 case is also held against its plain version: row 3's
worst ‖Δ‖/‖plain‖ over its nine gradients (autograd through the plain
version), row 6's largest |Δ|.  Fails without a CUDA device.
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

# row 3: the decoder's (P, L) pairs of a batch-8 512² training step (SR
# self-attention and cross-attention over 151 classes), 512 wide, 8 heads,
# and their launches a step
ATTN_SHAPES = [(256, 64, 1), (256, 151, 1), (1024, 256, 2), (1024, 151, 2), (4096, 1024, 3),
               (4096, 151, 3)]
# row 6: the swin-small stages of a batch-16 512² forward (grid, C, heads,
# blocks a shift); stage 4 (row 9) runs on no path and is one call
SWIN_STAGES = [(128, 96, 3, 1), (64, 192, 6, 1), (32, 384, 12, 9), (16, 768, 24, 1)]


def time_ms(fn, reps=10, warmup=2):
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


def device_ms(fn, reps=5):
    """The device time of fn()'s kernels, from torch.profiler: the sum over
    every kernel it launches, a mean over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.time_range.end - e.time_range.start for e in kernels) / reps / 1e3


def load_port(root: Path):
    """Import ROOT's lc2is_tpu_torch with a library built from the block
    kernels' sources only."""
    sys.path.insert(0, str(root))
    from lc2is_tpu_torch.ops import _build
    src = root / "build" / "block_ab" / "csrc"
    shutil.rmtree(src, ignore_errors=True)
    src.mkdir(parents=True)
    for p in (list(_build.CSRC.glob("*.cuh")) + [_build.CSRC / "runtime.cu"]
              + list(_build.CSRC.glob("attention_block*.cu"))
              + list(_build.CSRC.glob("swin_window*.cu"))):
        shutil.copy(p, src / p.name)
    _build.CSRC = src
    _build.BUILD_DIR = src.parent / "lib"
    keep = ("lc2_attn_block", "lc2_swin_window")
    _build.SIGNATURES = {k: v for k, v in _build.SIGNATURES.items() if k.startswith(keep)}
    _build.SIZE_SIGNATURES = {k: v for k, v in _build.SIZE_SIGNATURES.items()
                              if k.startswith(keep)}
    _build.library()
    from lc2is_tpu_torch.ops import attention_block as ab
    from lc2is_tpu_torch.ops import swin_window as sw
    return _build, ab, sw


def rand(rs, *shape, scale=1.0, offset=0.0, dtype=torch.float32):
    return torch.from_numpy((offset + scale * rs.standard_normal(shape)).astype(np.float32)
                            ).to("cuda", dtype)


def attn_args(rs, b, p, l, dt, c=512):
    return [rand(rs, b, p, c, dtype=dt), rand(rs, b, l, c, dtype=dt), rand(rs, b, l, c, dtype=dt),
            rand(rs, c, c, scale=c ** -0.5), rand(rs, c, scale=0.1), rand(rs, c, c, scale=c ** -0.5),
            rand(rs, c, scale=0.1), rand(rs, c, scale=0.1, offset=1.0), rand(rs, c, scale=0.1)]


def swin_args(rs, b, grid, c, heads, dt):
    return [rand(rs, b, grid, grid, c, dtype=dt), rand(rs, c, scale=0.1, offset=1.0),
            rand(rs, c, scale=0.1), rand(rs, 3 * c, c, scale=c ** -0.5), rand(rs, 3 * c, scale=0.1),
            rand(rs, c, c, scale=c ** -0.5), rand(rs, c, scale=0.1),
            rand(rs, heads, 49, 49, scale=0.1)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_block_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    root = Path(args.root).resolve()
    tag = args.tag or root.name
    build, ab, sw = load_port(root)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[{tag}] {root} on {smi}", flush=True)
    for name in sorted(build.SIZE_SIGNATURES):
        if name.startswith("lc2_attn_block_bwd_workspace"):
            print(f"[{tag}] {name} (8, 4096, 512) L1024 h8: "
                  f"{4 * build.size(name, 8, 4096, 1024, 512, 8)} bytes", flush=True)
    rs = np.random.RandomState(0)
    total = {}

    def report(row, label, dt, ms, count, ops, fn, note=""):
        key = (row, str(dt).split(".")[-1])
        with torch.no_grad():
            dev = device_ms(fn)
        ev, dv = total.get(key, (0.0, 0.0))
        total[key] = (ev + count * ms, dv + count * dev)
        print(f"[{tag}] row {row:2s} {key[1]:8s} {label:34s} {ms:8.3f} ms, device {dev:7.3f} "
              f"x{count} ({ops / dev / 1e9:6.1f} TFLOP/s on the device){note}", flush=True)

    # row 3 and row 2 (its forward, a control), bf16 at every shape, f32 at two
    for dt in (torch.bfloat16, torch.float32):
        for p, l, n in ATTN_SHAPES if dt == torch.bfloat16 else ATTN_SHAPES[:2]:
            b = 8
            a = attn_args(rs, b, p, l, dt)
            g = rand(rs, b, p, 512, dtype=dt)
            wq_s, bq_s = ab.fold_q_scale(a[3], a[4], 8)
            fwd_ops = 4 * b * p * 512 * 512 + 4 * b * p * l * 512

            def bwd(a=a, g=g, wq_s=wq_s, bq_s=bq_s):
                return ab.fused_attn_block_bwd(a[0], a[1], a[2], g, wq_s, bq_s, *a[5:], 8)

            with torch.no_grad():
                ms = time_ms(bwd)
            note = ""
            if dt == torch.bfloat16:
                ka = [t.detach().clone().requires_grad_() for t in a]
                pa = [t.detach().clone().requires_grad_() for t in a]
                got = torch.autograd.grad(ab.fused_attn_block(*ka, 8), ka, g)
                want = torch.autograd.grad(ab.fused_attn_block_plain(*pa, 8), pa, g)
                rel = max(((x.float() - y.float()).norm() / y.float().norm().clamp_min(1e-30)
                           ).item() for x, y in zip(got, want))
                note = f" rel {rel:.2e}"
                del ka, pa, got, want
            report("3", f"({b},{p},512) L{l} h8", dt, ms, n, 3 * fwd_ops, bwd, note)
            if dt == torch.bfloat16:
                with torch.no_grad():
                    ms = time_ms(lambda: ab.fused_attn_block(*a, 8), reps=20)
                report("2", f"({b},{p},512) L{l} h8", dt, ms, n, fwd_ops,
                       lambda: ab.fused_attn_block(*a, 8))
            del a, g
            torch.cuda.empty_cache()

    # row 6 (stages 1-3) and row 9 (stage 4), bf16 b16 every shape, f32 at
    # stage 3; row 7 (the swin backward, a control) at b8
    for dt in (torch.bfloat16, torch.float32):
        for s, (grid, c, heads, n) in enumerate(SWIN_STAGES):
            if dt == torch.float32 and s != 2:
                continue
            a = swin_args(rs, 16, grid, c, heads, dt)
            tok = 16 * (-(-grid // 7) * 7) ** 2
            ops = 8 * tok * c * c + 4 * tok * 49 * c
            for shift in (0, 3):
                with torch.no_grad():
                    ms = time_ms(lambda: sw.swin_window_block(*a, heads, 7, shift), reps=20)
                    note = ""
                    if dt == torch.bfloat16:
                        d = (sw.swin_window_block(*a, heads, 7, shift).float()
                             - sw.swin_window_block_plain(*a, heads, 7, shift).float()).abs()
                        note = f" max|Δ| {d.max().item():.2e}"
                report("6" if s < 3 else "9", f"stage{s + 1} (16,{grid},{grid},{c}) shift{shift}",
                       dt, ms, n, ops, lambda: sw.swin_window_block(*a, heads, 7, shift), note)
            if dt == torch.bfloat16 and s < 3:
                a8 = [a[0][:8].contiguous()] + a[1:]
                g8 = rand(rs, 8, grid, grid, c, dtype=dt)
                wq_s, bq_s = sw.fold_q_scale(a[3], a[4], heads)
                def swin_bwd(a8=a8, g8=g8, wq_s=wq_s, bq_s=bq_s, heads=heads):
                    return sw.swin_window_block_bwd(a8[0], g8, a8[1], a8[2], wq_s, bq_s,
                                                    *a8[5:], heads, 7, 3, residual=False)

                with torch.no_grad():
                    ms = time_ms(swin_bwd, reps=5)
                report("7", f"stage{s + 1} (8,{grid},{grid},{c}) shift3", dt, ms, n, 1.5 * ops,
                       swin_bwd)
                del a8, g8
            del a
            torch.cuda.empty_cache()
    for (row, dt), (ms, dev) in sorted(total.items()):
        print(f"[{tag}] total row {row} {dt}: {ms:.3f} ms, device {dev:.3f} ms "
              f"(launch-weighted)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
