#!/usr/bin/env python3
"""Time the port's block kernels at the main-path shapes on one NVIDIA GPU:
the feed-forward (``fused_mlp``, TPU row 1) and the decoder attention
forward (``fused_attn_block``, row 2) at the shapes of a batch-16 512²
serving forward and of a batch-8 training step's forward, the served mask
head (``score_upsample_argmax``, row 12) at a batch-16 forward's shape, the
fused upsample cross-entropy (``upsampled_cross_entropy``, rows 13-14) at a
batch-8 flagship step's two shapes (the call timed with the wrapper's
copies, and with autograd's backward), their int8 twins
(``fused_mlp_q``, row 17; ``fused_attn_block_q``, row 2q) at the shapes of a
batch-16 int8 serving forward, beside ``torch._int_mm`` at the decoder's two
int8 product shapes (a yardstick only, on no path), window attention
(``window_attention``, row 8), the swin window block's backward
(``swin_window_block_bwd``, rows 7 and 10), the decoder attention backward
(``fused_attn_block_bwd``, row 3) and the swin window block
(``swin_window_block``, rows 6 and 9), with the f32 bodies as controls:
CUDA-event medians of a call, and the device time of its kernels
(torch.profiler; the event time also holds the wrapper's host work when the
kernels are shorter than it).  Row 8 is timed beside one SDPA call with the
bias and region mask as its additive mask (``scaled_dot_product_attention``,
a yardstick only).

    python3 scripts/torch_block_ab.py [ROOT] [--tag NAME] [--rows 1,2,2q,3,6,7,8,12,13,17]

ROOT is a checkout of this repository (default: the one holding this
script); only the sources of those kernels are built (``fused_mlp*.cu``,
``attention_block*.cu``, ``swin_window*.cu``, ``window_attention.cu``,
``upsample_argmax.cu``, ``fused_ce.cu``, ``runtime.cu`` and the headers,
into ``build/block_ab/`` of that checkout),
so two versions compare on one card by running the script on each in
turns, e.g. parent, change, change, parent.  ``--rows`` picks the rows
timed (all by default; rows 9 and 10 come with 6 and 7).  Each bf16 case is
also held against its plain version: rows 3 and 7 by their worst
‖Δ‖/‖plain‖ over their gradients (autograd through the plain version), rows
1, 2, 6 and 8 by their largest |Δ|, rows 2q and 17 by their largest |Δ| over
max |plain|, row 12 by the pixels whose mask differs, row 13 by its loss's
relative error and its gradient's ‖Δ‖/‖plain‖.  The workspace bytes of rows 1, 2, 2q, 3, 7 and 17 are printed
at their largest main-path shape.  Fails without a CUDA device.
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

# rows 2 and 3: the decoder's (P, L) pairs of a 512² forward (SR
# self-attention and cross-attention over 151 classes), 512 wide, 8 heads,
# and their launches a forward (row 2 at batch 16 and 8) or a step (row 3,
# batch 8); DenseClip's prompt decoder (151 queries over 151 and 1025 keys)
# is one call a shape, not summed
ATTN_SHAPES = [(256, 64, 1), (256, 151, 1), (1024, 256, 2), (1024, 151, 2), (4096, 1024, 3),
               (4096, 151, 3)]
DENSECLIP_ATTN_SHAPES = [(151, 151), (151, 1025)]
# row 1: (tokens of one image, C, F, activation, LN position, launches a
# forward; None: not summed), at batch 16 (serving) and 8 (a step's forward,
# which also writes the pre-activation): the swin stages 1-3, the decoder
# layers, then stage 4 (on no path) and the v1 decoders' shapes
MLP_SHAPES = [(128 * 128, 96, 384, "gelu", "pre", 2), (64 * 64, 192, 768, "gelu", "pre", 2),
              (32 * 32, 384, 1536, "gelu", "pre", 18), (256, 512, 2048, "relu", "post", 1),
              (1024, 512, 2048, "relu", "post", 2), (4096, 512, 2048, "relu", "post", 3),
              (16 * 16, 768, 3072, "gelu", "pre", None), (1024, 768, 2048, "relu", "pre", None),
              (1025, 768, 2048, "relu", "pre", None), (151, 512, 2048, "relu", "post", None)]
# row 6: the swin-small stages of a batch-16 512² forward (grid, C, heads,
# blocks a shift); stage 4 (row 9) runs on no path and is one call.  Row 7
# runs at the same stages at batch 8 (a training step's launches a shift:
# 1, 1, 9); stage 4 is row 10, one call
SWIN_STAGES = [(128, 96, 3, 1), (64, 192, 6, 1), (32, 384, 12, 9), (16, 768, 24, 1)]
# row 8: window attention at the same stages of a batch-16 512² forward:
# (HF-padded grid, C, heads, blocks a shift), windows of 7 x 7; the 22
# blocks of stages 1-3 are summed, stage 4 apart
WINDOW_STAGES = [(133, 96, 3, 1), (70, 192, 6, 1), (35, 384, 12, 9), (21, 768, 24, 1)]


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


def device_ms(fn, reps=5, tries=3):
    """The device time of fn()'s kernels, from torch.profiler, a mean over
    ``reps`` calls: (the sum over every kernel it launches, {kernel name:
    its share}); (None, {}) when the profiler recorded no kernel in
    ``tries`` attempts (it occasionally returns an empty trace)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            by_name = {}
            for e in kernels:
                name = (e.name.replace("(anonymous namespace)::", "").split("(")[0]
                        .replace("void ", ""))
                by_name[name] = by_name.get(name, 0.0) + (e.time_range.end - e.time_range.start)
            return (sum(by_name.values()) / reps / 1e3,
                    {k: v / reps / 1e3 for k, v in by_name.items()})
    return None, {}


def load_port(root: Path):
    """Import ROOT's lc2is_tpu_torch with a library built from the block
    kernels' sources only."""
    sys.path.insert(0, str(root))
    from lc2is_tpu_torch.ops import _build
    src = root / "build" / "block_ab" / "csrc"
    shutil.rmtree(src, ignore_errors=True)
    src.mkdir(parents=True)
    for p in (list(_build.CSRC.glob("*.cuh")) + [_build.CSRC / "runtime.cu"]
              + list(_build.CSRC.glob("fused_mlp*.cu"))
              + list(_build.CSRC.glob("attention_block*.cu"))
              + list(_build.CSRC.glob("swin_window*.cu"))
              + [_build.CSRC / "window_attention.cu", _build.CSRC / "upsample_argmax.cu",
                 _build.CSRC / "fused_ce.cu"]):
        shutil.copy(p, src / p.name)
    _build.CSRC = src
    _build.BUILD_DIR = src.parent / "lib"
    keep = ("lc2_fused_mlp", "lc2_attn_block", "lc2_swin_window", "lc2_window_attention",
            "lc2_score_upsample_argmax", "lc2_upsample_argmax", "lc2_fused_ce")
    _build.SIGNATURES = {k: v for k, v in _build.SIGNATURES.items() if k.startswith(keep)}
    _build.SIZE_SIGNATURES = {k: v for k, v in _build.SIZE_SIGNATURES.items()
                              if k.startswith(keep)}
    _build.library()
    from lc2is_tpu_torch.ops import attention_block as ab
    from lc2is_tpu_torch.ops import fused_ce as ce
    from lc2is_tpu_torch.ops import fused_mlp as mlp
    from lc2is_tpu_torch.ops import quant
    from lc2is_tpu_torch.ops import swin_window as sw
    from lc2is_tpu_torch.ops import upsample_argmax as ua
    from lc2is_tpu_torch.ops import window_attention as wa
    return _build, ab, mlp, quant, sw, wa, ua, ce


def rand(rs, *shape, scale=1.0, offset=0.0, dtype=torch.float32):
    return torch.from_numpy((offset + scale * rs.standard_normal(shape)).astype(np.float32)
                            ).to("cuda", dtype)


def attn_args(rs, b, p, l, dt, c=512):
    return [rand(rs, b, p, c, dtype=dt), rand(rs, b, l, c, dtype=dt), rand(rs, b, l, c, dtype=dt),
            rand(rs, c, c, scale=c ** -0.5), rand(rs, c, scale=0.1), rand(rs, c, c, scale=c ** -0.5),
            rand(rs, c, scale=0.1), rand(rs, c, scale=0.1, offset=1.0), rand(rs, c, scale=0.1)]


def mlp_args(rs, t, c, f, dt):
    return [rand(rs, t, c, dtype=dt), rand(rs, c, scale=0.1, offset=1.0), rand(rs, c, scale=0.1),
            rand(rs, f, c, scale=c ** -0.5), rand(rs, f, scale=0.1), rand(rs, c, f, scale=f ** -0.5),
            rand(rs, c, scale=0.1)]


def swin_args(rs, b, grid, c, heads, dt):
    return [rand(rs, b, grid, grid, c, dtype=dt), rand(rs, c, scale=0.1, offset=1.0),
            rand(rs, c, scale=0.1), rand(rs, 3 * c, c, scale=c ** -0.5), rand(rs, 3 * c, scale=0.1),
            rand(rs, c, c, scale=c ** -0.5), rand(rs, c, scale=0.1),
            rand(rs, heads, 49, 49, scale=0.1)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--tag", default="")
    ap.add_argument("--rows", default="1,2,2q,3,6,7,8,12,13,17")
    args = ap.parse_args()
    rows = set(args.rows.split(","))
    if not torch.cuda.is_available():
        print("torch_block_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    root = Path(args.root).resolve()
    tag = args.tag or root.name
    build, ab, mlp, quant, sw, wa, ua, ce = load_port(root)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[{tag}] {root} on {smi}", flush=True)
    for name in sorted(build.SIZE_SIGNATURES):
        if name == "lc2_attn_block_fwd_workspace_bf16":
            print(f"[{tag}] {name} (16, 4096, 512) L1024 h8: "
                  f"{4 * build.size(name, 16, 4096, 1024, 512, 8)} bytes", flush=True)
        if name == "lc2_fused_mlp_workspace_bf16":
            print(f"[{tag}] {name} (65536, 512) F 2048 post: "
                  f"{4 * build.size(name, 65536, 512, 2048, 0)} bytes", flush=True)
        if name == "lc2_attn_block_q_workspace_bf16":
            print(f"[{tag}] {name} (16, 4096, 512) L1024 h8: "
                  f"{4 * build.size(name, 16, 4096, 1024, 512, 8)} bytes", flush=True)
        if name == "lc2_fused_mlp_q_workspace_bf16":
            print(f"[{tag}] {name} (65536, 512) F 2048 post: "
                  f"{4 * build.size(name, 65536, 512, 2048, 0)} bytes; (262144, 96) F 384 pre: "
                  f"{4 * build.size(name, 262144, 96, 384, 1)} bytes", flush=True)
        if name.startswith("lc2_attn_block_bwd_workspace"):
            print(f"[{tag}] {name} (8, 4096, 512) L1024 h8: "
                  f"{4 * build.size(name, 8, 4096, 1024, 512, 8)} bytes", flush=True)
        if name.startswith("lc2_swin_window_bwd_workspace"):
            print(f"[{tag}] {name} (8, 128, 128, 96) window 7: "
                  f"{4 * build.size(name, 8, 128, 128, 96, 7)} bytes", flush=True)
    rs = np.random.RandomState(0)
    total = {}

    def report(row, label, dt, ms, count, ops, fn, note="", split=False):
        """Print a case (``split``: and its device time by kernel) and add
        it, times its launches, to its row's totals."""
        key = (row, str(dt).split(".")[-1])
        with torch.no_grad():
            dev, by_name = device_ms(fn)
        ev, dv = total.get(key, (0.0, 0.0))
        # a case whose device time was not measured leaves the device total
        # None ("not measured"), not short
        total[key] = (ev + count * ms, None if dev is None or dv is None else dv + count * dev)
        dev_txt = ("device not measured" if dev is None else
                   f"device {dev:7.3f} x{count} ({ops / dev / 1e9:6.1f} TFLOP/s on the device)")
        print(f"[{tag}] row {row:2s} {key[1]:8s} {label:34s} {ms:8.3f} ms, {dev_txt}{note}",
              flush=True)
        if split and by_name:
            print(f"[{tag}]     by kernel, ms a call: " + ", ".join(
                f"{k} {v:.3f}" for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])),
                flush=True)

    def max_diff(got, want):
        return f" max|Δ| {(got.float() - want.float()).abs().max().item():.2e}"

    # row 1 at batch 16 (serving) and 8 (a step's forward, writing the
    # pre-activation as the training launch does), bf16 at every shape; f32
    # at two shapes of each batch (controls)
    for dt in (torch.bfloat16, torch.float32) if "1" in rows else ():
        for b, train in ((16, False), (8, True)):
            for i, (t, c, f, act, pos, n) in enumerate(MLP_SHAPES):
                if dt == torch.float32 and i not in (2, 4):
                    continue
                if train and n is None:
                    continue
                a = mlp_args(rs, b * t, c, f, dt)

                def run(a=a, act=act, pos=pos, train=train):
                    return mlp._launch(*a, act, pos, True, 1e-5, save_upre=train)[0]

                with torch.no_grad():
                    ms = time_ms(run, reps=20)
                    note = max_diff(run(), mlp.fused_mlp_plain(*a, activation=act, ln_position=pos))
                row = ("1" if n is not None else "1 not summed") + (" step" if train else "")
                report(row, f"({b * t},{c}) F{f} {act} {pos}", dt, ms, n or 1, 4 * b * t * c * f,
                       run, note, split=dt == torch.bfloat16 and not train)
                del a
                torch.cuda.empty_cache()

    # row 2 at batch 16, bf16 at every serving shape and DenseClip's two; f32
    # at two (its batch-8 shapes are timed with row 3 below)
    for dt in (torch.bfloat16, torch.float32) if "2" in rows else ():
        shapes = [(p, l, n) for p, l, n in ATTN_SHAPES] + [(p, l, None)
                                                           for p, l in DENSECLIP_ATTN_SHAPES]
        for i, (p, l, n) in enumerate(shapes):
            if dt == torch.float32 and i not in (0, 1):
                continue
            b = 16
            a = attn_args(rs, b, p, l, dt)
            fwd = lambda a=a: ab.fused_attn_block(*a, 8)
            with torch.no_grad():
                ms = time_ms(fwd, reps=20)
                note = max_diff(fwd(), ab.fused_attn_block_plain(*a, 8))
            report("2" if n is not None else "2 DenseClip", f"({b},{p},512) L{l} h8", dt, ms,
                   n or 1, 4 * b * p * 512 * 512 + 4 * b * p * l * 512, fwd, note,
                   split=dt == torch.bfloat16)
            del a
            torch.cuda.empty_cache()

    def rel_diff(got, want):
        d = (got.float() - want.float()).abs().max().item()
        return f" max|Δ| {d:.2e} = {d / want.float().abs().max().item():.2e} x max|plain|"

    # row 17 (int8 feed-forward) at batch 16, bf16 at every serving shape
    # (stage 4: one call, not summed), f32 at two (controls); row 2q (int8
    # decoder attention) at batch 16, bf16 at every serving shape, f32 at two
    for dt in (torch.bfloat16, torch.float32) if "17" in rows else ():
        for i, (t, c, f, act, pos, n) in enumerate(MLP_SHAPES[:7]):
            if dt == torch.float32 and i not in (2, 4):
                continue
            a = mlp_args(rs, 16 * t, c, f, dt)
            fwd = lambda a=a, act=act, pos=pos: quant.fused_mlp_q(*a, activation=act,
                                                                   ln_position=pos)
            with torch.no_grad():
                ms = time_ms(fwd, reps=20)
                note = rel_diff(fwd(), quant.fused_mlp_q_plain(*a, activation=act,
                                                               ln_position=pos))
            report("17" if n is not None else "17 not summed", f"({16 * t},{c}) F{f} {act} {pos}",
                   dt, ms, n or 1, 4 * 16 * t * c * f, fwd, note, split=dt == torch.bfloat16)
            del a
            torch.cuda.empty_cache()
    for dt in (torch.bfloat16, torch.float32) if "2q" in rows else ():
        for i, (p, l, n) in enumerate(ATTN_SHAPES):
            if dt == torch.float32 and i not in (0, 1):
                continue
            a = attn_args(rs, 16, p, l, dt)
            fwd = lambda a=a: ab.fused_attn_block_q(*a, 8)
            with torch.no_grad():
                ms = time_ms(fwd, reps=20)
                note = rel_diff(fwd(), ab.fused_attn_block_q_plain(*a, 8))
            report("2q", f"(16,{p},512) L{l} h8", dt, ms, n,
                   4 * 16 * p * 512 * 512 + 4 * 16 * p * l * 512, fwd, note,
                   split=dt == torch.bfloat16)
            del a
            torch.cuda.empty_cache()
    if "17" in rows:  # torch._int_mm at the decoder's two int8 products: a yardstick
        for m, k, nn in ((65536, 512, 2048), (65536, 2048, 512)):
            a8 = torch.randint(-127, 128, (m, k), dtype=torch.int8, device="cuda")
            w8 = torch.randint(-127, 128, (nn, k), dtype=torch.int8, device="cuda")
            # W (N, K) read through its transposed view, as the s8 GEMM reads it
            fn = lambda a8=a8, w8=w8: torch._int_mm(a8, w8.t())
            ms = time_ms(fn, reps=20)
            report("int_mm", f"({m},{k})·({nn},{k})ᵀ", torch.int8, ms, 1, 2 * m * k * nn, fn)
            del a8, w8
            torch.cuda.empty_cache()

    # row 3 and row 2 at batch 8 (a step's forward), bf16 at every shape, f32 at two
    for dt in (torch.bfloat16, torch.float32) if rows & {"2", "3"} else ():
        for p, l, n in ATTN_SHAPES if dt == torch.bfloat16 else ATTN_SHAPES[:2]:
            b = 8
            a = attn_args(rs, b, p, l, dt)
            g = rand(rs, b, p, 512, dtype=dt)
            wq_s, bq_s = ab.fold_q_scale(a[3], a[4], 8)
            fwd_ops = 4 * b * p * 512 * 512 + 4 * b * p * l * 512

            def bwd(a=a, g=g, wq_s=wq_s, bq_s=bq_s):
                return ab.fused_attn_block_bwd(a[0], a[1], a[2], g, wq_s, bq_s, *a[5:], 8)

            if "2" in rows:
                with torch.no_grad():
                    ms = time_ms(lambda: ab.fused_attn_block(*a, 8), reps=20)
                report("2 step", f"({b},{p},512) L{l} h8", dt, ms, n, fwd_ops,
                       lambda: ab.fused_attn_block(*a, 8))
            if "3" not in rows:
                continue
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
            del a, g
            torch.cuda.empty_cache()

    # row 6 (stages 1-3) and row 9 (stage 4), bf16 b16 every shape, f32 at
    # stage 3; rows 7 and 10 (the swin backward) at b8, bf16 every shape,
    # f32 at stage 3 shifted
    for dt in (torch.bfloat16, torch.float32) if rows & {"6", "7"} else ():
        for s, (grid, c, heads, n) in enumerate(SWIN_STAGES):
            if dt == torch.float32 and s != 2:
                continue
            a = swin_args(rs, 16, grid, c, heads, dt)
            tok = 16 * (-(-grid // 7) * 7) ** 2
            ops = 8 * tok * c * c + 4 * tok * 49 * c
            for shift in (0, 3) if "6" in rows else ():
                with torch.no_grad():
                    ms = time_ms(lambda: sw.swin_window_block(*a, heads, 7, shift), reps=20)
                    note = ""
                    if dt == torch.bfloat16:
                        d = (sw.swin_window_block(*a, heads, 7, shift).float()
                             - sw.swin_window_block_plain(*a, heads, 7, shift).float()).abs()
                        note = f" max|Δ| {d.max().item():.2e}"
                report("6" if s < 3 else "9", f"stage{s + 1} (16,{grid},{grid},{c}) shift{shift}",
                       dt, ms, n, ops, lambda: sw.swin_window_block(*a, heads, 7, shift), note)
            a8 = [a[0][:8].contiguous()] + a[1:]
            g8 = rand(rs, 8, grid, grid, c, dtype=dt)
            wq_s, bq_s = sw.fold_q_scale(a[3], a[4], heads)
            for shift in ((0, 3) if dt == torch.bfloat16 else (3,)) if "7" in rows else ():
                def swin_bwd(a8=a8, g8=g8, wq_s=wq_s, bq_s=bq_s, heads=heads, shift=shift):
                    return sw.swin_window_block_bwd(a8[0], g8, a8[1], a8[2], wq_s, bq_s,
                                                    *a8[5:], heads, 7, shift, residual=False)

                with torch.no_grad():
                    ms = time_ms(swin_bwd, reps=5)
                note = ""
                if dt == torch.bfloat16:
                    kw = dict(num_heads=heads, win=7, shift=shift, residual=False)
                    ka = [t.detach().clone().requires_grad_() for t in a8]
                    pa = [t.detach().clone().requires_grad_() for t in a8]
                    got = torch.autograd.grad(sw.swin_window_block(*ka, **kw), ka, g8)
                    want = torch.autograd.grad(sw.swin_window_block_plain(*pa, **kw), pa, g8)
                    rel = max(((x.float() - y.float()).norm() / y.float().norm().clamp_min(1e-30)
                               ).item() for x, y in zip(got, want))
                    note = f" rel {rel:.2e}"
                    del ka, pa, got, want
                report("7" if s < 3 else "10", f"stage{s + 1} (8,{grid},{grid},{c}) shift{shift}",
                       dt, ms, n, 1.5 * ops, swin_bwd, note)
            del a, a8, g8
            torch.cuda.empty_cache()

    # row 8: window attention at the 22 blocks' shapes of stages 1-3 and
    # stage 4 (one call), bf16, shift 0 and 3, beside one SDPA call; f32 at
    # stage 3 (a control)
    import torch.nn.functional as F
    for dt in (torch.bfloat16, torch.float32) if "8" in rows else ():
        for s, (hp, c, heads, n) in enumerate(WINDOW_STAGES):
            if dt == torch.float32 and s != 2:
                continue
            nw, dh = 16 * (hp // 7) ** 2, c // heads
            q, k, v = (rand(rs, nw, 49, c, dtype=dt) for _ in range(3))
            bias = rand(rs, heads, 49, 49, scale=0.5)
            split = tuple(t.view(nw, 49, heads, dh).transpose(1, 2) for t in (q, k, v))
            ops = 4 * nw * heads * 49 * 49 * dh
            for shift in (0, 3):
                reg = wa.region_labels(16, hp, hp, 7, shift, device="cuda")
                fn = lambda q=q, k=k, v=v, bias=bias, reg=reg, heads=heads: wa.window_attention(
                    q, k, v, bias, reg, heads)
                with torch.no_grad():
                    ms = time_ms(fn, reps=20)
                    d = (fn().float() - wa.window_attention_plain(q, k, v, bias, reg, heads
                                                                  ).float()).abs()
                label = f"stage{s + 1} ({nw},49,{c}) h{heads} shift{shift}"
                row = "8" if s < 3 else "8 stage4"
                report(row, label, dt, ms, n, ops, fn, f" max|Δ| {d.max().item():.2e}")
                if dt == torch.bfloat16:
                    mask = bias[None]
                    if reg is not None:
                        mask = mask + torch.where(reg[:, None, :, None] != reg[:, None, None, :],
                                                  wa.NEG, 0.0)
                    mask = mask.to(dt)
                    sdpa = lambda a=split, m=mask: F.scaled_dot_product_attention(*a, attn_mask=m)
                    with torch.no_grad():
                        ms = time_ms(sdpa, reps=20)
                    report(row + " SDPA", label, dt, ms, n, ops, sdpa)
                    del mask
            del q, k, v, split
            torch.cuda.empty_cache()
    # row 12: the served mask head at a batch-16 512² forward's shape (decoder
    # tokens (16, 128², 512), 151 classes, x4), bf16 and the f32 body (control)
    for dt in (torch.bfloat16, torch.float32) if "12" in rows else ():
        g = 128
        v = rand(rs, 16, g * g, 512, dtype=dt)
        tn = ua.l2_normalize(rand(rs, 16, 151, 512, dtype=dt), 2)
        fn = lambda v=v, tn=tn: ua.score_upsample_argmax(v, tn, g, 4)
        with torch.no_grad():
            ms = time_ms(fn, reps=20)
            n = int((fn() != ua.score_upsample_argmax_plain(v, tn, g, 4)).sum())
        report("12", f"(16,{g}²,512) K151 x4", dt, ms, 1, 2 * 16 * g * g * 151 * 512, fn,
               f" {n} of {16 * 16 * g * g} mask pixels differ from the plain version",
               split=True)
        del v, tn
        torch.cuda.empty_cache()

    # row 13 (one kernel for rows 13 and 14): the fused CE at a batch-8
    # flagship step's two launches, (8, 151, 128²) x4 and (8, 151, 32²) x16
    # over (8, 512²) int64 labels: the call as the step makes it
    # (fused_ce_fwd, the wrapper's copies included), and forward + backward
    # through autograd (the backward's scale, permute and cast included)
    for dt in (torch.bfloat16, torch.float32) if "13" in rows else ():
        for h, r in ((128, 4), (32, 16)):
            x = rand(rs, 8, 151, h, h, dtype=dt)
            y = torch.from_numpy(rs.randint(0, 151, size=(8, 512, 512))).cuda()
            fwd = lambda x=x, y=y, r=r: ce.fused_ce_fwd(x, y, r)
            xk = x.clone().requires_grad_()

            def both(xk=xk, y=y, r=r):
                with torch.enable_grad():
                    return torch.autograd.grad(ce.upsampled_cross_entropy(xk, y, r), [xk])

            with torch.no_grad():
                ms = time_ms(fwd, reps=20)
            ms_both = time_ms(both, reps=20)
            xp = x.clone().requires_grad_()
            lp = ce.upsampled_cross_entropy_plain(xp, y, r)
            (gp,) = torch.autograd.grad(lp, [xp])
            lk = ce.upsampled_cross_entropy(xk, y, r)
            (gk,) = torch.autograd.grad(lk, [xk])
            note = (f" loss rel {abs(lk.item() - lp.item()) / abs(lp.item()):.2e} grad rel "
                    f"{((gk.float() - gp.float()).norm() / gp.float().norm()).item():.2e}")
            ops = 8 * 151 * 512 * 512 * 8  # per hi-res pixel and class, ~8 (blend, exp, sum)
            report("13", f"(8,151,{h},{h}) r{r} call", dt, ms, 1, ops, fwd, note, split=True)
            report("13 fwd+bwd", f"(8,151,{h},{h}) r{r}", dt, ms_both, 1, ops, both, split=True)
            del x, y, xk, xp, gp, gk
            torch.cuda.empty_cache()
    for (row, dt), (ms, dev) in sorted(total.items()):
        dev_txt = "not measured" if dev is None else f"{dev:.3f} ms"
        print(f"[{tag}] total row {row} {dt}: {ms:.3f} ms, device {dev_txt} "
              f"(launch-weighted)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
