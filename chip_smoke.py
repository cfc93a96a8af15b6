#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (lc2is_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root, on a machine with an H100

Phases, in order; any failure raises and the script exits non-zero:

1. environment: torch / CUDA / nvcc / triton versions, the card's name and
   power limit; TF32 is switched off for the f32 phases;
2. build: every kernel of lc2is_tpu_torch/csrc with nvcc (sm_90a), timed;
3. kernels: each Hopper kernel against its plain PyTorch version on the card,
   at every shape the main path gives it (512², batch 16), bf16 and f32:
   max / mean abs error against the stated bound, and the kernel's time
   beside the plain version's (CUDA events, median of 20 after warm-up);
3b. backward kernels: each Hopper backward against autograd through its
   plain version at every shape of the 512², batch-8 training step, bf16 and
   f32: max |Δ| and the norm-relative error ‖Δ‖/‖ref‖ over every gradient
   against the stated bound, and the kernel's time beside the plain
   backward's (CUDA events, median of 5 after warm-up);
4. slice: PromptAuxCrossA at full width (swin-small, decoder 512, 12-layer
   text tower, 151 classes), weights from a numpy seed, embed_text once:
   (a) f32, batch 1: the card's score maps against the same model's plain run
       on the CPU;
   (b) bf16, batch 16: a few batches answered, shape and finiteness checked,
       held against the f32 output on the card, forward time and img/s; the
       kernels' launch counts over one forward are asserted.
6. training step (engine.train_step: low-res score maps, fused upsample-CE
   main + 0.4 x aux loss, AdamW lr 1e-5, frozen text tower):
   (a) f32, batch 1, 512², drop path off: the card's step against the same
       step's plain run on the CPU (losses, every trainable gradient, the
       parameters after AdamW; the frozen tower unchanged bit for bit);
   (b) bf16, batch 8, 512², drop path 0.1 from a seeded generator: two
       warm-up steps, the launch counts of one step asserted, six timed steps
       (step ms, img/s), finite losses, trainable parameters changed.
7. a JSON line of the kernels, the nvidia-smi line, and as the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Phase 6b ends with a torch.profiler trace of one more bf16 step (device time
by kernel, idle share).  With no CUDA device, or outside a checkout of the
repository, it fails without printing a result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
IMG = 512
BATCH = 16
N_CLASSES = 151
# stated bounds of a kernel against its plain version: |Δ| <= atol + rtol·|ref|
BOUNDS = {torch.float32: (1e-3, 1e-3), torch.bfloat16: (5e-2, 2e-2)}
# the f32 slice on the card against its plain run on the CPU (cosine scores)
SLICE_F32_MAX_ABS = 1e-2
SLICE_F32_ARGMAX_AGREE = 0.99
# the bf16 slice against the f32 slice on the card (cosine scores)
SLICE_BF16_MAX_ABS = 0.1
SLICE_BF16_MEAN_ABS = 1e-2
# per-forward launches of each kernel (swin-small: 2+2+18+2 blocks; 6 decoder layers)
EXPECTED_LAUNCHES = {"swin_window_block": 24, "fused_mlp": 30, "fused_attn_block": 12,
                     "upsample_tokens": 6}
# training: batch 8, AdamW lr 1e-5, drop path 0.1 (bench_train.py)
TRAIN_BATCH = 8
TRAIN_LR = 1e-5
# backward kernel against autograd through its plain version: ‖Δ‖ / ‖ref‖
GRAD_BOUNDS = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# the f32 step on the card against the CPU: losses (relative), gradients
# (norm-relative, per parameter), parameters after AdamW (absolute, where
# |g| >= max(1e-3 · max |g|, 1e-6): below, Adam's first update
# lr·g/(|g| + eps) follows the f32 noise of g).  The swin key biases have an
# exactly-zero gradient (softmax is invariant to the q·bk shared by a row's
# logits): their f32 noise is held to STEP_GRAD_REL x the norm of the same
# block's query-bias gradient, and their update is not compared.
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_REL = 1e-3
STEP_PARAM_ATOL = 1e-2 * TRAIN_LR + 1e-7
# per-step launches of the training step: the forward's, the backwards
# (stage 4's two blocks are dead code: the model reads hidden_states[:4], so
# autograd runs 22 swin backwards), one fused CE kernel per loss
EXPECTED_TRAIN_LAUNCHES = dict(EXPECTED_LAUNCHES, swin_window_block_bwd=22,
                               fused_attn_block_bwd=12, upsample_tokens_adjoint=6,
                               upsampled_cross_entropy=2)


def sh(cmd):
    try:
        return subprocess.run(cmd, capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"


def rand(rs, *shape, scale=1.0, offset=0.0, dtype=torch.float32, device="cuda"):
    return torch.from_numpy((offset + scale * rs.standard_normal(shape)).astype(np.float32)
                            ).to(device=device, dtype=dtype)


def seeded_labels(seed, *shape, device="cuda"):
    return torch.from_numpy(np.random.RandomState(seed).randint(0, N_CLASSES, size=shape)
                            ).to(device)


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


def kernel_cases(rs, dt):
    """(kernel name, shape label, per-forward count, kernel call, plain call) at
    every main-path shape of the 512² / batch-16 forward."""
    from lc2is_tpu_torch.ops.attention_block import fused_attn_block, fused_attn_block_plain
    from lc2is_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_plain
    from lc2is_tpu_torch.ops.swin_window import swin_window_block, swin_window_block_plain
    from lc2is_tpu_torch.ops.upsample import upsample_tokens, upsample_tokens_plain

    b = BATCH
    g = IMG // 4
    cases = []

    def w(o, i):
        return rand(rs, o, i, scale=i ** -0.5)

    def vec(n, offset=0.0):
        return rand(rs, n, scale=0.1, offset=offset)

    # swin stages: (grid, C, heads, blocks per shift)
    for s, (grid, c, heads, n) in enumerate([(g, 96, 3, 1), (g // 2, 192, 6, 1),
                                             (g // 4, 384, 12, 9), (g // 8, 768, 24, 1)]):
        x = rand(rs, b, grid, grid, c, dtype=dt)
        args = (x, vec(c, 1.0), vec(c), w(3 * c, c), vec(3 * c), w(c, c), vec(c),
                rand(rs, heads, 49, 49, scale=0.1))
        for shift in (0, 3):
            cases.append(("swin_window_block", f"stage{s + 1} ({b},{grid},{grid},{c}) h{heads} shift{shift}",
                          n, lambda a=args, h=heads, sh_=shift: swin_window_block(*a, h, 7, sh_),
                          lambda a=args, h=heads, sh_=shift: swin_window_block_plain(*a, h, 7, sh_)))
        xt = rand(rs, b * grid * grid, c, dtype=dt)
        margs = (xt, vec(c, 1.0), vec(c), w(4 * c, c), vec(4 * c), w(c, 4 * c), vec(c))
        cases.append(("fused_mlp", f"swin{s + 1} ({b * grid * grid},{c}) gelu pre", 2 * n,
                      lambda a=margs: fused_mlp(*a, activation="gelu", ln_position="pre"),
                      lambda a=margs: fused_mlp_plain(*a, activation="gelu", ln_position="pre")))
    # decoder: (tokens per image, SR keys, layers at that size)
    for p, l_sr, n in [(256, 64, 1), (1024, 256, 2), (4096, 1024, 3)]:
        x = rand(rs, b, p, 512, dtype=dt)
        margs = (x.reshape(-1, 512), vec(512, 1.0), vec(512), w(2048, 512), vec(2048),
                 w(512, 2048), vec(512))
        cases.append(("fused_mlp", f"decoder ({b * p},512) relu post", n,
                      lambda a=margs: fused_mlp(*a, activation="relu", ln_position="post"),
                      lambda a=margs: fused_mlp_plain(*a, activation="relu", ln_position="post")))
        for l, kind in [(l_sr, "SR self"), (N_CLASSES, "cross")]:
            aargs = (x, rand(rs, b, l, 512, dtype=dt), rand(rs, b, l, 512, dtype=dt),
                     w(512, 512), vec(512), w(512, 512), vec(512), vec(512, 1.0), vec(512))
            cases.append(("fused_attn_block", f"{kind} ({b},{p},512) L{l} h8", n,
                          lambda a=aargs: fused_attn_block(*a, 8),
                          lambda a=aargs: fused_attn_block_plain(*a, 8)))
    for grid, c, n in [(16, 768, 1), (32, 384, 1), (16, 512, 1), (32, 512, 2), (64, 512, 1)]:
        x = rand(rs, b, grid * grid, c, dtype=dt)
        cases.append(("upsample_tokens", f"({b},{grid}²,{c}) x2", n,
                      lambda x_=x, g_=grid: upsample_tokens(x_, (g_, g_), 2),
                      lambda x_=x, g_=grid: upsample_tokens_plain(x_, (g_, g_), 2)))
    return cases


def check_kernels():
    """Phase 3.  Returns per-kernel stats for the JSON line."""
    stats = {}
    for dt in (torch.bfloat16, torch.float32):
        atol, rtol = BOUNDS[dt]
        print(f"\n[kernels] {dt}: bound |kernel - plain| <= {atol} + {rtol}·|plain|", flush=True)
        rs = np.random.RandomState(SEED)
        for name, label, count, kern, plain in kernel_cases(rs, dt):
            got = kern()
            torch.cuda.synchronize()
            want = plain()
            d = (got.float() - want.float()).abs()
            bound_ok = bool((d <= atol + rtol * want.float().abs()).all())
            finite = bool(torch.isfinite(got).all())
            k_ms, p_ms = time_ms(kern), time_ms(plain)
            print(f"  {name:17s} {label:44s} max {d.max().item():.3e} mean {d.mean().item():.3e} "
                  f"kernel {k_ms:8.3f} ms plain {p_ms:8.3f} ms  x{count}/fwd "
                  f"{'ok' if bound_ok and finite else 'FAIL'}", flush=True)
            if not (bound_ok and finite):
                raise AssertionError(f"{name} {label} {dt}: kernel disagrees with its plain "
                                     f"version (max {d.max().item():.3e}, finite {finite})")
            s = stats.setdefault(name, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0))
            s["max_abs_err"] = max(s["max_abs_err"], d.max().item())
            if dt == torch.bfloat16:  # time per 512² / batch-16 bf16 forward
                s["ms"] += count * k_ms
                s["plain_ms"] += count * p_ms
            del got, want, d
        torch.cuda.empty_cache()
    return stats


def backward_cases(rs, dt):
    """(kernel name, shape label, launches per training step, kernel call,
    (kernel-path fn, plain fn, args, g) for the gradient check) at every
    shape of the 512² / batch-8 training step.  The plain time is autograd's
    backward through the plain version; for the fused CE, whose one kernel
    computes the loss and the gradient, it is the plain forward + backward."""
    from lc2is_tpu_torch.ops.attention_block import (fold_q_scale as fold_q, fused_attn_block,
                                                     fused_attn_block_bwd, fused_attn_block_plain)
    from lc2is_tpu_torch.ops.fused_ce import (fused_ce_fwd, upsampled_cross_entropy,
                                              upsampled_cross_entropy_plain)
    from lc2is_tpu_torch.ops.swin_window import (fold_q_scale, swin_window_block,
                                                 swin_window_block_bwd, swin_window_block_plain)
    from lc2is_tpu_torch.ops.upsample import (upsample_tokens, upsample_tokens_adjoint,
                                              upsample_tokens_plain)

    b = TRAIN_BATCH
    g = IMG // 4
    cases = []

    def w(o, i):
        return rand(rs, o, i, scale=i ** -0.5)

    def vec(n, offset=0.0):
        return rand(rs, n, scale=0.1, offset=offset)

    # drop path 0.1 over 24 blocks by linspace: only block 0 has rate 0 and
    # keeps the in-kernel residual; stage 4's blocks get no backward
    for s, (grid, c, heads, n) in enumerate([(g, 96, 3, 1), (g // 2, 192, 6, 1),
                                             (g // 4, 384, 12, 9), (g // 8, 768, 24, 0)]):
        x = rand(rs, b, grid, grid, c, dtype=dt)
        args = [x, vec(c, 1.0), vec(c), w(3 * c, c), vec(3 * c), w(c, c), vec(c),
                rand(rs, heads, 49, 49, scale=0.1)]
        gr = rand(rs, b, grid, grid, c, dtype=dt)
        wq_s, bq_s = fold_q_scale(args[3], args[4], heads)
        for shift in (0, 3):
            for res in (True, False):
                count = (1 if s == 0 and shift == 0 and res else
                         0 if res or (s == 0 and shift == 0) else n)
                kw = dict(num_heads=heads, win=7, shift=shift, residual=res)
                cases.append((
                    "swin_window_block_bwd",
                    f"stage{s + 1} ({b},{grid},{grid},{c}) h{heads} shift{shift} res{int(res)}",
                    count,
                    lambda a=args, q=(wq_s, bq_s), k=kw, g_=gr: swin_window_block_bwd(
                        a[0], g_, a[1], a[2], q[0], q[1], *a[5:], **k),
                    (lambda *a, k=kw: swin_window_block(*a, **k),
                     lambda *a, k=kw: swin_window_block_plain(*a, **k), args, gr)))
    for p, l_sr, n in [(256, 64, 1), (1024, 256, 2), (4096, 1024, 3)]:
        x = rand(rs, b, p, 512, dtype=dt)
        gr = rand(rs, b, p, 512, dtype=dt)
        for l, kind in [(l_sr, "SR self"), (N_CLASSES, "cross")]:
            args = [x, rand(rs, b, l, 512, dtype=dt), rand(rs, b, l, 512, dtype=dt),
                    w(512, 512), vec(512), w(512, 512), vec(512), vec(512, 1.0), vec(512)]
            q = fold_q(args[3], args[4], 8)
            cases.append((
                "fused_attn_block_bwd", f"{kind} ({b},{p},512) L{l} h8", n,
                lambda a=args, q=q, g_=gr: fused_attn_block_bwd(a[0], a[1], a[2], g_, *q,
                                                                *a[5:], 8),
                (lambda *a: fused_attn_block(*a, 8), lambda *a: fused_attn_block_plain(*a, 8),
                 args, gr)))
    for grid, c, n in [(16, 768, 1), (32, 384, 1), (16, 512, 1), (32, 512, 2), (64, 512, 1)]:
        x = rand(rs, b, grid * grid, c, dtype=dt)
        gr = rand(rs, b, 4 * grid * grid, c, dtype=dt)
        cases.append((
            "upsample_tokens_adjoint", f"({b},{grid}²,{c}) x2", n,
            lambda g_=gr, h=grid: upsample_tokens_adjoint(g_, (h, h), 2),
            (lambda a, h=grid: upsample_tokens(a, (h, h), 2),
             lambda a, h=grid: upsample_tokens_plain(a, (h, h), 2), [x], gr)))
    for h, r in [(g, 4), (g // 4, 16)]:
        x = rand(rs, b, N_CLASSES, h, h, dtype=dt)
        y = seeded_labels(SEED + r, b, IMG, IMG)
        cases.append((
            "upsampled_cross_entropy", f"({b},{N_CLASSES},{h},{h}) r{r}, labels ({b},{IMG},{IMG})",
            1, lambda x_=x, y_=y, r_=r: fused_ce_fwd(x_, y_, r_),
            (lambda a, y_=y, r_=r: upsampled_cross_entropy(a, y_, r_),
             lambda a, y_=y, r_=r: upsampled_cross_entropy_plain(a, y_, r_), [x], None)))
    return cases


def check_backward_kernels():
    """Phase 3b.  Returns per-kernel stats for the JSON line."""
    stats = {}
    for dt in (torch.bfloat16, torch.float32):
        bound = GRAD_BOUNDS[dt]
        print(f"\n[backward] {dt}: bound ‖kernel - plain‖ / ‖plain‖ <= {bound} over every "
              f"gradient", flush=True)
        rs = np.random.RandomState(SEED + 3)
        for name, label, count, kern, (kfn, pfn, args, g) in backward_cases(rs, dt):
            ka = [a.detach().clone().requires_grad_() for a in args]
            pa = [a.detach().clone().requires_grad_() for a in args]
            got = torch.autograd.grad(kfn(*ka), ka, g)
            torch.cuda.synchronize()
            out_p = pfn(*pa)
            want = torch.autograd.grad(out_p, pa, g, retain_graph=True)
            rel = max(((a.float() - b_.float()).norm() / b_.float().norm().clamp_min(1e-30)).item()
                      for a, b_ in zip(got, want))
            mx = max((a.float() - b_.float()).abs().max().item() for a, b_ in zip(got, want))
            finite = all(bool(torch.isfinite(a).all()) for a in got)
            k_ms = time_ms(kern, reps=5, warmup=1)
            p_ms = time_ms(lambda: torch.autograd.grad(out_p, pa, g, retain_graph=True),
                           reps=5, warmup=1)
            if name == "upsampled_cross_entropy":  # one kernel for loss and gradient
                p_ms = time_ms(lambda: torch.autograd.grad(pfn(*pa), pa), reps=5, warmup=1)
            ok = rel <= bound and finite
            print(f"  {name:23s} {label:46s} max {mx:.3e} rel {rel:.3e} kernel {k_ms:8.3f} ms "
                  f"plain {p_ms:8.3f} ms  x{count}/step {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(f"{name} {label} {dt}: backward kernel disagrees with "
                                     f"autograd through its plain version (rel {rel:.3e})")
            st = stats.setdefault(name, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0))
            st["max_abs_err"] = max(st["max_abs_err"], mx)
            if dt == torch.bfloat16:  # time per 512² / batch-8 bf16 training step
                st["ms"] += count * k_ms
                st["plain_ms"] += count * p_ms
            del got, want, out_p, ka, pa
        torch.cuda.empty_cache()
    return stats


NAMES = tuple(f"thing {i}" for i in range(N_CLASSES))


def seeded_state():
    """state_dict of the full-width PromptAuxCrossA, weights from the numpy seed."""
    from lc2is_tpu_torch.core.convert import seeded_init_
    from lc2is_tpu_torch.models.zoo import PromptAuxCrossA

    t0 = time.time()
    cpu = seeded_init_(PromptAuxCrossA(class_names=NAMES), SEED)
    n = sum(p.numel() for p in cpu.parameters())
    print(f"\n[slice] PromptAuxCrossA swin-small / decoder 512 / 12-layer text tower / "
          f"{N_CLASSES} classes: {n} parameters from numpy seed {SEED} "
          f"({time.time() - t0:.1f} s)", flush=True)
    return cpu.state_dict()


def model_from(state, **kw):
    from lc2is_tpu_torch.models.zoo import PromptAuxCrossA

    m = PromptAuxCrossA(class_names=NAMES, **kw)
    m.load_state_dict(state, strict=True)
    return m


def build_models(state):
    return (model_from(state).eval(), model_from(state, device="cuda").eval(),
            model_from(state, dtype=torch.bfloat16, device="cuda").eval())


def launch_counters():
    from lc2is_tpu_torch.ops.attention_block import fused_attn_block, fused_attn_block_bwd
    from lc2is_tpu_torch.ops.fused_ce import upsampled_cross_entropy
    from lc2is_tpu_torch.ops.fused_mlp import fused_mlp
    from lc2is_tpu_torch.ops.swin_window import swin_window_block, swin_window_block_bwd
    from lc2is_tpu_torch.ops.upsample import upsample_tokens, upsample_tokens_adjoint

    return {f.__name__: f for f in (swin_window_block, fused_mlp, fused_attn_block,
                                    upsample_tokens, swin_window_block_bwd,
                                    fused_attn_block_bwd, upsample_tokens_adjoint,
                                    upsampled_cross_entropy)}


def check_slice(smi, state):
    """Phase 4."""
    cpu, gpu32, gpu16 = build_models(state)
    with torch.no_grad():
        ts_cpu = cpu.embed_text()
        ts_gpu = gpu32.embed_text()
        d_ts = (ts_gpu.cpu() - ts_cpu).abs().max().item()
        print(f"[slice] embed_text (K, C) = {tuple(ts_gpu.shape)} f32, card vs CPU max |Δ| {d_ts:.3e}")

        # (a) f32, batch 1: card vs the plain run on the CPU
        rs = np.random.RandomState(SEED + 1)
        x1 = rand(rs, 1, 3, IMG, IMG, device="cpu")
        t0 = time.time()
        want = cpu({"pixel_values": x1, "text_static": ts_cpu})
        cpu_s = time.time() - t0
        got = gpu32({"pixel_values": x1.cuda(), "text_static": ts_gpu})
        torch.cuda.synchronize()
        for key, shape in (("outputs", (1, N_CLASSES, IMG, IMG)),
                           ("low_score_map", (1, N_CLASSES, IMG // 16, IMG // 16))):
            g_, w_ = got[key].cpu(), want[key]
            if tuple(g_.shape) != shape or not torch.isfinite(g_).all():
                raise AssertionError(f"f32 {key}: shape {tuple(g_.shape)} / non-finite values")
            d = (g_ - w_).abs()
            agree = (g_.argmax(1) == w_.argmax(1)).float().mean().item()
            print(f"[slice] (a) f32 b1 {key} {tuple(g_.shape)}: card vs CPU plain max |Δ| "
                  f"{d.max().item():.3e} (bound {SLICE_F32_MAX_ABS}) mean {d.mean().item():.3e}, "
                  f"argmax agreement {agree:.5f} (bound {SLICE_F32_ARGMAX_AGREE}); "
                  f"score range [{w_.min().item():.3f}, {w_.max().item():.3f}]", flush=True)
            if d.max().item() > SLICE_F32_MAX_ABS or agree < SLICE_F32_ARGMAX_AGREE:
                raise AssertionError(f"f32 slice on the card disagrees with the CPU plain run ({key})")
        print(f"[slice] (a) CPU plain forward {cpu_s:.1f} s", flush=True)
        del got, want, cpu

        # (b) bf16, batch 16: answer a few batches
        counters = launch_counters()
        batches = [rand(np.random.RandomState(SEED + 10 + i), BATCH, 3, IMG, IMG,
                        dtype=torch.bfloat16) for i in range(4)]
        gpu16({"pixel_values": batches[0], "text_static": ts_gpu})  # warm-up
        torch.cuda.synchronize()
        for f in counters.values():
            f.launches = 0
        times, outs = [], None
        for i, px in enumerate(batches[1:]):
            t0 = time.perf_counter()
            out = gpu16({"pixel_values": px, "text_static": ts_gpu})
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                counts = {name: f.launches for name, f in counters.items() if f.launches}
                outs = out
            o = out["outputs"]
            if tuple(o.shape) != (BATCH, N_CLASSES, IMG, IMG) or o.dtype != torch.bfloat16:
                raise AssertionError(f"bf16 outputs {tuple(o.shape)} {o.dtype}")
            if not (torch.isfinite(o).all() and torch.isfinite(out["low_score_map"]).all()):
                raise AssertionError("bf16 outputs hold non-finite values")
        print(f"[slice] (b) bf16 b{BATCH}: {len(times)} batches answered, outputs "
              f"{tuple(o.shape)} bf16 finite, low_score_map {tuple(out['low_score_map'].shape)}")
        print(f"[slice] launches over one forward: {counts} (expected {EXPECTED_LAUNCHES})")
        if counts != EXPECTED_LAUNCHES:
            raise AssertionError(f"launch counts {counts} != {EXPECTED_LAUNCHES}")
        ms = statistics.median(times)
        print(f"[slice] (b) bf16 b{BATCH} {IMG}² forward (host clock to synchronize): "
              f"{[round(t, 2) for t in times]} ms, median {ms:.2f} ms = "
              f"{BATCH * 1e3 / ms:.1f} img/s on {smi}", flush=True)

        ref = gpu32({"pixel_values": batches[1].float(), "text_static": ts_gpu})
        for key in ("outputs", "low_score_map"):
            d = (outs[key].float() - ref[key]).abs()
            agree = (outs[key].float().argmax(1) == ref[key].argmax(1)).float().mean().item()
            print(f"[slice] (b) bf16 vs f32 on the card, {key}: max |Δ| {d.max().item():.3e} "
                  f"(bound {SLICE_BF16_MAX_ABS}) mean {d.mean().item():.3e} (bound "
                  f"{SLICE_BF16_MEAN_ABS}), argmax agreement {agree:.4f}", flush=True)
            if d.max().item() > SLICE_BF16_MAX_ABS or d.mean().item() > SLICE_BF16_MEAN_ABS:
                raise AssertionError(f"bf16 slice outside its bound of the f32 slice ({key})")


def train_models(state, **kw):
    from lc2is_tpu_torch.engine.optim import make_optimizer
    from lc2is_tpu_torch.models.zoo import FROZEN_PREFIXES

    m = model_from(state, return_score_map=True, **kw)
    return m, make_optimizer(m, lr=TRAIN_LR, frozen_prefixes=FROZEN_PREFIXES["prompt_aux_cross_a"])


def check_train_f32(state):
    """Phase 6a: one f32 step at batch 1, drop path off, card vs CPU."""
    from lc2is_tpu_torch.engine.engine import train_step
    from lc2is_tpu_torch.models.zoo import FROZEN_PREFIXES
    from lc2is_tpu_torch.nn.swin import SWIN_SMALL

    frozen = FROZEN_PREFIXES["prompt_aux_cross_a"][0] + "."
    nodrop = dict(swin_cfg=dict(SWIN_SMALL, drop_path_rate=0.0))
    cpu, opt_c = train_models(state, **nodrop)
    gpu, opt_g = train_models(state, device="cuda", **nodrop)
    x = rand(np.random.RandomState(SEED + 20), 1, 3, IMG, IMG, device="cpu")
    y = seeded_labels(SEED + 21, 1, IMG, IMG, device="cpu")
    t0 = time.time()
    want = train_step(cpu, opt_c, {"pixel_values": x}, y)
    cpu_s = time.time() - t0
    got = train_step(gpu, opt_g, {"pixel_values": x.cuda()}, y.cuda())
    torch.cuda.synchronize()
    for key in want:
        g_, w_ = got[key].item(), want[key].item()
        print(f"[train] (a) f32 b1 {IMG}² {key}: card {g_:.6f} CPU {w_:.6f} "
              f"(bound {STEP_LOSS_RTOL} relative)", flush=True)
        if not (np.isfinite(g_) and abs(g_ - w_) <= STEP_LOSS_RTOL * abs(w_)):
            raise AssertionError(f"f32 step {key}: card {g_} vs CPU {w_}")
    worst, worst_name, n_grads, worst_param = 0.0, "", 0, 0.0
    gp = dict(gpu.named_parameters())
    for name, p in cpu.named_parameters():
        q = gp[name]
        if name.startswith(frozen):
            if q.grad is not None or not torch.equal(q.detach().cpu(), state[name]):
                raise AssertionError(f"frozen {name} got a gradient or changed")
            continue
        if p.grad is None or q.grad is None:
            if (p.grad is None) != (q.grad is None):
                raise AssertionError(f"{name}: gradient on one device only")
            continue
        n_grads += 1
        gq = q.grad.cpu()
        zero_in_exact = name.endswith("attention.self.key.bias")
        ref = dict(cpu.named_parameters())[name.replace("key.bias", "query.bias")] \
            if zero_in_exact else p
        rel = ((gq - p.grad).norm() / ref.grad.norm().clamp_min(1e-30)).item()
        if rel > worst:
            worst, worst_name = rel, name
        if zero_in_exact:
            continue
        sure = p.grad.abs() >= torch.clamp(1e-3 * p.grad.abs().max(), min=1e-6)
        d = (q.detach().cpu() - p.detach())[sure].abs()
        worst_param = max(worst_param, d.max().item() if d.numel() else 0.0)
    print(f"[train] (a) {n_grads} trainable gradients, card vs CPU: worst norm-relative "
          f"{worst:.3e} ({worst_name}; bound {STEP_GRAD_REL}); parameters after AdamW max "
          f"|Δ| {worst_param:.3e} (bound {STEP_PARAM_ATOL:.1e}); frozen text tower: no "
          f"gradient, unchanged bit for bit; CPU step {cpu_s:.1f} s", flush=True)
    if worst > STEP_GRAD_REL or worst_param > STEP_PARAM_ATOL:
        raise AssertionError("f32 training step on the card disagrees with the CPU run")


def check_train_bf16(smi, state):
    """Phase 6b.  Returns (launch counts of one step, median step ms)."""
    from lc2is_tpu_torch.engine.engine import train_step
    from lc2is_tpu_torch.models.zoo import FROZEN_PREFIXES

    frozen = FROZEN_PREFIXES["prompt_aux_cross_a"][0] + "."
    model, opt = train_models(state, dtype=torch.bfloat16, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = rand(np.random.RandomState(SEED + 30), TRAIN_BATCH, 3, IMG, IMG, dtype=torch.bfloat16)
    y = seeded_labels(SEED + 31, TRAIN_BATCH, IMG, IMG)
    inputs = {"pixel_values": x}
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    counters = launch_counters()
    for _ in range(2):  # warm-up
        train_step(model, opt, inputs, y, generator=gen)
    torch.cuda.synchronize()
    times, losses = [], []
    for i in range(6):
        if i == 0:
            for f in counters.values():
                f.launches = 0
        t0 = time.perf_counter()
        out = train_step(model, opt, inputs, y, generator=gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            counts = {name: f.launches for name, f in counters.items()}
        losses.append({k: v.item() for k, v in out.items()})
    print(f"[train] (b) bf16 b{TRAIN_BATCH} {IMG}², drop path 0.1: losses per step "
          f"{[(round(d['train_loss'], 5), round(d['train_aux_loss'], 5)) for d in losses]}")
    print(f"[train] launches over one step: {counts} (expected {EXPECTED_TRAIN_LAUNCHES})")
    if counts != EXPECTED_TRAIN_LAUNCHES:
        raise AssertionError(f"training launch counts {counts} != {EXPECTED_TRAIN_LAUNCHES}")
    if not all(np.isfinite(v) for d in losses for v in d.values()):
        raise AssertionError("non-finite training loss")
    changed = [n for n, p in model.named_parameters() if not torch.equal(p.detach(), start[n])]
    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    moved_frozen = [n for n in changed if n.startswith(frozen)]
    # stage 4's blocks are dead code (hidden_states[:4]): no gradient, no
    # update; a swin key bias's gradient is zero in exact arithmetic (softmax
    # is invariant to the q·bk a row's logits share), so it may not move
    dead = [n for n in trainable if n.startswith("vision_encoder.stages.3.blocks.")]
    zero = [n for n in trainable if n.endswith("attention.self.key.bias") and n not in dead]
    stuck = sorted(set(trainable) - set(changed) - set(dead) - set(zero))
    print(f"[train] {len(changed)} of {len(trainable)} trainable parameters changed after 8 "
          f"steps; not required to: the {len(dead)} of stage 4's dead blocks (as in the "
          f"reference) and the {len(zero)} swin key biases ({len(set(zero) - set(changed))} "
          f"did not move); frozen changed: {len(moved_frozen)}", flush=True)
    if stuck or moved_frozen:
        raise AssertionError(f"parameters not updated {stuck[:5]} / frozen moved {moved_frozen[:5]}")
    ms = statistics.median(times)
    print(f"[train] (b) bf16 b{TRAIN_BATCH} {IMG}² step (host clock to synchronize): "
          f"{[round(t, 2) for t in times]} ms, median {ms:.2f} ms = "
          f"{TRAIN_BATCH * 1e3 / ms:.2f} img/s on {smi}", flush=True)
    profile_step(lambda: train_step(model, opt, inputs, y, generator=gen))
    return counts, ms


def profile_step(step):
    """torch.profiler over one step: device time by kernel and idle share."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    span = spans[-1][1] - spans[0][0] if spans else 0.0
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    print(f"[profile] one bf16 step: {len(events)} device kernels, busy {busy / 1e3:.2f} ms "
          f"in a {span / 1e3:.2f} ms first-to-last span (idle {100 * (1 - busy / span):.1f} %)")
    print(table, flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    from lc2is_tpu_torch.ops import _build  # fails outside a checkout of the repository

    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"torch.version.cuda {torch.version.cuda}")
    print(f"[env] nvcc: {sh([_build.nvcc(), '--version']).splitlines()[-1]}")
    try:
        import triton
        print(f"[env] triton {triton.__version__}")
    except ImportError:
        print("[env] triton: not installed")
    print(f"[env] nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[env] TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False", flush=True)

    t0 = time.time()
    lib, log = _build.build(verbose=True)
    regs = [int(s.split("Used ")[1].split()[0]) for s in log.splitlines() if "Used " in s]
    spills = [s for s in log.splitlines() if "spill" in s and not s.strip().endswith(
        "0 bytes spill stores, 0 bytes spill loads")]
    report = (f"ptxas: {len(regs)} kernels, max {max(regs, default=0)} registers/thread, "
              f"{len(spills)} with spills" if log else "found already built")
    print(f"[build] {lib.name} in {time.time() - t0:.1f} s; {report}", flush=True)
    for s in spills:
        print(f"[build]   {s.strip()}")

    stats = check_kernels()
    stats.update(check_backward_kernels())
    state = seeded_state()
    check_slice(smi, state)
    check_train_f32(state)
    counts, step_ms = check_train_bf16(smi, state)

    sources = {"fused_mlp": ("lc2is_tpu_torch/csrc/fused_mlp.cu", "lc2is_tpu/ops/fused_mlp.py:110"),
               "fused_attn_block": ("lc2is_tpu_torch/csrc/attention_block.cu",
                                    "lc2is_tpu/ops/attention_block.py:37"),
               "upsample_tokens": ("lc2is_tpu_torch/csrc/upsample.cu", "lc2is_tpu/ops/upsample.py:42"),
               "swin_window_block": ("lc2is_tpu_torch/csrc/swin_window.cu",
                                     "lc2is_tpu/ops/swin_canvas.py:224; "
                                     "lc2is_tpu/ops/window_attention.py:386"),
               "swin_window_block_bwd": ("lc2is_tpu_torch/csrc/swin_window_bwd.cu",
                                         "lc2is_tpu/ops/swin_canvas.py:530; "
                                         "lc2is_tpu/ops/window_attention.py:701"),
               "fused_attn_block_bwd": ("lc2is_tpu_torch/csrc/attention_block_bwd.cu",
                                        "lc2is_tpu/ops/attention_block.py:264"),
               "upsample_tokens_adjoint": ("lc2is_tpu_torch/csrc/upsample.cu",
                                           "lc2is_tpu/ops/upsample.py:186"),
               "upsampled_cross_entropy": ("lc2is_tpu_torch/csrc/fused_ce.cu",
                                           "lc2is_tpu/ops/fused_ce.py:89; "
                                           "lc2is_tpu/ops/fused_ce.py:117")}
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep, launches=counts[name],
                    max_abs_err=stats[name]["max_abs_err"], ms=stats[name]["ms"],
                    plain_ms=stats[name]["plain_ms"])
               for name, (src, rep) in sources.items()]
    print(f"\n[summary] launches: one bf16 batch-{TRAIN_BATCH} {IMG}² training step (the main "
          f"path); ms / plain_ms: summed bf16 kernel time at the main-path shapes, per {IMG}² "
          f"batch-{BATCH} forward for the four forward kernels, per batch-{TRAIN_BATCH} "
          f"training step for the backward kernels and the fused CE; training step "
          f"{step_ms:.2f} ms on {smi}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
