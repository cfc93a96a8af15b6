#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (lc2is_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root, on a machine with an H100

Phases, in order; any failure raises and the script exits non-zero:

1. environment: torch / CUDA / nvcc / triton versions, the card's name and
   power limit; TF32 is switched off for the f32 phases;
2. build: every kernel of lc2is_tpu_torch/csrc with nvcc (sm_90a), timed,
   with the registers and spills of the bf16 tensor-core kernels (flash,
   the decoder attention forward's and backward's (its GEMM, which the
   feed-forward and the swin backward share, and its LayerNorm pass), the
   swin window block's, window attention's, the swin backward's attention
   core, the mask head's and the fused CE's) on a line;
3. kernels: each Hopper kernel against its plain PyTorch version on the card,
   at every shape the main paths give it (512², batch 16), bf16 and f32:
   max / mean abs error against the stated bound (masks: equal except at
   near-ties, on at most 1e-4 of the pixels; int8: relative to the largest
   reference value), the kernel's
   time beside the plain version's and, where one PyTorch call computes the
   same function, that call's (CUDA events, median of 20 after warm-up), and
   the least time the card could take (bytes at 3.35 TB/s against operations
   at the type's peak).  Flash attention (the v1 path) at the CLIP ViT-B/16
   and v1 decoder shapes, held to a share of its largest output, with
   controls that must fail the same gate (the kernel over all keys but the
   last 64-key tile; the key-padding case run without its mask) and a case
   of fully-masked batch entries whose NaN rows must match the plain
   version's exactly; flash at head widths 16, 40, 48 and 128 (each flash
   case also prints its TFLOP/s and its time over SDPA's); the v1 shapes of
   fused_mlp and fused_attn_block (timed, not summed into the flagship
   forward); each swin_window_block, fused_mlp and fused_attn_block case
   prints its TFLOP/s, the mask head its score product's TFLOP/s and its
   argmax's (pixel, class) pairs a second over the whole kernel time;
3b. backward kernels: each Hopper backward against autograd through its
   plain version at every shape of the 512², batch-8 training step, bf16 and
   f32: max |Δ| and the norm-relative error ‖Δ‖/‖ref‖ over every gradient
   against the stated bound, and the kernel's time beside the plain
   backward's (CUDA events, median of 5 after warm-up; fused_attn_block_bwd
   and swin_window_block_bwd also their TFLOP/s over three times their
   forward's products; the fused CE its exponentials a second (two per
   hi-res pixel and class) and its f32 operations a second); the flash backward
   (dq and dk/dv kernels) against flash_attention_backward_plain at the v1
   training shapes (ViT-B/16 (16, 12, 1025, 64), decoder (16, 8, 1024, 96)),
   masked, at D 48 and ragged (77 queries over 1025 keys), with two controls
   that must fail (the kernel over all keys but the last 64; the masked case
   run unmasked) and SDPA's backward timed beside it (TFLOP/s over the five
   products and the ratio printed);
3w. window attention (TPU row 8, on no model's path): window_attention
   against its plain version at swin-small's four stage shapes of a 512²
   batch-16 forward (N 5776 / 1600 / 400 / 144 windows of 49 tokens, C 96 to
   768), shift 0 and 3 (labels from region_labels), bf16 and f32, with the
   shifted case run without its labels as a control that must fail; times
   beside the plain version's and one SDPA call with the bias and mask as an
   additive attn_mask, summed over the 22 blocks of stages 1-3 (stage 4 as
   one call), each case with its GB/s beside the memory rate and its time
   over SDPA's; its recompute backward against autograd through the plain
   version at stage 3's shape; SwinAttention.forward on the card against
   its CPU run (stage-3 windows of one 512² image, shifted);
4. slice: PromptAuxCrossA at full width (swin-small, decoder 512, 12-layer
   text tower, 151 classes), weights from a numpy seed, embed_text once:
   (a) f32, batch 1: the card's score maps against the same model's plain run
       on the CPU;
   (b) bf16, batch 16: a few batches answered, shape and finiteness checked,
       held against the f32 output on the card, forward time and img/s; the
       kernels' launch counts over one forward are asserted (stage 4 of the
       swin runs on no path: no model reads it).
4m. the served head (predict_masks=True, as bench.py serves it): (a) f32
   batch 1, the card's masks against the CPU plain masks of 4a's decoder
   output (agreement and near-ties only); (b) bf16 batch 16: a few batches
   answered and timed, the launch counts of one forward asserted.
5. the int8 row (quant_int8=True, served head): (a) f32 batch 1, the card
   against its plain run on the CPU: the low score map's largest and mean
   error, the masks' agreement and near-ties; every int8 op call of the
   card's forward against its plain version on the inputs it had there; the
   card's float row and the float twins of those calls, as controls, must
   fail the same gates; the row with its input nudged by 1e-6 is printed as
   a yardstick; (b) bf16 batch 16: a few batches answered and timed, the
   launch counts of one forward asserted, mask agreement with 4m's bf16
   masks printed (not gated: the weights are random).
6. training step (engine.train_step: low-res score maps, fused upsample-CE
   main + 0.4 x aux loss, AdamW lr 1e-5, frozen text tower):
   (a) f32, batch 1, 512², drop path off: the card's step against the same
       step's plain run on the CPU (losses, every trainable gradient, the
       parameters after AdamW; the frozen tower unchanged bit for bit);
   (b) bf16, batch 8, 512², drop path 0.1 from a seeded generator: two
       warm-up steps, the launch counts of one step asserted, six timed steps
       (step ms, img/s), finite losses, trainable parameters changed.
7. the v1 CLIP family (ViT-B/16 at 512², the 12-layer CLIP text tower),
   weights from a numpy seed, ids from ops/bpe.tokenize on class-name
   prompts padded to 77, attention_mask = ids != 0:
   (a) BaseModelWithText (out 128²): f32 batch 1 on the card against the
       same model's plain run on the CPU (feature_mm, feature_t, feature_v
       relative to max |ref|, per-pixel argmax agreement with near-ties
       only); bf16 batch 16 against f32 on the card; launch counts of one
       forward; three answered bf16 batch-16 batches timed; a torch.profiler
       table of one more forward;
   (b) ContrastiveModel and DenseClip: the same f32 batch-1 check (logits;
       score_map and out) over the 151 class prompts, launch counts, bf16
       batch 16 timed.
8. v1 training (engine.train_step on BaseModelWithText: plain CE of
   feature_mm on 128² labels, AdamW lr 1e-5, nothing frozen):
   (a) f32, batch 1, 512²: the card's step against the same step on the CPU
       (the loss, every gradient, the parameters after AdamW);
   (b) bf16, batch 16, dropout 0: two warm-up steps, the launch counts of
       one step asserted (flash forward and backward 13 each, fused_mlp 1),
       six timed steps (step ms, img/s), a torch.profiler table of one more;
   (c) bf16, dropout 0.1 from a seeded generator: the self-attention on the
       einsum path (flash 12 and 12), finite losses, the same seed repeating
       the loss bit for bit.
10. the other five v4 models (BaseCrossA, BaseSelfA, PromptCrossA,
   PromptSelfA, PromptAuxSelfA) at full width, weights from the numpy seed:
   (a) f32 batch 1, the card against the same model's plain run on the CPU
       (phase 4a's score-map gates) and the card's masks against the CPU
       plain masks of the CPU run's decoder output (phase 4m's gates);
   (b) bf16 batch 16, predict_masks, text cached: three batches answered
       and timed, the launch counts of one forward asserted (the CrossA
       models the flagship's; the SelfA models 6 fused_attn_block).
11. BaseCrossA's training step (the CLI's default model; one fused CE, no
   frozen part): (a) f32 batch 1, 512² images and labels, card vs CPU under
   phase 6a's gates; (b) bf16 batch 8, dropout 0, drop path 0.1: two
   warm-up steps, the launch counts of one step, six timed steps, a
   torch.profiler table of one more.

Then a JSON line of the kernels (launches over one run of the path that
uses each: the served-mask forward, the int8 forward, the training step, the
v1 BaseModelWithText forward or its training step; 0 for upsample_argmax and
window_attention, which lie on no path), the nvidia-smi line, and as the
last line {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Each phase prints its seconds.

Phase 6b ends with a torch.profiler trace of one more bf16 step (device time
by kernel, idle share).  With no CUDA device, or outside a checkout of the
repository, it fails without printing a result.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
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
# flash attention: |Δ| <= FLASH_REL·max|ref|.  Its outputs are averages of v,
# about 0.05 over 1025 unit-normal keys, so BOUNDS' bf16 atol alone would pass
# a kernel that dropped a 64-key tile (about 1e-2 off)
FLASH_REL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}
# the f32 slice on the card against its plain run on the CPU (cosine scores)
SLICE_F32_MAX_ABS = 1e-2
SLICE_F32_ARGMAX_AGREE = 0.99
# the bf16 slice against the f32 slice on the card (cosine scores)
SLICE_BF16_MAX_ABS = 0.1
SLICE_BF16_MEAN_ABS = 1e-2
# per-forward launches of each kernel (swin-small: 2+2+18 blocks run; the 2
# of stage 4 do not, since every model reads hidden_states[:4], as XLA drops
# them; 6 decoder layers)
EXPECTED_LAUNCHES = {"swin_window_block": 22, "fused_mlp": 28, "fused_attn_block": 12,
                     "upsample_tokens": 6}
# the served head: one fused score + upsample + argmax kernel a forward
EXPECTED_MASK_LAUNCHES = dict(EXPECTED_LAUNCHES, score_upsample_argmax=1)
# the bf16 int8 row: stages 1-3 keep the float attention half (the JAX
# package's canvas kernel has no int8 branch, nn/swin.py); stage 4, whose two
# blocks would take the int8 window block, does not run; every MLP and
# decoder attention is int8
EXPECTED_INT8_LAUNCHES = {"swin_window_block": 22, "fused_mlp_q": 28, "fused_attn_block_q": 12,
                          "upsample_tokens": 6, "score_upsample_argmax": 1}
# masks: a pixel may differ from the plain version only where the plain
# version's two best blended scores lie within the near-tie bound of each
# other, and at most MASK_DIFFER_SHARE of the pixels may differ.  f32: the two
# sum in other orders.  bf16: each side rounds its f32 scores to bf16, so a
# score differs by at most one bf16 step (2^-7 of its power of two) and,
# the blend being convex, the top two by at most 2 steps at the largest
# score (near_tie_bound); upsample_argmax reads the same values on both sides
# and blends in f32, so it takes the f32 bound in both dtypes.
NEAR_TIE_F32 = 1e-5
MASK_DIFFER_SHARE = 1e-4
MASK_F32_AGREE = 0.999
# int8 kernels against their plain versions: |Δ| <= rel · max |ref|.  In
# f32 the two sides' LayerNorm and attention differ in the last bits, so at
# 262k tokens a few hundred codes (of ~50M) land on the other side of a .5
# boundary; one such flip moves its token's outputs by up to one activation
# step times the largest weight, about max|a|·max|w| / 127, which exceeds
# 1e-3 · max |ref|.  So f32 holds at most INT8_F32_FLIP_SHARE of the
# elements above the f32 bound, and every element to the bf16 bound.
INT8_REL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}
INT8_F32_FLIP_SHARE = 1e-4
# The f32 int8 row, card vs its plain run on the CPU.  The float parts of the
# two runs differ in the last bits from the first layer on, so codes flip at
# .5 boundaries and the flips add up over the blocks; the same row with its
# input moved by 1e-6 relative differs from itself about as much.  Gates: the
# low score map's largest and mean error relative to max |ref|; the masks'
# agreement, every differing pixel a near-tie of the CPU run's blended
# scores (relative to the largest); and every int8 op call of the card's
# forward, fed the inputs it had there, against its plain version on the
# card by the kernel phase's f32 int8 rule.  The card's float row
# (quant_int8=False), a row that does no quantising, goes through the same
# gates as a control and must fail them.
INT8_LOW_MAP_MAX_REL = 2e-2
INT8_LOW_MAP_MEAN_REL = 3e-3
INT8_MASK_AGREE = 0.99
INT8_MASK_NEAR_TIE_REL = 1e-2
INT8_INPUT_NUDGE = 1e-6
# the least time the card could take (NVIDIA H100 SXM data sheet, dense, at
# 700 W): bytes at the memory rate against operations at their type's peak
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}
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
# per-step launches of the training step: the forward's, the backwards (22
# swin blocks run, so 22 swin backwards), one fused CE kernel per loss
EXPECTED_TRAIN_LAUNCHES = dict(EXPECTED_LAUNCHES, swin_window_block_bwd=22,
                               fused_attn_block_bwd=12, upsample_tokens_adjoint=6,
                               upsampled_cross_entropy=2)
# the v1 family at 512²: a ViT-B/16 of 12 layers (1025 tokens: flash), the
# fusion decoders' self-attention over 1024 or 1025 tokens (flash), their FF
# halves (fused_mlp) and DenseClip's post-norm prompt decoder (fused halves)
V1_OUT = 128
EXPECTED_V1_LAUNCHES = {"BaseModelWithText": {"flash_attention": 13, "fused_mlp": 1},
                        "ContrastiveModel": {"flash_attention": 12},
                        "DenseClip": {"flash_attention": 20, "fused_attn_block": 16,
                                      "fused_mlp": 16}}
# per-step launches of the v1 BaseModelWithText training step (phase 8b): the
# ViT's 12 layers and the decoder's self-attention, forward and backward, and
# the decoder's feed-forward.  At dropout 0.1 (8c) the self-attention takes
# the einsum path (JAX's gate) and the feed-forward the unfused modules.
EXPECTED_V1_TRAIN_LAUNCHES = {"flash_attention": 13, "flash_attention_bwd": 13, "fused_mlp": 1}
EXPECTED_V1_DROPOUT_LAUNCHES = {"flash_attention": 12, "flash_attention_bwd": 12}
V1_DROPOUT = 0.1
# f32 batch 1, card vs the CPU plain run: |Δ| <= V1_F32_MAX_REL · max |ref| on
# every output; the argmax over the classes agrees on >= V1_F32_ARGMAX_AGREE
# of the pixels, each differing pixel a near-tie (top-2 gap <= V1_NEAR_TIE_REL
# · max |ref|).  bf16 batch 16 against f32 on the card: max and mean |Δ|
# relative to max |ref| (the outputs are dot products, not cosines).
V1_F32_MAX_REL = 1e-3
V1_F32_ARGMAX_AGREE = 0.999
V1_NEAR_TIE_REL = 1e-5
V1_BF16_MAX_REL = 0.1
V1_BF16_MEAN_REL = 1e-2
# the first 16 ADE20K classes, then placeholders: the v1 prompts
ADE_NAMES = ("wall", "building", "sky", "floor", "tree", "ceiling", "road", "bed", "windowpane",
             "grass", "cabinet", "sidewalk", "person", "earth", "door", "table")


# kernel: (CUDA source, the TPU kernel it replaces)
SOURCES = {
    "fused_mlp": ("lc2is_tpu_torch/csrc/fused_mlp.cu", "lc2is_tpu/ops/fused_mlp.py:110"),
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
                                "lc2is_tpu/ops/fused_ce.py:89; lc2is_tpu/ops/fused_ce.py:117"),
    "score_upsample_argmax": ("lc2is_tpu_torch/csrc/upsample_argmax.cu",
                              "lc2is_tpu/ops/upsample_argmax.py:117"),
    "upsample_argmax": ("lc2is_tpu_torch/csrc/upsample_argmax.cu",
                        "lc2is_tpu/ops/upsample_argmax.py:33"),
    "fused_mlp_q": ("lc2is_tpu_torch/csrc/fused_mlp_q.cu", "lc2is_tpu/ops/quant.py:70"),
    "fused_attn_block_q": ("lc2is_tpu_torch/csrc/attention_block.cu",
                           "lc2is_tpu/ops/attention_block.py:37 (quant branch :38-96)"),
    "swin_window_block_q": ("lc2is_tpu_torch/csrc/swin_window.cu",
                            "lc2is_tpu/ops/window_attention.py:386 (quant branch :414-418, "
                            ":468-476)"),
    "flash_attention": ("lc2is_tpu_torch/csrc/flash_attention.cu",
                        "lc2is_tpu/ops/flash_attention.py:42"),
    "flash_attention_bwd": ("lc2is_tpu_torch/csrc/flash_attention_bwd.cu",
                            "lc2is_tpu/ops/flash_attention.py:163; "
                            "lc2is_tpu/ops/flash_attention.py:194"),
    "window_attention": ("lc2is_tpu_torch/csrc/window_attention.cu",
                         "lc2is_tpu/ops/window_attention.py:164"),
}
BACKWARD_KERNELS = ("swin_window_block_bwd", "fused_attn_block_bwd", "upsample_tokens_adjoint",
                    "upsampled_cross_entropy")


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


def least_time(nbytes, ops):
    """(ms, what sets it): the larger of the bytes at the memory rate and the
    operations at their type's peak (summed over the types a kernel uses)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(n / PEAK_OPS_PER_S[k] for k, n in ops.items())
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def rate_of(work, ms):
    """The operations of ``work`` (bytes, {type: operations}) per second at
    ``ms``, as "x TFLOP/s" (int8 operations counted alike)."""
    return f"{sum(work[1].values()) / ms / 1e9:.1f} TFLOP/s"


def mm_type(dt):
    return "bf16" if dt == torch.bfloat16 else "f32"


def op_counts(*pairs):
    """{type: operations} from (type, count) pairs, summing a type's counts."""
    ops = {}
    for kind, n in pairs:
        ops[kind] = ops.get(kind, 0) + n
    return ops


# Work of one call, (bytes, {type: operations}): each input read once, each
# output written once; operations of the matrix products (2 per multiply-add)
# and, for the bilinear kernels, of the blends.
def mlp_work(t, c, f, dt, quant=False):
    e = dt.itemsize
    w_bytes = 2 * c * f * (1 if quant else e)
    return 2 * t * c * e + w_bytes, {"int8" if quant else mm_type(dt): 4 * t * c * f}


def attn_work(b, p, l, c, dt, quant=False):
    e = dt.itemsize
    return (2 * b * p * c * e + 2 * b * l * c * e + 2 * c * c * (1 if quant else e),
            op_counts(("int8" if quant else mm_type(dt), 4 * b * p * c * c),
                      (mm_type(dt), 4 * b * p * l * c)))


def swin_work(b, h, w, c, heads, dt, quant=False, win=7):
    e = dt.itemsize
    tok = b * (-(-h // win) * win) * (-(-w // win) * win)  # HF-padded canvas
    n = win * win
    return (2 * b * h * w * c * e + 4 * c * c * (1 if quant else e) + 4 * heads * n * n,
            op_counts(("int8" if quant else mm_type(dt), 8 * tok * c * c),
                      (mm_type(dt), 4 * tok * n * c)))


def upsample_work(b, h, w, c, r, dt):
    return b * h * w * c * dt.itemsize * (1 + r * r), {"f32": 6 * b * h * w * r * r * c}


def argmax_blend_ops(b, k, h, w, r):
    # per output pixel and class: a W blend (3) and a compare, and 3/r of an H blend
    return b * k * h * w * r * r * (4 + 3 / r)


def flash_work(b, h, lq, lk, d, dt, kept=None):
    """q, k, v in and the output out (and a mask row of bytes); the two
    products over the kept keys only (``kept``: kept keys summed over the
    batch, all of them when None)."""
    keys = b * lk if kept is None else kept
    return (dt.itemsize * b * h * d * (2 * lq + 2 * lk) + (0 if kept is None else b * lk),
            {mm_type(dt): 4 * h * lq * d * keys})


def v1_prompts(n):
    """n class-name prompts (ADE20K's first classes, then placeholders)."""
    names = ADE_NAMES + tuple(f"class {i}" for i in range(len(ADE_NAMES), n))
    return [f"a photo of a {name}." for name in names[:n]]


def kernel_cases(rs, dt):
    """Every main-path shape of the 512² / batch-16 forwards: dicts of kernel
    name, shape label, launches per forward, kernel call, plain call, check
    ("close", "mask" or "int8"), work (bytes, ops) and, where one PyTorch call
    computes the same function, that call."""
    import torch.nn.functional as F

    from lc2is_tpu_torch.ops.attention_block import (fused_attn_block, fused_attn_block_plain,
                                                     fused_attn_block_q, fused_attn_block_q_plain)
    from lc2is_tpu_torch.ops.bpe import tokenize
    from lc2is_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
    from lc2is_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_plain
    from lc2is_tpu_torch.ops.quant import fused_mlp_q, fused_mlp_q_plain
    from lc2is_tpu_torch.ops.swin_window import (swin_window_block, swin_window_block_plain,
                                                 swin_window_block_q, swin_window_block_q_plain)
    from lc2is_tpu_torch.ops.upsample import upsample_tokens, upsample_tokens_plain
    from lc2is_tpu_torch.ops.upsample_argmax import (l2_normalize, score_map_plain,
                                                     score_upsample_argmax,
                                                     score_upsample_argmax_plain, upsample_argmax,
                                                     upsample_argmax_plain)

    b = BATCH
    g = IMG // 4
    cases = []

    def case(name, label, count, kern, plain, work, check="close", library=None, scores=None,
             tie_dt=None, control=None, pairs=None):
        """``count``: launches per forward of the path the kernel's JSON row
        reports (0: one call, on no path; None: checked and timed, not
        summed); ``control``: (what, a wrong call) that must fail the same
        check; ``pairs``: a mask kernel's (output pixel, class) pairs."""
        cases.append(dict(name=name, label=label, count=count, kern=kern, plain=plain, work=work,
                          check=check, library=library, scores=scores, tie_dt=tie_dt,
                          control=control, pairs=pairs))

    def w(o, i):
        return rand(rs, o, i, scale=i ** -0.5)

    def vec(n, offset=0.0):
        return rand(rs, n, scale=0.1, offset=offset)

    # swin stages: (grid, C, heads, blocks per shift); stage 4 runs on no
    # path (no model reads it): its kernels are checked and timed, not summed,
    # and the int8 window block, which the int8 row took there (and, in f32,
    # takes at stage 1: nn/swin.py's gate), is reported as one call a shift
    for s, (grid, c, heads, n) in enumerate([(g, 96, 3, 1), (g // 2, 192, 6, 1),
                                             (g // 4, 384, 12, 9), (g // 8, 768, 24, None)]):
        x = rand(rs, b, grid, grid, c, dtype=dt)
        args = (x, vec(c, 1.0), vec(c), w(3 * c, c), vec(3 * c), w(c, c), vec(c),
                rand(rs, heads, 49, 49, scale=0.1))
        for shift in (0, 3):
            lab = f"stage{s + 1} ({b},{grid},{grid},{c}) h{heads} shift{shift}"
            case("swin_window_block", lab, n,
                 lambda a=args, h=heads, sh_=shift: swin_window_block(*a, h, 7, sh_),
                 lambda a=args, h=heads, sh_=shift: swin_window_block_plain(*a, h, 7, sh_),
                 swin_work(b, grid, grid, c, heads, dt))
            if s == 3 or (s == 0 and dt == torch.float32):
                case("swin_window_block_q", lab, 0,
                     lambda a=args, h=heads, sh_=shift: swin_window_block_q(*a, h, 7, sh_),
                     lambda a=args, h=heads, sh_=shift: swin_window_block_q_plain(*a, h, 7, sh_),
                     swin_work(b, grid, grid, c, heads, dt, quant=True), check="int8")
        xt = rand(rs, b * grid * grid, c, dtype=dt)
        margs = (xt, vec(c, 1.0), vec(c), w(4 * c, c), vec(4 * c), w(c, 4 * c), vec(c))
        for name, kern, plain, q in [("fused_mlp", fused_mlp, fused_mlp_plain, False),
                                     ("fused_mlp_q", fused_mlp_q, fused_mlp_q_plain, True)]:
            case(name, f"swin{s + 1} ({b * grid * grid},{c}) gelu pre",
                 None if n is None else 2 * n,
                 lambda a=margs, k=kern: k(*a, activation="gelu", ln_position="pre"),
                 lambda a=margs, p_=plain: p_(*a, activation="gelu", ln_position="pre"),
                 mlp_work(b * grid * grid, c, 4 * c, dt, q), check="int8" if q else "close")
    # decoder: (tokens per image, SR keys, layers at that size)
    for p, l_sr, n in [(256, 64, 1), (1024, 256, 2), (4096, 1024, 3)]:
        x = rand(rs, b, p, 512, dtype=dt)
        margs = (x.reshape(-1, 512), vec(512, 1.0), vec(512), w(2048, 512), vec(2048),
                 w(512, 2048), vec(512))
        for name, kern, plain, q in [("fused_mlp", fused_mlp, fused_mlp_plain, False),
                                     ("fused_mlp_q", fused_mlp_q, fused_mlp_q_plain, True)]:
            case(name, f"decoder ({b * p},512) relu post", n,
                 lambda a=margs, k=kern: k(*a, activation="relu", ln_position="post"),
                 lambda a=margs, p_=plain: p_(*a, activation="relu", ln_position="post"),
                 mlp_work(b * p, 512, 2048, dt, q), check="int8" if q else "close")
        for l, kind in [(l_sr, "SR self"), (N_CLASSES, "cross")]:
            aargs = (x, rand(rs, b, l, 512, dtype=dt), rand(rs, b, l, 512, dtype=dt),
                     w(512, 512), vec(512), w(512, 512), vec(512), vec(512, 1.0), vec(512))
            for name, kern, plain, q in [
                    ("fused_attn_block", fused_attn_block, fused_attn_block_plain, False),
                    ("fused_attn_block_q", fused_attn_block_q, fused_attn_block_q_plain, True)]:
                case(name, f"{kind} ({b},{p},512) L{l} h8", n,
                     lambda a=aargs, k=kern: k(*a, 8), lambda a=aargs, p_=plain: p_(*a, 8),
                     attn_work(b, p, l, 512, dt, q), check="int8" if q else "close")
    for grid, c, n in [(16, 768, 1), (32, 384, 1), (16, 512, 1), (32, 512, 2), (64, 512, 1)]:
        x = rand(rs, b, grid * grid, c, dtype=dt)
        case("upsample_tokens", f"({b},{grid}²,{c}) x2", n,
             lambda x_=x, g_=grid: upsample_tokens(x_, (g_, g_), 2),
             lambda x_=x, g_=grid: upsample_tokens_plain(x_, (g_, g_), 2),
             upsample_work(b, grid, grid, c, 2, dt),
             library=lambda x_=x, g_=grid, c_=c: F.interpolate(
                 x_.view(b, g_, g_, c_).permute(0, 3, 1, 2), scale_factor=2, mode="bilinear"))
    # the served head at the stage-1 grid: decoder tokens (B, 128², 512), 151 classes
    v = rand(rs, b, g * g, 512, dtype=dt)
    tn = l2_normalize(rand(rs, b, N_CLASSES, 512, dtype=dt), 2)
    e = dt.itemsize
    case("score_upsample_argmax", f"tokens ({b},{g}²,512) K{N_CLASSES} x4", 1,
         lambda: score_upsample_argmax(v, tn, g, 4),
         lambda: score_upsample_argmax_plain(v, tn, g, 4),
         (b * g * g * 512 * e + b * N_CLASSES * 512 * e + 4 * b * 16 * g * g,
          op_counts((mm_type(dt), 2 * b * g * g * N_CLASSES * 512),
                    ("f32", argmax_blend_ops(b, N_CLASSES, g, g, 4)))),
         check="mask", scores=lambda: score_map_plain(v, tn, g), tie_dt=dt,
         pairs=b * 16 * g * g * N_CLASSES)
    smap = rand(rs, b, N_CLASSES, g, g, dtype=dt)
    case("upsample_argmax", f"map ({b},{N_CLASSES},{g},{g}) x4", 0,
         lambda: upsample_argmax(smap, 4), lambda: upsample_argmax_plain(smap, 4),
         (b * N_CLASSES * g * g * e + 4 * b * 16 * g * g,
          {"f32": argmax_blend_ops(b, N_CLASSES, g, g, 4)}),
         check="mask", scores=lambda: smap.float(), tie_dt=torch.float32)
    # flash attention, per BaseModelWithText forward: the ViT-B/16's 12
    # layers at 512² and the fusion decoder's self-attention (1024 tokens);
    # DenseClip's f32 decoder layers (1025 tokens) are checked, not summed
    shapes = [(12, 1025, 64, 12, "ViT-B/16 self"), (8, 1024, 96, 1, "v1 decoder self")]
    if dt == torch.float32:
        shapes.append((8, 1025, 96, None, "DenseClip decoder self"))
    for h, l, d, count, what in shapes:
        fqkv = tuple(rand(rs, b, h, l, d, dtype=dt) for _ in range(3))
        short = (fqkv[0],) + tuple(t[:, :, :l - 64].contiguous() for t in fqkv[1:])
        case("flash_attention", f"{what} ({b},{h},{l},{d})", count,
             lambda a=fqkv: flash_attention(*a), lambda a=fqkv: flash_attention_plain(*a),
             flash_work(b, h, l, l, d, dt), check="flash",
             library=lambda a=fqkv: F.scaled_dot_product_attention(*a),
             control=("the kernel over all keys but the last 64",
                      lambda a=short: flash_attention(*a)))
    # other head widths (1 to 128; DP = D rounded up to 16, zero-filled
    # columns): 16, 48, 128 and 40, which is no multiple of 16 (nhead 16 over
    # the ViT-B width gives 48); checked and timed, not summed
    for d in (16, 40, 48, 128):
        fqkv = tuple(rand(rs, b, 8, 1024, d, dtype=dt) for _ in range(3))
        case("flash_attention", f"D {d} ({b},8,1024,{d})", None,
             lambda a=fqkv: flash_attention(*a), lambda a=fqkv: flash_attention_plain(*a),
             flash_work(b, 8, 1024, 1024, d, dt), check="flash",
             library=lambda a=fqkv: F.scaled_dot_product_attention(*a))
    # the v1 cross-attention shape (1024 queries over the 77 text tokens) with
    # the collator's mask: the gate keeps it on the einsum path, the kernel
    # must take it; run without its mask it must fail (the control)
    mask = torch.from_numpy(tokenize(v1_prompts(b), context_length=77) == 0).cuda()
    fqkv = (rand(rs, b, 8, 1024, 96, dtype=dt), rand(rs, b, 8, 77, 96, dtype=dt),
            rand(rs, b, 8, 77, 96, dtype=dt))
    full = mask.clone().index_fill_(0, torch.arange(3, device=mask.device), True)
    for m, what, control in [(mask, "ids != 0 mask", True),
                             (full, "3 entries fully masked", False)]:
        case("flash_attention", f"({b},8,1024,96) over 77 keys, {what}", None,
             lambda a=fqkv, m_=m: flash_attention(*a, m_),
             lambda a=fqkv, m_=m: flash_attention_plain(*a, m_),
             flash_work(b, 8, 1024, 77, 96, dt, int((~m).sum())), check="flash",
             library=lambda a=fqkv, m_=m: F.scaled_dot_product_attention(
                 *a, attn_mask=~m_[:, None, None, :]),
             control=("the kernel without its mask",
                      lambda a=fqkv: flash_attention(*a)) if control else None)
    # fused_mlp / fused_attn_block at the v1 decoders' shapes (f32 on the bf16
    # path, by JAX's promotion): checked and timed, not summed
    for p, c, pos in [(1024, 768, "pre"), (1025, 768, "pre"), (N_CLASSES, 512, "post")]:
        margs = (rand(rs, b * p, c, dtype=dt), vec(c, 1.0), vec(c), w(2048, c), vec(2048),
                 w(c, 2048), vec(c))
        case("fused_mlp", f"v1 ({b * p},{c}) relu {pos}", None,
             lambda a=margs, ps=pos: fused_mlp(*a, activation="relu", ln_position=ps),
             lambda a=margs, ps=pos: fused_mlp_plain(*a, activation="relu", ln_position=ps),
             mlp_work(b * p, c, 2048, dt))
    prompts = rand(rs, b, N_CLASSES, 512, dtype=dt)
    for l in (N_CLASSES, 1025):
        aargs = (prompts, rand(rs, b, l, 512, dtype=dt), rand(rs, b, l, 512, dtype=dt),
                 w(512, 512), vec(512), w(512, 512), vec(512), vec(512, 1.0), vec(512))
        case("fused_attn_block", f"DenseClip prompt ({b},{N_CLASSES},512) L{l} h8", None,
             lambda a=aargs: fused_attn_block(*a, 8), lambda a=aargs: fused_attn_block_plain(*a, 8),
             attn_work(b, N_CLASSES, l, 512, dt))
    return cases


def near_tie_gaps(scores, differ, r=4):
    """The two best blended scores' gap at each pixel where ``differ``, from
    the plain version's low-res scores (B, K, h, w), one image at a time."""
    from lc2is_tpu_torch.ops.upsample_argmax import upsample_blend_plain

    gaps = []
    for i in range(scores.shape[0]):
        if differ[i].any():
            top2 = upsample_blend_plain(scores[i:i + 1], r).topk(2, dim=1).values[0]
            gaps.append((top2[0] - top2[1])[differ[i]])
    return torch.cat(gaps) if gaps else torch.zeros(0, device=scores.device)


def near_tie_bound(dt, scores):
    """The near-tie bound of masks from ``scores`` rounded to ``dt``: in bf16
    two bf16 steps at the largest score, else NEAR_TIE_F32."""
    if dt != torch.bfloat16:
        return NEAR_TIE_F32
    return 2 * 2.0 ** (math.floor(math.log2(scores.abs().max().item())) - 7)


def compare(c, got, want, dt):
    """(ok, error, message) of a kernel's output against its plain version's."""
    if c["check"] == "flash":  # NaN rows equal exactly, the rest to a share of the max
        nan_w = torch.isnan(want)
        same = bool(torch.equal(torch.isnan(got), nan_w))
        d = (got.float() - want.float())[~nan_w].abs()
        lim = FLASH_REL[dt] * want.float()[~nan_w].abs().max().item()
        ok = same and bool((d <= lim).all()) and bool(torch.isfinite(d).all())
        return ok, d.max().item(), (f"max {d.max().item():.3e} mean {d.mean().item():.3e} (<= "
                                    f"{FLASH_REL[dt]}·max|plain| = {lim:.3e}); NaN rows "
                                    f"{int(nan_w.all(-1).sum())} in the plain output, "
                                    f"{'the same' if same else 'NOT the same'} in the kernel's")
    if c["check"] == "mask":
        scores = c["scores"]()
        tie = near_tie_bound(c["tie_dt"], scores)
        differ = got != want
        n = int(differ.sum())
        gaps = near_tie_gaps(scores, differ)
        worst = gaps.max().item() if gaps.numel() else 0.0
        ok = (got.dtype == torch.int32 and bool(gaps.le(tie).all())
              and n <= MASK_DIFFER_SHARE * differ.numel())
        return ok, worst, (f"{n} of {differ.numel()} pixels differ (at most "
                           f"{MASK_DIFFER_SHARE} of them), largest top-2 gap there {worst:.3e} "
                           f"(near-tie bound {tie:.3e})")
    d = (got.float() - want.float()).abs()
    ref = want.float().abs()
    if c["check"] == "int8":
        lim = INT8_REL[dt] * ref.max()
        over = d > lim
        n_over = int(over.sum())
        rows = int(over.reshape(-1, d.shape[-1]).any(-1).sum())
        ok = bool(d.max() <= INT8_REL[torch.bfloat16] * ref.max())
        if dt == torch.float32:
            ok = ok and n_over <= INT8_F32_FLIP_SHARE * d.numel()
        else:
            ok = ok and n_over == 0
        bound = (f"{INT8_REL[dt]}·max|plain| = {lim.item():.3e}; {n_over} elements of "
                 f"{rows} tokens above it")
    else:
        atol, rtol = BOUNDS[dt]
        ok = bool((d <= atol + rtol * ref).all())
        bound = f"{atol} + {rtol}·|plain|"
    ok = ok and bool(torch.isfinite(got).all())
    return ok, d.max().item(), f"max {d.max().item():.3e} mean {d.mean().item():.3e} (<= {bound})"


def run_case(c, dt, stats):
    """Check one kernel case against its plain version (and its control,
    which must fail), time it beside its plain version and one-call twin, and
    add its bf16 numbers, times its launches, to ``stats``."""
    with torch.no_grad():
        got = c["kern"]()
        torch.cuda.synchronize()
        want = c["plain"]()
        ok, err, msg = compare(c, got, want, dt)
        k_ms, p_ms = time_ms(c["kern"]), time_ms(c["plain"])
        lib_ms = time_ms(c["library"]) if c["library"] else None
        ctl = compare(c, c["control"][1](), want, dt) if c["control"] else None
    b_ms, by = least_time(*c["work"])
    lib = f" one-call {lib_ms:8.3f}" if lib_ms is not None else ""
    if c["name"] == "flash_attention":  # its rate and its ratio to SDPA
        lib += f" ({rate_of(c['work'], k_ms)}, {k_ms / lib_ms:.2f}x SDPA)"
    elif c["name"] in ("swin_window_block", "fused_mlp", "fused_attn_block", "fused_mlp_q",
                       "fused_attn_block_q"):
        lib += f" ({rate_of(c['work'], k_ms)})"
    elif c["name"] == "score_upsample_argmax":  # the product's rate, the argmax's pairs a second
        mm = sum(n for k_, n in c["work"][1].items() if k_ != "f32")
        lib += (f" (product {mm / k_ms / 1e9:.1f} TFLOP/s, argmax "
                f"{c['pairs'] / k_ms / 1e6:.1f} G pairs/s over the kernel's time)")
    elif c["name"] == "window_attention":  # bytes-bound: its memory rate and SDPA ratio
        lib += (f" ({c['work'][0] / k_ms / 1e6:.1f} GB/s of {HBM_BYTES_PER_S / 1e9:.0f}, "
                f"{k_ms / lib_ms:.2f}x SDPA)")
    per = "not summed" if c["count"] is None else f"x{c['count']}/fwd"
    print(f"  {c['name']:21s} {c['label']:42s} kernel {k_ms:8.3f} ms plain {p_ms:8.3f}"
          f"{lib} bound {b_ms:7.3f} ({by}) {per}; {msg} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{c['name']} {c['label']} {dt}: kernel disagrees with its "
                             f"plain version: {msg}")
    if ctl is not None:
        print(f"    control, {c['control'][0]}: {ctl[2]}: "
              f"{'passes' if ctl[0] else 'fails, as it must'}", flush=True)
        if ctl[0]:
            raise AssertionError(f"{c['name']} {c['label']}: the check passes its "
                                 f"control, {c['control'][0]}")
    s = stats.setdefault(c["name"], dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                                         bound_ms=0.0, library_ms=None, by={}))
    s["max_abs_err"] = max(s["max_abs_err"], err)
    if dt == torch.bfloat16 and c["count"] is not None:
        # per 512² / batch-16 bf16 forward (count 0: one call)
        n = c["count"] or 1
        s["ms"] += n * k_ms
        s["plain_ms"] += n * p_ms
        s["bound_ms"] += n * b_ms
        s["by"][by] = s["by"].get(by, 0.0) + n * b_ms
        if lib_ms is not None:
            s["library_ms"] = (s["library_ms"] or 0.0) + n * lib_ms
    return k_ms, p_ms, lib_ms, b_ms


def check_kernels(smi):
    """Phase 3.  Returns per-kernel stats for the JSON line: bf16 times,
    bounds and one-call times summed per forward of the path using each."""
    stats = {}
    for dt in (torch.bfloat16, torch.float32):
        print(f"\n[kernels] {dt} on {smi}", flush=True)
        rs = np.random.RandomState(SEED)
        for c in kernel_cases(rs, dt):
            run_case(c, dt, stats)
        torch.cuda.empty_cache()
    return stats


# swin-small's window-attention shapes in a 512² batch-16 forward: (stage,
# HF-padded grid, C, heads, blocks per shift a forward; None: stage 4, which
# runs on no path, timed as one call and not summed)
WINDOW_STAGES = [(1, 133, 96, 3, 1), (2, 70, 192, 6, 1), (3, 35, 384, 12, 9), (4, 21, 768, 24, None)]


def window_work(n, p, c, heads, dt, regions):
    """q, k, v in and the output out, the bias and the region labels; the two
    products per head."""
    return (4 * n * p * c * dt.itemsize + 4 * heads * p * p + (4 * n * p if regions else 0),
            {mm_type(dt): 4 * n * heads * p * p * (c // heads)})


def window_cases(rs, dt):
    """window_attention (TPU row 8) at the four swin-small stage shapes, shift
    0 and 3, with SDPA (the bias and the region mask as one additive mask) as
    its one-call twin; the shifted case run without its labels is the
    control that must fail."""
    import torch.nn.functional as F

    from lc2is_tpu_torch.ops.window_attention import (NEG, region_labels, window_attention,
                                                      window_attention_plain)

    cases = []
    for stage, hp, c, heads, count in WINDOW_STAGES:
        n, p, dh = BATCH * (hp // 7) ** 2, 49, c // heads
        q, k, v = (rand(rs, n, p, c, dtype=dt) for _ in range(3))
        bias = rand(rs, heads, p, p, scale=0.5)
        split = tuple(t.view(n, p, heads, dh).transpose(1, 2) for t in (q, k, v))
        for shift in (0, 3):
            reg = region_labels(BATCH, hp, hp, 7, shift, device="cuda")
            mask = bias[None]
            if reg is not None:
                mask = mask + torch.where(reg[:, None, :, None] != reg[:, None, None, :], NEG,
                                          0.0)
            mask = mask.to(dt)
            cases.append(dict(
                name="window_attention", count=count, check="close", library=(
                    lambda a=split, m=mask: F.scaled_dot_product_attention(*a, attn_mask=m)),
                label=f"stage{stage} ({n},{p},{c}) h{heads} shift{shift}",
                kern=lambda a=(q, k, v, bias, reg), h=heads: window_attention(*a, h),
                plain=lambda a=(q, k, v, bias, reg), h=heads: window_attention_plain(*a, h),
                work=window_work(n, p, c, heads, dt, reg is not None), scores=None, tie_dt=None,
                control=None if reg is None else (
                    "the shifted case run without its region labels",
                    lambda a=(q, k, v, bias), h=heads: window_attention(*a, None, h))))
    return cases


def check_window_attention(smi):
    """Phase 3w: window_attention (TPU row 8) against its plain version on the
    card at swin-small's four stage shapes, shift 0 and 3, bf16 and f32; its
    recompute backward against autograd through the plain version at stage
    3's shape; the windowed module path (SwinAttention.forward) on the card
    against its CPU run.  Returns the kernel's stats (bf16 times summed over
    the 22 blocks of stages 1-3)."""
    from lc2is_tpu_torch.core.convert import seeded_init_
    from lc2is_tpu_torch.nn.swin import SwinAttention, window_partition
    from lc2is_tpu_torch.ops.window_attention import (region_labels, window_attention,
                                                      window_attention_plain)

    stats = {}
    for dt in (torch.bfloat16, torch.float32):
        print(f"\n[window] {dt} on {smi}", flush=True)
        for c in window_cases(np.random.RandomState(SEED + 5), dt):
            run_case(c, dt, stats)
        torch.cuda.empty_cache()
    s = stats["window_attention"]
    print(f"[window] per forward (22 blocks of stages 1-3, half of them shifted), bf16: "
          f"kernel {s['ms']:.3f} ms, plain {s['plain_ms']:.3f}, SDPA {s['library_ms']:.3f}, "
          f"bound {s['bound_ms']:.3f} ms", flush=True)

    rs = np.random.RandomState(SEED + 6)
    reg = region_labels(BATCH, 35, 35, 7, 3, device="cuda")
    for dt in (torch.bfloat16, torch.float32):
        q, k, v = (rand(rs, 400, 49, 384, dtype=dt) for _ in range(3))
        bias, g = rand(rs, 12, 49, 49, scale=0.5), rand(rs, 400, 49, 384, dtype=dt)
        grads = []
        for fn in (window_attention, window_attention_plain):
            leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v, bias)]
            fn(*leaves, reg, 12).backward(g)
            grads.append([t.grad for t in leaves])
        rel = max(((a.float() - b.float()).norm() / b.float().norm()).item()
                  for a, b in zip(*grads))
        print(f"[window] backward {dt} (400,49,384) h12 shift3, recompute through the plain "
              f"version vs autograd through it: dq dk dv dbias ‖Δ‖/‖ref‖ <= {rel:.3e} (bound "
              f"{GRAD_BOUNDS[dt]})", flush=True)
        if not rel <= GRAD_BOUNDS[dt]:
            raise AssertionError(f"window_attention backward {dt}: {rel}")

    cpu = seeded_init_(SwinAttention(384, 12, 7), SEED).eval()
    gpu = SwinAttention(384, 12, 7, device="cuda").eval()
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    x = window_partition(rand(rs, 1, 35, 35, 384, device="cpu"), 7)
    before = window_attention.launches
    with torch.no_grad():
        want, got = cpu(x, (35, 35, 7, 3)), gpu(x.cuda(), (35, 35, 7, 3)).cpu()
    d = (got - want).abs()
    atol, rtol = BOUNDS[torch.float32]
    ok = bool((d <= atol + rtol * want.abs()).all()) and window_attention.launches == before + 1
    print(f"[window] SwinAttention.forward f32, stage-3 windows of one {IMG}² image (25,49,384) "
          f"shift 3, card vs CPU: max |Δ| {d.max().item():.3e} (<= {atol} + {rtol}·|CPU|), "
          f"{window_attention.launches - before} launch {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("SwinAttention.forward on the card disagrees with its CPU run")
    return stats


def backward_cases(rs, dt):
    """(kernel name, shape label, launches per training step, kernel call,
    (kernel-path fn, plain fn, args, g) for the gradient check, work (bytes,
    ops), the one PyTorch call of the same function or None) at every shape
    of the 512² / batch-8 training step.  The plain time is autograd's
    backward through the plain version; for the fused CE, whose one kernel
    computes the loss and the gradient, it is the plain forward + backward.
    A backward's work: its inputs and gradients once, and three times its
    forward's products (the recompute, and two products per forward product)."""
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
                nbytes, ops = swin_work(b, grid, grid, c, heads, dt)
                cases.append((
                    "swin_window_block_bwd",
                    f"stage{s + 1} ({b},{grid},{grid},{c}) h{heads} shift{shift} res{int(res)}",
                    count,
                    lambda a=args, q=(wq_s, bq_s), k=kw, g_=gr: swin_window_block_bwd(
                        a[0], g_, a[1], a[2], q[0], q[1], *a[5:], **k),
                    (lambda *a, k=kw: swin_window_block(*a, **k),
                     lambda *a, k=kw: swin_window_block_plain(*a, **k), args, gr),
                    (3 * nbytes // 2 + 4 * 4 * c * c, {k_: 3 * v_ for k_, v_ in ops.items()}),
                    None))
    for p, l_sr, n in [(256, 64, 1), (1024, 256, 2), (4096, 1024, 3)]:
        x = rand(rs, b, p, 512, dtype=dt)
        gr = rand(rs, b, p, 512, dtype=dt)
        for l, kind in [(l_sr, "SR self"), (N_CLASSES, "cross")]:
            args = [x, rand(rs, b, l, 512, dtype=dt), rand(rs, b, l, 512, dtype=dt),
                    w(512, 512), vec(512), w(512, 512), vec(512), vec(512, 1.0), vec(512)]
            q = fold_q(args[3], args[4], 8)
            nbytes, ops = attn_work(b, p, l, 512, dt)
            cases.append((
                "fused_attn_block_bwd", f"{kind} ({b},{p},512) L{l} h8", n,
                lambda a=args, q=q, g_=gr: fused_attn_block_bwd(a[0], a[1], a[2], g_, *q,
                                                                *a[5:], 8),
                (lambda *a: fused_attn_block(*a, 8), lambda *a: fused_attn_block_plain(*a, 8),
                 args, gr),
                (2 * nbytes + 4 * 512 * 512 * 4, {k_: 3 * v_ for k_, v_ in ops.items()}), None))
    for grid, c, n in [(16, 768, 1), (32, 384, 1), (16, 512, 1), (32, 512, 2), (64, 512, 1)]:
        x = rand(rs, b, grid * grid, c, dtype=dt)
        gr = rand(rs, b, 4 * grid * grid, c, dtype=dt)
        cases.append((
            "upsample_tokens_adjoint", f"({b},{grid}²,{c}) x2", n,
            lambda g_=gr, h=grid: upsample_tokens_adjoint(g_, (h, h), 2),
            (lambda a, h=grid: upsample_tokens(a, (h, h), 2),
             lambda a, h=grid: upsample_tokens_plain(a, (h, h), 2), [x], gr),
            upsample_work(b, grid, grid, c, 2, dt),
            lambda g_=gr, h=grid, c_=c: torch.ops.aten.upsample_bilinear2d_backward(
                g_.view(b, 2 * h, 2 * h, c_).permute(0, 3, 1, 2), [2 * h, 2 * h], [b, c_, h, h],
                False, None, None)))
    for h, r in [(g, 4), (g // 4, 16)]:
        x = rand(rs, b, N_CLASSES, h, h, dtype=dt)
        y = seeded_labels(SEED + r, b, IMG, IMG)
        cases.append((
            "upsampled_cross_entropy", f"({b},{N_CLASSES},{h},{h}) r{r}, labels ({b},{IMG},{IMG})",
            1, lambda x_=x, y_=y, r_=r: fused_ce_fwd(x_, y_, r_),
            (lambda a, y_=y, r_=r: upsampled_cross_entropy(a, y_, r_),
             lambda a, y_=y, r_=r: upsampled_cross_entropy_plain(a, y_, r_), [x], None),
            # logits in and their gradient out, int64 labels; per hi-res pixel
            # and class a blend, an exp and a sum (about 8 operations, 2 of
            # them exponentials: the softmax's, and the gradient's recomputed)
            (2 * x.numel() * dt.itemsize + 8 * y.numel(), {"f32": 8 * N_CLASSES * y.numel()}),
            None))
    return cases


def flash_bwd_work(b, h, lq, lk, d, dt, kept=None):
    """q, k, v, the output and its gradient in, dq, dk, dv out, the f32 lse
    (and a mask row of bytes); five products over the kept keys (the
    recomputed scores, dO·vᵀ, dv, dq, dk: 2 operations per multiply-add)."""
    keys = b * lk if kept is None else kept
    return (dt.itemsize * b * h * d * (4 * lq + 4 * lk) + 4 * b * h * lq
            + (0 if kept is None else b * lk), {mm_type(dt): 10 * h * lq * d * keys})


def flash_backward_cases(rs, dt):
    """The flash backward rows of phase 3b, at the shapes of the v1 training
    step (batch 16, 512²: the ViT-B/16's 12 layers and the fusion decoder's
    self-attention) and beside them: (label, launches per phase-8b step, or
    None for checked and timed but not summed, (q, k, v, g, key-padding mask),
    control or None)."""
    b = BATCH

    def inputs(h, lq, lk, d, mask=None):
        return tuple(rand(rs, b, h, n, d, dtype=dt) for n in (lq, lk, lk, lq)) + (mask,)

    keep = torch.from_numpy(rs.randint(512, 1025, size=b)).cuda()
    mask = torch.arange(1024, device="cuda")[None] >= keep[:, None]
    return [("ViT-B/16 self (16,12,1025,64)", 12, inputs(12, 1025, 1025, 64), "short"),
            ("v1 decoder self (16,8,1024,96)", 1, inputs(8, 1024, 1024, 96), None),
            ("masked (16,8,1024,96), 512-1024 keys kept", None,
             inputs(8, 1024, 1024, 96, mask), "unmasked"),
            ("D 48 (16,16,1024,48)", None, inputs(16, 1024, 1024, 48), None),
            ("ragged Lq 77 over Lk 1025 (16,12,77,64)", None, inputs(12, 77, 1025, 64), None)]


def check_flash_backward(stats):
    """Phase 3b, flash: flash_attention_bwd (the dq and the dk/dv kernels)
    against flash_attention_backward_plain on the kernel forward's output and
    lse, ‖Δ‖/‖ref‖ of each of dq, dk, dv within GRAD_BOUNDS; two controls must
    fail the same gate: the kernel over all keys but the last 64 (its dk and
    dv zero there), and the masked case run unmasked.  Times: CUDA events,
    the kernel, the plain version and SDPA's backward (one call)."""
    import torch.nn.functional as F

    from lc2is_tpu_torch.ops.flash_attention import (flash_attention,
                                                     flash_attention_backward_plain,
                                                     flash_attention_bwd)

    def rel_of(got, want):
        return max(((a.float() - b_.float()).norm() / b_.float().norm().clamp_min(1e-30)).item()
                   for a, b_ in zip(got, want))

    for dt in (torch.bfloat16, torch.float32):
        bound = GRAD_BOUNDS[dt]
        print(f"\n[backward] flash, {dt}: bound ‖kernel - plain‖ / ‖plain‖ <= {bound} over "
              f"dq, dk, dv", flush=True)
        rs = np.random.RandomState(SEED + 4)
        for label, count, (q, k, v, g, mask), control in flash_backward_cases(rs, dt):
            with torch.no_grad():
                out, lse = flash_attention(q, k, v, mask, with_stats=True)

                def kern(q=q, k=k, v=v, g=g, mask=mask, out=out, lse=lse):
                    return flash_attention_bwd(q, k, v, mask, out, lse, g)

                def plain(q=q, k=k, v=v, g=g, mask=mask, out=out, lse=lse):
                    return flash_attention_backward_plain(q, k, v, mask, out, lse, g)

                got = kern()
                torch.cuda.synchronize()
                want = plain()
                rel = rel_of(got, want)
                mx = max((a.float() - b_.float()).abs().max().item() for a, b_ in zip(got, want))
                ok = rel <= bound and all(bool(torch.isfinite(a).all()) for a in got)
                if control == "short":
                    what = "the kernel over all keys but the last 64"
                    dq, dk, dv = flash_attention_bwd(q, k[:, :, :-64].contiguous(),
                                                     v[:, :, :-64].contiguous(), None, out, lse,
                                                     g)
                    pad = torch.zeros_like(dk[:, :, :64])
                    ctl = rel_of((dq, torch.cat([dk, pad], 2), torch.cat([dv, pad], 2)), want)
                elif control == "unmasked":
                    what = "the masked case run unmasked"
                    ctl = rel_of(flash_attention_bwd(q, k, v, None, out, lse, g), want)
                k_ms = time_ms(kern, reps=5, warmup=1)
                p_ms = time_ms(plain, reps=5, warmup=1)
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            o = F.scaled_dot_product_attention(
                *leaves, attn_mask=None if mask is None else ~mask[:, None, None, :])
            lib_ms = time_ms(lambda: torch.autograd.grad(o, leaves, g, retain_graph=True),
                             reps=5, warmup=1)
            b, h, lq, d = q.shape
            kept = None if mask is None else int((~mask).sum())
            work = flash_bwd_work(b, h, lq, k.shape[2], d, dt, kept)
            b_ms, by = least_time(*work)
            per = "not summed" if count is None else f"x{count}/step"
            print(f"  {'flash_attention_bwd':23s} {label:46s} max {mx:.3e} rel {rel:.3e} kernel "
                  f"{k_ms:8.3f} ms plain {p_ms:8.3f} one-call {lib_ms:8.3f} ({rate_of(work, k_ms)}"
                  f" over 5 products, {k_ms / lib_ms:.2f}x SDPA's backward) bound {b_ms:7.3f} "
                  f"({by}) {per} {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(f"flash_attention_bwd {label} {dt}: backward kernels "
                                     f"disagree with the plain backward (rel {rel:.3e})")
            if control is not None:
                print(f"    control, {what}: rel {ctl:.3e}: "
                      f"{'passes' if ctl <= bound else 'fails, as it must'}", flush=True)
                if ctl <= bound:
                    raise AssertionError(f"flash_attention_bwd {label}: the gate passes its "
                                         f"control, {what}")
            st = stats.setdefault("flash_attention_bwd", dict(
                max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, by={}))
            st["max_abs_err"] = max(st["max_abs_err"], mx)
            if dt == torch.bfloat16 and count is not None:  # per phase-8b step
                st["ms"] += count * k_ms
                st["plain_ms"] += count * p_ms
                st["bound_ms"] += count * b_ms
                st["library_ms"] += count * lib_ms
                st["by"][by] = st["by"].get(by, 0.0) + count * b_ms
            del got, want, out, lse, leaves, o
        torch.cuda.empty_cache()


def check_backward_kernels():
    """Phase 3b.  Returns per-kernel stats for the JSON line."""
    stats = {}
    for dt in (torch.bfloat16, torch.float32):
        bound = GRAD_BOUNDS[dt]
        print(f"\n[backward] {dt}: bound ‖kernel - plain‖ / ‖plain‖ <= {bound} over every "
              f"gradient", flush=True)
        rs = np.random.RandomState(SEED + 3)
        for name, label, count, kern, (kfn, pfn, args, g), work, library in backward_cases(rs, dt):
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
            lib_ms = time_ms(library, reps=5, warmup=1) if library else None
            b_ms, by = least_time(*work)
            ok = rel <= bound and finite
            lib = f" one-call {lib_ms:8.3f}" if lib_ms is not None else ""
            if name in ("fused_attn_block_bwd", "swin_window_block_bwd"):
                lib += f" ({rate_of(work, k_ms)})"
            if name == "upsampled_cross_entropy":  # its exponentials and f32 operations a second
                f32_ops = work[1]["f32"]
                lib += (f" ({f32_ops / 4 / k_ms / 1e9:.2f} T exp/s, "
                        f"{f32_ops / k_ms / 1e9:.1f} T f32 op/s)")
            print(f"  {name:23s} {label:46s} max {mx:.3e} rel {rel:.3e} kernel {k_ms:8.3f} ms "
                  f"plain {p_ms:8.3f}{lib} bound {b_ms:7.3f} ({by}) x{count}/step "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(f"{name} {label} {dt}: backward kernel disagrees with "
                                     f"autograd through its plain version (rel {rel:.3e})")
            st = stats.setdefault(name, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                                             library_ms=None, by={}))
            st["max_abs_err"] = max(st["max_abs_err"], mx)
            if dt == torch.bfloat16:  # time per 512² / batch-8 bf16 training step
                st["ms"] += count * k_ms
                st["plain_ms"] += count * p_ms
                st["bound_ms"] += count * b_ms
                st["by"][by] = st["by"].get(by, 0.0) + count * b_ms
                if lib_ms is not None:
                    st["library_ms"] = (st["library_ms"] or 0.0) + count * lib_ms
            del got, want, out_p, ka, pa
        torch.cuda.empty_cache()
    check_flash_backward(stats)
    return stats


NAMES = tuple(f"thing {i}" for i in range(N_CLASSES))


def seeded_state():
    """state_dict of the full-width PromptAuxCrossA, weights from the numpy seed."""
    from lc2is_tpu_torch.core.convert import seeded_init_
    from lc2is_tpu_torch.models.zoo import PromptAuxCrossA

    t0 = time.time()
    cpu = seeded_init_(PromptAuxCrossA(class_names=NAMES, device="cpu"), SEED)
    n = sum(p.numel() for p in cpu.parameters())
    print(f"\n[slice] PromptAuxCrossA swin-small / decoder 512 / 12-layer text tower / "
          f"{N_CLASSES} classes: {n} parameters from numpy seed {SEED} "
          f"({time.time() - t0:.1f} s)", flush=True)
    return cpu.state_dict()


def model_from(state, name="PromptAuxCrossA", **kw):
    from lc2is_tpu_torch.models import zoo

    m = getattr(zoo, name)(class_names=NAMES, **kw)
    m.load_state_dict(state, strict=True)
    return m


def frozen_prefixes(name):
    """The prefixes the reference freezes for model class ``name``."""
    from lc2is_tpu_torch.models.zoo import FROZEN_PREFIXES, ZOO

    key = {cls.__name__: k for k, cls in ZOO.items()}[name]
    return FROZEN_PREFIXES.get(key, ())


def is_frozen(param, prefixes):
    return any(param == p or param.startswith(p + ".") for p in prefixes)


def build_models(state):
    return (model_from(state, device="cpu").eval(), model_from(state).eval(),
            model_from(state, dtype=torch.bfloat16).eval())


def launch_counters():
    from lc2is_tpu_torch.ops.attention_block import (fused_attn_block, fused_attn_block_bwd,
                                                     fused_attn_block_q)
    from lc2is_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd
    from lc2is_tpu_torch.ops.fused_ce import upsampled_cross_entropy
    from lc2is_tpu_torch.ops.fused_mlp import fused_mlp
    from lc2is_tpu_torch.ops.quant import fused_mlp_q
    from lc2is_tpu_torch.ops.swin_window import (swin_window_block, swin_window_block_bwd,
                                                 swin_window_block_q)
    from lc2is_tpu_torch.ops.upsample import upsample_tokens, upsample_tokens_adjoint
    from lc2is_tpu_torch.ops.upsample_argmax import score_upsample_argmax, upsample_argmax
    from lc2is_tpu_torch.ops.window_attention import window_attention

    return {f.__name__: f for f in (swin_window_block, fused_mlp, fused_attn_block,
                                    upsample_tokens, swin_window_block_bwd,
                                    fused_attn_block_bwd, upsample_tokens_adjoint,
                                    upsampled_cross_entropy, score_upsample_argmax,
                                    upsample_argmax, fused_mlp_q, fused_attn_block_q,
                                    swin_window_block_q, flash_attention, flash_attention_bwd,
                                    window_attention)}


def serve_batches(model, batches, extra, counters, expected, label, smi):
    """Answer ``batches[1:]`` (with the other inputs ``extra``) after a
    warm-up on ``batches[0]``, the launch counters set to 0 just before the
    first timed batch and read just after it; assert the counts.  Returns
    (outputs of the first timed batch, ms, the counts)."""
    model({"pixel_values": batches[0], **extra})  # warm-up
    torch.cuda.synchronize()
    times, first = [], None
    for i, px in enumerate(batches[1:]):
        if i == 0:
            for f in counters.values():
                f.launches = 0
        t0 = time.perf_counter()
        out = model({"pixel_values": px, **extra})
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            counts = {name: f.launches for name, f in counters.items() if f.launches}
            first = out
    print(f"[{label}] launches over one forward: {counts} (expected {expected})")
    if counts != expected:
        raise AssertionError(f"{label}: launch counts {counts} != {expected}")
    ms = statistics.median(times)
    print(f"[{label}] bf16 b{BATCH} {IMG}² forward (host clock to synchronize): "
          f"{[round(t, 2) for t in times]} ms, median {ms:.2f} ms = "
          f"{BATCH * 1e3 / ms:.1f} img/s on {smi}", flush=True)
    return first, ms, counts


def check_masks_out(masks, label):
    if (tuple(masks.shape) != (masks.shape[0], IMG, IMG) or masks.dtype != torch.int32
            or masks.min().item() < 0 or masks.max().item() >= N_CLASSES):
        raise AssertionError(f"{label}: masks {tuple(masks.shape)} {masks.dtype} out of range")


def check_slice(smi, state):
    """Phase 4.  Returns what 4m and 5 reuse: (the CPU run's decoder tokens
    and class embeddings, the batch-1 input, text on the CPU and the card,
    the bf16 batches)."""
    from lc2is_tpu_torch.ops.upsample_argmax import l2_normalize

    cpu, gpu32, gpu16 = build_models(state)
    captured = {}
    cpu.vision_decoder.register_forward_hook(lambda m, a, out: captured.update(v=out))
    cpu.prompt.register_forward_hook(lambda m, a, out: captured.update(t=out))
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
        cpu_head = (captured["v"], l2_normalize(captured["t"], 2))
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
        batches = [rand(np.random.RandomState(SEED + 10 + i), BATCH, 3, IMG, IMG,
                        dtype=torch.bfloat16) for i in range(4)]
        outs = serve_batches(gpu16, batches, {"text_static": ts_gpu}, launch_counters(),
                             EXPECTED_LAUNCHES, "slice (b)", smi)[0]
        for key, shape in (("outputs", (BATCH, N_CLASSES, IMG, IMG)),
                           ("low_score_map", (BATCH, N_CLASSES, IMG // 16, IMG // 16))):
            o = outs[key]
            if tuple(o.shape) != shape or o.dtype != torch.bfloat16 or not torch.isfinite(o).all():
                raise AssertionError(f"bf16 {key} {tuple(o.shape)} {o.dtype} or non-finite")
        print(f"[slice] (b) bf16 b{BATCH}: {len(batches) - 1} batches answered, outputs "
              f"{tuple(outs['outputs'].shape)} bf16 finite")

        ref = gpu32({"pixel_values": batches[1].float(), "text_static": ts_gpu})
        for key in ("outputs", "low_score_map"):
            d = (outs[key].float() - ref[key]).abs()
            agree = (outs[key].float().argmax(1) == ref[key].argmax(1)).float().mean().item()
            print(f"[slice] (b) bf16 vs f32 on the card, {key}: max |Δ| {d.max().item():.3e} "
                  f"(bound {SLICE_BF16_MAX_ABS}) mean {d.mean().item():.3e} (bound "
                  f"{SLICE_BF16_MEAN_ABS}), argmax agreement {agree:.4f}", flush=True)
            if d.max().item() > SLICE_BF16_MAX_ABS or d.mean().item() > SLICE_BF16_MEAN_ABS:
                raise AssertionError(f"bf16 slice outside its bound of the f32 slice ({key})")
    return cpu_head, x1, ts_cpu, ts_gpu, batches


def check_masks(smi, state, cpu_head, x1, ts_gpu, batches):
    """Phase 4m: the served head.  Returns (launch counts of one bf16
    forward, the first timed batch's bf16 masks, the forward's median ms)."""
    from lc2is_tpu_torch.ops.upsample_argmax import score_map_plain, score_upsample_argmax_plain

    with torch.no_grad():
        gpu32 = model_from(state, predict_masks=True).eval()
        got = gpu32({"pixel_values": x1.cuda(), "text_static": ts_gpu})["outputs"].cpu()
        v, tn = cpu_head
        grid = IMG // 4
        want = score_upsample_argmax_plain(v, tn, grid)
        check_masks_out(got, "masks (a)")
        differ = got != want
        gaps = near_tie_gaps(score_map_plain(v, tn, grid), differ)
        agree = 1.0 - differ.float().mean().item()
        worst = gaps.max().item() if gaps.numel() else 0.0
        print(f"[masks] (a) f32 b1 {tuple(got.shape)} int32: card vs the CPU plain masks of the "
              f"4a decoder output, agreement {agree:.6f} (bound {MASK_F32_AGREE}); "
              f"{int(differ.sum())} pixels differ, largest top-2 gap there {worst:.3e} "
              f"(near-tie bound {NEAR_TIE_F32})", flush=True)
        if agree < MASK_F32_AGREE or worst > NEAR_TIE_F32:
            raise AssertionError("f32 masks on the card disagree with the CPU plain masks")
        del gpu32
        gpu16 = model_from(state, dtype=torch.bfloat16, predict_masks=True).eval()
        first, ms, counts = serve_batches(gpu16, batches, {"text_static": ts_gpu},
                                          launch_counters(), EXPECTED_MASK_LAUNCHES, "masks (b)",
                                          smi)
        check_masks_out(first["outputs"], "masks (b)")
    return counts, first["outputs"], ms


@contextlib.contextmanager
def recording_int8_calls():
    """Record every int8 op call the model's modules make, with its inputs
    and output, by rebinding the names nn/layers.py and nn/swin.py call the
    ops by.  Yields the list of (op name, plain version, float twin, args,
    kwargs, output)."""
    import lc2is_tpu_torch.nn.layers as layers
    import lc2is_tpu_torch.nn.swin as swin
    from lc2is_tpu_torch.ops.attention_block import fused_attn_block, fused_attn_block_q_plain
    from lc2is_tpu_torch.ops.fused_mlp import fused_mlp
    from lc2is_tpu_torch.ops.quant import fused_mlp_q_plain
    from lc2is_tpu_torch.ops.swin_window import swin_window_block, swin_window_block_q_plain

    twins = {"fused_mlp_q": (fused_mlp_q_plain, fused_mlp),
             "fused_attn_block_q": (fused_attn_block_q_plain, fused_attn_block),
             "swin_window_block_q": (swin_window_block_q_plain, swin_window_block)}
    calls, saved = [], []
    for mod in (layers, swin):
        for name, (plain, twin) in twins.items():
            if hasattr(mod, name):
                op = getattr(mod, name)
                saved.append((mod, name, op))

                def rec(*a, _op=op, _plain=plain, _twin=twin, **kw):
                    out = _op(*a, **kw)
                    calls.append((_op.__name__, _plain, _twin, a, kw, out))
                    return out
                setattr(mod, name, rec)
    try:
        yield calls
    finally:
        for mod, name, op in saved:
            setattr(mod, name, op)


def int8_row_gates(got, want, scores):
    """(ok, message) of a served f32 forward ``got`` against the CPU plain
    int8 run ``want``; ``scores``: that run's low-res cosine scores."""
    ref = want["low_score_map"]
    top = ref.abs().max().item()
    d = (got["low_score_map"] - ref).abs()
    mx, mean = d.max().item() / top, d.mean().item() / top
    differ = got["outputs"] != want["outputs"]
    agree = 1.0 - differ.float().mean().item()
    gaps = near_tie_gaps(scores, differ)
    gap = (gaps.max().item() if gaps.numel() else 0.0) / scores.abs().max().item()
    ok = (mx <= INT8_LOW_MAP_MAX_REL and mean <= INT8_LOW_MAP_MEAN_REL
          and agree >= INT8_MASK_AGREE and gap <= INT8_MASK_NEAR_TIE_REL)
    return ok, (f"low_score_map max |Δ| {mx:.3e} (bound {INT8_LOW_MAP_MAX_REL}) mean {mean:.3e} "
                f"(bound {INT8_LOW_MAP_MEAN_REL}) x max |ref|; masks agree {agree:.6f} (bound "
                f"{INT8_MASK_AGREE}), largest top-2 gap where they differ {gap:.3e} x max "
                f"|score| (bound {INT8_MASK_NEAR_TIE_REL})")


def check_int8_calls(calls):
    """Each int8 op call of the card's f32 forward, fed the inputs it had
    there, against its plain version on the card by compare()'s f32 int8
    rule; as a control, the op's float twin on the same inputs must fail the
    same rule at every call."""
    by_op = {}
    with torch.no_grad():
        for name, plain, twin, a, kw, out in calls:
            want = plain(*a, **kw)
            ok, err, msg = compare(dict(check="int8"), out, want, torch.float32)
            t_ok, t_err, t_msg = compare(dict(check="int8"), twin(*a, **kw), want, torch.float32)
            s = by_op.setdefault(name, dict(n=0, err=0.0, twin_err=math.inf, twin_ok=0))
            s["n"] += 1
            s["err"] = max(s["err"], err / want.abs().max().item())
            s["twin_err"] = min(s["twin_err"], t_err / want.abs().max().item())
            s["twin_ok"] += t_ok
            if not ok:
                raise AssertionError(f"int8 row: a {name} call {tuple(a[0].shape)} on the card "
                                     f"disagrees with its plain version on its inputs: {msg}")
    for name, s in by_op.items():
        print(f"[int8] (a) {s['n']} {name} calls at their inputs in the card's forward: largest "
              f"|Δ| vs the plain version {s['err']:.3e} x max |ref|, every call within the f32 "
              f"int8 rule; control, the float twin on the same inputs: fails the rule at "
              f"{s['n'] - s['twin_ok']} of {s['n']} calls (its smallest largest |Δ| "
              f"{s['twin_err']:.3e} x max |ref|)", flush=True)
        if s["twin_ok"]:
            raise AssertionError(f"the int8 rule does not tell {name} from its float twin")
    return sum(s["n"] for s in by_op.values())


def check_int8(smi, state, x1, ts_cpu, ts_gpu, batches, masks16, masks_ms):
    """Phase 5: the int8 row.  Returns the launch counts of one bf16 forward;
    prints its time over ``masks_ms``, the bf16 masks forward's of 4m."""
    from lc2is_tpu_torch.ops.upsample_argmax import l2_normalize, score_map_plain

    with torch.no_grad():
        cpu = model_from(state, device="cpu", predict_masks=True, quant_int8=True).eval()
        captured = {}
        cpu.vision_decoder.register_forward_hook(lambda m, a, out: captured.update(v=out))
        cpu.prompt.register_forward_hook(lambda m, a, out: captured.update(t=out))
        t0 = time.time()
        want = cpu({"pixel_values": x1, "text_static": ts_cpu})
        cpu_s = time.time() - t0
        scores = score_map_plain(captured["v"], l2_normalize(captured["t"], 2), IMG // 4)
        del cpu
        gpu_q = model_from(state, predict_masks=True, quant_int8=True).eval()
        with recording_int8_calls() as calls:
            got = {k: v.cpu() for k, v in gpu_q({"pixel_values": x1.cuda(),
                                                 "text_static": ts_gpu}).items()}
        check_masks_out(got["outputs"], "int8 (a)")
        ok, msg = int8_row_gates(got, want, scores)
        print(f"[int8] (a) f32 b1, card vs CPU plain: {msg}; CPU plain forward {cpu_s:.1f} s",
              flush=True)
        if not ok:
            raise AssertionError("f32 int8 row on the card disagrees with the CPU plain run")
        n_calls = check_int8_calls(calls)
        del calls
        nudged = {k: v.cpu() for k, v in gpu_q({"pixel_values": x1.cuda() * (1 + INT8_INPUT_NUDGE),
                                                "text_static": ts_gpu}).items()}
        print(f"[int8] (a) yardstick, the card's int8 row with its input x (1 + "
              f"{INT8_INPUT_NUDGE}): {int8_row_gates(nudged, want, scores)[1]}", flush=True)
        del gpu_q
        gpu_f = model_from(state, predict_masks=True).eval()
        control = {k: v.cpu() for k, v in gpu_f({"pixel_values": x1.cuda(),
                                                 "text_static": ts_gpu}).items()}
        c_ok, c_msg = int8_row_gates(control, want, scores)
        print(f"[int8] (a) control, the card's float row (quant_int8=False) through the same "
              f"gates: {c_msg}: {'passes' if c_ok else 'fails, as it must'}", flush=True)
        if c_ok:
            raise AssertionError("the int8 row's gates do not tell it from the float row")
        del gpu_f
        gpu16 = model_from(state, dtype=torch.bfloat16, predict_masks=True,
                           quant_int8=True).eval()
        first, ms, counts = serve_batches(gpu16, batches, {"text_static": ts_gpu},
                                          launch_counters(), EXPECTED_INT8_LAUNCHES, "int8 (b)",
                                          smi)
        check_masks_out(first["outputs"], "int8 (b)")
        print(f"[int8] (b) the int8 masks forward over the bf16 masks forward of 4m (host clock, "
              f"medians): {ms:.2f} / {masks_ms:.2f} ms = {ms / masks_ms:.3f}x", flush=True)
        agree = (first["outputs"] == masks16).float().mean().item()
        print(f"[int8] (b) bf16 b{BATCH} masks agree with the bf16 masks of 4m on {agree:.5f} of "
              f"the pixels (random weights: printed, not gated); {n_calls} int8 op calls "
              f"checked in (a)", flush=True)
    return counts


def train_models(state, name="PromptAuxCrossA", **kw):
    from lc2is_tpu_torch.engine.optim import make_optimizer

    m = model_from(state, name, return_score_map=True, **kw)
    return m, make_optimizer(m, lr=TRAIN_LR, frozen_prefixes=frozen_prefixes(name))


def check_train_f32(state, name="PromptAuxCrossA", label="train"):
    """Phase 6a (11a for BaseCrossA): one f32 step at batch 1, 512² images and
    labels, drop path off, card vs CPU."""
    from lc2is_tpu_torch.engine.engine import train_step
    from lc2is_tpu_torch.nn.swin import SWIN_SMALL

    frozen = frozen_prefixes(name)
    nodrop = dict(swin_cfg=dict(SWIN_SMALL, drop_path_rate=0.0))
    cpu, opt_c = train_models(state, name, device="cpu", **nodrop)
    gpu, opt_g = train_models(state, name, **nodrop)
    x = rand(np.random.RandomState(SEED + 20), 1, 3, IMG, IMG, device="cpu")
    y = seeded_labels(SEED + 21, 1, IMG, IMG, device="cpu")
    t0 = time.time()
    want = train_step(cpu, opt_c, {"pixel_values": x}, y)
    cpu_s = time.time() - t0
    got = train_step(gpu, opt_g, {"pixel_values": x.cuda()}, y.cuda())
    torch.cuda.synchronize()
    for key in want:
        g_, w_ = got[key].item(), want[key].item()
        print(f"[{label}] (a) {name} f32 b1 {IMG}² {key}: card {g_:.6f} CPU {w_:.6f} "
              f"(bound {STEP_LOSS_RTOL} relative)", flush=True)
        if not (np.isfinite(g_) and abs(g_ - w_) <= STEP_LOSS_RTOL * abs(w_)):
            raise AssertionError(f"f32 step {key}: card {g_} vs CPU {w_}")
    worst, worst_name, n_grads, worst_param = 0.0, "", 0, 0.0
    gp = dict(gpu.named_parameters())
    for pname, p in cpu.named_parameters():
        q = gp[pname]
        if is_frozen(pname, frozen):
            if q.grad is not None or not torch.equal(q.detach().cpu(), state[pname]):
                raise AssertionError(f"frozen {pname} got a gradient or changed")
            continue
        if p.grad is None or q.grad is None:
            if (p.grad is None) != (q.grad is None):
                raise AssertionError(f"{pname}: gradient on one device only")
            continue
        n_grads += 1
        gq = q.grad.cpu()
        zero_in_exact = pname.endswith("attention.self.key.bias")
        ref = dict(cpu.named_parameters())[pname.replace("key.bias", "query.bias")] \
            if zero_in_exact else p
        rel = ((gq - p.grad).norm() / ref.grad.norm().clamp_min(1e-30)).item()
        if rel > worst:
            worst, worst_name = rel, pname
        if zero_in_exact:
            continue
        sure = p.grad.abs() >= torch.clamp(1e-3 * p.grad.abs().max(), min=1e-6)
        d = (q.detach().cpu() - p.detach())[sure].abs()
        worst_param = max(worst_param, d.max().item() if d.numel() else 0.0)
    tower = ("frozen " + ", ".join(frozen) + ": no gradient, unchanged bit for bit"
             if frozen else "nothing frozen")
    print(f"[{label}] (a) {n_grads} trainable gradients, card vs CPU: worst norm-relative "
          f"{worst:.3e} ({worst_name}; bound {STEP_GRAD_REL}); parameters after AdamW max "
          f"|Δ| {worst_param:.3e} (bound {STEP_PARAM_ATOL:.1e}); {tower}; CPU step "
          f"{cpu_s:.1f} s", flush=True)
    if worst > STEP_GRAD_REL or worst_param > STEP_PARAM_ATOL:
        raise AssertionError("f32 training step on the card disagrees with the CPU run")


def check_train_bf16(smi, state, name="PromptAuxCrossA", expected=None, label="train"):
    """Phase 6b (11b for BaseCrossA): bf16 batch 8, drop path 0.1, decoder
    dropout 0.  Returns (launch counts of one step, median step ms)."""
    from lc2is_tpu_torch.engine.engine import train_step

    expected = EXPECTED_TRAIN_LAUNCHES if expected is None else expected
    frozen = frozen_prefixes(name)
    model, opt = train_models(state, name, dtype=torch.bfloat16)
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
            counts = {k: f.launches for k, f in counters.items() if f.launches}
        losses.append({k: v.item() for k, v in out.items()})
    print(f"[{label}] (b) {name} bf16 b{TRAIN_BATCH} {IMG}², drop path 0.1: losses per step "
          f"{[tuple(round(v, 5) for v in d.values()) for d in losses]} ({', '.join(losses[0])})")
    print(f"[{label}] launches over one step: {counts} (expected {expected})")
    if counts != expected:
        raise AssertionError(f"{name} training launch counts {counts} != {expected}")
    if not all(np.isfinite(v) for d in losses for v in d.values()):
        raise AssertionError("non-finite training loss")
    changed = [n for n, p in model.named_parameters() if not torch.equal(p.detach(), start[n])]
    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    moved_frozen = [n for n in changed if is_frozen(n, frozen)]
    # stage 4's blocks are dead code (hidden_states[:4]): no gradient, no
    # update; a swin key bias's gradient is zero in exact arithmetic (softmax
    # is invariant to the q·bk a row's logits share), so it may not move
    dead = [n for n in trainable if n.startswith("vision_encoder.stages.3.blocks.")]
    zero = [n for n in trainable if n.endswith("attention.self.key.bias") and n not in dead]
    stuck = sorted(set(trainable) - set(changed) - set(dead) - set(zero))
    print(f"[{label}] {len(changed)} of {len(trainable)} trainable parameters changed after 8 "
          f"steps; not required to: the {len(dead)} of stage 4's dead blocks (as in the "
          f"reference) and the {len(zero)} swin key biases ({len(set(zero) - set(changed))} "
          f"did not move); frozen changed: {len(moved_frozen)}", flush=True)
    if stuck or moved_frozen:
        raise AssertionError(f"parameters not updated {stuck[:5]} / frozen moved {moved_frozen[:5]}")
    ms = statistics.median(times)
    print(f"[{label}] (b) {name} bf16 b{TRAIN_BATCH} {IMG}² step (host clock to synchronize): "
          f"{[round(t, 2) for t in times]} ms, median {ms:.2f} ms = "
          f"{TRAIN_BATCH * 1e3 / ms:.2f} img/s on {smi}", flush=True)
    profile_step(lambda: train_step(model, opt, inputs, y, generator=gen),
                 f"one {name} bf16 step")
    return counts, ms


# the five other v4 models (phase 10): per-forward launches of the bf16
# served-mask forward.  The CrossA decoders run the flagship's 6 SR decoder
# layers (12 attention halves); the SelfA decoders 6 SR encoder layers (one
# self-attention half each); every decoder layer has one feed-forward, and
# the swin and the head are the flagship's.
V4_MODELS = ("BaseCrossA", "BaseSelfA", "PromptCrossA", "PromptSelfA", "PromptAuxSelfA")
EXPECTED_V4_LAUNCHES = {
    name: dict(EXPECTED_MASK_LAUNCHES, **({} if "CrossA" in name else {"fused_attn_block": 6}))
    for name in V4_MODELS}
# BaseCrossA's training step (phase 11b): the flagship's, with one loss (no
# low-res map, so one fused CE kernel)
EXPECTED_V4_TRAIN_LAUNCHES = dict(EXPECTED_TRAIN_LAUNCHES, upsampled_cross_entropy=1)


def check_v4_model(smi, name):
    """Phase 10 for one model: (a) f32 batch 1, the card against the same
    model's plain run on the CPU under phase 4a's score-map gates, and the
    card's masks against the CPU plain masks of the CPU run's decoder output
    under phase 4m's gates; (b) bf16 batch 16 masks with text cached, three
    batches answered and timed, the launch counts of one forward asserted.
    Returns (median ms, launch counts)."""
    from lc2is_tpu_torch.core.convert import seeded_init_
    from lc2is_tpu_torch.models import zoo
    from lc2is_tpu_torch.ops.upsample_argmax import (l2_normalize, score_map_plain,
                                                     score_upsample_argmax_plain)

    t0 = time.time()
    cpu = seeded_init_(getattr(zoo, name)(class_names=NAMES, device="cpu"), SEED).eval()
    state = cpu.state_dict()
    prompted = hasattr(cpu, "prompt")
    print(f"\n[v4] {name}: {sum(p.numel() for p in cpu.parameters())} parameters from numpy "
          f"seed {SEED} ({time.time() - t0:.1f} s)", flush=True)
    captured = {}
    cpu.vision_decoder.register_forward_hook(lambda m, a, out: captured.update(v=out))
    (cpu.prompt if prompted else cpu.classes).register_forward_hook(
        lambda m, a, out: captured.update(t=out))
    gpu = model_from(state, name).eval()
    x1 = rand(np.random.RandomState(SEED + 1), 1, 3, IMG, IMG, device="cpu")
    with torch.no_grad():
        text_c = {"text_static": cpu.embed_text()} if prompted else {}
        text_g = {"text_static": gpu.embed_text()} if prompted else {}
        t0 = time.time()
        want = cpu({"pixel_values": x1, **text_c})
        cpu_s = time.time() - t0
        got = gpu({"pixel_values": x1.cuda(), **text_g})
        torch.cuda.synchronize()
        for key, w_ in want.items():
            g_ = got[key].cpu()
            if tuple(g_.shape) != tuple(w_.shape) or not torch.isfinite(g_).all():
                raise AssertionError(f"{name} f32 {key}: shape {tuple(g_.shape)} / non-finite")
            d = (g_ - w_).abs()
            agree = (g_.argmax(1) == w_.argmax(1)).float().mean().item()
            print(f"[v4] (a) {name} f32 b1 {key} {tuple(g_.shape)}: card vs CPU plain max |Δ| "
                  f"{d.max().item():.3e} (bound {SLICE_F32_MAX_ABS}) mean {d.mean().item():.3e}, "
                  f"argmax agreement {agree:.5f} (bound {SLICE_F32_ARGMAX_AGREE})", flush=True)
            if d.max().item() > SLICE_F32_MAX_ABS or agree < SLICE_F32_ARGMAX_AGREE:
                raise AssertionError(f"{name}: f32 {key} on the card disagrees with the CPU")
        gpu.predict_masks = True
        masks = gpu({"pixel_values": x1.cuda(), **text_g})["outputs"].cpu()
        v, tn, grid = captured["v"], l2_normalize(captured["t"], 2), IMG // 4
        check_masks_out(masks, f"{name} masks (a)")
        differ = masks != score_upsample_argmax_plain(v, tn, grid)
        gaps = near_tie_gaps(score_map_plain(v, tn, grid), differ)
        agree = 1.0 - differ.float().mean().item()
        worst = gaps.max().item() if gaps.numel() else 0.0
        print(f"[v4] (a) {name} f32 b1 masks: card vs the CPU plain masks of the CPU decoder "
              f"output, agreement {agree:.6f} (bound {MASK_F32_AGREE}); {int(differ.sum())} "
              f"differ, largest top-2 gap there {worst:.3e} (near-tie bound {NEAR_TIE_F32}); "
              f"CPU forward {cpu_s:.1f} s", flush=True)
        if agree < MASK_F32_AGREE or worst > NEAR_TIE_F32:
            raise AssertionError(f"{name}: f32 masks on the card disagree with the CPU")
        del cpu, gpu, want, got
        gpu16 = model_from(state, name, dtype=torch.bfloat16, predict_masks=True).eval()
        text = {"text_static": gpu16.embed_text()} if prompted else {}
        batches = [rand(np.random.RandomState(SEED + 10 + i), BATCH, 3, IMG, IMG,
                        dtype=torch.bfloat16) for i in range(4)]
        first, ms, counts = serve_batches(gpu16, batches, text, launch_counters(),
                                          EXPECTED_V4_LAUNCHES[name], f"v4 {name} (b)", smi)
        check_masks_out(first["outputs"], f"{name} masks (b)")
        if name == "PromptAuxSelfA":
            low = first["low_score_map"]
            if (tuple(low.shape) != (BATCH, N_CLASSES, IMG // 16, IMG // 16)
                    or low.dtype != torch.bfloat16 or not torch.isfinite(low).all()):
                raise AssertionError(f"{name} bf16 low_score_map {tuple(low.shape)} {low.dtype}")
    del gpu16, batches, first
    torch.cuda.empty_cache()
    return ms, counts


def check_v4(smi):
    """Phase 10: the other five v4 models served.  Returns {name: ms}."""
    return {name: check_v4_model(smi, name)[0] for name in V4_MODELS}


def check_v4_train(smi):
    """Phase 11: BaseCrossA's training step (the CLI's default model), one
    loss through the fused upsample-CE, nothing frozen.  Returns (launch
    counts of one 11b step, its median ms)."""
    from lc2is_tpu_torch.core.convert import seeded_init_
    from lc2is_tpu_torch.models.zoo import BaseCrossA

    state = seeded_init_(BaseCrossA(class_names=NAMES, device="cpu"), SEED).state_dict()
    check_train_f32(state, "BaseCrossA", "v4 train")
    torch.cuda.empty_cache()
    return check_train_bf16(smi, state, "BaseCrossA", EXPECTED_V4_TRAIN_LAUNCHES, "v4 train")


def profile_step(step, label, rows=40):
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
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=rows)
    print(f"[profile] {label}: {len(events)} device kernels, busy {busy / 1e3:.2f} ms "
          f"in a {span / 1e3:.2f} ms first-to-last span (idle {100 * (1 - busy / span):.1f} %)")
    print(table, flush=True)


def v1_text(n, device):
    """input_ids (n, 77) from ops/bpe.tokenize on n class-name prompts and
    attention_mask = ids != 0 (the collator's)."""
    from lc2is_tpu_torch.ops.bpe import tokenize

    ids = torch.from_numpy(tokenize(v1_prompts(n), context_length=77))
    return {"input_ids": ids.to(device), "attention_mask": (ids != 0).long().to(device)}


# per v1 model: constructor arguments, prompts at batch 1 and 16, output
# names (None where the model returns None), the output whose argmax over the
# classes is checked with its class axis, and the one the bf16 gate holds
V1_MODELS = {
    "BaseModelWithText": (dict(out_size=V1_OUT), 1, BATCH,
                          ("feature_t", "feature_v", "feature_mm"), ("feature_mm", 1),
                          "feature_mm"),
    "ContrastiveModel": (dict(out_size=V1_OUT), N_CLASSES, N_CLASSES,
                         ("feature_t", "feature_v", "logits"), ("logits", -1), None),
    "DenseClip": (dict(), N_CLASSES, N_CLASSES, (None, "score_map", "out"), ("score_map", 1),
                  None),
}


def rel_err(got, want):
    """(max, mean) |Δ| relative to max |ref|."""
    top = want.float().abs().max().item()
    d = (got.float() - want.float()).abs()
    return d.max().item() / top, d.mean().item() / top


def check_v1_f32(name, got, want, names, argmax_of):
    """Phase 7 f32 batch 1: every output of the card within V1_F32_MAX_REL of
    the CPU plain run; the argmax over the classes agrees, near-ties only."""
    for key, g, w in zip(names, got, want):
        if key is None:
            if g is not None or w is not None:
                raise AssertionError(f"v1 {name}: expected None")
            continue
        g = g.cpu()
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"v1 {name} {key}: shape {tuple(g.shape)} / non-finite")
        mx, mean = rel_err(g, w)
        msg = ""
        ok = mx <= V1_F32_MAX_REL
        if key == argmax_of[0]:
            dim = argmax_of[1]
            differ = g.argmax(dim) != w.argmax(dim)
            agree = 1.0 - differ.float().mean().item()
            top2 = w.topk(2, dim=dim).values
            gaps = (top2.select(dim, 0) - top2.select(dim, 1))[differ]
            gap = (gaps.max().item() if gaps.numel() else 0.0) / w.abs().max().item()
            ok = ok and agree >= V1_F32_ARGMAX_AGREE and gap <= V1_NEAR_TIE_REL
            msg = (f"; argmax over the classes agrees on {agree:.6f} (bound "
                   f"{V1_F32_ARGMAX_AGREE}), largest top-2 gap where it differs {gap:.3e} x max "
                   f"|ref| (bound {V1_NEAR_TIE_REL})")
        print(f"[v1] (a) {name} f32 b1 {key} {tuple(g.shape)}: card vs CPU plain max |Δ| "
              f"{mx:.3e} (bound {V1_F32_MAX_REL}) mean {mean:.3e} x max |ref| "
              f"{w.abs().max().item():.4g}{msg}", flush=True)
        if not ok:
            raise AssertionError(f"v1 {name} f32 on the card disagrees with the CPU plain run "
                                 f"({key})")


def check_v1(smi):
    """Phase 7: the v1 CLIP family.  Returns {model: (launch counts of one
    bf16 forward, median forward ms)}."""
    from lc2is_tpu_torch.core.convert import seeded_init_
    from lc2is_tpu_torch.models import zoo

    x1 = rand(np.random.RandomState(SEED + 40), 1, 3, IMG, IMG, device="cpu")
    batches = [rand(np.random.RandomState(SEED + 50 + i), BATCH, 3, IMG, IMG,
                    dtype=torch.bfloat16) for i in range(4)]
    counters = launch_counters()
    results = {}
    for name, (kw, n1, n16, names, argmax_of, gated) in V1_MODELS.items():
        cls = getattr(zoo, name)
        t0 = time.time()
        cpu = seeded_init_(cls(in_size=IMG, device="cpu", **kw), SEED).eval()
        state = cpu.state_dict()
        n_par = sum(p.numel() for p in cpu.parameters())
        with torch.no_grad():
            t1 = time.time()
            want = cpu({"pixel_values": x1, **v1_text(n1, "cpu")})
            cpu_s = time.time() - t1
            del cpu
            gpu32 = cls(in_size=IMG, **kw)
            gpu32.load_state_dict(state, strict=True)
            gpu32.eval()
            got = gpu32({"pixel_values": x1.cuda(), **v1_text(n1, "cuda")})
            torch.cuda.synchronize()
            print(f"\n[v1] {name}, CLIP ViT-B/16 at {IMG}² + 12-layer text tower: {n_par} "
                  f"parameters from numpy seed {SEED} ({t1 - t0:.1f} s); CPU plain forward b1 "
                  f"{cpu_s:.1f} s", flush=True)
            check_v1_f32(name, got, want, names, argmax_of)
            del got, want
            gpu16 = cls(in_size=IMG, dtype=torch.bfloat16, **kw)
            gpu16.load_state_dict(state, strict=True)
            gpu16.eval()
            text = v1_text(n16, "cuda")
            first, ms, counts = serve_batches(gpu16, batches, text, counters,
                                              EXPECTED_V1_LAUNCHES[name], f"v1 {name}", smi)
            if name == "BaseModelWithText":
                profile_step(lambda: gpu16({"pixel_values": batches[1], **text}),
                             f"one bf16 b{BATCH} {name} forward", rows=25)
            ref = gpu32({"pixel_values": batches[1].float(), **text})
            for key, o, r in zip(names, first, ref):
                if key is None:
                    continue
                if o.shape != r.shape or not torch.isfinite(o).all():
                    raise AssertionError(f"v1 {name} bf16 {key}: {tuple(o.shape)} or non-finite")
                mx, mean = rel_err(o, r)
                bound = (f" (bounds {V1_BF16_MAX_REL}, {V1_BF16_MEAN_REL})" if key == gated
                         else " (printed, not gated)")
                print(f"[v1] (b) {name} bf16 b{BATCH} {key} {tuple(o.shape)} {o.dtype} vs f32 on "
                      f"the card: max |Δ| {mx:.3e} mean {mean:.3e} x max |ref|{bound}", flush=True)
                if key == gated and (mx > V1_BF16_MAX_REL or mean > V1_BF16_MEAN_REL):
                    raise AssertionError(f"v1 {name} bf16 outside its bound of f32 ({key})")
        results[name] = (counts, ms)
        del gpu32, gpu16, first, ref
        torch.cuda.empty_cache()
    return results


def v1_train_models(state, **kw):
    """A BaseModelWithText at 512² (out 128²) from ``state`` and its AdamW
    (lr 1e-5; nothing is frozen for this model)."""
    from lc2is_tpu_torch.engine.optim import make_optimizer
    from lc2is_tpu_torch.models.zoo import BaseModelWithText

    m = BaseModelWithText(in_size=IMG, out_size=V1_OUT, **kw)
    m.load_state_dict(state, strict=True)
    return m, make_optimizer(m, lr=TRAIN_LR)


def exact_zero_partner(name):
    """For a parameter whose gradient is 0 in exact arithmetic (f32 noise on
    both devices), the parameter whose gradient norm that noise is held to: a
    key bias (softmax is invariant to the q·bk a row's logits share) against
    its layer's query bias; the prototypes' projection bias (it adds
    feature_v·b to every class's logit alike) against the visual one."""
    if name.endswith("k_proj.bias"):
        return name.replace("k_proj", "q_proj")
    if name == "pixel_patch.textual.bias":
        return "pixel_patch.visual.bias"
    return None


def check_v1_train_f32(state):
    """Phase 8a: one f32 BaseModelWithText step at batch 1, 512², card vs
    CPU: the loss, every gradient, the parameters after AdamW."""
    from lc2is_tpu_torch.engine.engine import train_step

    cpu, opt_c = v1_train_models(state, device="cpu")
    gpu, opt_g = v1_train_models(state)
    x = rand(np.random.RandomState(SEED + 60), 1, 3, IMG, IMG, device="cpu")
    y = seeded_labels(SEED + 61, 1, V1_OUT, V1_OUT, device="cpu")
    t0 = time.time()
    want = train_step(cpu, opt_c, {"pixel_values": x, **v1_text(1, "cpu")}, y)
    cpu_s = time.time() - t0
    got = train_step(gpu, opt_g, {"pixel_values": x.cuda(), **v1_text(1, "cuda")}, y.cuda())
    torch.cuda.synchronize()
    g_, w_ = got["train_loss"].item(), want["train_loss"].item()
    print(f"\n[v1 train] (a) f32 b1 {IMG}² BaseModelWithText train_loss: card {g_:.6f} CPU "
          f"{w_:.6f} (bound {STEP_LOSS_RTOL} relative)", flush=True)
    if not (np.isfinite(g_) and abs(g_ - w_) <= STEP_LOSS_RTOL * abs(w_)):
        raise AssertionError(f"v1 f32 step train_loss: card {g_} vs CPU {w_}")
    cp, gp = dict(cpu.named_parameters()), dict(gpu.named_parameters())
    rels, worst_param, unread = {}, 0.0, []
    for name, p in cp.items():
        q = gp[name]
        if p.grad is None or q.grad is None:
            if (p.grad is None) != (q.grad is None):
                raise AssertionError(f"{name}: gradient on one device only")
            unread.append(name)
            continue
        partner = exact_zero_partner(name)
        ref = cp[partner or name].grad
        rels[name] = ((q.grad.cpu() - p.grad).norm() / ref.norm().clamp_min(1e-30)).item()
        if partner:
            continue
        sure = p.grad.abs() >= torch.clamp(1e-3 * p.grad.abs().max(), min=1e-6)
        d = (q.detach().cpu() - p.detach())[sure].abs()
        worst_param = max(worst_param, d.max().item() if d.numel() else 0.0)
    worst = max(rels, key=rels.get)
    named = {n: f"{rels[n]:.3e}" for n in ("vision_encoder.encoder_layers.0.self_attn.q_proj."
                                           "weight", "vision_encoder.encoder_layers.0.self_attn."
                                           "k_proj.weight", "vision_encoder.encoder_layers.11."
                                           "self_attn.v_proj.weight", "class_prototypes")}
    print(f"[v1 train] (a) {len(rels)} gradients, card vs CPU: worst norm-relative "
          f"{rels[worst]:.3e} ({worst}; bound {STEP_GRAD_REL}; the key biases and the "
          f"prototypes' projection bias, 0 in exact arithmetic, against their partner's norm); "
          f"{named}; no gradient on either device: {unread} (not read by the model); "
          f"parameters after AdamW max |Δ| {worst_param:.3e} (bound {STEP_PARAM_ATOL:.1e}); "
          f"CPU step {cpu_s:.1f} s", flush=True)
    if rels[worst] > STEP_GRAD_REL or worst_param > STEP_PARAM_ATOL:
        raise AssertionError("v1 f32 training step on the card disagrees with the CPU run")


def v1_train_batch():
    x = rand(np.random.RandomState(SEED + 62), BATCH, 3, IMG, IMG, dtype=torch.bfloat16)
    y = seeded_labels(SEED + 63, BATCH, V1_OUT, V1_OUT)
    return {"pixel_values": x, **v1_text(BATCH, "cuda")}, y


def step_counts(counters, step):
    """Run ``step`` with every launch counter at 0; (its output, the counts)."""
    for f in counters.values():
        f.launches = 0
    out = step()
    torch.cuda.synchronize()
    return out, {name: f.launches for name, f in counters.items() if f.launches}


def check_v1_train_bf16(smi, state):
    """Phase 8b: the bf16 batch-16 BaseModelWithText step at dropout 0: two
    warm-up steps, six timed, the launch counts of the first timed step, a
    profile of one more.  Returns (the counts, median step ms)."""
    from lc2is_tpu_torch.engine.engine import train_step

    model, opt = v1_train_models(state, dtype=torch.bfloat16)
    inputs, y = v1_train_batch()
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    counters = launch_counters()
    for _ in range(2):  # warm-up
        train_step(model, opt, inputs, y)
    torch.cuda.synchronize()
    times, losses = [], []
    for i in range(6):
        t0 = time.perf_counter()
        if i == 0:
            out, counts = step_counts(counters, lambda: train_step(model, opt, inputs, y))
        else:
            out = train_step(model, opt, inputs, y)
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(out["train_loss"].item())
    print(f"\n[v1 train] (b) bf16 b{BATCH} {IMG}², labels {V1_OUT}², dropout 0: losses per step "
          f"{[round(v, 5) for v in losses]}")
    print(f"[v1 train] (b) launches over one step: {counts} (expected "
          f"{EXPECTED_V1_TRAIN_LAUNCHES})")
    if counts != EXPECTED_V1_TRAIN_LAUNCHES:
        raise AssertionError(f"v1 training launch counts {counts} != {EXPECTED_V1_TRAIN_LAUNCHES}")
    if not all(np.isfinite(losses)):
        raise AssertionError("non-finite v1 training loss")
    stuck = [n for n, p in model.named_parameters()
             if torch.equal(p.detach(), start[n]) and not exact_zero_partner(n)
             and p.grad is not None]
    if stuck:
        raise AssertionError(f"v1 parameters not updated after 8 steps: {stuck[:5]}")
    ms = statistics.median(times)
    print(f"[v1 train] (b) bf16 b{BATCH} {IMG}² step (host clock to synchronize): "
          f"{[round(t, 2) for t in times]} ms, median {ms:.2f} ms = {BATCH * 1e3 / ms:.2f} "
          f"img/s on {smi}", flush=True)
    profile_step(lambda: train_step(model, opt, inputs, y), f"one bf16 b{BATCH} v1 step")
    return counts, ms


def check_v1_train_dropout(state):
    """Phase 8c: one bf16 step at dropout 0.1 from a seeded generator, three
    times from the same weights: seeds s, s, s + 1.  The launch counts of the
    first; finite losses; the same seed repeats the loss bit for bit, the
    other seed does not."""
    from lc2is_tpu_torch.engine.engine import train_step

    inputs, y = v1_train_batch()
    counters = launch_counters()
    runs = []
    for seed in (SEED, SEED, SEED + 1):
        model, opt = v1_train_models(state, dtype=torch.bfloat16, dropout=V1_DROPOUT)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        out, counts = step_counts(counters,
                                  lambda: train_step(model, opt, inputs, y, generator=gen))
        runs.append((out["train_loss"], counts,
                     {n: p.detach().clone() for n, p in model.named_parameters()}))
        del model, opt
    (l0, counts, p0), (l1, _, p1), (l2, _, _) = runs
    drift = max((p0[n].float() - p1[n].float()).abs().max().item() for n in p0)
    same = "bit for bit" if torch.equal(l0, l1) else "DIFFERENT"
    print(f"\n[v1 train] (c) bf16 b{BATCH} dropout {V1_DROPOUT}: launches over one step "
          f"{counts} (expected {EXPECTED_V1_DROPOUT_LAUNCHES}); train_loss seed {SEED}: "
          f"{l0.item():.6f} and again {l1.item():.6f} ({same}), seed {SEED + 1}: "
          f"{l2.item():.6f}; largest parameter difference between the two seed-{SEED} steps "
          f"{drift:.3e} (printed, not gated)", flush=True)
    if counts != EXPECTED_V1_DROPOUT_LAUNCHES:
        raise AssertionError(f"v1 dropout launch counts {counts} != "
                             f"{EXPECTED_V1_DROPOUT_LAUNCHES}")
    if not all(torch.isfinite(v) for v in (l0, l1, l2)):
        raise AssertionError("non-finite v1 dropout loss")
    if not torch.equal(l0, l1) or torch.equal(l0, l2):
        raise AssertionError("v1 dropout step does not follow its generator seed")


def check_v1_train(smi):
    """Phase 8: v1 training.  Returns (launch counts of one 8b step, its ms)."""
    from lc2is_tpu_torch.core.convert import seeded_init_
    from lc2is_tpu_torch.models.zoo import BaseModelWithText

    state = seeded_init_(BaseModelWithText(in_size=IMG, out_size=V1_OUT, device="cpu"),
                         SEED).state_dict()
    check_v1_train_f32(state)
    result = check_v1_train_bf16(smi, state)
    torch.cuda.empty_cache()
    check_v1_train_dropout(state)
    return result


# the kernels of the bf16 tensor-core bodies: flash (rows 15, 16), the
# decoder attention forward and backward (rows 2, 3: the attention cores,
# the GEMM, which the feed-forward (row 1) and the swin backward share, and
# the LayerNorm pass of rows 1 and 2), the swin window block (rows 6, 9),
# window attention (row 8), the swin backward's attention core (rows 7,
# 10), and the int8 row's s8 GEMM and row pass (rows 2q, 17)
MMA_KERNELS = ("flash_mma_kernel", "flash_bwd_dq_mma", "flash_bwd_dkv_mma", "attn_fwd_mma",
               "attn_dq_mma", "attn_dkdv_mma", "gemm_bf16_kernel", "layer_norm_rows",
               "swin_mma_kernel", "window_attention_mma", "swin_attn_bwd_mma", "gemm_s8_kernel",
               "quant_rows_kernel", "head_kernel", "fused_ce_kernel")


def mma_registers(log):
    """The tensor-core bodies' kernels' registers a thread and spill stores,
    from ptxas's report in the build log: "name<template args>
    registers/spill bytes", once for a kernel that several sources compile."""
    lines = log.splitlines()
    out = []
    for i, line in enumerate(lines):
        if "Compiling entry" not in line:
            continue
        name = next((n for n in MMA_KERNELS if n + "I" in line), None)
        info = " ".join(lines[i + 1:i + 4])
        if name is None or "Used " not in info:
            continue
        raw = line.split(name + "I")[1].split("EE")[0]
        targs = ",".join({"13__nv_bfloat16": "bf16", "f": "f32"}.get(t, t.lstrip("Lib"))
                         for t in re.findall(r"13__nv_bfloat16|L[ib]-?\d+|^f", raw))
        regs = info.split("Used ")[1].split()[0]
        spill = info.split("bytes spill stores")[0].split(",")[-1].strip()
        if f"{name}<{targs}> {regs}/{spill}" not in out:
            out.append(f"{name}<{targs}> {regs}/{spill}")
    return ("bf16 tensor-core bodies' kernels, registers a thread / spill-store bytes: "
            + ", ".join(out) if out else
            "bf16 tensor-core bodies' kernels: no ptxas report (library found already built)")


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
    print(f"[build] {mma_registers(log)}", flush=True)

    def phase(label, fn, *args):
        t_start = time.time()
        out = fn(*args)
        print(f"[time] phase {label}: {time.time() - t_start:.1f} s", flush=True)
        return out

    stats = phase("3", check_kernels, smi)
    stats.update(phase("3w", check_window_attention, smi))
    stats.update(phase("3b", check_backward_kernels))
    state = seeded_state()
    cpu_head, x1, ts_cpu, ts_gpu, batches = phase("4", check_slice, smi, state)
    counts, masks16, masks_ms = phase("4m", check_masks, smi, state, cpu_head, x1, ts_gpu,
                                      batches)
    int8_counts = phase("5", check_int8, smi, state, x1, ts_cpu, ts_gpu, batches, masks16,
                        masks_ms)
    counts.update({k: v for k, v in int8_counts.items() if k.endswith("_q")})
    del cpu_head, batches, masks16
    torch.cuda.empty_cache()
    phase("6a", check_train_f32, state)
    train_counts, step_ms = phase("6b", check_train_bf16, smi, state)
    counts.update({k: v for k, v in train_counts.items() if k in BACKWARD_KERNELS})
    del state
    v1 = phase("7", check_v1, smi)
    counts["flash_attention"] = v1["BaseModelWithText"][0]["flash_attention"]
    v1_train_counts, v1_step_ms = phase("8", check_v1_train, smi)
    counts["flash_attention_bwd"] = v1_train_counts["flash_attention_bwd"]
    v4 = phase("10", check_v4, smi)
    _, v4_step_ms = phase("11", check_v4_train, smi)
    print(f"[time] all phases: {time.time() - t0:.1f} s", flush=True)

    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=counts.get(name, 0), max_abs_err=stats[name]["max_abs_err"],
                    ms=stats[name]["ms"], plain_ms=stats[name]["plain_ms"],
                    bound_ms=stats[name]["bound_ms"],
                    bound_by=max(stats[name]["by"], key=stats[name]["by"].get),
                    library_ms=stats[name]["library_ms"])
               for name, (src, rep) in SOURCES.items()]
    print(f"\n[summary] launches: over one run of the path that uses the kernel: the bf16 "
          f"batch-{BATCH} {IMG}² served-mask forward (phase 4m) for the float forward kernels "
          f"and the head, the int8 forward (phase 5) for the *_q kernels, one bf16 "
          f"batch-{TRAIN_BATCH} training step (phase 6b) for the backwards and the fused CE, "
          f"the bf16 batch-{BATCH} BaseModelWithText forward (phase 7) for flash_attention, "
          f"one bf16 batch-{BATCH} BaseModelWithText training step (phase 8b) for "
          f"flash_attention_bwd; "
          f"upsample_argmax and window_attention are on no path (the JAX package reaches "
          f"them from tests only; window_attention is driven through SwinAttention.forward "
          f"in phase 3w): launches 0. ms / "
          f"plain_ms / bound_ms / library_ms: bf16 at the main-path shapes, summed per forward "
          f"or per training step as the launches (upsample_argmax: one call at the served "
          f"shape; window_attention: summed over the 22 swin blocks of stages 1-3 of a "
          f"batch-{BATCH} {IMG}² forward); library_ms: one PyTorch call of the same function "
          f"(F.interpolate and its backward, F.scaled_dot_product_attention and its backward, "
          f"SDPA with the window bias and mask as its additive mask), null where none "
          f"exists; max_abs_err of "
          f"a mask kernel: the largest top-2 "
          f"score gap at a pixel where it differs from its plain version. Training step "
          f"{step_ms:.2f} ms; v1 training step {v1_step_ms:.2f} ms; v1 bf16 b{BATCH} forwards "
          f"{ {k: round(ms, 2) for k, (_, ms) in v1.items()} } ms; v4 bf16 b{BATCH} mask "
          f"forwards { {k: round(ms, 2) for k, ms in v4.items()} } ms; BaseCrossA training "
          f"step {v4_step_ms:.2f} ms on {smi}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
