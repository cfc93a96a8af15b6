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
   core, the mask head's and the fused CE's; and the f32 3xTF32 kernels of
   flash and of the swin window block's attention core) on a line;
3. kernels: each Hopper kernel against its plain PyTorch version on the card,
   at every shape the main paths give it (512², batch 16), bf16 and f32:
   max / mean abs error against the stated bound (masks: equal except at
   near-ties, on at most 1e-4 of the pixels; int8: relative to the largest
   reference value; the upsample: bf16 equal on >= 99.99 % of the elements
   and within one bf16 step elsewhere, f32 within 1e-6 of max |plain|, its
   GB/s and share of the memory rate printed), the kernel's
   time beside the plain version's and, where one PyTorch call computes the
   same function, that call's (CUDA events, median of 20 after warm-up;
   inputs drawn on the card from seeds of the numpy stream), and
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
   argmax's (pixel, class) pairs a second over the whole kernel time; and
   the device time of each step of the bf16 window block's token-major plan
   (C > 384, row 9: LayerNorm, QKV GEMM, attention core, out-projection
   GEMM) at swin-base stage 3, both shifts, from one torch.profiler call;
   the f32 bodies of rows 1, 2, 6, 9 and 15 (3xTF32) also within F32X3_REL of
   max |plain| at every shape, the plain version run with TF32 products as a
   control that must fail it (flash keeps its own controls beside it), and
   each dtype's flash times summed per BaseModelWithText forward;
   and rows 1, 2, 4 and 6 at the 480² crop of the sliding sweep (phase 14):
   each distinct call of the flagship's score-map forward there, recorded by
   hooks, on the inputs it had (bf16 at the sweep's batch, 4, each tagged
   with its launches a sweep; f32 at batch 1), with the sums per 480²
   forward and per bf16 sweep of two 640² images (the 512² batch-16 cases
   tagged twice a sweep), whose launches phase 14 must count;
3b. backward kernels: each Hopper backward against autograd through its
   plain version at every shape of the 512², batch-8 training step, bf16 and
   f32: max |Δ| and the norm-relative error ‖Δ‖/‖ref‖ over every gradient
   against the stated bound (the upsample adjoint, reached through autograd,
   against its own plain version by phase 3's upsample rule, with autograd
   through the plain forward, which rounds in the old order, as a bf16
   control that must fail; its GB/s printed), and the kernel's time beside the plain
   backward's (CUDA events, median of 5 after warm-up; fused_attn_block_bwd
   and swin_window_block_bwd also their TFLOP/s over three times their
   forward's products; the fused CE its exponentials a second (two per
   hi-res pixel and class) and its f32 operations a second); the flash backward
   (dq and dk/dv kernels) against flash_attention_backward_plain at the v1
   training shapes (ViT-B/16 (16, 12, 1025, 64), decoder (16, 8, 1024, 96)),
   masked, at D 48 and ragged (77 queries over 1025 keys), with two controls
   that must fail (the kernel over all keys but the last 64; the masked case
   run unmasked) and SDPA's backward timed beside it (TFLOP/s over the five
   products and the ratio printed); its f32 bodies (3xTF32) also within
   F32X3_GRAD_REL on each of dq, dk and dv, with the plain backward run with
   TF32 products as a control that must fail it, and each dtype's times
   summed per v1 training step; and every backward at the shapes of the
   FTN training steps (phase 13): the swin-base window blocks' backwards at
   stages 1-2 (row 7, (8, 128², 128) h4 and (8, 64², 256) h8) and stage 3
   (row 10, reported as fused_window_block_bwd, (8, 32², 512) h16, both
   shifts), the decoder attention backward at DenseCLIPFTN's FTNDecoder
   shapes, the upsample adjoint at the FTN decoders' shapes, each tagged
   with its launches per step of each FTN model (in the dtype that step runs
   it in), their kernel / plain / bound times summed per step of each, and
   the launches so summed held to phase 13's counts; the f32 bodies of
   fused_attn_block_bwd, swin_window_block_bwd and fused_window_block_bwd
   (3xTF32) also within F32X3_GRAD_REL on every gradient, with the plain
   version run with TF32 products as a control that must fail it (both
   errors printed), and their f32 times summed per batch-8 step; then, in
   f32 under the same rules, every backward of phase 6c's batch-16 flagship
   step at its shapes (the fused CE at 128² labels: the low-res map's, ratio
   4), tagged with that step's launches, which must sum to phase 6c's counts,
   and rows 3 and 7 summed per batch-16 step;
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
       (step ms, img/s), finite losses, trainable parameters changed;
   (c) f32, batch 16, 512², 128² labels, decoder dropout 0, as
       scripts/all_args.sh trains it: two warm-up steps, six timed (step ms,
       img/s, peak memory), the launch counts of one step asserted, and a
       torch.profiler table of one more step, from which rows 3 and 7's
       device time a step is read (their autograd nodes,
       _FusedAttnBlockBackward and _SwinWindowBlockBackward), and row 6's
       forward device time (the swin window block's f32 kernels, by name:
       the token-major plan's LayerNorm pass and the three kernels after
       it, or an older checkout's swin_window_kernel).
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
       batch 16 timed;
   (f) BaseModelWithText in f32 at batch 16, 512² (scripts/evaluate.sh's
       configuration, the CLI's default dtype): launch counts of one forward
       (flash 13, fused_mlp 1), three answered batches timed, peak memory.
8. v1 training (engine.train_step on BaseModelWithText: plain CE of
   feature_mm on 128² labels, AdamW lr 1e-5, nothing frozen):
   (a) f32, batch 1, 512²: the card's step against the same step on the CPU
       (the loss, every gradient, the parameters after AdamW);
   (b) bf16, batch 16, dropout 0: two warm-up steps, the launch counts of
       one step asserted (flash forward and backward 13 each, fused_mlp 1),
       six timed steps (step ms, img/s), a torch.profiler table of one more;
   (c) bf16, dropout 0.1 from a seeded generator: the self-attention on the
       einsum path (flash 12 and 12), finite losses, the same seed repeating
       the loss bit for bit;
   (d) f32, batch 16, dropout 0 (the CLI's default dtype): two warm-up
       steps, the launch counts of one step asserted (flash forward and
       backward 13 each, fused_mlp 1), six timed steps (step ms, img/s),
       peak memory.
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
   torch.profiler table of one more; then BaseSelfA's, PromptSelfA's and
   PromptCrossA's bf16 batch-8 steps the same way, each profile's five
   largest items only.  Every bf16 step prints its peak device memory.
12. the FTN family on swin-base (DenseCLIPFTN, PromptFTNv1, BaseFTN,
   PromptFTNv2; decoder 512, 151 classes or class-name prompts), weights
   from the numpy seed: (a) f32 batch 1, the card's score map (BaseFTN: its
   logits) against the same model's plain run on the CPU under phase 4a's
   gates (scaled by max |ref| where that exceeds 1); for DenseCLIPFTN also
   the whole backbone with every stage run (C 1024 at stage 4), each hidden
   state within 1e-3 of max |ref|; (b) bf16 batch 16: three batches answered
   and timed, the launch counts of one forward asserted, the window blocks
   of the stages the JAX package sends through fused_window_block (TPU row
   9: swin-base stage 3, 18) counted per stage, held against f32 on the card
   under phase 4b's gates; the whole backbone's counts (24 window blocks and
   feed-forwards) and time; a torch.profiler table of one PromptFTNv2
   forward.  Phase 3 holds every kernel at every shape of these forwards
   (swin-base's window blocks at stages 1-4, stages 3-4 as
   fused_window_block, its feed-forwards up to C 1024 F 4096, the FTN
   decoders' attention halves up to 4096 queries over 4096 keys, the f32
   prompt decoders over 256 keys of d_kv 1024 and over 16384 keys, the
   upsample at C 1024), and sums its times, plain times and bounds per
   forward of each FTN model, in the dtype that forward runs each shape in;
   the launches so summed must equal phase 12's counts.
13. the FTN family's training steps (engine.train_step: the plain CE of the
   512² map against 512² labels, AdamW lr 1e-5, the frozen text towers),
   weights from the numpy seed: (a) f32 batch 1, every Dropout rate, MHA
   dropout and drop-path rate set to 0 on the built model (the layers keep
   their dropout attribute, so they take the unfused halves the real step
   takes), the card's step against the same step on the CPU under phase
   6a's gates (the prompt decoders' gradients within 1e-2 norm-relative:
   their 151-token relu layers switch units between card and CPU), the CPU
   step's seconds printed; (b) bf16 batch 8 (or the
   largest batch that fits, the failure printed), the decoders' dropout as
   built (0.1; DenseCLIPFTN's FTNDecoder 0) and drop path 0.1 from a seeded
   generator: two warm-up steps, the launch counts of one step asserted, the
   window blocks and their backwards of swin-base stage 3 (rows 9 and 10)
   counted per stage, 18 each, six timed steps, finite losses, trainable
   parameters changed and frozen ones not, the peak device memory, a fresh
   model repeating the first step's loss bit for bit from the same seed, and
   a torch.profiler table of one more step (idle share; 20 items for
   DenseCLIPFTN and BaseFTN, 5 for the other two).
14. the evaluation (engine.eval_step / evaluate, engine/sliding.py,
   metrics/), weights from the numpy seed: (a) eval_step of PromptAuxCrossA
   and BaseCrossA, f32 batch 1, 512² images and labels, card against CPU:
   losses, the argmax maps at 512² and at 2048² (the per-image mIoU's
   bicubic x4) equal but at near-ties, the confusion counts, the per-image
   mIoU; (b) bf16 batch 16, three batches through evaluate after a warm-up:
   host ms a batch, forward and metric ms by CUDA events, img/s, peak memory,
   launch counts; (c) evaluate_sliding of PromptAuxCrossA (640², scales
   0.75 / 1.0 / 1.25, crop 512, stride 341, flip): one image f32 card against
   CPU (probabilities, argmax, eval_mIOU_sliding), then a bf16 sweep of two
   images timed, its launches held to phase 3's sweep tags; (d) the
   GT-resolution mIoU of seeded (4, 151, 128, 128) logits at four GT sizes,
   card against CPU per image, bucket=64 against the exact path.
15. the CLI (cli/train.py and cli/evaluate.py over engine/engine.py::Engine)
   on the synthetic ADE20K from the seed, in a temporary directory,
   PromptAuxCrossA at full width, 512², the weights drawn by nn/init.py:
   (a) train 4 steps (--fp16 true, batch 8, 16 images, checkpoints every 2
       steps, an evaluation at step 4, a CSV row a step): finite losses,
       every step's launch counts equal to phase 6b's step, step-2 and
       step-4 checkpoints, 4 rows; the train img/s and the share of the time
       spent waiting on the loader printed beside phase 6b's bare step;
   (b) --resume to step 6: it starts at step 4 with the model and optimizer
       state of step-4.pth bit for bit, and ends at step 6;
   (c) a training subprocess sent SIGUSR1 after its first logged step:
       it checkpoints the step it is at and exits 0;
   (d) evaluate step-4.pth and its reference .pt export (bf16, batch 16):
       the same metrics within 1e-6, rows 1, 2, 4 and 6 launched, eval img/s
       printed; then f32 on 2 images, --device cuda against --device cpu
       under phase 14's rules;
   (e) --sliding (640², 2 images) and --gt_metrics --gt_bucket 64: finite
       eval_mIOU_sliding and eval_mIOU_gt; base_with_text through
       scripts/parity_eval.sh's flags (parsed from the script; the port's
       module, the synthetic dataset, a reference .pt of nn/init.py's
       weights): finite label, GT and dataset mIoU.
16. the data axis (lc2is_tpu_torch/core/mesh.py: one process a device, the
   gradients all-reduced, the masks drawn for the global batch):
   (a) over NCCL on min(device count, 4) GPUs, the bf16 PromptAuxCrossA at
       the global batch 8 of phase 6b, 3 steps through train_step on the
       mesh against 3 without it: on one GPU (a mesh of one device builds no
       group, and train_step runs the plain step) the first step's losses
       equal bit for bit and its gradients within 1e-3 norm-relative, every
       step's losses within 1e-4 relative, the parameters' distance printed
       beside that of a second plain run (the backwards of rows 3 and 7 add
       with f32 atomics: the card's step is not bitwise repeatable); on several GPUs
       the ranks' parameters equal bit for bit; each step's launch counts
       equal to phase 6b's; both step times (median of 6, host clock after
       a synchronize);
   (b) two ranks on cuda:0 over gloo (NCCL refuses two ranks on one GPU):
       the f32 flagship at a global batch of 2 (1 a rank), drop path 0.1,
       2 steps against the one-process batch-2 steps (each from rank 0's
       state) under phase 6a's gates
       (losses 1e-4 relative, the reduced gradients 1e-3 norm-relative,
       AdamW within 1e-2 lr), the ranks' parameters equal bit for bit; then
       evaluate over 4 images (2 a rank) against one process under 14a's
       rules (the confusion counts equal where no pixel's argmax differs),
       and dp_sliding_miou over two 640² images against evaluate_sliding in
       one process, mIoU within 1e-3;
   (c) where two GPUs are visible: cli.train --dp -1 for 4 steps, then
       --resume to step 6, every rank's model and optimizer state equal to
       step-4.pth bit for bit as it starts; on one GPU it prints that it was
       not run.
17. The model axis (parallel/sharding.py; the optimizer holds each sharded
    weight's shard and its AdamW moments, the module the whole weight
    gathered after each step):
   (a) two ranks on cuda:0 over gloo as the mesh (data 1, model 2): phase
       6b's bf16 flagship step (global batch 8, drop path 0.1) for 3 steps
       against the one-process step on the same card: step 1's losses equal
       bit for bit, its gradients within 1e-3 norm-relative, every loss
       within 1e-4 relative, the ranks' parameters equal bit for bit, each
       rank's AdamW moment elements exactly the spec's share, 6b's launches
       on each rank at every step; the census, each rank's step time (the two
       ranks share the card) and max_memory_allocated printed;
   (b) on four GPUs or more, NCCL (2, 2) against one card's step under the
       same rules (step 1's losses' equality printed, not gated: the four
       ranks' mean adds in another order);
   (c) on two GPUs or more, cli.train --dp -1 --tp 2 then --resume, as
       16c; (b) and (c) print that they were not run on one GPU.

Then a JSON line of the kernels (launches over one run of the path that
uses each: the served-mask forward, the int8 forward, the training step, the
v1 BaseModelWithText forward or its training step, the DenseCLIPFTN forward
and training step for rows 9 and 10; 0 for upsample_argmax and
window_attention, which lie on no path), the nvidia-smi line, and as the
last line {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Each phase prints its seconds.

Phase 6b ends with a torch.profiler trace of one more bf16 step (device time
by kernel, idle share).  With no CUDA device, or outside a checkout of the
repository, it fails without printing a result.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import json
import math
import os
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
# the f32 bodies of the feed-forward, the decoder attention block, the swin
# window block (rows 6 and 9) and flash attention (row 15; 3xTF32 on the
# tensor cores) are also held to |Δ| <= F32X3_REL·max|ref|: BOUNDS' and
# FLASH_REL's f32 rules would pass TF32 products (about 5e-4 relative) too.
# Their plain versions run with TF32 products
# (torch.backends.cuda.matmul.allow_tf32) are the control that must fail it
F32X3_REL = 1e-5
F32X3_KERNELS = ("fused_mlp", "fused_attn_block", "swin_window_block", "fused_window_block",
                 "flash_attention")
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
# the multi-scale sliding evaluation (phase 14; lc2is_tpu/cli/common.py:63-65,
# lc2is_tpu/engine/sliding.py): a 640² image at scales 0.75, 1.0 and 1.25,
# crop 512, stride 341, flip in the same batch.  At 0.75 the image is 480² and
# the crop min(512, 480): one window, the swin at grids 120², 60², 30², 15²; at
# 1.0 and 1.25 2 x 2 windows of 512².  Each scale is one forward of its
# windows, so a sweep of SLIDE_IMAGES images runs three score-map forwards:
# 2·n tiles of 480², 8·n and 8·n of 512² (n = 2: BATCH, phase 3's shapes)
SLIDE_BASE, SLIDE_SCALES, SLIDE_CROP, SLIDE_STRIDE = 640, (0.75, 1.0, 1.25), 512, 341
SLIDE_IMAGES = 2
SWEEP = "sliding sweep"
CROP = "480² crop forward"
EXPECTED_SWEEP_LAUNCHES = {k: len(SLIDE_SCALES) * n for k, n in EXPECTED_LAUNCHES.items()}
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
# 700 W): bytes at the memory rate against operations at their type's peak.
# f32: the fastest f32-accurate route on this card, 3xTF32 on the tensor
# cores (495 dense TF32 TFLOP/s over three products), not the 67 TFLOP/s of
# the CUDA cores, which the f32 bodies of rows 1 and 2 would otherwise beat
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 495e12 / 3, "int8": 1979e12}
# training: batch 8, AdamW lr 1e-5, drop path 0.1 (bench_train.py)
TRAIN_BATCH = 8
TRAIN_LR = 1e-5
# backward kernel against autograd through its plain version: ‖Δ‖ / ‖ref‖
GRAD_BOUNDS = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# the f32 bodies of the training backwards (TPU rows 3, 7, 10 and 16: every
# product in 3xTF32 on the tensor cores) are also held to ‖Δ‖ / ‖ref‖ <=
# F32X3_GRAD_REL on every gradient: GRAD_BOUNDS' f32 rule would pass TF32
# products too.  Their plain versions run with TF32 products are the control
# that must fail it
F32X3_GRAD_REL = 1e-5
F32X3_BACKWARDS = ("fused_attn_block_bwd", "swin_window_block_bwd", "fused_window_block_bwd")
# the upsample kernels (rows 4 and 5) against their plain versions, which
# round where the reference rounds and sum in the kernels' order: bf16 equal
# on at least UPSAMPLE_BF16_EQUAL of the elements and within one bf16 step on
# the rest; f32 within UPSAMPLE_F32_REL of max |plain|.  The adjoint rounded
# in the old order (each column's H-adjoint first, as autograd through the
# plain forward rounds) is the control that must fail in bf16.
UPSAMPLE_BF16_EQUAL = 0.9999
UPSAMPLE_F32_REL = 1e-6
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
# the bf16 steps: a trainable parameter that did not move in 8 steps passes
# only where its last AdamW step is below ROUNDED_AWAY x eps · |p| (eps of
# p's dtype) on every element.  Round to nearest keeps p only where the step
# is at most half of p's spacing, which is at most eps · |p|; the f32 FTN
# prompt-decoder parameters that stay reach 0.07-0.13 of it on an H100
ROUNDED_AWAY = 0.5
# the FTN steps (phase 13a): a relu unit of a prompt decoder's post-norm
# layers whose pre-activation has another sign on the card than on the CPU
# switches, and the gradients of its layer and of every layer before it move
# together.  In PromptFTNv2 one unit of layer 2 switches and layers 0-2 part by 2.1e-3 to
# 4.0e-3; fed the CPU step's inputs, the decoder on the CPU lies within
# 1.1e-5 of float64 and on the card 2.1e-3 to 4.0e-3 from it in layers 0-2,
# its f32 error having switched that unit against float64
# (scripts/ftn_prompt_grad_probe.py on an H100).  So the gradients of a prompt
# decoder's layers up to the deepest one with a switched unit are held to
# PROMPT_DECODER_GRAD_REL, those of the later layers to STEP_GRAD_REL, and a
# step may switch at most RELU_SWITCHES units
PROMPT_DECODER_GRAD_REL = 5e-3
RELU_SWITCHES = 4
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
    # the same kernel where the JAX package takes its windowed entry
    # (fused_window_block :645, C > 384): swin-base stage 3 on the FTN path
    "fused_window_block": ("lc2is_tpu_torch/csrc/swin_window.cu",
                           "lc2is_tpu/ops/window_attention.py:386"),
    "swin_window_block_bwd": ("lc2is_tpu_torch/csrc/swin_window_bwd.cu",
                              "lc2is_tpu/ops/swin_canvas.py:530; "
                              "lc2is_tpu/ops/window_attention.py:701"),
    # the same kernel where the JAX package takes its windowed backward
    # (C > 384, up to 768): swin-base stage 3 in the FTN training steps
    "fused_window_block_bwd": ("lc2is_tpu_torch/csrc/swin_window_bwd.cu",
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
    """Normal samples from the numpy stream ``rs``: on the CPU numpy's own
    draws; on the card a torch generator's, seeded from ``rs`` (phase 3 alone
    makes about 10⁹ input elements, which numpy would draw one by one on the
    host)."""
    if torch.device(device).type == "cpu":
        return torch.from_numpy((offset + scale * rs.standard_normal(shape)).astype(np.float32)
                                ).to(dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(int(rs.randint(2 ** 31 - 1)))
    return (offset + scale * torch.randn(shape, generator=gen, device=device)).to(dtype)


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
    """The projections of the b·h·w real tokens only: an HF pad token's LN
    output is zero, so its q, k and v are the biases, and its output is
    cropped.  The attention products of the real queries over every key of
    their (HF-padded) window."""
    e = dt.itemsize
    tok = b * h * w
    n = win * win
    return (2 * tok * c * e + 4 * c * c * (1 if quant else e) + 4 * heads * n * n,
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


# the FTN models by decoder (phase 12), for the launches of phase 3's cases
# on each FTN forward: FTNDecoder, FTNDecoderV2
FTN_DEC1 = ("DenseCLIPFTN", "PromptFTNv1")
FTN_DEC2 = ("BaseFTN", "PromptFTNv2")
FTN_ALL = FTN_DEC1 + FTN_DEC2


def ftn_counts(n, models):
    """{model: n} for ``models`` ({} where n is None)."""
    return {} if n is None else {m: n for m in models}


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

    def sweep(n):
        """Launches a bf16 sliding sweep of SLIDE_IMAGES images gives a
        flagship shape at 512², batch 16: n a forward, at scales 1.0 and 1.25."""
        return {} if n is None else {SWEEP: 2 * n}

    def case(name, label, count, kern, plain, work, check="close", library=None, scores=None,
             tie_dt=None, control=None, pairs=None, ftn=None, ftn_dt=torch.bfloat16):
        """``count``: launches per forward of the path the kernel's JSON row
        reports (0: one call, on no path; None: checked and timed, not
        summed); ``control``: (what, a wrong call) that must fail the same
        check; ``pairs``: a mask kernel's (output pixel, class) pairs;
        ``ftn``: {FTN model: launches per bf16 batch-16 forward, or SWEEP:
        launches per bf16 sliding sweep}, summed from the ``ftn_dt`` pass (the
        dtype that path runs the shape in)."""
        cases.append(dict(name=name, label=label, count=count, kern=kern, plain=plain, work=work,
                          check=check, library=library, scores=scores, tie_dt=tie_dt,
                          control=control, pairs=pairs, ftn=ftn or None, ftn_dt=ftn_dt))

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
                 swin_work(b, grid, grid, c, heads, dt), ftn=sweep(n))
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
                 mlp_work(b * grid * grid, c, 4 * c, dt, q), check="int8" if q else "close",
                 ftn=None if q or n is None else sweep(2 * n))
    # swin-base, stages 1-3 in all four FTN models (phase 12; ``ftn``:
    # launches per forward of each): stages 1-2 through the canvas entry (row
    # 6), stage 3 through the windowed one the JAX package takes at C > 384
    # (row 9), reported as fused_window_block, 9 blocks a shift a DenseCLIPFTN
    # forward; stage 4 (C 1024, like stage 3 on the bf16 body's token-major
    # plan) and its feed-forward, which no model runs (phase 12 drives them
    # through the whole backbone): checked and timed, not summed
    for s, (grid, c, heads, n) in enumerate([(g, 128, 4, 1), (g // 2, 256, 8, 1),
                                             (g // 4, 512, 16, 9), (g // 8, 1024, 32, None)]):
        name = "fused_window_block" if c > 384 else "swin_window_block"
        x = rand(rs, b, grid, grid, c, dtype=dt)
        args = (x, vec(c, 1.0), vec(c), w(3 * c, c), vec(3 * c), w(c, c), vec(c),
                rand(rs, heads, 49, 49, scale=0.1))
        for shift in (0, 3):
            case(name, f"swin-base{s + 1} ({b},{grid},{grid},{c}) h{heads} shift{shift}",
                 n if name == "fused_window_block" else None,
                 lambda a=args, h=heads, sh_=shift: swin_window_block(*a, h, 7, sh_),
                 lambda a=args, h=heads, sh_=shift: swin_window_block_plain(*a, h, 7, sh_),
                 swin_work(b, grid, grid, c, heads, dt), ftn=ftn_counts(n, FTN_ALL))
        xt = rand(rs, b * grid * grid, c, dtype=dt)
        margs = (xt, vec(c, 1.0), vec(c), w(4 * c, c), vec(4 * c), w(c, 4 * c), vec(c))
        case("fused_mlp", f"swin-base{s + 1} ({b * grid * grid},{c}) gelu pre", None,
             lambda a=margs: fused_mlp(*a, activation="gelu", ln_position="pre"),
             lambda a=margs: fused_mlp_plain(*a, activation="gelu", ln_position="pre"),
             mlp_work(b * grid * grid, c, 4 * c, dt),
             ftn=ftn_counts(None if n is None else 2 * n, FTN_ALL))
    # decoder: (tokens per image, SR keys, layers at that size); the FTN
    # decoders have as many layers at each size, FTNDecoder's with the same
    # two attention halves, FTNDecoderV2's with the SR keys once (its
    # RepeatTransformers' other halves follow)
    xs = {}
    for p, l_sr, n in [(256, 64, 1), (1024, 256, 2), (4096, 1024, 3)]:
        x = xs[p] = rand(rs, b, p, 512, dtype=dt)
        margs = (x.reshape(-1, 512), vec(512, 1.0), vec(512), w(2048, 512), vec(2048),
                 w(512, 2048), vec(512))
        for name, kern, plain, q in [("fused_mlp", fused_mlp, fused_mlp_plain, False),
                                     ("fused_mlp_q", fused_mlp_q, fused_mlp_q_plain, True)]:
            case(name, f"decoder ({b * p},512) relu post", n,
                 lambda a=margs, k=kern: k(*a, activation="relu", ln_position="post"),
                 lambda a=margs, p_=plain: p_(*a, activation="relu", ln_position="post"),
                 mlp_work(b * p, 512, 2048, dt, q), check="int8" if q else "close",
                 ftn=None if q else dict(ftn_counts(n, FTN_ALL), **sweep(n)))
        for l, kind in [(l_sr, "SR self"), (N_CLASSES, "cross")]:
            aargs = (x, rand(rs, b, l, 512, dtype=dt), rand(rs, b, l, 512, dtype=dt),
                     w(512, 512), vec(512), w(512, 512), vec(512), vec(512, 1.0), vec(512))
            on_ftn = dict(ftn_counts(n, FTN_DEC1), **(ftn_counts(1, FTN_DEC2) if l == l_sr
                                                       else {}))
            for name, kern, plain, q in [
                    ("fused_attn_block", fused_attn_block, fused_attn_block_plain, False),
                    ("fused_attn_block_q", fused_attn_block_q, fused_attn_block_q_plain, True)]:
                case(name, f"{kind} ({b},{p},512) L{l} h8", n,
                     lambda a=aargs, k=kern: k(*a, 8), lambda a=aargs, p_=plain: p_(*a, 8),
                     attn_work(b, p, l, 512, dt, q), check="int8" if q else "close",
                     ftn=None if q else dict(on_ftn, **sweep(n)))
    # FTNDecoderV2's other attention halves: each RepeatTransformer layer's
    # self-attention over its own tokens and its cross-attention over the
    # stream's fixed SR memory, (tokens, keys, launches a forward); checked
    # and timed, not summed
    for p, l, n in [(4096, 4096, 3), (4096, 256, 1), (4096, 64, 1), (1024, 1024, 2),
                    (1024, 64, 1), (256, 256, 1)]:
        kv = xs[p] if l == p else None
        aargs = (xs[p], rand(rs, b, l, 512, dtype=dt) if kv is None else kv,
                 rand(rs, b, l, 512, dtype=dt) if kv is None else kv,
                 w(512, 512), vec(512), w(512, 512), vec(512), vec(512, 1.0), vec(512))
        case("fused_attn_block", f"{'self' if kv is not None else 'cross'} ({b},{p},512) L{l} h8",
             None, lambda a=aargs: fused_attn_block(*a, 8),
             lambda a=aargs: fused_attn_block_plain(*a, 8), attn_work(b, p, l, 512, dt),
             ftn=ftn_counts(n, FTN_DEC2))
    # the prompt decoders of PromptFTNv1 / v2 (8 post-norm layers each), f32
    # on the bf16 path (JAX's promotion with the f32 text tower): 151 prompts
    # over swin-base's last level, 16² tokens of C 1024 whose K / V are
    # projected to 512 outside the kernel (d_kv 1024), and over the 128²
    # decoded map; their self-attention and feed-forward follow with
    # DenseClip's.  Checked and timed, not summed
    x = rand(rs, b, N_CLASSES, 512, dtype=dt)
    mem = rand(rs, b, (g // 8) ** 2, 1024, dtype=dt)
    wk, wv = w(512, 1024), w(512, 1024)
    aargs = (x, F.linear(mem, wk.to(dt)), F.linear(mem, wv.to(dt)),
             w(512, 512), vec(512), w(512, 512), vec(512), vec(512, 1.0), vec(512))
    case("fused_attn_block", f"prompt d_kv 1024 ({b},{N_CLASSES},512) L{(g // 8) ** 2} h8", None,
         lambda a=aargs: fused_attn_block(*a, 8), lambda a=aargs: fused_attn_block_plain(*a, 8),
         attn_work(b, N_CLASSES, (g // 8) ** 2, 512, dt), ftn={"PromptFTNv1": 8},
         ftn_dt=torch.float32)
    # keys at 4x the unit scale: over 16,384 unit keys the softmax is nearly
    # flat, the head outputs ~1 % of the block's output, and no rule on the
    # output could see the attention path (the TF32 control passed F32X3_REL
    # there); peaked, as a trained decoder's, the attention carries it
    aargs = (x, rand(rs, b, g * g, 512, scale=4.0, dtype=dt), rand(rs, b, g * g, 512, dtype=dt),
             w(512, 512), vec(512), w(512, 512), vec(512), vec(512, 1.0), vec(512))
    case("fused_attn_block", f"prompt ({b},{N_CLASSES},512) L{g * g} h8", None,
         lambda a=aargs: fused_attn_block(*a, 8), lambda a=aargs: fused_attn_block_plain(*a, 8),
         attn_work(b, N_CLASSES, g * g, 512, dt), ftn={"PromptFTNv2": 8}, ftn_dt=torch.float32)
    # ×2 upsamples: (grid, C, launches a flagship forward, an FTNDecoder
    # forward, an FTNDecoderV2 forward); the last, (16, 1024), the FTN
    # decoders' first top-down ×2
    for grid, c, n, n1, n2 in [(16, 768, 1, None, None), (32, 384, 1, None, None),
                               (16, 512, 1, 1, 1), (32, 512, 2, 3, 3), (64, 512, 1, 1, 3),
                               (16, 1024, None, 1, 1)]:
        x = rand(rs, b, grid * grid, c, dtype=dt)
        case("upsample_tokens", f"({b},{grid}²,{c}) x2", n,
             lambda x_=x, g_=grid: upsample_tokens(x_, (g_, g_), 2),
             lambda x_=x, g_=grid: upsample_tokens_plain(x_, (g_, g_), 2),
             upsample_work(b, grid, grid, c, 2, dt), check="bits",
             library=lambda x_=x, g_=grid, c_=c: F.interpolate(
                 x_.view(b, g_, g_, c_).permute(0, 3, 1, 2), scale_factor=2, mode="bilinear"),
             ftn=dict(ftn_counts(n1, FTN_DEC1), **ftn_counts(n2, FTN_DEC2), **sweep(n)))
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
    # path, by JAX's promotion), the prompt ones also the FTN prompt decoders':
    # checked and timed, not summed
    prompt_ftn = ftn_counts(8, ("PromptFTNv1", "PromptFTNv2"))
    for p, c, pos in [(1024, 768, "pre"), (1025, 768, "pre"), (N_CLASSES, 512, "post")]:
        margs = (rand(rs, b * p, c, dtype=dt), vec(c, 1.0), vec(c), w(2048, c), vec(2048),
                 w(c, 2048), vec(c))
        case("fused_mlp", f"v1 ({b * p},{c}) relu {pos}", None,
             lambda a=margs, ps=pos: fused_mlp(*a, activation="relu", ln_position=ps),
             lambda a=margs, ps=pos: fused_mlp_plain(*a, activation="relu", ln_position=ps),
             mlp_work(b * p, c, 2048, dt), ftn=prompt_ftn if p == N_CLASSES else None,
             ftn_dt=torch.float32)
    prompts = rand(rs, b, N_CLASSES, 512, dtype=dt)
    for l in (N_CLASSES, 1025):
        aargs = (prompts, rand(rs, b, l, 512, dtype=dt), rand(rs, b, l, 512, dtype=dt),
                 w(512, 512), vec(512), w(512, 512), vec(512), vec(512, 1.0), vec(512))
        case("fused_attn_block", f"DenseClip prompt ({b},{N_CLASSES},512) L{l} h8", None,
             lambda a=aargs: fused_attn_block(*a, 8), lambda a=aargs: fused_attn_block_plain(*a, 8),
             attn_work(b, N_CLASSES, l, 512, dt), ftn=prompt_ftn if l == N_CLASSES else None,
             ftn_dt=torch.float32)
    return cases


@contextlib.contextmanager
def recording_kernel_calls():
    """Record every call the model's modules make to the four float forward
    kernels of the score-map path, by rebinding the names nn/layers.py,
    nn/swin.py and ops/resize.py call them by.  Yields the list of (kernel
    name, wrapper, args, kwargs)."""
    import lc2is_tpu_torch.nn.layers as layers
    import lc2is_tpu_torch.nn.swin as swin
    import lc2is_tpu_torch.ops.resize as resize_ops

    calls, saved = [], []
    for mod in (layers, swin, resize_ops):
        for name in ("swin_window_block", "fused_mlp", "fused_attn_block", "upsample_tokens"):
            if hasattr(mod, name):
                op = getattr(mod, name)
                saved.append((mod, name, op))

                def rec(*a, _op=op, **kw):
                    calls.append((_op.__name__, _op, a, kw))
                    return _op(*a, **kw)
                setattr(mod, name, rec)
    try:
        yield calls
    finally:
        for mod, name, op in saved:
            setattr(mod, name, op)


def crop_cases(state, dt):
    """Phase 3's cases at the sliding sweep's 480² crop (scale 0.75 of 640²):
    the flagship's kernel calls in one score-map forward there, recorded by
    recording_kernel_calls, one case per distinct call (its shapes and
    arguments) on the inputs it had, held against its plain version; bf16 at
    the sweep's batch (SLIDE_IMAGES images and their flips), each tagged with
    its launches a sweep; f32 at batch 1."""
    import torch.nn.functional as F

    from lc2is_tpu_torch.ops.attention_block import fused_attn_block_plain
    from lc2is_tpu_torch.ops.fused_mlp import fused_mlp_plain
    from lc2is_tpu_torch.ops.swin_window import swin_window_block_plain
    from lc2is_tpu_torch.ops.upsample import upsample_tokens_plain

    plain = {"swin_window_block": swin_window_block_plain, "fused_mlp": fused_mlp_plain,
             "fused_attn_block": fused_attn_block_plain, "upsample_tokens": upsample_tokens_plain}
    side = int(round(SLIDE_BASE * SLIDE_SCALES[0]))
    b = 2 * SLIDE_IMAGES if dt == torch.bfloat16 else 1
    model = model_from(state, dtype=dt).eval()
    x = rand(np.random.RandomState(SEED + 30), b, 3, side, side, dtype=dt)
    with torch.no_grad():
        extra = {"text_static": model.embed_text()}
        with recording_kernel_calls() as calls:
            model({"pixel_values": x, **extra})
    del model
    groups = {}
    for name, fn, a, kw in calls:
        key = (name,) + tuple(tuple(v.shape) if torch.is_tensor(v) else v for v in a) + tuple(
            sorted(kw.items()))
        groups.setdefault(key, [name, fn, a, kw, 0])[4] += 1
    cases = []
    for name, fn, a, kw, n in groups.values():
        x0, library, check = a[0], None, "close"
        if name == "swin_window_block":
            bb, h, w, c = x0.shape
            label = f"({bb},{h},{w},{c}) h{a[8]} shift{a[10]}"
            work = swin_work(bb, h, w, c, a[8], dt, win=a[9])
        elif name == "fused_mlp":
            t, c = x0.numel() // x0.shape[-1], x0.shape[-1]
            label = f"({t},{c}) {kw.get('activation')} {kw.get('ln_position')}"
            work = mlp_work(t, c, a[3].shape[0], dt)
        elif name == "fused_attn_block":
            bb, p, c = x0.shape
            label = f"({bb},{p},{c}) L{a[1].shape[1]} h{a[9]}"
            work = attn_work(bb, p, a[1].shape[1], c, dt)
        else:
            (bb, p, c), (h, w), r = x0.shape, a[1], a[2]
            label, check = f"({bb},{h}x{w},{c}) x{r}", "bits"
            work = upsample_work(bb, h, w, c, r, dt)
            library = (lambda x_=x0, h_=h, w_=w, r_=r: F.interpolate(
                x_.reshape(x_.shape[0], h_, w_, -1).permute(0, 3, 1, 2), scale_factor=r_,
                mode="bilinear"))
        cases.append(dict(name=name, label=f"{side}² crop {label}", count=None,
                          kern=lambda f=fn, a_=a, k_=kw: f(*a_, **k_),
                          plain=lambda f=plain[name], a_=a, k_=kw: f(*a_, **k_), work=work,
                          check=check, library=library, scores=None, tie_dt=None, control=None,
                          pairs=None, ftn={SWEEP: n, CROP: n} if dt == torch.bfloat16 else None,
                          ftn_dt=torch.bfloat16))
    return cases


def report_sweep_kernels(ftn_stats):
    """Phase 3's times at the bf16 sliding sweep's shapes: per forward at the
    480² crop (batch 2·SLIDE_IMAGES), and per sweep of SLIDE_IMAGES images
    (the crop's cases and the 512² batch-16 ones, each as many times as the
    sweep launches it); returns the sweep's launches so summed, which phase
    14 must count."""
    for key, what in ((CROP, f"bf16 forward at the sweep's 480² crop, batch {2 * SLIDE_IMAGES}"),
                      (SWEEP, f"bf16 sliding sweep of {SLIDE_IMAGES} {SLIDE_BASE}² images "
                              f"(scales {SLIDE_SCALES}, flip)")):
        got = ftn_stats.get(key, {})
        tot = [sum(f[k] for f in got.values()) for k in ("ms", "plain_ms", "bound_ms")]
        print(f"\n[kernels] per {what}, from the cases above (launches x ms): " + "; ".join(
            f"{name} {f['launches']} kernel {f['ms']:.3f} plain {f['plain_ms']:.3f} bound "
            f"{f['bound_ms']:.3f}" for name, f in got.items())
            + f"; all kernel {tot[0]:.3f} ms plain {tot[1]:.3f} bound {tot[2]:.3f}", flush=True)
    launches = {name: f["launches"] for name, f in ftn_stats.get(SWEEP, {}).items()}
    if launches != EXPECTED_SWEEP_LAUNCHES:
        raise AssertionError(f"phase 3's sweep shapes give launches {launches}, a sweep runs "
                             f"{EXPECTED_SWEEP_LAUNCHES}")
    return launches


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


def bf16_steps(a, b):
    """bf16 steps between the elements of a and b (0: the same value)."""
    def key(t):
        v = t.contiguous().view(torch.int16).int()
        return torch.where(v >= 0, v, -(v & 0x7FFF))
    return (key(a) - key(b)).abs()


def upsample_bits(got, want):
    """(ok, max |Δ|, message) of an upsample kernel's output against its
    plain version's by the UPSAMPLE_* rule."""
    d = (got.float() - want.float()).abs()
    if got.dtype == torch.bfloat16:
        steps = bf16_steps(got, want)
        equal = int((steps == 0).sum()) / steps.numel()
        most = int(steps.max())
        ok = most <= 1 and equal >= UPSAMPLE_BF16_EQUAL
        msg = (f"{equal:.6f} of the elements equal (>= {UPSAMPLE_BF16_EQUAL}), at most "
               f"{most} bf16 steps apart (<= 1)")
    else:
        lim = UPSAMPLE_F32_REL * want.float().abs().max().item()
        ok = d.max().item() <= lim
        msg = f"max |Δ| {d.max().item():.3e} (<= {UPSAMPLE_F32_REL}·max|plain| = {lim:.3e})"
    return ok and bool(torch.isfinite(got).all()), d.max().item(), msg


def memory_rate(nbytes, ms):
    """" (x GB/s, y % of 3.35 TB/s)" of a bytes-bound call."""
    return (f" ({nbytes / ms / 1e6:.1f} GB/s, {100 * nbytes * 1e3 / ms / HBM_BYTES_PER_S:.1f} % "
            f"of {HBM_BYTES_PER_S / 1e12:.2f} TB/s)")


def compare(c, got, want, dt):
    """(ok, error, message) of a kernel's output against its plain version's."""
    if c["check"] == "flash":  # NaN rows equal exactly, the rest to a share of the max
        nan_w = torch.isnan(want)
        same = bool(torch.equal(torch.isnan(got), nan_w))
        d = (got.float() - want.float())[~nan_w].abs()
        top = want.float()[~nan_w].abs().max().item()
        lim = FLASH_REL[dt] * top
        ok = same and bool((d <= lim).all()) and bool(torch.isfinite(d).all())
        x3 = ""
        if dt == torch.float32 and c["name"] in F32X3_KERNELS:
            ok = ok and d.max().item() <= F32X3_REL * top
            x3 = f"; max |Δ| / max |plain| {d.max().item() / top:.2e} (<= {F32X3_REL})"
        return ok, d.max().item(), (f"max {d.max().item():.3e} mean {d.mean().item():.3e} (<= "
                                    f"{FLASH_REL[dt]}·max|plain| = {lim:.3e}{x3}); NaN rows "
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
    if c["check"] == "bits":
        return upsample_bits(got, want)
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
        if dt == torch.float32 and c["name"] in F32X3_KERNELS:
            lim = F32X3_REL * ref.max().item()
            ok = ok and d.max().item() <= lim
            bound += (f"; max |Δ| / max |plain| {d.max().item() / ref.max().item():.2e} (<= "
                      f"{F32X3_REL})")
    ok = ok and bool(torch.isfinite(got).all())
    return ok, d.max().item(), f"max {d.max().item():.3e} mean {d.mean().item():.3e} (<= {bound})"


def plain_tf32(plain):
    """plain() with TF32 matrix products (the F32X3_REL rule's control);
    the flag restored after."""
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return plain()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def run_case(c, dt, stats, ftn_stats=None):
    """Check one kernel case against its plain version (and its control,
    which must fail), time it beside its plain version and one-call twin, and
    add its bf16 numbers, times its launches, to ``stats`` (and, in its
    ``ftn_dt`` pass, its numbers times its launches on each FTN forward to
    ``ftn_stats``)."""
    with torch.no_grad():
        got = c["kern"]()
        torch.cuda.synchronize()
        want = c["plain"]()
        ok, err, msg = compare(c, got, want, dt)
        k_ms, p_ms = time_ms(c["kern"]), time_ms(c["plain"])
        lib_ms = time_ms(c["library"]) if c["library"] else None
        ctls = [(c["control"][0], compare(c, c["control"][1](), want, dt))] if c["control"] else []
        if dt == torch.float32 and c["name"] in F32X3_KERNELS:
            # flash keeps its own controls beside this one; the others' stands alone
            tf32 = compare(c, plain_tf32(c["plain"]), want, dt)
            ctls = (ctls if c["check"] == "flash" else []) + [
                ("the plain version with TF32 products", tf32)]
    b_ms, by = least_time(*c["work"])
    lib = f" one-call {lib_ms:8.3f}" if lib_ms is not None else ""
    if c["name"] == "flash_attention":  # its rate and its ratio to SDPA
        lib += f" ({rate_of(c['work'], k_ms)}, {k_ms / lib_ms:.2f}x SDPA)"
    elif c["name"] in ("swin_window_block", "fused_window_block", "fused_mlp",
                       "fused_attn_block", "fused_mlp_q", "fused_attn_block_q"):
        lib += f" ({rate_of(c['work'], k_ms)})"
    elif c["name"] == "score_upsample_argmax":  # the product's rate, the argmax's pairs a second
        mm = sum(n for k_, n in c["work"][1].items() if k_ != "f32")
        lib += (f" (product {mm / k_ms / 1e9:.1f} TFLOP/s, argmax "
                f"{c['pairs'] / k_ms / 1e6:.1f} G pairs/s over the kernel's time)")
    elif c["name"] == "upsample_tokens":  # bytes-bound: its memory rate
        lib += memory_rate(c["work"][0], k_ms)
    elif c["name"] == "window_attention":  # bytes-bound: its memory rate and SDPA ratio
        lib += (f" ({c['work'][0] / k_ms / 1e6:.1f} GB/s of {HBM_BYTES_PER_S / 1e9:.0f}, "
                f"{k_ms / lib_ms:.2f}x SDPA)")
    per = "not summed" if c["count"] is None else f"x{c['count']}/fwd"
    on_ftn = c.get("ftn") if dt == c.get("ftn_dt") else None
    if on_ftn:
        per += "; per " + ", ".join(f"{m} x{n}" for m, n in on_ftn.items())
    print(f"  {c['name']:21s} {c['label']:42s} kernel {k_ms:8.3f} ms plain {p_ms:8.3f}"
          f"{lib} bound {b_ms:7.3f} ({by}) {per}; {msg} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{c['name']} {c['label']} {dt}: kernel disagrees with its "
                             f"plain version: {msg}")
    for what, ctl in ctls:
        print(f"    control, {what}: {ctl[2]}: "
              f"{'passes' if ctl[0] else 'fails, as it must'}", flush=True)
        if ctl[0]:
            raise AssertionError(f"{c['name']} {c['label']}: the check passes its "
                                 f"control, {what}")
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
    for model, n in (on_ftn or {}).items() if ftn_stats is not None else ():
        f = ftn_stats.setdefault(model, {}).setdefault(
            c["name"], dict(launches=0, ms=0.0, plain_ms=0.0, bound_ms=0.0))
        f["launches"] += n
        f["ms"] += n * k_ms
        f["plain_ms"] += n * p_ms
        f["bound_ms"] += n * b_ms
    return k_ms, p_ms, lib_ms, b_ms


def report_ftn_kernels(ftn_stats):
    """Phase 3's times at the FTN paths' shapes, per bf16 batch-16 forward of
    each FTN model (each shape in the dtype that forward runs it in); the
    launches so summed must equal those phase 12 counts (row 9's blocks,
    fused_window_block, among swin_window_block's)."""
    print("\n[kernels] per bf16 b16 FTN forward, from the cases above (launches x ms at the "
          "path's shapes and dtypes):", flush=True)
    for model, (_, expected) in FTN_MODELS.items():
        got = ftn_stats.get(model, {})
        tot = [sum(f[k] for f in got.values()) for k in ("ms", "plain_ms", "bound_ms")]
        print(f"  {model}: " + "; ".join(
            f"{name} {f['launches']} kernel {f['ms']:.3f} plain {f['plain_ms']:.3f} bound "
            f"{f['bound_ms']:.3f}" for name, f in got.items())
            + f"; all kernel {tot[0]:.3f} ms plain {tot[1]:.3f} bound {tot[2]:.3f}", flush=True)
        launches = {}
        for name, f in got.items():
            key = "swin_window_block" if name == "fused_window_block" else name
            launches[key] = launches.get(key, 0) + f["launches"]
        if launches != expected:
            raise AssertionError(f"phase 3's shapes of {model} give launches {launches}, "
                                 f"phase 12 counts {expected}")


def check_kernels(smi, state):
    """Phase 3.  Returns per-kernel stats for the JSON line (bf16 times,
    bounds and one-call times summed per forward of the path using each) and
    the launches a bf16 sliding sweep gives phase 3's shapes."""
    stats, ftn_stats = {}, {}
    for dt in (torch.bfloat16, torch.float32):
        print(f"\n[kernels] {dt} on {smi}", flush=True)
        rs = np.random.RandomState(SEED)
        t0 = time.time()
        cases = kernel_cases(rs, dt) + crop_cases(state, dt)
        walls = []
        print(f"  ({len(cases)} cases, inputs made in {time.time() - t0:.1f} s)", flush=True)
        # name: [kernel, plain, bound, one call or None] ms summed as the launches, this dtype
        sums = {}
        for c in cases:
            t0 = time.time()
            k_ms, p_ms, lib_ms, b_ms = run_case(c, dt, stats, ftn_stats)
            walls.append((time.time() - t0, f"{c['name']} {c['label']}"))
            if c["count"] is not None:
                n = c["count"] or 1
                acc = sums.setdefault(c["name"], [0.0, 0.0, 0.0, 0.0])
                for i, v in enumerate((k_ms, p_ms, b_ms)):
                    acc[i] += n * v
                acc[3] = None if lib_ms is None or acc[3] is None else acc[3] + n * lib_ms
        print(f"  {dt} per forward of each kernel's path (launches x ms; count-0 rows one "
              f"call): " + "; ".join(f"{k} kernel {v[0]:.3f} plain {v[1]:.3f} bound {v[2]:.3f}"
                                     + ("" if v[3] is None else f" one-call {v[3]:.3f}")
                                     for k, v in sums.items()), flush=True)
        del cases
        torch.cuda.empty_cache()
        print(f"  {dt} cases: {sum(t for t, _ in walls):.1f} s; the slowest: "
              + "; ".join(f"{what} {t:.1f} s" for t, what in sorted(walls)[::-1][:4]), flush=True)
    report_ftn_kernels(ftn_stats)
    sweep = report_sweep_kernels(ftn_stats)
    report_token_major_steps(smi)
    return stats, sweep


def report_token_major_steps(smi, tries=3):
    """The device time of each step of the bf16 window block's token-major
    plan (C > 384: TPU row 9) at swin-base stage 3, (16, 32, 32, 512) h16,
    both shifts, from one torch.profiler call: the LayerNorm pass, the QKV
    GEMM, the gathered attention core, the out-projection GEMM (the GEMMs
    told apart by their order), and the wrapper's casts before them."""
    from torch.profiler import ProfilerActivity, profile

    from lc2is_tpu_torch.ops.swin_window import swin_window_block

    rs = np.random.RandomState(SEED + 17)
    b, grid, c, heads = BATCH, IMG // 16, 512, 16
    args = (rand(rs, b, grid, grid, c, dtype=torch.bfloat16), rand(rs, c, scale=0.1, offset=1.0),
            rand(rs, c, scale=0.1), rand(rs, 3 * c, c, scale=c ** -0.5), rand(rs, 3 * c, scale=0.1),
            rand(rs, c, c, scale=c ** -0.5), rand(rs, c, scale=0.1),
            rand(rs, heads, 49, 49, scale=0.1))
    label = f"({b},{grid},{grid},{c}) h{heads}"
    with torch.no_grad():
        for shift in (0, 3):
            swin_window_block(*args, heads, 7, shift)
        torch.cuda.synchronize()
        for _ in range(tries):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for shift in (0, 3):
                    swin_window_block(*args, heads, 7, shift)
                torch.cuda.synchronize()
            events = sorted((e for e in prof.events()
                             if e.device_type == torch.autograd.DeviceType.CUDA),
                            key=lambda e: e.time_range.start)
            if events:
                break
    calls, steps = [], None
    for e in events:
        name, ms = e.name, (e.time_range.end - e.time_range.start) / 1e3
        if steps is None:
            steps = {"wrapper casts": 0.0}
        if "swin_ln_kernel" in name:
            steps["LN"] = ms
        elif "gemm_bf16_kernel" in name:
            steps["QKV GEMM" if "QKV GEMM" not in steps else "out GEMM"] = ms
        elif "swin_core_mma" in name:
            steps["core"] = ms
        else:
            steps["wrapper casts"] += ms
        if "out GEMM" in steps:
            calls.append(steps)
            steps = None
    if len(calls) != 2:
        print(f"[kernels] row 9's token-major plan at {label}: the profiler's device times "
              f"not measured ({len(events)} kernels recorded) on {smi}", flush=True)
        return
    for shift, st in zip((0, 3), calls):
        print(f"[kernels] row 9's token-major plan at {label} shift{shift}, device ms by step "
              f"(one torch.profiler call): " + ", ".join(f"{k} {v:.4f}" for k, v in st.items())
              + f"; sum {sum(st.values()):.4f} on {smi}", flush=True)


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


def backward_cases(rs, dt, b=TRAIN_BATCH, label=IMG):
    """(kernel name, shape label, launches per training step, kernel call,
    (kernel-path fn, plain fn, args, g) for the gradient check, work (bytes,
    ops), the one PyTorch call of the same function or None, the plain
    adjoint or None, {FTN model: launches per bf16 batch-8 step of it in this
    dtype}) at every shape of the 512² / batch-``b`` training steps, labels
    ``label``², of the flagship and of the FTN models (phase 13).  Row 10,
    the window blocks of swin-base stage 3 (C 512, the JAX package's
    windowed backward), reports
    as ``fused_window_block_bwd``, its launches per DenseCLIPFTN step.  The
    plain time is autograd's backward through the plain version; for the
    fused CE, whose one kernel computes the loss and the gradient, it is the
    plain forward + backward; for the upsample adjoint, which has a plain
    version of its own, that version's.
    A backward's work: its inputs and gradients once, and three times its
    forward's products (the recompute, and two products per forward product)."""
    from lc2is_tpu_torch.ops.attention_block import (fold_q_scale as fold_q, fused_attn_block,
                                                     fused_attn_block_bwd, fused_attn_block_plain)
    from lc2is_tpu_torch.ops.fused_ce import (fused_ce_fwd, upsampled_cross_entropy,
                                              upsampled_cross_entropy_plain)
    from lc2is_tpu_torch.ops.swin_window import (fold_q_scale, swin_window_block,
                                                 swin_window_block_bwd, swin_window_block_plain)
    from lc2is_tpu_torch.ops.upsample import (upsample_tokens, upsample_tokens_adjoint,
                                              upsample_tokens_adjoint_plain,
                                              upsample_tokens_plain)

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
                    None, None, {}))
    # swin-base in the FTN steps (phase 13: drop path 0.1 over 24 blocks, so
    # block 0 alone keeps the in-kernel residual): stages 1-2 (row 7), one
    # block a shift each; stage 3 (row 10), 9 blocks a shift
    for s, (grid, c, heads, cases_) in enumerate([
            (g, 128, 4, [(0, True, 1), (3, False, 1)]),
            (g // 2, 256, 8, [(0, False, 1), (3, False, 1)]),
            (g // 4, 512, 16, [(0, False, 9), (3, False, 9)])]):
        x = rand(rs, b, grid, grid, c, dtype=dt)
        args = [x, vec(c, 1.0), vec(c), w(3 * c, c), vec(3 * c), w(c, c), vec(c),
                rand(rs, heads, 49, 49, scale=0.1)]
        gr = rand(rs, b, grid, grid, c, dtype=dt)
        wq_s, bq_s = fold_q_scale(args[3], args[4], heads)
        name = "fused_window_block_bwd" if c > 384 else "swin_window_block_bwd"
        for shift, res, n in cases_:
            kw = dict(num_heads=heads, win=7, shift=shift, residual=res)
            nbytes, ops = swin_work(b, grid, grid, c, heads, dt)
            cases.append((
                name, f"swin-base{s + 1} ({b},{grid},{grid},{c}) h{heads} shift{shift} "
                      f"res{int(res)}",
                n if name == "fused_window_block_bwd" else 0,
                lambda a=args, q=(wq_s, bq_s), k=kw, g_=gr: swin_window_block_bwd(
                    a[0], g_, a[1], a[2], q[0], q[1], *a[5:], **k),
                (lambda *a, k=kw: swin_window_block(*a, **k),
                 lambda *a, k=kw: swin_window_block_plain(*a, **k), args, gr),
                (3 * nbytes // 2 + 4 * 4 * c * c, {k_: 3 * v_ for k_, v_ in ops.items()}),
                None, None, ftn_counts(n if dt == torch.bfloat16 else None, FTN_ALL)))
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
                (2 * nbytes + 4 * 512 * 512 * 4, {k_: 3 * v_ for k_, v_ in ops.items()}), None,
                # DenseCLIPFTN's FTNDecoder (dropout 0) runs these halves fused; the
                # other FTN decoders train on the unfused ones (dropout 0.1)
                None, ftn_counts(n if dt == torch.bfloat16 else None, ("DenseCLIPFTN",))))
    # the x2 upsamples' adjoints: (grid, C, launches per flagship step, per FTN
    # step in this dtype).  PromptFTNv1's unfused FTNDecoder layers leave f32
    # (their cross-attention over the f32 text promotes, as in JAX), so its
    # upsamples after a block, and the deferred one, are f32
    bf = dt == torch.bfloat16
    for grid, c, n, on_ftn in [
            (16, 768, 1, {}), (32, 384, 1, {}),
            (16, 1024, 0, ftn_counts(1 if bf else None, FTN_ALL)),
            (16, 512, 1, dict(ftn_counts(1, ("DenseCLIPFTN",) + FTN_DEC2)) if bf
             else {"PromptFTNv1": 1}),
            (32, 512, 2, dict(ftn_counts(3, ("DenseCLIPFTN",) + FTN_DEC2), PromptFTNv1=1) if bf
             else {"PromptFTNv1": 2}),
            (64, 512, 1, dict(ftn_counts(3, FTN_DEC2), DenseCLIPFTN=1) if bf
             else {"PromptFTNv1": 1})]:
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
                False, None, None),
            lambda g_=gr, h=grid: upsample_tokens_adjoint_plain(g_, (h, h), 2), on_ftn))
    # the score map and the low-res map; at ratio 1 the loss is a plain CE
    for h, r in [(g, label // g), (g // 4, 4 * label // g)]:
        if r == 1:
            continue
        x = rand(rs, b, N_CLASSES, h, h, dtype=dt)
        y = seeded_labels(SEED + r, b, label, label)
        cases.append((
            "upsampled_cross_entropy",
            f"({b},{N_CLASSES},{h},{h}) r{r}, labels ({b},{label},{label})",
            1, lambda x_=x, y_=y, r_=r: fused_ce_fwd(x_, y_, r_),
            (lambda a, y_=y, r_=r: upsampled_cross_entropy(a, y_, r_),
             lambda a, y_=y, r_=r: upsampled_cross_entropy_plain(a, y_, r_), [x], None),
            # logits in and their gradient out, int64 labels; per hi-res pixel
            # and class a blend, an exp and a sum (about 8 operations, 2 of
            # them exponentials: the softmax's, and the gradient's recomputed)
            (2 * x.numel() * dt.itemsize + 8 * y.numel(), {"f32": 8 * N_CLASSES * y.numel()}),
            None, None, {}))
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
    lse, ‖Δ‖/‖ref‖ of each of dq, dk, dv within GRAD_BOUNDS (f32, the 3xTF32
    bodies: also within F32X3_GRAD_REL, the plain backward with TF32
    products failing it); two controls must fail the same gate: the kernel
    over all keys but the last 64 (its dk and dv zero there), and the masked
    case run unmasked.  Times: CUDA events, the kernel, the plain version and
    SDPA's backward (one call), each dtype's summed per v1 training step."""
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
        step = [0.0, 0.0, 0.0, 0.0]  # kernel, plain, SDPA's backward, bound: per v1 step
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
                if dt == torch.float32:  # the 3xTF32 rule; its control, the plain version in TF32
                    ok = ok and rel <= F32X3_GRAD_REL
                    c_rel = rel_of(plain_tf32(plain), want)
                    print(f"    3xTF32 rule ‖Δ‖/‖plain‖ <= {F32X3_GRAD_REL} on each of dq, dk, "
                          f"dv: kernel {rel:.3e}; control, the plain version with TF32 products "
                          f"{c_rel:.3e}: "
                          f"{'fails, as it must' if c_rel > F32X3_GRAD_REL else 'passes'}",
                          flush=True)
                    if c_rel <= F32X3_GRAD_REL:
                        raise AssertionError(f"flash_attention_bwd {label}: the 3xTF32 rule "
                                             f"passes its TF32 control ({c_rel:.3e})")
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
            if count is not None:
                for i, t_ in enumerate((k_ms, p_ms, lib_ms, b_ms)):
                    step[i] += count * t_
            if dt == torch.bfloat16 and count is not None:  # per phase-8b step
                st["ms"] += count * k_ms
                st["plain_ms"] += count * p_ms
                st["bound_ms"] += count * b_ms
                st["library_ms"] += count * lib_ms
                st["by"][by] = st["by"].get(by, 0.0) + count * b_ms
            del got, want, out, lse, leaves, o
        print(f"  flash_attention_bwd {dt} per v1 training step (launches x ms): kernel "
              f"{step[0]:.3f} plain {step[1]:.3f} SDPA's backward {step[2]:.3f} bound "
              f"{step[3]:.3f}", flush=True)
        torch.cuda.empty_cache()


def check_backward_kernels():
    """Phase 3b: bf16 and f32 at the batch-8 steps' shapes, then f32 at the
    shapes of phase 6c's batch-16 flagship step (128² labels), whose launches
    they are tagged with and must sum to.  Returns per-kernel stats for the
    JSON line."""
    stats, ftn_stats, f32_sums = {}, {}, {}
    for dt, batch, labels in ((torch.bfloat16, TRAIN_BATCH, IMG),
                              (torch.float32, TRAIN_BATCH, IMG),
                              (torch.float32, F32_STEP_BATCH, F32_STEP_LABEL)):
        bound = GRAD_BOUNDS[dt]
        step6c = batch == F32_STEP_BATCH
        print(f"\n[backward] {dt}, batch {batch}, {labels}² labels"
              f"{' (phase 6c: the flagship step only)' if step6c else ''}: bound "
              f"‖kernel - plain‖ / ‖plain‖ <= {bound} over every gradient", flush=True)
        rs = np.random.RandomState(SEED + 3)
        launches = {}
        for (name, label, count, kern, (kfn, pfn, args, g), work, library,
             adjoint_plain, on_ftn) in backward_cases(rs, dt, batch, labels):
            if step6c:
                if not count or name not in BACKWARD_KERNELS:
                    continue
                on_ftn = {}  # the FTN sums are per bf16 batch-8 step
                launches[name] = launches.get(name, 0) + count
            ka = [a.detach().clone().requires_grad_() for a in args]
            pa = [a.detach().clone().requires_grad_() for a in args]
            got = torch.autograd.grad(kfn(*ka), ka, g)
            torch.cuda.synchronize()
            out_p = pfn(*pa)
            want = torch.autograd.grad(out_p, pa, g, retain_graph=True)
            if adjoint_plain is not None:
                # the upsample adjoint: held to its own plain version by the
                # bit rule; autograd through the plain forward (the old
                # rounding order) is the control
                control, want = want, (adjoint_plain(),)
            rel = max(((a.float() - b_.float()).norm() / b_.float().norm().clamp_min(1e-30)).item()
                      for a, b_ in zip(got, want))
            mx = max((a.float() - b_.float()).abs().max().item() for a, b_ in zip(got, want))
            finite = all(bool(torch.isfinite(a).all()) for a in got)
            x3_rule = dt == torch.float32 and name in F32X3_BACKWARDS
            if x3_rule:  # the 3xTF32 rule and its control, the plain version in TF32
                ta = [a.detach().clone().requires_grad_() for a in args]
                tf32 = plain_tf32(lambda: torch.autograd.grad(pfn(*ta), ta, g))
                c_rel = max(((a.float() - b_.float()).norm()
                             / b_.float().norm().clamp_min(1e-30)).item()
                            for a, b_ in zip(tf32, want))
                print(f"    3xTF32 rule ‖Δ‖/‖plain‖ <= {F32X3_GRAD_REL} on every gradient: "
                      f"kernel {rel:.3e}; control, the plain version with TF32 products "
                      f"{c_rel:.3e}: {'fails, as it must' if c_rel > F32X3_GRAD_REL else 'passes'}",
                      flush=True)
                if c_rel <= F32X3_GRAD_REL:
                    raise AssertionError(f"{name} {label}: the 3xTF32 rule passes its TF32 "
                                         f"control ({c_rel:.3e})")
                del ta, tf32
            k_ms = time_ms(kern, reps=5, warmup=1)
            p_ms = time_ms(lambda: torch.autograd.grad(out_p, pa, g, retain_graph=True),
                           reps=5, warmup=1)
            if name == "upsampled_cross_entropy":  # one kernel for loss and gradient
                p_ms = time_ms(lambda: torch.autograd.grad(pfn(*pa), pa), reps=5, warmup=1)
            if adjoint_plain is not None:
                p_ms = time_ms(adjoint_plain, reps=5, warmup=1)
            lib_ms = time_ms(library, reps=5, warmup=1) if library else None
            b_ms, by = least_time(*work)
            ok = rel <= bound and finite and (not x3_rule or rel <= F32X3_GRAD_REL)
            lib = f" one-call {lib_ms:8.3f}" if lib_ms is not None else ""
            if adjoint_plain is not None:
                ok, _, msg = upsample_bits(got[0], want[0])
                lib += f"{memory_rate(work[0], k_ms)}; {msg}"
            if name in ("fused_attn_block_bwd", "swin_window_block_bwd",
                        "fused_window_block_bwd"):
                lib += f" ({rate_of(work, k_ms)})"
            if name == "upsampled_cross_entropy":  # its exponentials and f32 operations a second
                f32_ops = work[1]["f32"]
                lib += (f" ({f32_ops / 4 / k_ms / 1e9:.2f} T exp/s, "
                        f"{f32_ops / k_ms / 1e9:.1f} T f32 op/s)")
            per = f"x{count}/step" + ("; FTN " + ", ".join(f"{m} x{n}" for m, n in on_ftn.items())
                                      if on_ftn else "")
            print(f"  {name:23s} {label:46s} max {mx:.3e} rel {rel:.3e} kernel {k_ms:8.3f} ms "
                  f"plain {p_ms:8.3f}{lib} bound {b_ms:7.3f} ({by}) {per} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(f"{name} {label} {dt}: backward kernel disagrees with "
                                     f"autograd through its plain version (rel {rel:.3e})")
            if adjoint_plain is not None and dt == torch.bfloat16:
                c_ok, _, c_msg = upsample_bits(control[0], want[0])
                print(f"    control, the adjoint rounded in the old order (autograd through "
                      f"the plain forward): {c_msg}: "
                      f"{'passes' if c_ok else 'fails, as it must'}", flush=True)
                if c_ok:
                    raise AssertionError(f"{name} {label}: the bit rule passes its control")
            if x3_rule and count:  # f32 per flagship step (row 10: per FTN step)
                f = f32_sums.setdefault((name, batch), [0, 0.0, 0.0, 0.0])
                for i, v in enumerate((count, count * k_ms, count * p_ms, count * b_ms)):
                    f[i] += v
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
            for model, n in on_ftn.items():  # per bf16 batch-8 step of each FTN model
                f = ftn_stats.setdefault(model, {}).setdefault(
                    name, dict(launches=0, ms=0.0, plain_ms=0.0, bound_ms=0.0))
                f["launches"] += n
                for key, v in (("ms", k_ms), ("plain_ms", p_ms), ("bound_ms", b_ms)):
                    f[key] += n * v
            del got, want, out_p, ka, pa
            control = None
        torch.cuda.empty_cache()
        want_launches = {k: v for k, v in EXPECTED_F32_STEP_LAUNCHES.items()
                         if k in BACKWARD_KERNELS}
        if step6c and launches != want_launches:
            raise AssertionError(f"phase 3b's f32 batch-{batch} shapes give launches "
                                 f"{launches}, phase 6c counts {want_launches}")
    for (name, batch), (n, k_ms, p_ms, b_ms) in f32_sums.items():
        per = "DenseCLIPFTN step" if name == "fused_window_block_bwd" else "flagship step"
        print(f"[backward] f32 (3xTF32) {name}: {n} launches a batch-{batch} {per}: "
              f"kernel {k_ms:.2f} ms, plain {p_ms:.2f}, bound {b_ms:.3f}", flush=True)
    report_ftn_backward(ftn_stats)
    check_flash_backward(stats)
    return stats


def report_ftn_backward(ftn_stats):
    """Phase 3b's times at the FTN steps' shapes, per bf16 batch-8 step of
    each FTN model (each shape in the dtype that step runs it in); the
    launches so summed must equal phase 13's backward counts (row 10's
    blocks, fused_window_block_bwd, among swin_window_block_bwd's)."""
    print("\n[backward] per bf16 b8 FTN training step, from the cases above (launches x ms at "
          "the step's shapes and dtypes):", flush=True)
    for model, expected in EXPECTED_FTN_TRAIN_LAUNCHES.items():
        got = ftn_stats.get(model, {})
        tot = [sum(f[k] for f in got.values()) for k in ("ms", "plain_ms", "bound_ms")]
        print(f"  {model}: " + "; ".join(
            f"{name} {f['launches']} kernel {f['ms']:.3f} plain {f['plain_ms']:.3f} bound "
            f"{f['bound_ms']:.3f}" for name, f in got.items())
            + f"; all kernel {tot[0]:.3f} ms plain {tot[1]:.3f} bound {tot[2]:.3f}", flush=True)
        launches = {}
        for name, f in got.items():
            key = "swin_window_block_bwd" if name == "fused_window_block_bwd" else name
            launches[key] = launches.get(key, 0) + f["launches"]
        want = {k: v for k, v in expected.items() if k in BACKWARD_KERNELS}
        if launches != want:
            raise AssertionError(f"phase 3b's shapes of {model} give launches {launches}, "
                                 f"phase 13 counts {want}")


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


def serve_batches(model, batches, extra, counters, expected, label, smi, what="bf16"):
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
    print(f"[{label}] {what} b{BATCH} {IMG}² forward (host clock to synchronize): "
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
    from lc2is_tpu_torch.nn.swin import SWIN_SMALL

    nodrop = dict(swin_cfg=dict(SWIN_SMALL, drop_path_rate=0.0))
    cpu, opt_c = train_models(state, name, device="cpu", **nodrop)
    gpu, opt_g = train_models(state, name, **nodrop)
    x = rand(np.random.RandomState(SEED + 20), 1, 3, IMG, IMG, device="cpu")
    compare_f32_steps(state, name, label, cpu, opt_c, gpu, opt_g, {"pixel_values": x})


# the flagship's f32 training step as scripts/all_args.sh runs it (phase 6c):
# 512² images, 128² labels, batch 16, FP16=False, dropout 0
F32_STEP_BATCH = 16
F32_STEP_LABEL = IMG // 4
# its launches: at 128² labels the score map's loss is a plain CE (ratio 1,
# engine.py's _fused_or_plain_ce) and only the low-res map's (ratio 4) runs
# the fused CE
EXPECTED_F32_STEP_LAUNCHES = dict(EXPECTED_TRAIN_LAUNCHES, upsampled_cross_entropy=1)


def check_train_f32_step(smi, state, name="PromptAuxCrossA", label="train"):
    """Phase 6c: the flagship's f32 training step at batch 16 (512², 128²
    labels, decoder dropout 0, the swin's default drop path), as
    scripts/all_args.sh trains it: 2 warm-up steps and 6 timed ones (host
    clock to a synchronize), img/s, peak memory, the launch counts of one
    step (every f32 backward through its kernel), and a torch.profiler table
    of one more step with rows 3 and 7's device time read from it.  Returns
    the median step ms."""
    from lc2is_tpu_torch.engine.engine import train_step

    model, opt = train_models(state, name)
    batch = F32_STEP_BATCH
    x = rand(np.random.RandomState(SEED + 60), batch, 3, IMG, IMG)
    y = seeded_labels(SEED + 61, batch, F32_STEP_LABEL, F32_STEP_LABEL)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    counters = launch_counters()
    for _ in range(2):
        train_step(model, opt, {"pixel_values": x}, y, generator=gen)
    torch.cuda.synchronize()
    times = []
    for i in range(6):
        if i == 0:
            for f in counters.values():
                f.launches = 0
        t0 = time.perf_counter()
        out = train_step(model, opt, {"pixel_values": x}, y, generator=gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            counts = {k: f.launches for k, f in counters.items() if f.launches}
    peak = torch.cuda.max_memory_allocated()
    ms = statistics.median(times)
    losses = {k: round(v.item(), 5) for k, v in out.items()}
    print(f"[{label}] (c) {name} f32 b{batch} {IMG}², {F32_STEP_LABEL}² labels, decoder "
          f"dropout 0 (scripts/all_args.sh): losses {losses}; launches over one step "
          f"{counts}", flush=True)
    if counts != EXPECTED_F32_STEP_LAUNCHES or not all(np.isfinite(v) for v in losses.values()):
        raise AssertionError(f"f32 step launch counts {counts} != "
                             f"{EXPECTED_F32_STEP_LAUNCHES} or a non-finite loss")
    print(f"[{label}] (c) {name} f32 b{batch} step (host clock to synchronize): "
          f"{[round(t, 2) for t in times]} ms, median {ms:.2f} ms = "
          f"{batch * 1e3 / ms:.2f} img/s, peak device memory {peak / 2 ** 30:.2f} GiB on {smi}",
          flush=True)
    events = []
    table = profile_step(lambda: train_step(model, opt, {"pixel_values": x}, y, generator=gen),
                         f"one {name} f32 b{batch} step", events=events)
    rows = {e.key: e for e in table
            if e.key in ("_FusedAttnBlockBackward", "_SwinWindowBlockBackward")}
    if len(rows) != 2:
        raise AssertionError(f"the profile has rows 3 and 7's autograd nodes {sorted(rows)}")
    fwd_ms, fwd_calls = swin_forward_device_ms(events)
    print(f"[{label}] (c) a step's rows 3 and 7 in the profile (device time of their autograd "
          f"nodes: the kernel and its zeroed gradients): "
          + ", ".join(f"{k} {device_us(e) / 1e3:.2f} ms ({e.count} calls)"
                      for k, e in sorted(rows.items()))
          + f"; row 6's forward (the swin window block's f32 kernels) {fwd_ms:.2f} ms "
          f"({fwd_calls} calls)", flush=True)
    if fwd_calls != EXPECTED_F32_STEP_LAUNCHES["swin_window_block"]:
        raise AssertionError(f"the profile has {fwd_calls} f32 swin window block forwards")
    return ms


def swin_forward_device_ms(events):
    """(device ms, calls) of the f32 swin window block forwards among a
    profile's device events: each call of the token-major plan is its
    LayerNorm pass (swin_ln_f32_kernel) and the three kernels after it on
    the stream (the QKV GEMM, swin_core_x3, the out-projection GEMM); an
    older checkout's CUDA-core body is one swin_window_kernel."""
    events = sorted(events, key=lambda e: e.time_range.start)
    total, calls = 0.0, 0
    for i, e in enumerate(events):
        if "swin_window_kernel" in e.name:
            plan = [e]
        elif "swin_ln_f32_kernel" in e.name:
            plan = events[i:i + 4]
            if len(plan) != 4 or "swin_core_x3" not in plan[2].name:
                raise AssertionError(f"the kernels after a swin_ln_f32_kernel: "
                                     f"{[k.name for k in plan]}")
        else:
            continue
        total += sum(k.time_range.end - k.time_range.start for k in plan) / 1e3
        calls += 1
    return total, calls


def prompt_decoder_relu_inputs(model):
    """{layer: its ``linear1`` output, the relu's input, in the last forward}
    for the layers of the model's prompt decoder (none without one)."""
    pre = {}
    decoder = getattr(model, "prompt_decoder", None)
    for i, layer in enumerate(decoder.layers if decoder is not None else ()):
        layer.linear1.register_forward_hook(
            lambda m, a, out, i=i: pre.__setitem__(i, out.detach().cpu()))
    return pre


def compare_f32_steps(state, name, label, cpu, opt_c, gpu, opt_g, inputs):
    """One f32 ``train_step`` of the same model on the CPU and on the card
    (``inputs`` on the CPU, 512² labels from the seed), under phase 6a's
    gates: the losses, every trainable gradient (those of a prompt
    decoder's layers up to the deepest one where a relu unit switched:
    PROMPT_DECODER_GRAD_REL), the parameters after AdamW, the frozen
    parameters unchanged bit for bit."""
    from lc2is_tpu_torch.engine.engine import train_step

    frozen = frozen_prefixes(name)
    y = seeded_labels(SEED + 21, 1, IMG, IMG, device="cpu")
    pre_c, pre_g = prompt_decoder_relu_inputs(cpu), prompt_decoder_relu_inputs(gpu)
    t0 = time.time()
    want = train_step(cpu, opt_c, inputs, y)
    cpu_s = time.time() - t0
    got = train_step(gpu, opt_g, {k: v.cuda() for k, v in inputs.items()}, y.cuda())
    torch.cuda.synchronize()
    switched = [int(((pre_g[i] > 0) != (pre_c[i] > 0)).sum()) for i in range(len(pre_c))]
    loose = tuple(f"prompt_decoder.layers.{i}." for i in range(
        max((i + 1 for i, n in enumerate(switched) if n), default=0)))
    if switched:
        print(f"[{label}] (a) relu units with another sign on the card than on the CPU, per "
              f"prompt-decoder layer: {switched} (bound {RELU_SWITCHES} in all); "
              f"{len(loose)} layers held to {PROMPT_DECODER_GRAD_REL}", flush=True)
    if sum(switched) > RELU_SWITCHES:
        raise AssertionError(f"{name}: {sum(switched)} relu units switched in the f32 step")
    for key in want:
        g_, w_ = got[key].item(), want[key].item()
        print(f"[{label}] (a) {name} f32 b1 {IMG}² {key}: card {g_:.6f} CPU {w_:.6f} "
              f"(bound {STEP_LOSS_RTOL} relative)", flush=True)
        if not (np.isfinite(g_) and abs(g_ - w_) <= STEP_LOSS_RTOL * abs(w_)):
            raise AssertionError(f"f32 step {key}: card {g_} vs CPU {w_}")
    worst, worst_name, n_grads, worst_param = 0.0, "", 0, 0.0
    worst_pd, worst_pd_name = 0.0, ""
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
        if pname.startswith(loose):
            if rel > worst_pd:
                worst_pd, worst_pd_name = rel, pname
        elif rel > worst:
            worst, worst_name = rel, pname
        if zero_in_exact:
            continue
        sure = p.grad.abs() >= torch.clamp(1e-3 * p.grad.abs().max(), min=1e-6)
        d = (q.detach().cpu() - p.detach())[sure].abs()
        worst_param = max(worst_param, d.max().item() if d.numel() else 0.0)
    tower = ("frozen " + ", ".join(frozen) + ": no gradient, unchanged bit for bit"
             if frozen else "nothing frozen")
    pd = (f"; of its layers 0-{len(loose) - 1} the worst {worst_pd:.3e} ({worst_pd_name}; "
          f"bound {PROMPT_DECODER_GRAD_REL})" if loose else "")
    print(f"[{label}] (a) {n_grads} trainable gradients, card vs CPU: worst norm-relative "
          f"{worst:.3e} ({worst_name}; bound {STEP_GRAD_REL}){pd}; parameters after AdamW max "
          f"|Δ| {worst_param:.3e} (bound {STEP_PARAM_ATOL:.1e}); {tower}; CPU step "
          f"{cpu_s:.1f} s", flush=True)
    if (worst > STEP_GRAD_REL or worst_pd > PROMPT_DECODER_GRAD_REL
            or worst_param > STEP_PARAM_ATOL):
        raise AssertionError("f32 training step on the card disagrees with the CPU run")


def check_train_bf16(smi, state, name="PromptAuxCrossA", expected=None, label="train",
                     profile_rows=40):
    """Phase 6b (11b for the other v4 models): bf16 batch 8, drop path 0.1,
    decoder dropout 0, a profile table of ``profile_rows`` items.  Returns
    (launch counts of one step, median step ms)."""
    expected = EXPECTED_TRAIN_LAUNCHES if expected is None else expected
    model, opt = train_models(state, name, dtype=torch.bfloat16)
    x = rand(np.random.RandomState(SEED + 30), TRAIN_BATCH, 3, IMG, IMG, dtype=torch.bfloat16)
    y = seeded_labels(SEED + 31, TRAIN_BATCH, IMG, IMG)
    counts, ms, _, _ = run_train_bf16(smi, model, opt, {"pixel_values": x}, y, name, expected,
                                      label, "drop path 0.1", profile_rows)
    return counts, ms


def run_train_bf16(smi, model, opt, inputs, y, name, expected, label, what, profile_rows=40):
    """Two warm-up steps (the generator seeded SEED), the launch counts of one
    step asserted, six timed steps, finite losses, every trainable parameter
    changed (but stage 4's dead blocks and the swin key biases), the frozen
    ones unchanged, the peak device memory; a torch.profiler table (its
    ``profile_rows`` largest items) of one more step.  Returns (counts,
    median ms, the first warm-up step's train_loss, peak bytes)."""
    from lc2is_tpu_torch.engine.engine import train_step

    frozen = frozen_prefixes(name)
    batch = y.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    counters = launch_counters()
    torch.cuda.reset_peak_memory_stats()
    first = train_step(model, opt, inputs, y, generator=gen)["train_loss"]
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
    print(f"[{label}] (b) {name} bf16 b{batch} {IMG}², {what}: losses per step "
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
    dead = [n for n in trainable if ".stages.3.blocks." in n]
    zero = [n for n in trainable if n.endswith("attention.self.key.bias") and n not in dead]
    # a parameter that got a gradient and AdamW moments but did not move is
    # excused only where the last step, from its group's own lr, betas, eps
    # and weight decay, is below ROUNDED_AWAY x eps · |p| (eps of p's dtype)
    # on every element, so the rounding keeps it (the FTN prompt decoders, whose
    # output the models scale by 1e-4 and 1e-5: Adam's m / (sqrt(v) + eps)
    # is far below 1 where |g| << eps); the group's lr must be the step's
    # TRAIN_LR, so a schedule at 0 excuses nothing
    params, adam = dict(model.named_parameters()), opt.adamw.state
    group_of = {id(p): g for g in opt.adamw.param_groups for p in g["params"]}
    below, unexplained = {}, []
    for n in sorted(set(trainable) - set(changed) - set(dead) - set(zero)):
        p, st, g = params[n], adam.get(params[n], {}), group_of.get(id(params[n]))
        if (p.grad is None or not p.grad.any() or not st or not st["exp_avg"].any()
                or g is None or g["lr"] != TRAIN_LR):
            unexplained.append(n)
            continue
        (b1, b2), t = g["betas"], float(st["step"])
        step = (g["lr"] * st["exp_avg"] / (1 - b1 ** t)
                / ((st["exp_avg_sq"] / (1 - b2 ** t)).sqrt() + g["eps"])).abs()
        step = step + g["lr"] * g["weight_decay"] * p.detach().abs()
        spacing = (torch.finfo(p.dtype).eps * p.detach().abs()).clamp_min(1e-30)
        below[n] = (step / spacing).max().item()
        if below[n] >= ROUNDED_AWAY:
            unexplained.append(n)
    print(f"[{label}] {len(changed)} of {len(trainable)} trainable parameters changed after 8 "
          f"steps; not required to: the {len(dead)} of stage 4's dead blocks (as in the "
          f"reference), the {len(zero)} swin key biases ({len(set(zero) - set(changed))} "
          f"did not move) and those whose last AdamW step is below {ROUNDED_AWAY} x eps·|p|: "
          f"{len(set(below) - set(unexplained))}; frozen changed: {len(moved_frozen)}",
          flush=True)
    for n, r in below.items():
        print(f"[{label}]   did not move: {n}, last step / (eps·|p|) at most {r:.3f} "
              f"(bound {ROUNDED_AWAY})", flush=True)
    if unexplained or moved_frozen:
        raise AssertionError(f"parameters not updated {unexplained[:5]} / frozen moved "
                             f"{moved_frozen[:5]}")
    ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated()
    print(f"[{label}] (b) {name} bf16 b{batch} {IMG}² step (host clock to synchronize): "
          f"{[round(t, 2) for t in times]} ms, median {ms:.2f} ms = "
          f"{batch * 1e3 / ms:.2f} img/s, peak device memory {peak / 2 ** 30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated) on {smi}", flush=True)
    profile_step(lambda: train_step(model, opt, inputs, y, generator=gen),
                 f"one {name} bf16 b{batch} step", rows=profile_rows)
    return counts, ms, first, peak


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
# the other v4 models phase 11 trains in bf16: one loss each; the SelfA
# decoders' 6 layers have one attention half each
V4_TRAINED = ("BaseSelfA", "PromptSelfA", "PromptCrossA")
EXPECTED_V4_TRAIN_LAUNCHES_OF = {
    name: dict(EXPECTED_V4_TRAIN_LAUNCHES,
               **({} if "CrossA" in name else {"fused_attn_block": 6, "fused_attn_block_bwd": 6}))
    for name in V4_TRAINED}


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
    loss through the fused upsample-CE, nothing frozen: (a) f32 card vs CPU,
    (b) bf16 with a profile; then the bf16 steps of BaseSelfA, PromptSelfA
    and PromptCrossA.  Returns (launch counts of one BaseCrossA 11b step,
    {name: median ms})."""
    from lc2is_tpu_torch.core.convert import seeded_init_
    from lc2is_tpu_torch.models import zoo

    def state_of(name):
        return seeded_init_(getattr(zoo, name)(class_names=NAMES, device="cpu"),
                            SEED).state_dict()

    state = state_of("BaseCrossA")
    check_train_f32(state, "BaseCrossA", "v4 train")
    torch.cuda.empty_cache()
    counts, ms = check_train_bf16(smi, state, "BaseCrossA", EXPECTED_V4_TRAIN_LAUNCHES,
                                  "v4 train")
    step_ms = {"BaseCrossA": ms}
    for name in V4_TRAINED:
        torch.cuda.empty_cache()
        step_ms[name] = check_train_bf16(smi, state_of(name), name,
                                         EXPECTED_V4_TRAIN_LAUNCHES_OF[name], "v4 train",
                                         profile_rows=5)[1]
    return counts, step_ms


def profile_step(step, label, rows=40, events=None):
    """torch.profiler over one step: device time by kernel and idle share.
    Returns the profile's key averages (and adds its device events to the
    list ``events``, where given)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if events is not None:
        events.extend(device)
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    span = spans[-1][1] - spans[0][0] if spans else 0.0
    averages = prof.key_averages()
    table = averages.table(sort_by="cuda_time_total", row_limit=rows)
    print(f"[profile] {label}: {len(device)} device kernels, busy {busy / 1e3:.2f} ms "
          f"in a {span / 1e3:.2f} ms first-to-last span (idle {100 * (1 - busy / span):.1f} %)")
    print(table, flush=True)
    return averages


def device_us(event):
    """A profiler average's device time in µs (its "CUDA total")."""
    return getattr(event, "device_time_total", None) or event.cuda_time_total


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
                check_v1_f32_batch(smi, gpu32, [b.float() for b in batches], text, counters)
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


def check_v1_f32_batch(smi, model, batches, text, counters):
    """Phase 7f: the f32 BaseModelWithText at batch 16, 512², as
    scripts/evaluate.sh evaluates it (the CLI's default dtype): the launch
    counts of one forward (flash 13, its f32 body; fused_mlp 1), three
    answered batches timed after a warm-up, finite outputs, peak memory."""
    name = "BaseModelWithText"
    torch.cuda.reset_peak_memory_stats()
    first, ms, _ = serve_batches(model, batches, text, counters, EXPECTED_V1_LAUNCHES[name],
                                 f"v1 (f) {name}", smi, what="f32")
    peak = torch.cuda.max_memory_allocated()
    if not all(o is None or bool(torch.isfinite(o).all()) for o in first):
        raise AssertionError(f"v1 {name} f32 b{BATCH}: non-finite output")
    print(f"[v1 (f) {name}] f32 b{BATCH} {IMG}² forward median {ms:.2f} ms, peak device "
          f"memory {peak / 2 ** 30:.2f} GiB on {smi}", flush=True)
    return ms


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


def v1_train_batch(dtype=torch.bfloat16):
    x = rand(np.random.RandomState(SEED + 62), BATCH, 3, IMG, IMG, dtype=dtype)
    y = seeded_labels(SEED + 63, BATCH, V1_OUT, V1_OUT)
    return {"pixel_values": x, **v1_text(BATCH, "cuda")}, y


def step_counts(counters, step):
    """Run ``step`` with every launch counter at 0; (its output, the counts)."""
    for f in counters.values():
        f.launches = 0
    out = step()
    torch.cuda.synchronize()
    return out, {name: f.launches for name, f in counters.items() if f.launches}


def check_v1_train_step(smi, state, dtype=torch.bfloat16):
    """Phase 8b: the bf16 batch-16 BaseModelWithText step at dropout 0: two
    warm-up steps, six timed, the launch counts of the first timed step, the
    peak memory, a profile of one more.  Phase 8d: the same in f32 (the CLI's
    default dtype; its flash bodies 3xTF32), without the profile.  Returns
    (the counts, median step ms)."""
    from lc2is_tpu_torch.engine.engine import train_step

    what, part = ("bf16", "b") if dtype == torch.bfloat16 else ("f32", "d")
    torch.cuda.reset_peak_memory_stats()
    model, opt = v1_train_models(state, dtype=dtype)
    inputs, y = v1_train_batch(dtype)
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
    print(f"\n[v1 train] ({part}) {what} b{BATCH} {IMG}², labels {V1_OUT}², dropout 0: losses "
          f"per step {[round(v, 5) for v in losses]}")
    print(f"[v1 train] ({part}) launches over one step: {counts} (expected "
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
    peak = torch.cuda.max_memory_allocated()
    print(f"[v1 train] ({part}) {what} b{BATCH} {IMG}² step (host clock to synchronize): "
          f"{[round(t, 2) for t in times]} ms, median {ms:.2f} ms = {BATCH * 1e3 / ms:.2f} "
          f"img/s, peak device memory {peak / 2 ** 30:.2f} GiB on {smi}", flush=True)
    if dtype == torch.bfloat16:
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
    """Phase 8: v1 training.  Returns (launch counts of one 8b step, its ms,
    the f32 step's ms, 8d)."""
    from lc2is_tpu_torch.core.convert import seeded_init_
    from lc2is_tpu_torch.models.zoo import BaseModelWithText

    state = seeded_init_(BaseModelWithText(in_size=IMG, out_size=V1_OUT, device="cpu"),
                         SEED).state_dict()
    check_v1_train_f32(state)
    result = check_v1_train_step(smi, state)
    torch.cuda.empty_cache()
    check_v1_train_dropout(state)
    torch.cuda.empty_cache()
    _, f32_ms = check_v1_train_step(smi, state, torch.float32)
    torch.cuda.empty_cache()
    return result + (f32_ms,)


# the kernels of the tensor-core bodies (bf16 but four): flash (rows 15, 16;
# and their f32 bodies' 3xTF32 kernels), the decoder attention forward and
# backward (rows 2, 3: the attention cores, the GEMM, which the feed-forward
# (row 1) and the swin backward share, and the LayerNorm pass of rows 1 and
# 2), the swin window block (rows 6, 9; and its f32 body's 3xTF32 attention
# core), window attention (row 8), the swin backward's attention core (rows
# 7, 10), and the int8 row's s8 GEMM and row pass (rows 2q, 17)
MMA_KERNELS = ("flash_mma_kernel", "flash_bwd_dq_mma", "flash_bwd_dkv_mma", "flash_x3_kernel",
               "flash_bwd_dq_x3", "flash_bwd_dkv_x3", "attn_fwd_mma",
               "attn_dq_mma", "attn_dkdv_mma", "gemm_bf16_kernel", "layer_norm_rows",
               "swin_mma_kernel", "swin_core_mma", "swin_core_x3", "window_attention_mma",
               "swin_attn_bwd_mma", "gemm_s8_kernel", "quant_rows_kernel", "head_kernel",
               "fused_ce_kernel")


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
    return ("tensor-core bodies' kernels, registers a thread / spill-store bytes: "
            + ", ".join(out) if out else
            "tensor-core bodies' kernels: no ptxas report (library found already built)")


# the FTN family (phase 12): swin-base, decoder 512, 151 classes; per model,
# whether it takes the v1 text inputs (151 class-name prompts), and its
# launches over one bf16 batch-16 forward: the swin's 22 blocks of stages
# 1-3 (hidden_states[:4]; stage 4 does not run) and their feed-forwards;
# FTNDecoder: 6 SR decoder layers (two attention halves and a feed-forward
# each) and 6 ×2 upsamples; FTNDecoderV2: the 6 decoder layers of its
# RepeatTransformers and 8 ×2 upsamples; the prompt decoders of
# PromptFTNv1 / v2: 8 post-norm layers.  The CLIP text towers' causal
# attention takes the einsum path: no flash launch.
FTN_MODELS = {
    "DenseCLIPFTN": (False, {"swin_window_block": 22, "fused_mlp": 28, "fused_attn_block": 12,
                             "upsample_tokens": 6}),
    "PromptFTNv1": (True, {"swin_window_block": 22, "fused_mlp": 36, "fused_attn_block": 28,
                           "upsample_tokens": 6}),
    "BaseFTN": (False, {"swin_window_block": 22, "fused_mlp": 28, "fused_attn_block": 12,
                        "upsample_tokens": 8}),
    "PromptFTNv2": (True, {"swin_window_block": 22, "fused_mlp": 36, "fused_attn_block": 28,
                           "upsample_tokens": 8}),
}
# the one FTN model whose forward phase 12 profiles: the slowest, its f32
# prompt decoder over the 128² map (phase 3 sums every model's kernels)
FTN_PROFILED = "PromptFTNv2"
# of the 22 window blocks, those the JAX package sends through its windowed
# kernel (row 9, fused_window_block; nn/swin.py's canvas gate: C > 384): the
# 18 of swin-base stage 3 (C 512)
FTN_ROW9_LAUNCHES = 18
# the whole swin-base backbone, every stage run (SwinModel.forward with all
# hidden states): 24 window blocks (stage 4's 2 at C 1024) and feed-forwards
FTN_BACKBONE_LAUNCHES = {"swin_window_block": 24, "fused_mlp": 24}


def ftn_gate(got, want, max_abs, mean_abs=None):
    """(ok, message): |Δ| against max_abs (and its mean against mean_abs)
    times max(1, max |ref|): phase 4a's / 4b's gates on the cosine score maps
    (|ref| <= 1), scaled to BaseFTN's logits; the argmax over the classes."""
    scale = max(1.0, want.abs().max().item())
    d = (got.float() - want.float()).abs()
    agree = (got.float().argmax(1) == want.float().argmax(1)).float().mean().item()
    ok = d.max().item() <= max_abs * scale and bool(torch.isfinite(got).all())
    msg = (f"max |Δ| {d.max().item():.3e} (bound {max_abs} x {scale:.3g}) mean "
           f"{d.mean().item():.3e}")
    if mean_abs is not None:
        ok = ok and d.mean().item() <= mean_abs * scale
        msg += f" (bound {mean_abs} x {scale:.3g})"
    return ok, agree, f"{msg}, argmax agreement {agree:.5f}"


def swin_of(model):
    from lc2is_tpu_torch.nn.swin import SwinModel

    return next(m for m in model.modules() if isinstance(m, SwinModel))


def row9_launches(model):
    """Hooks on the model's swin stages: {stage: window-block launches in its
    last call}, for the stages whose blocks the JAX package sends through its
    windowed kernel (not takes_canvas_kernel)."""
    from lc2is_tpu_torch.nn.swin import takes_canvas_kernel
    from lc2is_tpu_torch.ops.swin_window import swin_window_block

    per_stage = {}
    for i, stage in enumerate(swin_of(model).stages):
        def pre(m, args, i=i):
            per_stage[i] = -swin_window_block.launches

        def post(m, args, out, i=i):
            h, w = args[1]
            c = args[0].shape[-1]
            if takes_canvas_kernel(h, w, c, args[0].dtype):
                per_stage.pop(i)
            else:
                per_stage[i] += swin_window_block.launches

        stage.register_forward_pre_hook(pre)
        stage.register_forward_hook(post)
    return per_stage


def check_ftn_model(smi, name, batches):
    """Phase 12 for one model: (a) f32 batch 1, the card against the same
    model's plain run on the CPU under ftn_gate's phase-4a bounds; (b) bf16
    batch 16, three batches answered and timed, the launch counts of one
    forward asserted (and its row-9 launches, per swin stage), a profile of
    one more, held against f32 on the card under phase 4b's bounds.  For DenseCLIPFTN also the whole
    backbone, every stage run: f32 b1 card vs CPU, bf16 b16 counts and time.
    Returns (median ms, row-9 launches of one forward)."""
    from lc2is_tpu_torch.core.convert import seeded_init_
    from lc2is_tpu_torch.models import zoo

    text_inputs, expected = FTN_MODELS[name]
    kw = dict(class_names=NAMES) if name == "DenseCLIPFTN" else {}
    t0 = time.time()
    cpu = seeded_init_(getattr(zoo, name)(device="cpu", **kw), SEED).eval()
    state = cpu.state_dict()
    print(f"\n[ftn] {name}: swin-base, {sum(p.numel() for p in cpu.parameters())} parameters "
          f"from numpy seed {SEED} ({time.time() - t0:.1f} s)", flush=True)
    gpu = getattr(zoo, name)(**kw)
    gpu.load_state_dict(state, strict=True)
    gpu.eval()
    x1 = rand(np.random.RandomState(SEED + 1), 1, 3, IMG, IMG, device="cpu")
    with torch.no_grad():
        text_c = v1_text(N_CLASSES, "cpu") if text_inputs else {}
        text_g = v1_text(N_CLASSES, "cuda") if text_inputs else {}
        if name == "DenseCLIPFTN":
            text_c = {"text_static": cpu.embed_text()}
            text_g = {"text_static": gpu.embed_text()}
        t0 = time.time()
        none_c, want = cpu({"pixel_values": x1, **text_c})
        cpu_s = time.time() - t0
        none_g, got = gpu({"pixel_values": x1.cuda(), **text_g})
        torch.cuda.synchronize()
        got = got.cpu()
        if none_c is not None or none_g is not None or got.shape != want.shape \
                or tuple(got.shape) != (1, N_CLASSES, IMG, IMG):
            raise AssertionError(f"ftn {name} f32: outputs {none_g}, {tuple(got.shape)}")
        ok, agree, msg = ftn_gate(got, want, SLICE_F32_MAX_ABS)
        print(f"[ftn] (a) {name} f32 b1 {tuple(got.shape)}: card vs CPU plain {msg} (bound "
              f"{SLICE_F32_ARGMAX_AGREE}); CPU forward {cpu_s:.1f} s", flush=True)
        if not ok or agree < SLICE_F32_ARGMAX_AGREE:
            raise AssertionError(f"ftn {name}: f32 on the card disagrees with the CPU plain run")
        if name == "DenseCLIPFTN":
            want_h = swin_of(cpu)(x1)
            got_h = swin_of(gpu)(x1.cuda())
            errs = [((g.cpu() - w).abs().max() / w.abs().max()).item()
                    for g, w in zip(got_h, want_h)]
            print(f"[ftn] (a) swin-base backbone, every stage, f32 b1: hidden states "
                  f"{[tuple(h.shape[1:]) for h in got_h]}, card vs CPU max |Δ| / max |ref| "
                  f"{[f'{e:.2e}' for e in errs]} (bound 1e-3)", flush=True)
            if len(got_h) != 5 or max(errs) > 1e-3:
                raise AssertionError("ftn: the swin-base backbone on the card disagrees")
        del cpu, want, got
        gpu16 = getattr(zoo, name)(dtype=torch.bfloat16, **kw)
        gpu16.load_state_dict(state, strict=True)
        gpu16.eval()
        text = v1_text(N_CLASSES, "cuda") if text_inputs else {}
        if name == "DenseCLIPFTN":
            text = {"text_static": gpu16.embed_text()}
        per_stage = row9_launches(gpu16)
        first, ms, _ = serve_batches(lambda inp: gpu16(inp)[1], batches, text, launch_counters(),
                                     expected, f"ftn {name} (b)", smi)
        row9 = sum(per_stage.values())
        print(f"[ftn] (b) {name}: window-block launches per swin stage the JAX package sends "
              f"through fused_window_block (row 9): {per_stage}, {row9} (expected "
              f"{FTN_ROW9_LAUNCHES})", flush=True)
        if row9 != FTN_ROW9_LAUNCHES:
            raise AssertionError(f"ftn {name}: row-9 launches {row9} != {FTN_ROW9_LAUNCHES}")
        if name == FTN_PROFILED:
            profile_step(lambda: gpu16({"pixel_values": batches[1], **text}),
                         f"one bf16 b{BATCH} {name} forward", rows=15)
        ref = gpu({"pixel_values": batches[1].float(), **text_g})[1]
        if tuple(first.shape) != (BATCH, N_CLASSES, IMG, IMG):
            raise AssertionError(f"ftn {name} bf16: {tuple(first.shape)}")
        ok, agree, msg = ftn_gate(first, ref, SLICE_BF16_MAX_ABS, SLICE_BF16_MEAN_ABS)
        print(f"[ftn] (b) {name} bf16 b{BATCH} {tuple(first.shape)} {first.dtype} vs f32 on the "
              f"card: {msg}", flush=True)
        if not ok:
            raise AssertionError(f"ftn {name}: bf16 outside its bound of f32")
        del ref, first, gpu
        if name == "DenseCLIPFTN":
            enc = swin_of(gpu16)
            serve_batches(lambda inp: enc(inp["pixel_values"]), batches, {}, launch_counters(),
                          FTN_BACKBONE_LAUNCHES, "ftn swin-base backbone, every stage (b)", smi)
    del gpu16
    torch.cuda.empty_cache()
    return ms, row9


def check_ftn(smi):
    """Phase 12: the FTN family served.  Returns ({name: median ms}, row-9
    launches of one forward)."""
    batches = [rand(np.random.RandomState(SEED + 60 + i), BATCH, 3, IMG, IMG,
                    dtype=torch.bfloat16) for i in range(4)]
    out = {name: check_ftn_model(smi, name, batches) for name in FTN_MODELS}
    return {k: ms for k, (ms, _) in out.items()}, out["DenseCLIPFTN"][1]


# the FTN training steps (phase 13), bf16 batch 8, the decoders' dropout
# (hardwired 0.1 but DenseCLIPFTN's FTNDecoder, 0) and drop path 0.1: the
# launches of one step.  The swin's 22 window blocks and feed-forwards and
# the 22 window-block backwards (18 of them row 10, swin-base stage 3);
# DenseCLIPFTN's FTNDecoder runs its fused halves as served (12 attention
# halves, 6 feed-forwards) and their backwards; the other decoders' and the
# prompt decoders' layers train on the unfused halves (JAX's gate at dropout
# 0.1): no decoder kernel; every x2 upsample and its adjoint
_FTN_SWIN_STEP = {"swin_window_block": 22, "fused_mlp": 22, "swin_window_block_bwd": 22}
EXPECTED_FTN_TRAIN_LAUNCHES = {
    "DenseCLIPFTN": dict(_FTN_SWIN_STEP, fused_mlp=28, fused_attn_block=12,
                         fused_attn_block_bwd=12, upsample_tokens=6, upsample_tokens_adjoint=6),
    "PromptFTNv1": dict(_FTN_SWIN_STEP, upsample_tokens=6, upsample_tokens_adjoint=6),
    "BaseFTN": dict(_FTN_SWIN_STEP, upsample_tokens=8, upsample_tokens_adjoint=8),
    "PromptFTNv2": dict(_FTN_SWIN_STEP, upsample_tokens=8, upsample_tokens_adjoint=8),
}
# the window-block backwards of the stages the JAX package sends through its
# windowed backward (row 10; C > 384): swin-base stage 3's 18
FTN_ROW10_LAUNCHES = 18
# the two FTN steps whose profile phase 13b prints in full: the fused decoder
# and FTNDecoderV2's unfused one
FTN_PROFILED_STEPS = ("DenseCLIPFTN", "BaseFTN")


def ftn_built(name, state, **kw):
    """The FTN model ``name`` (on the card unless ``device`` says otherwise)
    with the weights of ``state`` copied in, and its AdamW (lr 1e-5, the
    reference's frozen prefixes)."""
    from lc2is_tpu_torch.engine.optim import make_optimizer
    from lc2is_tpu_torch.models import zoo

    extra = dict(class_names=NAMES) if name == "DenseCLIPFTN" else {}
    m = getattr(zoo, name)(**extra, **kw)
    m.load_state_dict(state, strict=True)
    return m, make_optimizer(m, lr=TRAIN_LR, frozen_prefixes=frozen_prefixes(name))


def ftn_inputs(name, batch, seed, device="cuda", dtype=torch.float32):
    """512² images from the seed, and the 151 class-name prompts for the
    models that read text."""
    x = rand(np.random.RandomState(seed), batch, 3, IMG, IMG, dtype=dtype, device=device)
    return {"pixel_values": x, **(v1_text(N_CLASSES, device) if FTN_MODELS[name][0] else {})}


def row10_launches(model):
    """Hooks on the model's swin stages: {stage: window-block backward
    launches in the last backward}, for the stages whose blocks the JAX
    package sends through its windowed backward (not takes_canvas_kernel):
    counted between the gradient reaching the stage's output and its input."""
    from lc2is_tpu_torch.nn.swin import takes_canvas_kernel
    from lc2is_tpu_torch.ops.swin_window import swin_window_block_bwd

    per_stage = {}
    for i, stage in enumerate(swin_of(model).stages):
        def post(m, args, out, i=i):
            x, (h, w) = args[0], args[1]
            if takes_canvas_kernel(h, w, x.shape[-1], x.dtype) or not out[0].requires_grad:
                return
            out[0].register_hook(
                lambda g: per_stage.__setitem__(i, -swin_window_block_bwd.launches))
            x.register_hook(
                lambda g: per_stage.__setitem__(i, per_stage[i] + swin_window_block_bwd.launches))

        stage.register_forward_hook(post)
    return per_stage


def ftn_train_bf16(smi, name, state, batch):
    """Phase 13b for one model at ``batch``: run_train_bf16's checks with
    the launch counts of one step, the window blocks and their backwards of
    the stages the JAX package sends through its windowed kernels (rows 9
    and 10) counted per stage, the peak device memory, and a fresh model's
    first step repeating the first step's loss bit for bit from the same
    seed.  Returns (median ms, row-10 launches, peak bytes)."""
    from lc2is_tpu_torch.engine.engine import train_step

    model, opt = ftn_built(name, state, dtype=torch.bfloat16)
    inputs = ftn_inputs(name, batch, SEED + 30, dtype=torch.bfloat16)
    y = seeded_labels(SEED + 31, batch, IMG, IMG)
    row9, row10 = row9_launches(model), row10_launches(model)
    _, ms, first, peak = run_train_bf16(smi, model, opt, inputs, y, name,
                                        EXPECTED_FTN_TRAIN_LAUNCHES[name], "ftn train",
                                        "decoder dropout as built, drop path 0.1",
                                        20 if name in FTN_PROFILED_STEPS else 5)
    r9, r10 = sum(row9.values()), sum(row10.values())
    del model, opt
    model, opt = ftn_built(name, state, dtype=torch.bfloat16)
    again = train_step(model, opt, inputs, y,
                       generator=torch.Generator(device="cuda").manual_seed(SEED))["train_loss"]
    print(f"[ftn train] (b) {name} b{batch}: window blocks per stage through the windowed "
          f"kernels (row 9) {row9}, their backwards (row 10) {row10} (expected "
          f"{FTN_ROW9_LAUNCHES} each); first step's train_loss {first.item():.6f}, a "
          f"fresh model's from the same seed {again.item():.6f} "
          f"({'bit for bit' if torch.equal(first, again) else 'DIFFERENT'})", flush=True)
    if r9 != FTN_ROW9_LAUNCHES or r10 != FTN_ROW10_LAUNCHES:
        raise AssertionError(f"ftn {name} step: rows 9 / 10 launches {r9} / {r10}")
    if not torch.equal(first, again):
        raise AssertionError(f"ftn {name} step does not repeat from its seed")
    return ms, r10, peak


def check_ftn_train_model(smi, name):
    """Phase 13 for one model: (a) f32 batch 1, dropout and drop path rates
    0, the card's step against the same step on the CPU under phase 6a's
    gates; (b) bf16 batch 8 (or, where it does not fit, the largest batch
    that does), ftn_train_bf16.  Returns (median ms, row-10 launches, peak
    bytes, batch)."""
    from lc2is_tpu_torch.core.convert import seeded_init_
    from lc2is_tpu_torch.models import zoo

    extra = dict(class_names=NAMES) if name == "DenseCLIPFTN" else {}
    t0 = time.time()
    state = seeded_init_(getattr(zoo, name)(device="cpu", **extra), SEED).state_dict()
    print(f"\n[ftn train] {name}: swin-base, weights from numpy seed {SEED} "
          f"({time.time() - t0:.1f} s)", flush=True)
    cpu, opt_c = ftn_built(name, state, device="cpu")
    gpu, opt_g = ftn_built(name, state)
    compare_f32_steps(state, name, "ftn train", zoo.without_dropout(cpu), opt_c,
                      zoo.without_dropout(gpu), opt_g, ftn_inputs(name, 1, SEED + 20, "cpu"))
    del cpu, gpu, opt_c, opt_g
    torch.cuda.empty_cache()
    batch = TRAIN_BATCH
    while True:
        try:
            return (*ftn_train_bf16(smi, name, state, batch), batch)
        except torch.cuda.OutOfMemoryError as e:
            print(f"[ftn train] (b) {name} bf16 batch {batch} does not fit: {e}", flush=True)
            if batch == 1:
                raise
        gc.collect()
        torch.cuda.empty_cache()
        batch //= 2


def check_ftn_train(smi):
    """Phase 13: the FTN family's training steps.  Returns ({name: (median
    ms, batch, peak bytes)}, DenseCLIPFTN's row-10 launches of one step)."""
    out = {}
    for name in FTN_MODELS:
        ms, r10, peak, batch = check_ftn_train_model(smi, name)
        out[name] = (ms, batch, peak)
        if name == "DenseCLIPFTN":
            row10 = r10
        torch.cuda.empty_cache()
    return out, row10


# the evaluation (phase 14): (a) f32 batch 1, the card's eval step against the
# CPU's: losses within EVAL_LOSS_RTOL, the argmax maps at 512² (the logits,
# the confusion counts' map) and at 2048² (bicubic x4, the per-image mIoU's)
# equal but where the CPU's two best scores lie within EVAL_NEAR_TIE_REL x
# max |logit| (4m's rule, relative), the confusion counts apart by at most two
# a differing pixel, the per-image mIoU within EVAL_MIOU_ATOL; (b) bf16 batch
# 16, EVAL_BATCHES batches through evaluate, timed; (c) the sliding sweep of
# one 640² image in f32, card against CPU: probabilities within
# SLIDE_PROB_ATOL, argmax agreement >= SLIDE_ARGMAX_AGREE with every differing
# pixel a near-tie, eval_mIOU_sliding within EVAL_MIOU_ATOL; then a bf16 sweep
# of SLIDE_IMAGES images timed, its launches phase 3's sweep tags; (d) the
# GT-resolution mIoU of seeded logits at GT_SIZES, card against CPU per image
# within GT_MIOU_ATOL, bucket=64 equal to the exact path on the card
EVAL_MODELS = ("PromptAuxCrossA", "BaseCrossA")
EVAL_LOSS_RTOL = 1e-4
EVAL_NEAR_TIE_REL = 1e-5
EVAL_MIOU_ATOL = 1e-3
EVAL_BATCHES = 3
SLIDE_PROB_ATOL = 1e-3
SLIDE_ARGMAX_AGREE = 0.999
GT_SIZES = ((512, 683), (683, 512), (375, 500), (512, 512))
GT_MIOU_ATOL = 1e-6


def argmax_flips(got, want, label):
    """(pixels whose argmax over dim 1 differs, the largest top-2 gap of
    ``want`` (CPU, f32) there over max |want|); raises where a differing pixel
    is no near-tie.  The gaps are computed on the card."""
    differ = got.argmax(1).cpu() != want.argmax(1)
    n = int(differ.sum())
    if n == 0:
        return 0, 0.0
    w = want.cuda()
    top2 = w.topk(2, dim=1).values
    rel = ((top2[:, 0] - top2[:, 1])[differ.cuda()].max() / w.abs().max()).item()
    del w, top2
    if rel > EVAL_NEAR_TIE_REL:
        raise AssertionError(f"{label}: {n} pixels' argmax differs card vs CPU, the largest "
                             f"top-2 gap there {rel:.3e} x max |logit| (> {EVAL_NEAR_TIE_REL})")
    return n, rel


def eval_state(name, state):
    """The flagship's state, or ``name``'s from the numpy seed."""
    if name == "PromptAuxCrossA":
        return state
    from lc2is_tpu_torch.core.convert import seeded_init_
    from lc2is_tpu_torch.models import zoo

    return seeded_init_(getattr(zoo, name)(class_names=NAMES, device="cpu"), SEED).state_dict()


def check_eval_step_f32(name, st):
    """14a for one model: eval_step of one 512² image, f32, card vs CPU."""
    from lc2is_tpu_torch.engine.engine import eval_step
    from lc2is_tpu_torch.metrics.miou import resized_argmax
    from lc2is_tpu_torch.ops.resize import resize

    x = rand(np.random.RandomState(SEED + 40), 1, 3, IMG, IMG, device="cpu")
    y = seeded_labels(SEED + 41, 1, IMG, IMG, device="cpu").long()
    t0 = time.time()
    cpu = model_from(st, name, device="cpu").eval()
    c_losses, c_miou, c_cm, c_logits = eval_step(cpu, {"pixel_values": x}, y)
    cpu_s = time.time() - t0
    del cpu
    gpu = model_from(st, name).eval()
    g_losses, g_miou, g_cm, g_logits = eval_step(gpu, {"pixel_values": x.cuda()}, y.cuda())
    del gpu
    for k, v in c_losses.items():
        rel = abs(g_losses[k].item() - v.item()) / abs(v.item())
        print(f"[eval] (a) {name} f32 b1 {k}: card {g_losses[k].item():.6f} CPU {v.item():.6f}, "
              f"relative |Δ| {rel:.3e} (bound {EVAL_LOSS_RTOL})", flush=True)
        if rel > EVAL_LOSS_RTOL:
            raise AssertionError(f"{name}: {k} on the card disagrees with the CPU")
    if tuple(g_logits.shape) != (1, N_CLASSES, IMG, IMG) or not torch.isfinite(g_logits).all():
        raise AssertionError(f"{name}: eval logits {tuple(g_logits.shape)} / non-finite")
    n512, gap512 = argmax_flips(g_logits, c_logits, f"{name} 512² map")
    d_cm = int((g_cm.cpu().long() - c_cm.long()).abs().sum())
    up_g = resized_argmax(g_logits[0], scale_factor=4)[None].cpu()
    up_c = resized_argmax(c_logits[0], scale_factor=4)[None]
    differ4 = up_g != up_c
    n2048, gap2048 = int(differ4.sum()), 0.0
    if n2048:
        w4 = resize(c_logits.cuda(), scale_factor=4, method="bicubic")
        top2 = w4.topk(2, dim=1).values
        gap2048 = ((top2[:, 0] - top2[:, 1])[differ4.cuda()].max() / w4.abs().max()).item()
        del w4, top2
    d_miou = abs(g_miou.item() - c_miou.item())
    print(f"[eval] (a) {name} f32 b1: argmax differs at {n512} of {IMG * IMG} pixels at 512² "
          f"(largest top-2 gap there {gap512:.3e} x max |logit|), {n2048} of {16 * IMG * IMG} "
          f"at 2048² ({gap2048:.3e}; near-tie bound {EVAL_NEAR_TIE_REL}); confusion counts "
          f"|Δ| summed {d_cm} (at most {2 * n512}); per-image mIoU card {g_miou.item():.6f} CPU "
          f"{c_miou.item():.6f}, |Δ| {d_miou:.3e} (bound {EVAL_MIOU_ATOL}); CPU eval step "
          f"{cpu_s:.1f} s", flush=True)
    if gap2048 > EVAL_NEAR_TIE_REL or d_cm > 2 * n512 or d_miou > EVAL_MIOU_ATOL:
        raise AssertionError(f"{name}: the f32 eval step on the card disagrees with the CPU")


@contextlib.contextmanager
def eval_events(model):
    """CUDA events around each forward of ``model`` and each metric call of
    engine/engine.py's eval step (per_image_miou, batch_confusion), by hooks
    and by rebinding the names eval_step calls them by.  Yields
    {"forward": [(start, end)], "metrics": [(start, end)]}."""
    import lc2is_tpu_torch.engine.engine as eng

    ev, saved = {"forward": [], "metrics": []}, {}

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    hooks = [model.register_forward_pre_hook(lambda m, a: ev["forward"].append([event()])),
             model.register_forward_hook(lambda m, a, o: ev["forward"][-1].append(event()))]
    for name in ("per_image_miou", "batch_confusion"):
        saved[name] = getattr(eng, name)

        def timed(*a, _f=saved[name], **kw):
            start = event()
            out = _f(*a, **kw)
            ev["metrics"].append([start, event()])
            return out
        setattr(eng, name, timed)
    try:
        yield ev
    finally:
        for h in hooks:
            h.remove()
        for name, f in saved.items():
            setattr(eng, name, f)


def check_eval_bf16(smi, name, st):
    """14b for one model: EVAL_BATCHES bf16 batch-16 512² batches through
    evaluate after one warm-up batch; the host clock a batch, its forward and
    metric device times, the peak memory, the launch counts.  Returns (median
    ms a batch, forward ms, metric ms, peak GiB)."""
    from lc2is_tpu_torch.engine.engine import evaluate

    model = model_from(st, name, dtype=torch.bfloat16).eval()
    batches = [dict(pixel_values=rand(np.random.RandomState(SEED + 60 + i), BATCH, 3, IMG, IMG),
                    label=seeded_labels(SEED + 70 + i, BATCH, IMG, IMG).long())
               for i in range(EVAL_BATCHES + 1)]
    evaluate(model, batches[:1])  # warm-up
    torch.cuda.synchronize()
    counters = launch_counters()
    stamps = []

    def stamped():
        for b in batches[1:]:
            stamps.append(time.perf_counter())
            yield b

    torch.cuda.reset_peak_memory_stats()
    for f in counters.values():
        f.launches = 0
    with eval_events(model) as ev:
        metrics = evaluate(model, stamped())
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    counts = {k: f.launches for k, f in counters.items() if f.launches}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    host = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    fwd = [s.elapsed_time(e) for s, e in ev["forward"]]
    met = [sum(s.elapsed_time(e) for s, e in ev["metrics"][2 * i:2 * i + 2])
           for i in range(EVAL_BATCHES)]
    ms, f_ms, m_ms = (statistics.median(v) for v in (host, fwd, met))
    want = {k: EVAL_BATCHES * n for k, n in EXPECTED_LAUNCHES.items()}
    print(f"[eval] (b) {name} bf16 b{BATCH} {IMG}², {EVAL_BATCHES} batches through evaluate: "
          f"host clock a batch {[round(t, 2) for t in host]} ms, median {ms:.2f} ms = "
          f"{BATCH * 1e3 / ms:.1f} img/s; CUDA events a batch: forward {f_ms:.2f} ms, metrics "
          f"(per-image mIoU at 2048², confusion counts) {m_ms:.2f} ms, {100 * m_ms / ms:.1f} % of "
          f"the batch; peak {peak:.2f} GiB (torch.cuda.max_memory_allocated); launches {counts} "
          f"(expected {want}); {metrics} on {smi}", flush=True)
    if counts != want:
        raise AssertionError(f"{name}: evaluate's launch counts {counts} != {want}")
    if not all(math.isfinite(v) for v in metrics.values()) or not (
            0.0 <= metrics["eval_mIOU_label"] <= 1.0):
        raise AssertionError(f"{name}: evaluate's metrics {metrics}")
    del model, batches
    torch.cuda.empty_cache()
    return ms, f_ms, m_ms, peak


@contextlib.contextmanager
def recording_sliding_probs():
    """The probabilities engine/sliding.py hands per_image_miou, recorded."""
    import lc2is_tpu_torch.engine.sliding as sl

    seen, orig = [], sl.per_image_miou

    def rec(probs, *a, **kw):
        seen.append(probs.cpu())
        return orig(probs, *a, **kw)
    sl.per_image_miou = rec
    try:
        yield seen
    finally:
        sl.per_image_miou = orig


def check_sliding(smi, state, sweep_launches):
    """14c: the flagship's sliding evaluation.  Returns (sweep ms, peak GiB)."""
    from lc2is_tpu_torch.engine.sliding import evaluate_sliding

    kw = dict(scales=SLIDE_SCALES, crop=SLIDE_CROP, stride=SLIDE_STRIDE)
    x = rand(np.random.RandomState(SEED + 80), 1, 3, SLIDE_BASE, SLIDE_BASE, device="cpu")
    y = seeded_labels(SEED + 81, 1, SLIDE_BASE, SLIDE_BASE, device="cpu")
    batch = dict(pixel_values=x, label=y)
    out = {}
    for dev in ("cpu", "cuda"):
        t0 = time.time()
        model = model_from(state, device=dev).eval()
        with recording_sliding_probs() as seen:
            res = evaluate_sliding(model, [batch], **kw)
        out[dev] = (res, seen[0], time.time() - t0)
        del model
    (c_res, c_p, cpu_s), (g_res, g_p, _) = out["cpu"], out["cuda"]
    if tuple(g_p.shape) != (1, N_CLASSES, SLIDE_BASE, SLIDE_BASE) or not torch.isfinite(g_p).all():
        raise AssertionError(f"sliding probabilities {tuple(g_p.shape)} / non-finite")
    d = (g_p - c_p).abs().max().item()
    differ = g_p.argmax(1) != c_p.argmax(1)
    agree = 1.0 - differ.float().mean().item()
    n, gap = argmax_flips(g_p, c_p, "sliding probabilities")
    d_miou = abs(g_res["eval_mIOU_sliding"] - c_res["eval_mIOU_sliding"])
    print(f"[eval] (c) PromptAuxCrossA sliding f32, one {SLIDE_BASE}² image, scales "
          f"{SLIDE_SCALES}, crop {SLIDE_CROP}, stride {SLIDE_STRIDE}, flip: card vs CPU "
          f"probabilities max |Δ| {d:.3e} (bound {SLIDE_PROB_ATOL}), argmax agreement {agree:.6f} "
          f"(bound {SLIDE_ARGMAX_AGREE}; {n} differ, largest top-2 gap there {gap:.3e} x max "
          f"prob), eval_mIOU_sliding card {g_res['eval_mIOU_sliding']:.6f} CPU "
          f"{c_res['eval_mIOU_sliding']:.6f}, |Δ| {d_miou:.3e} (bound {EVAL_MIOU_ATOL}); CPU "
          f"sweep {cpu_s:.1f} s", flush=True)
    if d > SLIDE_PROB_ATOL or agree < SLIDE_ARGMAX_AGREE or d_miou > EVAL_MIOU_ATOL:
        raise AssertionError("the f32 sliding evaluation on the card disagrees with the CPU")
    model = model_from(state, dtype=torch.bfloat16).eval()
    xb = rand(np.random.RandomState(SEED + 82), SLIDE_IMAGES, 3, SLIDE_BASE, SLIDE_BASE)
    yb = seeded_labels(SEED + 83, SLIDE_IMAGES, SLIDE_BASE, SLIDE_BASE)
    batch = dict(pixel_values=xb, label=yb)
    evaluate_sliding(model, [batch], **kw)  # warm-up
    torch.cuda.synchronize()
    counters = launch_counters()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(2):
        if i == 0:
            for f in counters.values():
                f.launches = 0
        t0 = time.perf_counter()
        res = evaluate_sliding(model, [batch], **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            counts = {k: f.launches for k, f in counters.items() if f.launches}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = statistics.median(times)
    print(f"[eval] (c) PromptAuxCrossA sliding bf16, {SLIDE_IMAGES} {SLIDE_BASE}² images a "
          f"sweep (tiles a scale: {2 * SLIDE_IMAGES} of 480², {8 * SLIDE_IMAGES} and "
          f"{8 * SLIDE_IMAGES} of 512²): host clock {[round(t, 2) for t in times]} ms, median "
          f"{ms:.2f} ms = {SLIDE_IMAGES * 1e3 / ms:.2f} img/s; peak {peak:.2f} GiB; launches "
          f"over one sweep {counts} (phase 3's sweep tags {sweep_launches}); "
          f"eval_mIOU_sliding {res['eval_mIOU_sliding']:.6f} on {smi}", flush=True)
    if counts != sweep_launches or not 0.0 <= res["eval_mIOU_sliding"] <= 1.0:
        raise AssertionError(f"the bf16 sweep's launches {counts} != phase 3's {sweep_launches} "
                             f"or its mIoU {res['eval_mIOU_sliding']} out of range")
    del model
    torch.cuda.empty_cache()
    return ms, peak


def check_gt_miou():
    """14d: the GT-resolution mIoU of seeded (4, 151, 128, 128) logits."""
    from lc2is_tpu_torch.metrics.gt import compute_gt_miou, gt_miou_per_image

    logits = rand(np.random.RandomState(SEED + 90), len(GT_SIZES), N_CLASSES, IMG // 4,
                  IMG // 4, device="cpu")
    gts = [seeded_labels(SEED + 91 + i, *s, device="cpu") for i, s in enumerate(GT_SIZES)]
    t0 = time.time()
    cpu = gt_miou_per_image(logits, gts, GT_SIZES, device="cpu")
    cpu_s = time.time() - t0
    gpu = gt_miou_per_image(logits, gts, GT_SIZES, device="cuda")
    exact = compute_gt_miou(logits, gts, GT_SIZES, device="cuda")["mIOU_gt"]
    bucket = compute_gt_miou(logits, gts, GT_SIZES, bucket=64, device="cuda")["mIOU_gt"]
    d = float(np.abs(gpu - cpu).max())
    print(f"[eval] (d) GT mIoU, logits {tuple(logits.shape)} to GT sizes {GT_SIZES}: per image "
          f"card {gpu.tolist()} CPU {cpu.tolist()}, max |Δ| {d:.3e} (bound {GT_MIOU_ATOL}); "
          f"mIOU_gt on the card exact {exact:.8f}, bucket=64 {bucket:.8f}; CPU {cpu_s:.1f} s",
          flush=True)
    if d > GT_MIOU_ATOL or bucket != exact:
        raise AssertionError("GT mIoU: card vs CPU or bucket vs exact disagree")


def check_eval(smi, state, sweep_launches):
    """Phase 14: the evaluation (a-d).  Returns {what: numbers} for the summary."""
    out = {}
    with torch.no_grad():
        for name in EVAL_MODELS:
            st = eval_state(name, state)
            check_eval_step_f32(name, st)
            out[name] = check_eval_bf16(smi, name, st)
        out["sliding"] = check_sliding(smi, state, sweep_launches)
        check_gt_miou()
    return out


# phase 15: the CLI on the card (cli/train.py, cli/evaluate.py over the Engine)
CLI_MODEL = "prompt_aux_cross_a"
CLI_DATA = 16
CLI_STEPS, CLI_RESUMED_STEPS, CLI_SAVE = 4, 6, 2
CLI_PREEMPT_STEPS = 40
CLI_NATIVE_PT_ATOL = 1e-6  # the same weights from a .pth and from its .pt export
CLI_F32_IMAGES = 2
CLI_SLIDE_IMG = 640
CLI_GT_BUCKET = 64
CLI_EVAL_KERNELS = ("swin_window_block", "fused_mlp", "fused_attn_block", "upsample_tokens")
CLI_DEVICE = "cuda"


def cli_args(out_dir, name, img=None, fp16=True, batch=None, data=None, device=None,
             model=CLI_MODEL, logger="csv"):
    """The CLI's argv on the synthetic ADE20K from the seed (by default
    {IMG}², batch TRAIN_BATCH, CLI_DATA images, on CLI_DEVICE)."""
    img, batch = img or IMG, batch or TRAIN_BATCH
    data, device = data or CLI_DATA, device or CLI_DEVICE
    return ["--name", name, "--out_dir", out_dir, "--seed", str(SEED), "--data_name",
            "synthetic", "--data_size", str(data), "--model", model, "--fp16", str(fp16),
            "--batch_size", str(batch), "--img_size", str(img), "--device", device,
            "--logger", logger]


@contextlib.contextmanager
def wrapped(owner, name, wrap):
    """``owner.name`` replaced by ``wrap(original)`` inside the block."""
    original = getattr(owner, name)
    setattr(owner, name, wrap(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def same_state(a, b):
    """Nested dicts / lists of tensors and numbers equal bit for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_state(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_state(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a.cpu(),
                                                                                  b.cpu())
    return a == b


def cli_train(smi, tmp, expected, step_ms):
    """15a: 4 steps through cli/train.py; returns the checkpoint directory."""
    import csv

    from lc2is_tpu_torch.cli import train as train_cli
    from lc2is_tpu_torch.engine.engine import Engine

    counters, per_step, engines = launch_counters(), [], []

    def count_steps(step):
        def counted(self, inputs, labels, *rest):
            before = {k: f.launches for k, f in counters.items()}
            out = step(self, inputs, labels, *rest)
            per_step.append({k: f.launches - before[k] for k, f in counters.items()
                             if f.launches != before[k]})
            return out
        return counted

    def keep(train):
        def kept(self):
            engines.append(self)
            return train(self)
        return kept

    argv = cli_args(tmp, "cli") + ["--max_steps", str(CLI_STEPS), "--exact_steps",
                                   "--save_step", str(CLI_SAVE), "--eval_step", str(CLI_STEPS),
                                   "--log_step", "1"]
    print(f"[cli] (a) python -m lc2is_tpu_torch.cli.train {' '.join(argv)}", flush=True)
    for f in counters.values():
        f.launches = 0
    with wrapped(Engine, "_step", count_steps), wrapped(Engine, "train", keep):
        metrics = train_cli.main(argv)
    total = {k: f.launches for k, f in counters.items() if f.launches}
    eng = engines[0]
    ckdir = os.path.join(eng.out_dir, "checkpoints")
    with open(os.path.join(eng.out_dir, "log.csv")) as f:
        rows = list(csv.DictReader(f))
    losses = [float(r[k]) for r in rows for k in ("train_loss", "train_aux_loss")]
    print(f"[cli] (a) launches per step {per_step} (phase 6b's step: {expected}); over the run "
          f"(4 steps and the step-4 evaluation) {total}", flush=True)
    print(f"[cli] (a) log.csv rows {len(rows)}, losses {[round(v, 5) for v in losses]}, "
          f"checkpoints {sorted(os.listdir(ckdir))}; eval at step 4: "
          f"{ {k: round(v, 6) for k, v in metrics.items() if k.startswith('eval')} }", flush=True)
    if len(per_step) != CLI_STEPS or any(c != expected for c in per_step):
        raise AssertionError(f"CLI step launch counts {per_step} != phase 6b's {expected}")
    if len(rows) != CLI_STEPS or not all(np.isfinite(losses)) or not all(
            np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"CLI training log {rows} / metrics {metrics}")
    if not all(os.path.exists(os.path.join(ckdir, f"step-{n}.pth")) for n in (2, 4)):
        raise AssertionError(f"checkpoints step-2 and step-4 missing: {os.listdir(ckdir)}")
    busy = eng.step_seconds + eng.loader_wait_seconds
    print(f"[cli] (a) train through the CLI ({CLI_MODEL}, bf16, batch {TRAIN_BATCH}, {IMG}²): "
          f"{eng.train_images / eng.step_seconds:.2f} img/s over {eng.train_step_count} steps "
          f"({eng.step_seconds * 1e3 / eng.train_step_count:.2f} ms a step, host clock, the "
          f"first step included), waiting on the loader {eng.loader_wait_seconds * 1e3:.1f} ms "
          f"= {100 * eng.loader_wait_seconds / busy:.2f} % of step + wait; phase 6b's bare step "
          f"{step_ms:.2f} ms = {TRAIN_BATCH * 1e3 / step_ms:.2f} img/s; on {smi}", flush=True)
    return ckdir


def cli_resume(tmp, ckdir):
    """15b: rerun with --resume to step 6, the state checked before the first step."""
    from lc2is_tpu_torch.cli import train as train_cli
    from lc2is_tpu_torch.engine.engine import Engine

    saved = torch.load(os.path.join(ckdir, f"step-{CLI_STEPS}.pth"), map_location="cpu",
                       weights_only=True)
    seen = {}

    def checked(train):
        def run(self):
            seen.update(start=self.train_step_count,
                        model=same_state(self.model.state_dict(), saved["model"]),
                        optimizer=same_state(self.optimizer.state_dict(), saved["optimizer"]))
            out = train(self)
            seen["end"] = self.train_step_count
            return out
        return run

    argv = cli_args(tmp, "cli") + ["--max_steps", str(CLI_RESUMED_STEPS), "--exact_steps",
                                   "--save_step", str(CLI_SAVE), "--eval_step", str(CLI_STEPS),
                                   "--log_step", "1", "--resume"]
    with wrapped(Engine, "train", checked):
        metrics = train_cli.main(argv)
    print(f"[cli] (b) --resume: started at step {seen['start']}, model state equal to "
          f"step-{CLI_STEPS}.pth: {seen['model']}, optimizer state equal: {seen['optimizer']}; "
          f"ended at step {seen['end']}, train_loss {metrics['train_loss']:.5f}", flush=True)
    if seen != dict(start=CLI_STEPS, model=True, optimizer=True, end=CLI_RESUMED_STEPS) \
            or not os.path.exists(os.path.join(ckdir, f"step-{CLI_RESUMED_STEPS}.pth")):
        raise AssertionError(f"resume: {seen}")


def cli_preempt(tmp):
    """15c: SIGUSR1 to a training subprocess after its first logged step."""
    import signal
    import threading

    argv = cli_args(tmp, "preempt", logger="null") + [
        "--max_steps", str(CLI_PREEMPT_STEPS), "--exact_steps", "--log_step", "1",
        "--save_step", "1000", "--eval_step", "1000"]
    lines, sent_at = [], None
    err_path = os.path.join(tmp, "preempt.err")
    root = os.path.dirname(os.path.abspath(__file__))
    with open(err_path, "w") as err:
        proc = subprocess.Popen([sys.executable, "-m", "lc2is_tpu_torch.cli.train", *argv],
                                cwd=root, stdout=subprocess.PIPE, stderr=err, text=True,
                                env=dict(os.environ, PYTHONUNBUFFERED="1"))
        watchdog = threading.Timer(300, proc.kill)
        watchdog.start()
        try:
            for line in proc.stdout:
                lines.append(line.rstrip())
                if sent_at is None and line.startswith("[engine] step 1:"):
                    proc.send_signal(signal.SIGUSR1)
                    sent_at = 1
            rc = proc.wait()
        finally:
            watchdog.cancel()
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    found = [re.search(r"preemption signal: checkpointed at step (\d+)", ln) for ln in lines]
    step = next((int(m.group(1)) for m in found if m), None)
    logged = [ln for ln in lines if ln.startswith("[engine] step ")]
    ck = os.path.join(tmp, "preempt", "checkpoints", f"step-{step}.pth")
    print(f"[cli] (c) SIGUSR1 after the first logged step: exit code {rc}, {len(logged)} steps "
          f"logged, checkpointed at step {step} of {CLI_PREEMPT_STEPS}, {ck} exists: "
          f"{os.path.exists(ck)}", flush=True)
    if rc != 0 or sent_at is None or step is None or not 1 <= step < CLI_PREEMPT_STEPS \
            or not os.path.exists(ck) or len(logged) != step:
        with open(err_path) as f:
            print(f.read()[-4000:], file=sys.stderr)
        raise AssertionError(f"preemption: rc {rc}, step {step}, output {lines[-5:]}")


def cli_evaluate(smi, tmp, ckdir):
    """15d: the native checkpoint and its .pt export at bf16 batch 16, then
    f32 on two images, --device cuda against --device cpu."""
    from lc2is_tpu_torch.cli import evaluate as evaluate_cli
    from lc2is_tpu_torch.engine.checkpoint import export_reference_pt
    from lc2is_tpu_torch.engine.engine import Engine

    native = os.path.join(ckdir, f"step-{CLI_STEPS}.pth")
    pt = os.path.join(tmp, f"step-{CLI_STEPS}.pt")
    export_reference_pt(torch.load(native, map_location="cpu", weights_only=True)["model"], pt)
    counters, timed = launch_counters(), []

    def timing(evaluate):
        def run(self):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = evaluate(self)
            torch.cuda.synchronize()
            timed.append(time.perf_counter() - t0)
            return out
        return run

    argv = cli_args(tmp, "eval", batch=BATCH)
    for f in counters.values():
        f.launches = 0
    with wrapped(Engine, "evaluate", timing):
        m_native = evaluate_cli.main(argv + ["--checkpoint", native])
    counts = {k: f.launches for k, f in counters.items() if f.launches}
    m_pt = evaluate_cli.main(argv + ["--checkpoint", pt])
    diff = {k: abs(m_native[k] - m_pt[k]) for k in m_native}
    print(f"[cli] (d) bf16 b{BATCH}: step-{CLI_STEPS}.pth {m_native}; its .pt export {m_pt}; "
          f"|Δ| {diff} (bound {CLI_NATIVE_PT_ATOL}); launches {counts}", flush=True)
    print(f"[cli] (d) evaluate through the CLI ({CLI_MODEL}, bf16, batch {BATCH}, {IMG}², the "
          f"per-image mIoU at {4 * IMG}²): {CLI_DATA} images in {timed[0] * 1e3:.1f} ms = "
          f"{CLI_DATA / timed[0]:.2f} img/s (host clock around Engine.evaluate, the loader "
          f"included) on {smi}", flush=True)
    if set(m_native) != set(m_pt) or max(diff.values()) > CLI_NATIVE_PT_ATOL \
            or not all(counts.get(k) for k in CLI_EVAL_KERNELS):
        raise AssertionError(f"evaluate: native {m_native} / .pt {m_pt} / launches {counts}")
    f32 = {dev: evaluate_cli.main(cli_args(tmp, f"eval-{dev}", fp16=False, batch=CLI_F32_IMAGES,
                                           data=CLI_F32_IMAGES, device=dev)
                                  + ["--checkpoint", native])
           for dev in (CLI_DEVICE, "cpu")}
    card, cpu = f32[CLI_DEVICE], f32["cpu"]
    print(f"[cli] (d) f32, {CLI_F32_IMAGES} images: --device cuda {card}; --device cpu {cpu}",
          flush=True)
    for k, v in cpu.items():
        bad = (abs(card[k] - v) > EVAL_LOSS_RTOL * abs(v) if "loss" in k
               else abs(card[k] - v) > EVAL_MIOU_ATOL)
        if bad or not np.isfinite(card[k]):
            raise AssertionError(f"f32 evaluate: {k} card {card[k]} CPU {v}")
    return native


def cli_paths(tmp, native):
    """15e: --sliding, --gt_metrics, and parity_eval.sh's flags for base_with_text."""
    from lc2is_tpu_torch.cli import evaluate as evaluate_cli
    from lc2is_tpu_torch.engine.checkpoint import export_reference_pt
    from lc2is_tpu_torch.models import zoo
    from lc2is_tpu_torch.nn.init import init_parameters_

    slide = evaluate_cli.main(cli_args(tmp, "slide", img=CLI_SLIDE_IMG, batch=SLIDE_IMAGES,
                                       data=SLIDE_IMAGES) + ["--checkpoint", native, "--sliding"])
    gt = evaluate_cli.main(cli_args(tmp, "gt", batch=SLIDE_IMAGES, data=SLIDE_IMAGES)
                           + ["--checkpoint", native, "--gt_metrics", "--gt_bucket",
                              str(CLI_GT_BUCKET)])
    print(f"[cli] (e) --sliding at {CLI_SLIDE_IMG}² ({SLIDE_IMAGES} images, bf16): {slide}; "
          f"--gt_metrics --gt_bucket {CLI_GT_BUCKET}: {gt}", flush=True)
    if not (np.isfinite(slide["eval_mIOU_sliding"]) and np.isfinite(gt["eval_mIOU_gt"])):
        raise AssertionError("sliding / GT mIoU not finite")

    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "scripts", "parity_eval.sh")) as f:
        sh = f.read()
    flags = list(dict.fromkeys(re.findall(r"(--[a-z0-9_]+)",
                                          sh[sh.index("python -m lc2is_tpu.cli.evaluate"):])))
    ckpt = os.path.join(tmp, "step-400.pt")
    model = zoo.BaseModelWithText(in_size=IMG, out_size=IMG // 4, device=CLI_DEVICE)
    init_parameters_(model, torch.Generator(device=CLI_DEVICE).manual_seed(SEED))
    export_reference_pt(model, ckpt)
    del model
    # the script's values; the synthetic dataset (16 images) in place of ADE20K
    values = {"--name": "parity-eval", "--checkpoint": ckpt, "--seed": "1024",
              "--data_name": "synthetic", "--data_size": str(CLI_DATA),
              "--model": "base_with_text", "--patch_size": "16", "--img_size": str(IMG),
              "--label_size": str(IMG // 4), "--batch_size": str(BATCH), "--dropout": "0",
              "--fp16": "False", "--gt_bucket": "128", "--logger": "csv"}
    argv = []
    for flag in flags:
        if flag in ("--data_root", "--split"):
            continue
        argv += [flag] + ([] if flag == "--gt_metrics" else [values[flag]])
    argv += ["--out_dir", tmp, "--device", CLI_DEVICE]
    print(f"[cli] (e) scripts/parity_eval.sh through lc2is_tpu_torch.cli.evaluate: "
          f"{' '.join(argv)}", flush=True)
    parity = evaluate_cli.main(argv)
    print(f"[cli] (e) base_with_text (f32, batch {BATCH}): {parity}", flush=True)
    if not all(np.isfinite(parity[k]) for k in ("eval_mIOU_label", "eval_mIOU_gt",
                                               "eval_mIOU_dataset")):
        raise AssertionError(f"parity_eval.sh path: {parity}")


def check_cli(smi, train_counts, step_ms):
    """Phase 15: the port's CLI on the card, in a temporary directory."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="lc2is_cli_")
    try:
        t0 = time.time()
        ckdir = cli_train(smi, tmp, train_counts, step_ms)
        t1 = time.time()
        cli_resume(tmp, ckdir)
        gc.collect()
        torch.cuda.empty_cache()  # the card's memory for the subprocess of (c)
        t2 = time.time()
        cli_preempt(tmp)
        t3 = time.time()
        native = cli_evaluate(smi, tmp, ckdir)
        t4 = time.time()
        cli_paths(tmp, native)
        print(f"[cli] seconds: (a) {t1 - t0:.1f}, (b) {t2 - t1:.1f}, (c) {t3 - t2:.1f}, "
              f"(d) {t4 - t3:.1f}, (e) {time.time() - t4:.1f}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()


# phase 16: the data axis (lc2is_tpu_torch/core/mesh.py) on the card: (a) the
# bf16 flagship step through the mesh path over NCCL on min(device count, 4)
# GPUs (on one, the mesh builds no group and the step must be the plain one
# bit for bit); (b) two ranks on cuda:0 over gloo (NCCL refuses two ranks on
# one GPU): f32 steps, evaluate and dp_sliding_miou against one process;
# (c) cli.train --dp -1 and --resume where two GPUs are visible
DP_MAX_GPUS = 4
DP_STEPS, DP_TIMED_STEPS = 3, 6
DP_F32_BATCH, DP_F32_STEPS = 2, 2
DP_EVAL_IMAGES, DP_SLIDE_IMAGES = 4, 2
DP_TIMEOUT = 600.0
DP_GLOO_DEVICES = ("cuda:0", "cuda:0")
DP_CLI_STEPS, DP_CLI_RESUMED_STEPS = 4, 6


def flat_params(model):
    return torch.cat([p.detach().reshape(-1).float() for p in model.parameters()])


def ranks_equal(mesh, model):
    """Every rank's parameters equal rank 0's bit for bit (gathered)."""
    from lc2is_tpu_torch.core.mesh import all_gather_rows

    parts = all_gather_rows(mesh, flat_params(model).view(torch.int32)[None]).unbind()
    return all(torch.equal(parts[0], p) for p in parts[1:])


def bf16_stepper(mesh, state, device):
    """(model, optimizer, step) of phases 16a and 17: 6b's bf16 flagship at
    the global batch TRAIN_BATCH (drop path 0.1, the generator seeded SEED)
    on ``device``, each step through ``train_step`` on this rank's rows of
    ``mesh``, the optimizer holding this rank's shards on a model axis
    (``mesh`` None: one process)."""
    from lc2is_tpu_torch.core.mesh import batch_rows, take_rows
    from lc2is_tpu_torch.engine.engine import train_step
    from lc2is_tpu_torch.engine.optim import make_optimizer

    model = model_from(state, return_score_map=True, dtype=torch.bfloat16, device=device)
    opt = make_optimizer(model, lr=TRAIN_LR, frozen_prefixes=frozen_prefixes("PromptAuxCrossA"),
                         mesh=mesh)
    x = rand(np.random.RandomState(SEED + 30), TRAIN_BATCH, 3, IMG, IMG, dtype=torch.bfloat16,
             device=device)
    y = seeded_labels(SEED + 31, TRAIN_BATCH, IMG, IMG, device=device)
    rows = None if mesh is None else batch_rows(mesh, TRAIN_BATCH)
    if rows is not None:
        x, y = take_rows((x, y), rows)
    gen = torch.Generator(device=device).manual_seed(SEED)

    def step():
        return train_step(model, opt, {"pixel_values": x}, y, generator=gen, mesh=mesh, rows=rows)
    return model, opt, step


def recorded_steps(step, n):
    """(losses, launch counts) of each of ``n`` steps."""
    counters, losses, counts = launch_counters(), [], []
    for _ in range(n):
        for f in counters.values():
            f.launches = 0
        out = step()
        counts.append({k: f.launches for k, f in counters.items() if f.launches})
        losses.append({k: v.item() for k, v in out.items()})
    return losses, counts


def timed_step(step):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def dp_nccl_rank(mesh, state):
    """16a on one rank of a mesh of several GPUs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    model, _, step = bf16_stepper(mesh, state, mesh.device)
    losses, counts = recorded_steps(step, DP_STEPS)
    equal = ranks_equal(mesh, model)
    times = [timed_step(step) for _ in range(DP_TIMED_STEPS)]
    return dict(losses=losses, counts=counts, times=times, equal=equal)


def param_gap(a, b):
    """(max |Δ| of two models' parameters, the elements that differ)."""
    worst, n = 0.0, 0
    for p, q in zip(a.parameters(), b.parameters()):
        d = (p.detach() - q.detach()).abs()
        worst, n = max(worst, d.max().item()), n + int((d != 0).sum())
    return worst, n


def check_dp_nccl(smi, state, expected):
    """16a.  Returns the world size and both median step times."""
    from lc2is_tpu_torch.core.mesh import make_mesh, spawn

    n = min(torch.cuda.device_count(), DP_MAX_GPUS)
    devices = [torch.device("cuda", i) for i in range(n)]
    if n == 1:  # one process: the mesh path and the plain one (twice), in turns
        m_model, _, m_step = bf16_stepper(make_mesh(devices=devices), state, devices[0])
        p_model, _, p_step = bf16_stepper(None, state, devices[0])
        q_model, _, q_step = bf16_stepper(None, state, devices[0])
        losses, counts = recorded_steps(m_step, 1)
        p_losses, _ = recorded_steps(p_step, 1)
        grad_rel = max(((a.grad - b.grad).norm() / b.grad.norm().clamp_min(1e-30)).item()
                       for a, b in zip(m_model.parameters(), p_model.parameters())
                       if b.grad is not None)
        first = losses[0] == p_losses[0]
        more, more_counts = recorded_steps(m_step, DP_STEPS - 1)
        losses, counts = losses + more, counts + more_counts
        p_losses += recorded_steps(p_step, DP_STEPS - 1)[0]
        q_losses, _ = recorded_steps(q_step, DP_STEPS)
        mesh_gap, plain_gap = param_gap(m_model, p_model), param_gap(q_model, p_model)
        m_times, p_times = [], []
        for _ in range(DP_TIMED_STEPS):
            m_times.append(timed_step(m_step))
            p_times.append(timed_step(p_step))
        del m_model, p_model, q_model, m_step, p_step, q_step
        rel = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(losses, p_losses) for k in b)
        print(f"[dp] (a) one GPU: the mesh builds no group and train_step runs the plain step. "
              f"Step 1's losses equal bit for bit: {first}, its gradients worst norm-relative "
              f"{grad_rel:.3e} (bound {STEP_GRAD_REL}); over {DP_STEPS} steps the losses "
              f"relative |Δ| {rel:.3e} (bound {STEP_LOSS_RTOL}; bit for bit: "
              f"{losses == p_losses}); parameters max |Δ| {mesh_gap[0]:.3e} at {mesh_gap[1]} "
              f"elements, where two plain runs part by {plain_gap[0]:.3e} at {plain_gap[1]} "
              f"elements (losses bit for bit: {q_losses == p_losses}): the backwards of rows "
              f"3 and 7 add with f32 atomics, so the card's step is not bitwise repeatable",
              flush=True)
        equal = first and grad_rel <= STEP_GRAD_REL and rel <= STEP_LOSS_RTOL
        what = "step 1 bit for bit in its losses and by 6a's rules after it"
    else:
        ranks = spawn(dp_nccl_rank, (state,), data=n, devices=devices, timeout=DP_TIMEOUT)
        losses, counts, m_times = ranks[0]["losses"], ranks[0]["counts"], ranks[0]["times"]
        equal = all(r["equal"] for r in ranks)
        p_model, _, p_step = bf16_stepper(None, state, devices[0])
        p_losses, _ = recorded_steps(p_step, DP_STEPS)
        p_times = [timed_step(p_step) for _ in range(DP_TIMED_STEPS)]
        del p_model, p_step
        what = "the ranks' parameters equal bit for bit"
    gc.collect()
    torch.cuda.empty_cache()
    m_ms, p_ms = statistics.median(m_times), statistics.median(p_times)
    print(f"[dp] (a) NCCL world {n}: PromptAuxCrossA bf16, global batch {TRAIN_BATCH} "
          f"({TRAIN_BATCH // n if TRAIN_BATCH % n == 0 else TRAIN_BATCH} a rank), {IMG}², drop "
          f"path 0.1: losses per step through the mesh {losses}, plain {p_losses}; {what}: "
          f"{equal}; launches per step {counts} (phase 6b's {expected})", flush=True)
    print(f"[dp] (a) step, host clock to synchronize, median of {DP_TIMED_STEPS}: mesh path "
          f"{[round(t, 2) for t in m_times]} ms, median {m_ms:.2f} ms = "
          f"{TRAIN_BATCH * 1e3 / m_ms:.2f} img/s; plain {[round(t, 2) for t in p_times]} ms, "
          f"median {p_ms:.2f} ms on {smi}", flush=True)
    if not equal or any(c != expected for c in counts) or not all(
            np.isfinite(v) for d in losses for v in d.values()):
        raise AssertionError(f"16a: world {n} mesh steps: equal {equal}, counts {counts}")
    return n, m_ms, p_ms


def dp_eval_maps(outputs, labels):
    """The kept outputs' argmax and top-2 gap over max |logit| (16b's
    ``compute_metrics``; on the card where there is one)."""
    o = torch.from_numpy(outputs).to("cuda" if torch.cuda.is_available() else "cpu")
    top2 = o.topk(2, dim=1).values
    return dict(pred=o.argmax(1).cpu().numpy(),
                gap=((top2[:, 0] - top2[:, 1]) / o.abs().max()).cpu().numpy())


def grad_errors(model, ref, frozen):
    """(worst norm-relative gradient error, its parameter, max |Δ| of the
    parameters where |g| >= max(1e-3 max |g|, 1e-6)), 6a's way: a swin key
    bias's gradient (zero in exact arithmetic) against its block's query
    bias's norm, its update not compared."""
    worst, worst_name, worst_param = 0.0, "", 0.0
    rp = dict(ref.named_parameters())
    for name, p in model.named_parameters():
        q = rp[name]
        if is_frozen(name, frozen) or q.grad is None:
            continue
        zero = name.endswith("attention.self.key.bias")
        norm = (rp[name.replace("key.bias", "query.bias")] if zero else q).grad.norm()
        rel = ((p.grad - q.grad).norm() / norm.clamp_min(1e-30)).item()
        if rel > worst:
            worst, worst_name = rel, name
        if not zero:
            sure = q.grad.abs() >= torch.clamp(1e-3 * q.grad.abs().max(), min=1e-6)
            d = (p.detach() - q.detach())[sure].abs()
            worst_param = max(worst_param, d.max().item() if d.numel() else 0.0)
    return worst, worst_name, worst_param


def dp_gloo_rank(mesh, state):
    """16b on one of two ranks on cuda:0.  Rank 0 also runs each piece in
    one process and returns the comparison; its one-process model starts
    each training step from rank 0's state, as phase 6a compares one step
    (in a second step from states a step's f32 noise apart, a relu unit of
    the decoder switched: 2.0e-3 on its linear1.bias)."""
    from lc2is_tpu_torch.core.mesh import batch_rows, take_rows
    from lc2is_tpu_torch.engine.engine import evaluate, train_step
    from lc2is_tpu_torch.engine.sliding import dp_sliding_miou, evaluate_sliding

    torch.backends.cuda.matmul.allow_tf32 = False
    main, out, t0, dev = mesh.is_main, {}, time.time(), mesh.device
    frozen = frozen_prefixes("PromptAuxCrossA")
    x = rand(np.random.RandomState(SEED + 160), DP_F32_BATCH, 3, IMG, IMG, device=dev)
    y = seeded_labels(SEED + 161, DP_F32_BATCH, IMG, IMG, device=dev)
    rows = batch_rows(mesh, DP_F32_BATCH)
    xr, yr = take_rows((x, y), rows)
    model, opt = train_models(state, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    if main:
        ref, ref_opt = train_models(state, device=dev)
        ref_gen = torch.Generator(device=dev).manual_seed(SEED)
    steps = []
    for _ in range(DP_F32_STEPS):
        if main:  # each step from the same state (one step's noise moves relu units later)
            ref.load_state_dict(model.state_dict())
            ref_opt.load_state_dict(copy.deepcopy(opt.state_dict()))  # no shared moments
        got = train_step(model, opt, {"pixel_values": xr}, yr, generator=gen, mesh=mesh,
                         rows=rows)
        if main:
            want = train_step(ref, ref_opt, {"pixel_values": x}, y, generator=ref_gen)
            losses = {k: (got[k].item(), want[k].item()) for k in want}
            steps.append((losses, *grad_errors(model, ref, frozen)))
    out["steps"], out["equal"] = steps, ranks_equal(mesh, model)
    out["train_s"] = time.time() - t0
    del opt, gen, got
    if main:
        del ref_opt, ref_gen, want
    # evaluation: both from the seeded state again, the served head
    t0 = time.time()
    pairs = [model] + ([ref] if main else [])
    for m in pairs:
        m.load_state_dict(state)
        m.return_score_map = False
        m.zero_grad(set_to_none=True)
    gc.collect()
    torch.cuda.empty_cache()
    xe = rand(np.random.RandomState(SEED + 170), DP_EVAL_IMAGES, 3, IMG, IMG, device=dev)
    ye = seeded_labels(SEED + 171, DP_EVAL_IMAGES, IMG, IMG, device=dev)
    kw = dict(keep_eval_outputs=True, compute_metrics=dp_eval_maps)
    got = evaluate(model, [dict(pixel_values=xe, label=ye)], mesh=mesh, **kw)
    if main:
        out["eval"] = (got, evaluate(ref, [dict(pixel_values=xe, label=ye)], **kw))
    out["eval_s"] = time.time() - t0
    # the sliding evaluation of DP_SLIDE_IMAGES images, one a rank
    t0 = time.time()
    xs = rand(np.random.RandomState(SEED + 180), DP_SLIDE_IMAGES, 3, SLIDE_BASE, SLIDE_BASE,
              device=dev)
    ys = seeded_labels(SEED + 181, DP_SLIDE_IMAGES, SLIDE_BASE, SLIDE_BASE, device=dev)
    slide = dict(scales=SLIDE_SCALES, crop=SLIDE_CROP, stride=SLIDE_STRIDE)
    model.eval()
    with torch.no_grad():
        ts = model.embed_text()
        got = dp_sliding_miou(lambda t: model({"pixel_values": t, "text_static": ts})["outputs"],
                              xs, ys, mesh, num_classes=N_CLASSES, **slide).item()
    if main:
        want = evaluate_sliding(ref, [dict(pixel_values=xs, label=ys)], **slide)
        out["sliding"] = (got, want["eval_mIOU_sliding"])
    out["sliding_s"] = time.time() - t0
    return out if main else None


def check_dp_gloo(smi, state):
    """16b: two ranks on cuda:0 over gloo against one process."""
    from lc2is_tpu_torch.core.mesh import spawn

    t0 = time.time()
    out = spawn(dp_gloo_rank, (state,), data=2, devices=DP_GLOO_DEVICES, backend="gloo",
                timeout=DP_TIMEOUT)[0]
    bad = []
    for i, (losses, worst, worst_name, worst_param) in enumerate(out["steps"]):
        rel = {k: abs(g - w) / abs(w) for k, (g, w) in losses.items()}
        print(f"[dp] (b) gloo, two ranks on cuda:0, PromptAuxCrossA f32 global batch "
              f"{DP_F32_BATCH} (1 a rank) {IMG}², drop path 0.1, step {i + 1}: losses (two "
              f"ranks, one process) {losses}, relative |Δ| {rel} (bound {STEP_LOSS_RTOL}); "
              f"gradients after the reduction: worst norm-relative {worst:.3e} ({worst_name}; "
              f"bound {STEP_GRAD_REL}); parameters after AdamW max |Δ| {worst_param:.3e} "
              f"(bound {STEP_PARAM_ATOL:.1e})", flush=True)
        if max(rel.values()) > STEP_LOSS_RTOL or worst > STEP_GRAD_REL \
                or worst_param > STEP_PARAM_ATOL:
            bad.append(f"step {i + 1}")
    print(f"[dp] (b) the two ranks' parameters equal bit for bit: {out['equal']}", flush=True)
    if not out["equal"]:
        bad.append("ranks' parameters")
    got, want = out["eval"]
    differ = got["eval_pred"] != want["eval_pred"]
    gap = float(want["eval_gap"][differ].max()) if differ.any() else 0.0
    d = {k: abs(got[k] - want[k]) for k in ("eval_mIOU_label", "eval_mIOU_dataset")}
    rel = {k: abs(got[k] - want[k]) / abs(want[k]) for k in want if k.endswith("loss")}
    print(f"[dp] (b) evaluate of {DP_EVAL_IMAGES} {IMG}² images (2 a rank), f32: losses "
          f"relative |Δ| {rel} (bound {EVAL_LOSS_RTOL}); argmax differs at {int(differ.sum())} "
          f"of {differ.size} pixels (largest top-2 gap there {gap:.3e} x max |logit|, bound "
          f"{EVAL_NEAR_TIE_REL}); mIoU label {got['eval_mIOU_label']:.6f} vs "
          f"{want['eval_mIOU_label']:.6f}, dataset {got['eval_mIOU_dataset']:.6f} vs "
          f"{want['eval_mIOU_dataset']:.6f} (|Δ| bound {EVAL_MIOU_ATOL}; the dataset counts "
          f"equal where no pixel differs)", flush=True)
    if max(rel.values()) > EVAL_LOSS_RTOL or gap > EVAL_NEAR_TIE_REL \
            or max(d.values()) > EVAL_MIOU_ATOL \
            or (not differ.any() and d["eval_mIOU_dataset"] != 0.0):
        bad.append("evaluate")
    g_s, w_s = out["sliding"]
    print(f"[dp] (b) dp_sliding_miou of {DP_SLIDE_IMAGES} {SLIDE_BASE}² images (one a rank), "
          f"f32: {g_s:.6f}; evaluate_sliding in one process {w_s:.6f}; |Δ| {abs(g_s - w_s):.3e} "
          f"(bound {EVAL_MIOU_ATOL})", flush=True)
    if abs(g_s - w_s) > EVAL_MIOU_ATOL:
        bad.append("dp_sliding_miou")
    print(f"[dp] (b) seconds: {time.time() - t0:.1f} in all; on rank 0 training "
          f"{out['train_s']:.1f}, evaluate {out['eval_s']:.1f}, sliding {out['sliding_s']:.1f}",
          flush=True)
    if bad:
        raise AssertionError(f"16b: two ranks against one process: {bad}")


def dp_resumed_rank(mesh, argv, checkpoint):
    """16c on one rank: ``cli/train.py``'s rank function on ``argv`` (with
    ``--resume``), the Engine's state checked against ``checkpoint`` as
    training starts."""
    from lc2is_tpu_torch.cli import train as train_cli
    from lc2is_tpu_torch.cli.common import parse_args
    from lc2is_tpu_torch.engine.engine import Engine

    saved = torch.load(checkpoint, map_location="cpu", weights_only=True)
    seen, run = {}, Engine.train

    def checked(self):
        seen.update(start=self.train_step_count,
                    model=same_state(self.model.state_dict(), saved["model"]),
                    optimizer=same_state(self.optimizer.state_dict(), saved["optimizer"]))
        result = run(self)
        seen["end"] = self.train_step_count
        return result

    Engine.train = checked  # this rank's own process
    try:
        train_cli.train(mesh, parse_args(argv))
    finally:
        Engine.train = run
    return seen


def check_dp_cli(smi, tp=1):
    """16c (17c with ``tp`` 2): cli.train --dp -1 --tp ``tp`` on every
    visible GPU (two at least, a multiple of ``tp``), then --resume; the
    state bit for bit on every rank as the resumed run starts."""
    import shutil
    import tempfile

    from lc2is_tpu_torch.cli import train as train_cli
    from lc2is_tpu_torch.core.mesh import spawn

    n = torch.cuda.device_count()
    tag, phase = ("[dp] (c)", "16c") if tp == 1 else ("[tp] (c)", "17c")
    if n < 2 or n % tp:
        print(f"{tag} cli.train --dp -1 --tp {tp} and --resume across GPUs: needs two GPUs (a "
              f"multiple of {tp}), this host has {n}: not run", flush=True)
        return
    tmp = tempfile.mkdtemp(prefix="lc2is_dp_")
    try:
        base = cli_args(tmp, "dp") + ["--dp", "-1", "--tp", str(tp), "--exact_steps",
                                      "--save_step", "2", "--eval_step", str(DP_CLI_STEPS),
                                      "--log_step", "1"]
        t0 = time.time()
        metrics = train_cli.main(base + ["--max_steps", str(DP_CLI_STEPS)])
        t1 = time.time()
        ckpt = os.path.join(tmp, "dp", "checkpoints", f"step-{DP_CLI_STEPS}.pth")
        seen = spawn(dp_resumed_rank, (base + ["--max_steps", str(DP_CLI_RESUMED_STEPS),
                                               "--resume"], ckpt),
                     model=tp, devices=[torch.device("cuda", i) for i in range(n)],
                     timeout=DP_TIMEOUT)
        print(f"{tag} cli.train --dp -1 --tp {tp} on {n} GPUs, global batch {TRAIN_BATCH}: "
              f"{DP_CLI_STEPS} steps in {t1 - t0:.1f} s, metrics "
              f"{ {k: round(v, 5) for k, v in metrics.items() if isinstance(v, float)} }; "
              f"--resume to step {DP_CLI_RESUMED_STEPS} in {time.time() - t1:.1f} s: per rank "
              f"{seen} on {smi}", flush=True)
        want = dict(start=DP_CLI_STEPS, model=True, optimizer=True, end=DP_CLI_RESUMED_STEPS)
        if any(s != want for s in seen) or not all(np.isfinite(
                [v for v in metrics.values() if isinstance(v, float)])):
            raise AssertionError(f"{phase}: resumed state {seen} / metrics {metrics}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check_data_parallel(smi, state, train_counts):
    """Phase 16 (a-c).  Returns (world size of (a), its mesh and plain median
    step ms)."""
    t0 = time.time()
    a = check_dp_nccl(smi, state, train_counts)
    t1 = time.time()
    check_dp_gloo(smi, state)
    t2 = time.time()
    check_dp_cli(smi)
    print(f"[dp] seconds: (a) {t1 - t0:.1f}, (b) {t2 - t1:.1f}, (c) {time.time() - t2:.1f}",
          flush=True)
    return a


# phase 17: the model axis (lc2is_tpu_torch/parallel/sharding.py, the sharded
# AdamW state of engine/optim.py) on the card: (a) two gloo ranks on cuda:0 as
# the mesh (data 1, model 2): 6b's bf16 flagship step against one process,
# and each sharded AdamW step against the same step replayed whole;
# (b) NCCL (2, 2) on four GPUs against one card's step; (c) cli.train
# --dp -1 --tp 2 and --resume where two GPUs are visible
TP = 2
TP_STEPS, TP_TIMED_STEPS = 3, 4
TP_GLOO_DEVICES = ("cuda:0", "cuda:0")
TP_NCCL_GPUS = 4
# ‖mesh − one process‖ / ‖one process − start‖ over the trainable weights,
# at every step: a bf16 weight whose update lies at a rounding midpoint
# moves a whole ulp on one side of f32-atomic noise (two plain runs part so),
# while a skipped gather leaves the sharded weights where they started
# (0.86 for the tiny flagship on the CPU)
TP_UPDATE_REL = 0.1


def moment_elements(opt, m):
    """(AdamW moment elements this rank holds, the spec's share of them,
    what one device holds), over the parameters that have moments."""
    state = opt.adamw.state_dict()["state"]
    held = share = whole = 0
    for i, (name, p) in enumerate(zip(opt.names, opt.params)):
        if i in state:
            held += state[i]["exp_avg"].numel() + state[i]["exp_avg_sq"].numel()
            share += 2 * (p.numel() // m if name in opt.specs else p.numel())
            whole += 2 * p.numel()
    return held, share, whole


def replayed_step(model, opt, ref, ref_opt):
    """The mesh's last AdamW step replayed in one process: ``ref`` holds the
    mesh's weights and ``ref_opt`` its whole moments from before the step;
    ``ref_opt`` steps them on the mesh's whole reduced gradients.  Returns
    (max |Δ| of the mesh's weights from the replay, the max |Δ| a skipped
    gather would leave: the sharded weights where they were before the
    step)."""
    rp = dict(ref.named_parameters())
    stale = {n: rp[n].detach().clone() for n in opt.specs}
    for name, p in zip(opt.names, opt.params):
        rp[name].grad = None if p.grad is None else p.grad.clone()
    ref_opt.step()
    gap = max((p.detach() - rp[n].detach()).abs().max().item()
              for n, p in zip(opt.names, opt.params))
    skipped = max((t - rp[n].detach()).abs().max().item() for n, t in stale.items())
    return gap, skipped


def update_gap(model, ref, start):
    """‖model − ref‖ / ‖ref − start‖ over the parameters named in ``start``:
    how far ``model``'s weights lie from ``ref``'s, against how far
    ``ref``'s travelled from ``start``."""
    mp, rp = dict(model.named_parameters()), dict(ref.named_parameters())
    num = sum((mp[n].detach().float() - rp[n].detach().float()).square().sum() for n in start)
    den = sum((rp[n].detach().float() - t.float()).square().sum() for n, t in start.items())
    return (num / den).sqrt().item()


def tp_rank(mesh, state):
    """17a / 17b on one rank: TP_STEPS steps of the flagship on the mesh.
    Rank 0 also runs the one-process step twice (the second run the
    distance of two plain runs), compares step 1's losses, gradients and
    parameters and every step's losses and parameters, and replays each
    of the mesh's AdamW steps in one process on the mesh's gradients
    (:func:`replayed_step`; the moments gathered whole, which every rank
    takes part in).  Returns the losses, launch counts, the ranks'
    parameters equal, the moments, the census, the step times and the peak
    memory."""
    from lc2is_tpu_torch.core.mesh import barrier
    from lc2is_tpu_torch.engine.optim import make_optimizer
    from lc2is_tpu_torch.parallel.sharding import spec_census

    torch.backends.cuda.matmul.allow_tf32 = False
    dev, main = mesh.device, mesh.is_main
    frozen = frozen_prefixes("PromptAuxCrossA")
    torch.cuda.reset_peak_memory_stats(dev)
    model, opt, step = bf16_stepper(mesh, state, dev)
    out = dict(params=[], replay=[])
    if main:  # the one-process steps first, so their gradients stand beside step 1's
        p_model, _, p_step = bf16_stepper(None, state, dev)
        q_model, _, q_step = bf16_stepper(None, state, dev)
        start = {n: p.detach().clone() for n, p in p_model.named_parameters()
                 if p.requires_grad}
        p_losses, _ = recorded_steps(p_step, 1)
        recorded_steps(q_step, 1)
        ref = model_from(state, return_score_map=True, dtype=torch.bfloat16, device=dev)
        ref_opt = make_optimizer(ref, lr=TRAIN_LR, frozen_prefixes=frozen)
    losses, counts = [], []
    for i in range(TP_STEPS):
        whole = opt.state_dict()
        if main:  # a copy: the replicated moments in ``whole`` are the mesh's own
            ref.load_state_dict(model.state_dict())
            ref_opt.load_state_dict(copy.deepcopy(whole))
        del whole
        got, got_counts = recorded_steps(step, 1)
        losses, counts = losses + got, counts + got_counts
        if i and main:
            p_losses += recorded_steps(p_step, 1)[0]
            recorded_steps(q_step, 1)
        if main:
            out["replay"].append(replayed_step(model, opt, ref, ref_opt))
            worst, worst_name, gap = grad_errors(model, p_model, frozen)
            out["params"].append((gap, grad_errors(q_model, p_model, frozen)[2],
                                  update_gap(model, p_model, start),
                                  update_gap(q_model, p_model, start)))
            if i == 0:
                out.update(grad_rel=worst, grad_name=worst_name)
    if main:
        out["p_losses"] = p_losses
        del p_model, p_step, q_model, q_step, ref, ref_opt, start
        gc.collect()
        torch.cuda.empty_cache()
    equal = ranks_equal(mesh, model)
    times = []
    for _ in range(TP_TIMED_STEPS):
        barrier(mesh)
        times.append(timed_step(step))
    census = {k: len(v) for k, v in spec_census(model, mesh).items()}
    out.update(losses=losses, counts=counts, equal=equal, times=times,
               moments=moment_elements(opt, mesh.model), census=census,
               sharded=len(opt.shards), peak=torch.cuda.max_memory_allocated(dev),
               coords=(mesh.rank, mesh.data_index, mesh.model_index, str(dev)))
    return out


def check_tp(smi, ranks, label, expected, step_ms, same_rows):
    """The gates of 17a / 17b on the ranks' results; raises where one
    fails.  Returns rank 0's median step ms.  ``same_rows``: every rank
    runs the whole batch (no data axis), so step 1's losses are the
    one-process step's bit for bit and its gradients within STEP_GRAD_REL.
    Where a data axis splits the batch, the gradients are printed only, as
    16a prints its several-GPU steps: a bf16 step split over data ranks
    parts from one card's in the relative-position-bias gradients with or
    without a model axis (on H100s: 6.830e-03 on both (2, 1) and (2, 2),
    1.352e-02 on (4, 1))."""
    r0 = ranks[0]
    losses, p_losses = r0["losses"], r0["p_losses"]
    first = losses[0] == p_losses[0]
    rel = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(losses, p_losses) for k in b)
    census = r0["census"]
    print(f"[tp] ({label}) census on model {TP}: {census} (column + row sharded "
          f"{census['column'] + census['row']}; trainable sharded {r0['sharded']})", flush=True)
    ms = statistics.median(r0["times"])
    for r in ranks:
        held, share, whole = r["moments"]
        print(f"[tp] ({label}) rank {r['coords']}: AdamW moment elements {held} (the spec's share "
              f"{share}, one device {whole}: {held / whole:.4f}); launches per step "
              f"{r['counts']}; step, host clock, median of {TP_TIMED_STEPS} "
              f"{statistics.median(r['times']):.2f} ms {[round(t, 2) for t in r['times']]}; "
              f"max_memory_allocated {r['peak'] / 2 ** 30:.2f} GiB", flush=True)
    print(f"[tp] ({label}) PromptAuxCrossA bf16, global batch {TRAIN_BATCH}, {IMG}², drop path "
          f"0.1, {TP_STEPS} steps: losses on the mesh {losses}, one process {p_losses}; step 1's "
          f"losses bit for bit: {first}; its gradients worst norm-relative "
          f"{r0['grad_rel']:.3e} ({r0['grad_name']}; "
          f"{f'bound {STEP_GRAD_REL}' if same_rows else 'the data axis splits the batch'}); "
          f"every loss relative |Δ| {rel:.3e} (bound {STEP_LOSS_RTOL}); the ranks' parameters "
          f"bit for bit: "
          f"{all(r['equal'] for r in ranks)}; step median {ms:.2f} ms on the mesh (6b's "
          f"{step_ms:.2f} ms) on {smi}", flush=True)
    for i, ((gap, plain, rel_gap, rel_plain), (replay, skipped)) in enumerate(
            zip(r0["params"], r0["replay"])):
        print(f"[tp] ({label}) after step {i + 1}: parameters max |Δ| where |g| >= max(1e-3 "
              f"max |g|, 1e-6), the mesh against one process {gap:.3e}, two plain runs "
              f"{plain:.3e} (bound {STEP_PARAM_ATOL:.1e} after step 1); ‖Δ‖ over the "
              f"trainable weights against ‖one process − start‖: the mesh {rel_gap:.3e}, "
              f"two plain runs {rel_plain:.3e} (bound {TP_UPDATE_REL}); the mesh's sharded "
              f"AdamW step and gather against that step replayed whole in one process on the "
              f"mesh's gradients and moments: max |Δ| {replay:.3e} (bound 0), a gather skipped "
              f"would leave {skipped:.3e}", flush=True)
    bad = []
    if same_rows and not first:
        bad.append("step 1's losses")
    if same_rows and r0["grad_rel"] > STEP_GRAD_REL or rel > STEP_LOSS_RTOL:
        bad.append("gradients or losses")
    if r0["params"][0][0] > STEP_PARAM_ATOL or any(
            rel_gap > TP_UPDATE_REL for _, _, rel_gap, _ in r0["params"]):
        bad.append("parameters against one process")
    if any(replay != 0 or skipped == 0 for replay, skipped in r0["replay"]):
        bad.append("the replayed AdamW step")
    if not all(r["equal"] for r in ranks):
        bad.append("ranks' parameters")
    if any(r["moments"][0] != r["moments"][1] for r in ranks):
        bad.append("moment shares")
    if any(c != expected for r in ranks for c in r["counts"]):
        bad.append("launches")
    if not all(np.isfinite(v) for d in losses for v in d.values()):
        bad.append("finite losses")
    if bad:
        raise AssertionError(f"17{label}: {bad}")
    return ms


def check_model_axis(smi, state, train_counts, step_ms):
    """Phase 17 (a-c).  Returns 17a's median step ms on the mesh."""
    from lc2is_tpu_torch.core.mesh import spawn

    t0 = time.time()
    ranks = spawn(tp_rank, (state,), data=1, model=TP, devices=TP_GLOO_DEVICES, backend="gloo",
                  timeout=DP_TIMEOUT)
    a_ms = check_tp(smi, ranks, "a", train_counts, step_ms, same_rows=True)
    t1 = time.time()
    n = torch.cuda.device_count()
    if n >= TP_NCCL_GPUS:
        devices = [torch.device("cuda", i) for i in range(TP_NCCL_GPUS)]
        ranks = spawn(tp_rank, (state,), data=TP_NCCL_GPUS // TP, model=TP, devices=devices,
                      timeout=DP_TIMEOUT)
        check_tp(smi, ranks, "b", train_counts, step_ms, same_rows=False)
    else:
        print(f"[tp] (b) NCCL mesh ({TP_NCCL_GPUS // TP}, {TP}) against one card's step: needs "
              f"{TP_NCCL_GPUS} GPUs, this host has {n}: not run", flush=True)
    t2 = time.time()
    check_dp_cli(smi, tp=TP)
    print(f"[tp] seconds: (a) {t1 - t0:.1f}, (b) {t2 - t1:.1f}, (c) {time.time() - t2:.1f}",
          flush=True)
    return a_ms



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

    state = seeded_state()
    stats, sweep_launches = phase("3", check_kernels, smi, state)
    stats.update(phase("3w", check_window_attention, smi))
    stats.update(phase("3b", check_backward_kernels))
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
    f32_step_ms = phase("6c", check_train_f32_step, smi, state)
    counts.update({k: v for k, v in train_counts.items() if k in BACKWARD_KERNELS})
    v1 = phase("7", check_v1, smi)
    counts["flash_attention"] = v1["BaseModelWithText"][0]["flash_attention"]
    v1_train_counts, v1_step_ms, v1_f32_step_ms = phase("8", check_v1_train, smi)
    counts["flash_attention_bwd"] = v1_train_counts["flash_attention_bwd"]
    v4 = phase("10", check_v4, smi)
    _, v4_step_ms = phase("11", check_v4_train, smi)
    ftn, counts["fused_window_block"] = phase("12", check_ftn, smi)
    ftn_train, counts["fused_window_block_bwd"] = phase("13", check_ftn_train, smi)
    evals = phase("14", check_eval, smi, state, sweep_launches)
    phase("15", check_cli, smi, train_counts, step_ms)
    dp_world, dp_ms, dp_plain_ms = phase("16", check_data_parallel, smi, state, train_counts)
    tp_ms = phase("17", check_model_axis, smi, state, train_counts, step_ms)
    print(f"[time] all phases: {time.time() - t0:.1f} s", flush=True)

    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=counts.get(name, 0), max_abs_err=stats[name]["max_abs_err"],
                    ms=stats[name]["ms"], plain_ms=stats[name]["plain_ms"],
                    bound_ms=stats[name]["bound_ms"],
                    bound_by=max(stats[name]["by"], key=stats[name]["by"].get),
                    library_ms=stats[name]["library_ms"])
               for name, (src, rep) in SOURCES.items()]
    ftn_steps = {k: (round(ms, 2), b, round(pk / 2 ** 30, 2))
                 for k, (ms, b, pk) in ftn_train.items()}
    print(f"\n[summary] launches: over one run of the path that uses the kernel: the bf16 "
          f"batch-{BATCH} {IMG}² served-mask forward (phase 4m) for the float forward kernels "
          f"and the head, the int8 forward (phase 5) for the *_q kernels, one bf16 "
          f"batch-{TRAIN_BATCH} training step (phase 6b) for the backwards and the fused CE, "
          f"one bf16 batch-{TRAIN_BATCH} DenseCLIPFTN training step (phase 13b) for "
          f"fused_window_block_bwd (the window-block backwards of swin-base stage 3, TPU row "
          f"10, among swin_window_block_bwd's 22), "
          f"the bf16 batch-{BATCH} BaseModelWithText forward (phase 7) for flash_attention, "
          f"one bf16 batch-{BATCH} BaseModelWithText training step (phase 8b) for "
          f"flash_attention_bwd, the bf16 batch-{BATCH} DenseCLIPFTN forward (phase 12) for "
          f"fused_window_block (the window blocks of the swin stages whose C the JAX package "
          f"sends through fused_window_block, TPU row 9: swin-base stage 3); "
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
          f"{step_ms:.2f} ms; f32 b{F32_STEP_BATCH} training step {f32_step_ms:.2f} ms; v1 "
          f"training step {v1_step_ms:.2f} ms (f32 {v1_f32_step_ms:.2f} ms); v1 bf16 b{BATCH} forwards "
          f"{ {k: round(ms, 2) for k, (_, ms) in v1.items()} } ms; v4 bf16 b{BATCH} mask "
          f"forwards { {k: round(ms, 2) for k, ms in v4.items()} } ms; v4 bf16 b{TRAIN_BATCH} "
          f"training steps { {k: round(ms, 2) for k, ms in v4_step_ms.items()} } ms; FTN bf16 "
          f"b{BATCH} forwards { {k: round(ms, 2) for k, ms in ftn.items()} } ms; FTN bf16 "
          f"training steps (ms, batch, peak GiB) {ftn_steps}; evaluation bf16 b{BATCH} (ms a "
          f"batch, forward ms, metrics ms, peak GiB) "
          f"{ {k: tuple(round(v, 2) for v in evals[k]) for k in EVAL_MODELS} }, sliding sweep of "
          f"{SLIDE_IMAGES} {SLIDE_BASE}² images (ms, peak GiB) "
          f"{tuple(round(v, 2) for v in evals['sliding'])}; data-parallel bf16 "
          f"b{TRAIN_BATCH} step over NCCL on {dp_world} GPU(s) {dp_ms:.2f} ms (plain "
          f"{dp_plain_ms:.2f} ms); model axis ({TP} gloo ranks on one GPU) bf16 b{TRAIN_BATCH} "
          f"step {tp_ms:.2f} ms on {smi}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
