#!/usr/bin/env python3
"""Time the flagship's bf16 served-mask forward, the two bf16 training steps,
the served bf16 forwards of ``PromptFTNv1`` and ``PromptFTNv2``, the
flagship's f32 batch-16 training step and the f32 batch-16
``BaseModelWithText`` forward and training step of two checkouts of this
repository on one NVIDIA GPU, in turns, each through that checkout's own
``chip_smoke.py`` phase functions (4m: the batch-16 512² masks forward, 6b:
the flagship's batch-8 step, 11b: ``BaseCrossA``'s batch-8 step, 12:
``check_ftn_model``, whose (b) half serves three batch-16 512² batches and
profiles one ``PromptFTNv2`` forward; host clock to a synchronize, medians of
3 and 6 runs) but the f32 ones, which both run through the functions of
phases 6c (``check_train_f32_step``), 7f (``check_v1_f32_batch``) and 8d
(``check_v1_train_step`` in f32) of the checkout holding this script on
their own package (an older ``chip_smoke.py`` may lack the phase), so that a
change's end-to-end times stand beside its parent's from the same card:

    python3 scripts/torch_steps_ab.py PARENT CHANGE [--pairs 3] [--log DIR]
        [--metrics step_ms,...]   # a subset of METRICS; all by default

PARENT and CHANGE are checkouts (e.g. ``git archive HEAD | tar -x -C
build/parent``); each is run in a process of its own, in the order parent,
change, change, parent, parent, change, ... (``--pairs`` pairs), and each
builds its kernels into its own ``build/`` at first use.  Every run prints
one line ``STEPS {json}`` (with ``--log``, its whole output, profiles
included, goes to ``DIR/<tag>_<i>.log``); the script ends with each metric's
runs and medians for both.  Fails without a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

METRICS = ("masks_ms", "step_ms", "basecrossa_ms", "PromptFTNv1_ms", "PromptFTNv2_ms",
           "f32_step_ms", "v1_f32_fwd_ms", "v1_f32_step_ms")
FTN_TIMED = ("PromptFTNv1", "PromptFTNv2")


def one(root: Path, metrics) -> None:
    """The times in ``metrics`` of the checkout at ``root``, as a ``STEPS``
    line."""
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    out = {}
    # this script's own chip_smoke.py, for the phases an older one may lack
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    here = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(here)
    if "v1_f32_fwd_ms" in metrics or "v1_f32_step_ms" in metrics:
        from lc2is_tpu_torch.core.convert import seeded_init_
        from lc2is_tpu_torch.models.zoo import BaseModelWithText

        v1 = seeded_init_(BaseModelWithText(in_size=here.IMG, out_size=here.V1_OUT,
                                            device="cpu"), here.SEED).state_dict()
        if "v1_f32_fwd_ms" in metrics:  # phase 7f
            model = BaseModelWithText(in_size=here.IMG, out_size=here.V1_OUT)
            model.load_state_dict(v1, strict=True)
            batches = [here.rand(np.random.RandomState(here.SEED + 50 + i), here.BATCH, 3,
                                 here.IMG, here.IMG) for i in range(4)]
            with torch.no_grad():
                out["v1_f32_fwd_ms"] = here.check_v1_f32_batch(
                    smi, model.eval(), batches, here.v1_text(here.BATCH, "cuda"),
                    here.launch_counters())
            del model, batches
            torch.cuda.empty_cache()
        if "v1_f32_step_ms" in metrics:  # phase 8d
            out["v1_f32_step_ms"] = here.check_v1_train_step(smi, v1, torch.float32)[1]
            torch.cuda.empty_cache()
        del v1
    flagship = ("masks_ms", "step_ms", "f32_step_ms")
    state = cs.seeded_state() if any(m in metrics for m in flagship) else None
    if "masks_ms" in metrics:
        cpu_head, x1, _, ts_gpu, batches = cs.check_slice(smi, state)
        out["masks_ms"] = cs.check_masks(smi, state, cpu_head, x1, ts_gpu, batches)[2]
        del cpu_head, batches
        torch.cuda.empty_cache()
    if "step_ms" in metrics:
        out["step_ms"] = cs.check_train_bf16(smi, state)[1]
    if "f32_step_ms" in metrics:  # phase 6c of this script's chip_smoke.py, on ROOT's package
        out["f32_step_ms"] = here.check_train_f32_step(smi, state)
        torch.cuda.empty_cache()
    del state
    torch.cuda.empty_cache()
    if "basecrossa_ms" in metrics:
        v4 = cs.check_v4_train(smi)[1]  # BaseCrossA's ms, or {model: ms} where phase 11 trains more
        out["basecrossa_ms"] = v4["BaseCrossA"] if isinstance(v4, dict) else v4
        torch.cuda.empty_cache()
    batches = [cs.rand(np.random.RandomState(cs.SEED + 60 + i), cs.BATCH, 3, cs.IMG, cs.IMG,
                       dtype=torch.bfloat16) for i in range(4)]  # phase 12's
    for name in FTN_TIMED:
        if f"{name}_ms" in metrics:
            out[f"{name}_ms"] = cs.check_ftn_model(smi, name, batches)[0]
    print("STEPS " + json.dumps({"root": str(root), **out, "device": smi}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--log", default=None, help="directory for each run's whole output")
    ap.add_argument("--metrics", default=",".join(METRICS),
                    help=f"the times to take, a comma-separated subset of {','.join(METRICS)}")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    metrics = [m for m in METRICS if m in args.metrics.split(",")]
    if args.one:
        one(Path(args.parent).resolve(), metrics)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_steps_ab: no CUDA device", file=sys.stderr)
        return 1
    order = []
    for i in range(args.pairs):
        order += [("parent", "change"), ("change", "parent")][i % 2]
    runs = {"parent": [], "change": []}
    for i, tag in enumerate(order):
        root = Path(getattr(args, tag)).resolve()
        proc = subprocess.run([sys.executable, __file__, str(root), str(root), "--one",
                               "--metrics", ",".join(metrics)],
                              capture_output=True, text=True)
        if args.log:
            Path(args.log).mkdir(parents=True, exist_ok=True)
            (Path(args.log) / f"{tag}_{i}.log").write_text(proc.stdout + proc.stderr)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("STEPS ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-3000:], proc.stderr[-3000:], file=sys.stderr)
            raise RuntimeError(f"{tag} ({root}) failed with {proc.returncode}")
        print(f"[{tag}] {lines[-1]}", flush=True)
        runs[tag].append(json.loads(lines[-1][len("STEPS "):]))
    for m in metrics:
        for tag in ("parent", "change"):
            v = [r[m] for r in runs[tag]]
            print(f"{m} {tag}: {[round(x, 2) for x in v]} median {statistics.median(v):.2f} ms",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
