#!/usr/bin/env python3
"""Time the flagship's bf16 served-mask forward and the two bf16 training
steps of two checkouts of this repository on one NVIDIA GPU, in turns, each
through that checkout's own ``chip_smoke.py`` phase functions (4m: the
batch-16 512² masks forward, 6b: the flagship's batch-8 step, 11b:
``BaseCrossA``'s batch-8 step; host clock to a synchronize, medians of 3 and
6 runs), so that a change's end-to-end times stand beside its parent's from
the same card:

    python3 scripts/torch_steps_ab.py PARENT CHANGE [--pairs 3]

PARENT and CHANGE are checkouts (e.g. ``git archive HEAD | tar -x -C
build/parent``); each is run in a process of its own, in the order parent,
change, change, parent, parent, change, ... (``--pairs`` pairs), and each
builds its kernels into its own ``build/`` at first use.  Every run prints
one line ``STEPS {json}``; the script ends with each metric's runs and
medians for both.  Fails without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

METRICS = ("masks_ms", "step_ms", "basecrossa_ms")


def one(root: Path) -> None:
    """The three times of the checkout at ``root``, as a ``STEPS`` line."""
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    state = cs.seeded_state()
    cpu_head, x1, _, ts_gpu, batches = cs.check_slice(smi, state)
    masks_ms = cs.check_masks(smi, state, cpu_head, x1, ts_gpu, batches)[2]
    del cpu_head, batches
    torch.cuda.empty_cache()
    step_ms = cs.check_train_bf16(smi, state)[1]
    del state
    torch.cuda.empty_cache()
    basecrossa_ms = cs.check_v4_train(smi)[1]
    print("STEPS " + json.dumps({"root": str(root), "masks_ms": masks_ms, "step_ms": step_ms,
                                 "basecrossa_ms": basecrossa_ms, "device": smi}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        one(Path(args.parent).resolve())
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_steps_ab: no CUDA device", file=sys.stderr)
        return 1
    order = []
    for i in range(args.pairs):
        order += [("parent", "change"), ("change", "parent")][i % 2]
    runs = {"parent": [], "change": []}
    for tag in order:
        root = Path(getattr(args, tag)).resolve()
        proc = subprocess.run([sys.executable, __file__, str(root), str(root), "--one"],
                              capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("STEPS ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-3000:], proc.stderr[-3000:], file=sys.stderr)
            raise RuntimeError(f"{tag} ({root}) failed with {proc.returncode}")
        print(f"[{tag}] {lines[-1]}", flush=True)
        runs[tag].append(json.loads(lines[-1][len("STEPS "):]))
    for m in METRICS:
        for tag in ("parent", "change"):
            v = [r[m] for r in runs[tag]]
            print(f"{m} {tag}: {[round(x, 2) for x in v]} median {statistics.median(v):.2f} ms",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
