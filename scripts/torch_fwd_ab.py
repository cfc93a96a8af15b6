#!/usr/bin/env python3
"""Time served bf16 forwards of two checkouts of this repository on one
NVIDIA GPU, in turns, by host clock and by device time: the flagship's
batch-16 512² masks forward (phase 4m's model and inputs), and
``PromptFTNv1``'s, ``DenseCLIPFTN``'s and ``BaseFTN``'s batch-16 512²
forwards (phase 12's).  Each run builds the models from that checkout's
``chip_smoke.py`` helpers and reports, per forward, the host-clock median of
10 calls ending in a synchronize (after 2 warm-up calls) and the device's
busy time over one more call (torch.profiler: the union of its kernels'
intervals), which the host's noise does not reach:

    python3 scripts/torch_fwd_ab.py PARENT CHANGE [--pairs 4]

PARENT and CHANGE are checkouts (e.g. ``git archive HEAD | tar -x -C
build/parent``); each run is a process of its own, in the order parent,
change, change, parent, ... (``--pairs`` pairs), each checkout building its
kernels into its own ``build/`` at first use.  Every run prints one line
``FWD {json}``; the script ends with each metric's runs and medians for both.
Fails without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

FORWARDS = ("masks", "v1", "denseclip", "baseftn")


def busy_ms(fn):
    """(device busy ms, first-to-last kernel span ms) of one call of fn."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3, (spans[-1][1] - spans[0][0]) / 1e3


def timed(fn, n=10):
    """(median, all) host-clock ms of n calls of fn, each to a synchronize."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def one(root: Path) -> None:
    """The four forwards of the checkout at ``root``, as a ``FWD`` line."""
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    from lc2is_tpu_torch.core.convert import seeded_init_
    from lc2is_tpu_torch.models import zoo

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"root": str(root),
           "device": cs.sh(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"])}

    def measure(key, fn):
        out[f"{key}_ms"], out[f"{key}_runs"] = timed(fn)
        out[f"{key}_busy"], out[f"{key}_span"] = busy_ms(fn)

    def ftn_model(name, **kw):
        cpu = seeded_init_(getattr(zoo, name)(device="cpu", **kw), cs.SEED).eval()
        model = getattr(zoo, name)(dtype=torch.bfloat16, **kw)
        model.load_state_dict(cpu.state_dict(), strict=True)
        return model.eval()

    with torch.no_grad():
        px = cs.rand(np.random.RandomState(cs.SEED + 60), cs.BATCH, 3, cs.IMG, cs.IMG,
                     dtype=torch.bfloat16)
        state = cs.seeded_state()
        gpu32 = cs.model_from(state).eval()
        text_static = gpu32.embed_text()
        del gpu32
        model = cs.model_from(state, dtype=torch.bfloat16, predict_masks=True).eval()
        measure("masks", lambda: model({"pixel_values": px, "text_static": text_static}))
        del model, state
        model = ftn_model("PromptFTNv1")
        text = cs.v1_text(cs.N_CLASSES, "cuda")
        measure("v1", lambda: model({"pixel_values": px, **text}))
        model = ftn_model("DenseCLIPFTN", class_names=cs.NAMES)
        text_static = model.embed_text()
        measure("denseclip", lambda: model({"pixel_values": px, "text_static": text_static}))
        model = ftn_model("BaseFTN")
        measure("baseftn", lambda: model({"pixel_values": px}))
        del model
        torch.cuda.empty_cache()
    print("FWD " + json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        one(Path(args.parent).resolve())
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_fwd_ab: no CUDA device", file=sys.stderr)
        return 1
    order = []
    for i in range(args.pairs):
        order += [("parent", "change"), ("change", "parent")][i % 2]
    runs = {"parent": [], "change": []}
    for tag in order:
        root = Path(getattr(args, tag)).resolve()
        proc = subprocess.run([sys.executable, __file__, str(root), str(root), "--one"],
                              capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("FWD ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-3000:], proc.stderr[-3000:], file=sys.stderr)
            raise RuntimeError(f"{tag} ({root}) failed with {proc.returncode}")
        print(f"[{tag}] {lines[-1]}", flush=True)
        runs[tag].append(json.loads(lines[-1][len("FWD "):]))
    for m in (f"{f}_{k}" for f in FORWARDS for k in ("ms", "busy")):
        for tag in ("parent", "change"):
            v = [r[m] for r in runs[tag]]
            print(f"{m} {tag}: {[round(x, 2) for x in v]} median {statistics.median(v):.2f} ms",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
