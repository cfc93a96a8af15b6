"""Shared CLI plumbing, counterpart of ``lc2is_tpu/cli/common.py``: the
reference's argparse surface (``evaluate.py:18-51`` / ``all_args.sh:10-35``),
flag for flag with the JAX CLI's defaults, and the dataset, loader, model and
weight builders.

``--device`` names the device (``cuda``, the card, by default; ``cpu`` runs
on the CPU).  ``--dp`` and ``--tp`` are the data and model axes of the
mesh (``core/mesh.py``), ``--dp`` × ``--tp`` devices: ``--dp`` -1 every
visible GPU over ``--tp`` (which must divide them), n the first n × tp of
them (more than are visible raises); on the CPU, n × tp gloo processes
(``--dp`` -1: one a model rank).  :func:`run` starts one process a device
(one device: this process, no group), or, under ``torchrun``, joins its
group.  ``--batch_size`` is the global batch, split over the data axis by
rows; the model axis holds the sharded weights' shards and AdamW moments
(``parallel/sharding.py``, ``engine/optim.py``).
"""

from __future__ import annotations

import argparse
import hashlib
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from lc2is_tpu_torch.core.mesh import TORCHRUN_ENV, Mesh, make_mesh, spawn, visible_devices
from lc2is_tpu_torch.data.ade20k import ADE20KDataset, SyntheticADE20K
from lc2is_tpu_torch.data.collators import ADE20KCollator, ADE20KTextCollator
from lc2is_tpu_torch.data.loader import DataLoader
from lc2is_tpu_torch.data.transforms import Compose, Resize, _pil_resize
from lc2is_tpu_torch.engine.checkpoint import import_reference_pt, load_checkpoint
from lc2is_tpu_torch.models import zoo

V1_MODELS = ("base_with_text", "contrastive", "dense_clip")
V4_MODELS = ("base_self_a", "base_cross_a", "prompt_self_a", "prompt_cross_a",
             "prompt_aux_self_a", "prompt_aux_cross_a")
# the reference's class-prototype table (model/ade20k_prototypes.pt, the
# trainable (151, 512) CLIP-text-space table loaded at model/model.py:22)
PROTO_SHA256 = "16e4ae8913cc59453e79babcb055c68a07413b4a0b43e3dc718126a12776122f"


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    # Base arguments
    p.add_argument("--name", type=str, required=True, help="Run name")
    p.add_argument("--out_dir", type=str, default="./experience/", help="Outputs directory")
    p.add_argument("--seed", type=int, default=1024, help="Seed for reproducibility")
    # Data arguments
    p.add_argument("--data_name", type=str, default="ade20k",
                   help="Dataset name (ade20k|synthetic)")
    p.add_argument("--data_size", type=int, default=None, help="Dataset size")
    p.add_argument("--data_root", type=str, default=None, help="ADE20K root dir")
    p.add_argument("--split", type=str, default="validation")
    # Model / training arguments
    p.add_argument("--model", type=str, default="base_cross_a", choices=sorted(zoo.ZOO.keys()))
    p.add_argument("--patch_size", type=int, default=16, help="Patch size")
    p.add_argument("--img_size", type=int, default=512, help="Input images size")
    p.add_argument("--label_size", type=int, default=128, help="Input labels size")
    p.add_argument("--batch_size", type=int, default=16, help="Batch size")
    p.add_argument("--lr", type=float, default=1e-5, help="Learning rate (initial)")
    p.add_argument("--dropout", type=float, default=0.0, help="Dropout")
    p.add_argument("--weight_decay", type=float, default=0.0, help="Weight decay")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (the card, default) or cpu")
    p.add_argument("--fp16", type=lambda s: s.lower() in ("1", "true"), default=False,
                   help="Mixed precision (bf16 compute, f32 parameters)")
    p.add_argument("--max_epoch", type=int, default=1, help="Maximum train epoch")
    p.add_argument("--max_steps", type=int, default=None, help="Maximum train steps")
    p.add_argument("--exact_steps", action="store_true",
                   help="run exactly max_steps (skip the reference's "
                        "max(steps_in_epoch*max_epoch, max_steps) quirk)")
    p.add_argument("--log_step", type=int, default=None)
    p.add_argument("--eval_step", type=int, default=None)
    p.add_argument("--save_step", type=int, default=None)
    p.add_argument("--checkpoint", type=str, default=None,
                   help="native .pth or reference .pt weights to load")
    p.add_argument("--resume", action="store_true", help="Resume from latest checkpoint")
    # Logging arguments
    p.add_argument("--logger", type=str, default="csv", choices=["csv", "wandb", "null"])
    p.add_argument("--wandb_project", type=str, default=None, help="Name of WandB project")
    p.add_argument("--watch_grads", action="store_true",
                   help="log the trainable-grad global norm each step "
                        "(wandb.watch equivalent; on with --logger wandb, "
                        "matching engine.py:52)")
    # Mesh: the data axis is one process a device (core/mesh.py)
    p.add_argument("--dp", type=int, default=-1,
                   help="data-parallel axis size (-1: all devices; on the CPU, processes)")
    p.add_argument("--tp", type=int, default=1,
                   help="model-parallel axis size (the sharded weights and their AdamW "
                        "moments split over it)")
    # Sliding-window multi-scale eval (BASELINE config #5)
    p.add_argument("--sliding", action="store_true", help="multi-scale sliding-window eval")
    p.add_argument("--scales", type=str, default="0.75,1.0,1.25")
    p.add_argument("--crop", type=int, default=512)
    p.add_argument("--stride", type=int, default=341)
    # GT-resolution mIoU (metrics.py:61-79; needs raw-logit accumulation)
    p.add_argument("--gt_metrics", action="store_true",
                   help="also compute mIOU_gt at each image's original size")
    p.add_argument("--gt_bucket", type=int, default=None,
                   help="accepted for the JAX CLI's argv; the values do not depend on it")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    """The parsed argv; ``--dp`` below 1 but -1, or ``--tp`` below 1,
    raises."""
    args = build_arg_parser().parse_args(argv)
    if args.tp < 1:
        raise ValueError(f"--tp {args.tp}: the model axis takes a size of at least 1")
    if args.dp < 1 and args.dp != -1:
        raise ValueError(f"--dp {args.dp}: the data axis takes -1 (every device) or a size "
                         "of at least 1")
    return args


def mesh_devices(args) -> list:
    """The devices of ``args``' mesh: ``--dp`` × ``--tp`` of the visible GPUs
    (``--dp`` -1: all; a ``--device`` with an index alone), or that many CPU
    processes (``--dp`` -1: one a model rank)."""
    kind = torch.device(args.device).type
    if kind == "cpu":
        return [torch.device("cpu")] * (max(args.dp, 1) * args.tp)
    zoo._model_device(args.device)  # raises without a card
    if torch.device(args.device).index is not None and args.dp in (-1, 1) and args.tp == 1:
        return [torch.device(args.device)]  # the one device named
    devices = visible_devices()
    if args.dp == -1:
        return devices
    if args.dp * args.tp > len(devices):
        raise ValueError(f"--dp {args.dp} --tp {args.tp}: {len(devices)} visible GPUs")
    return devices[:args.dp * args.tp]


def run(args, fn):
    """``fn(mesh, args)`` on every rank of ``args``' mesh; returns rank 0's
    result.  Under ``torchrun`` this process is one rank of its group; one
    device runs in this process; otherwise :func:`~lc2is_tpu_torch.core.mesh.spawn`
    starts one process a device."""
    if all(k in os.environ for k in TORCHRUN_ENV):
        world = int(os.environ["WORLD_SIZE"])
        devices = ([torch.device("cpu")] * world if torch.device(args.device).type == "cpu"
                   else [torch.device("cuda", i) for i in range(world)])
        return fn(make_mesh(args.dp, args.tp, devices), args)
    return spawn(fn, (args,), data=args.dp, model=args.tp, devices=mesh_devices(args))[0]


def build_dataset(args, split: Optional[str] = None):
    split = split or args.split
    transform = Compose([Resize(args.img_size)])
    if args.data_name == "synthetic":
        return SyntheticADE20K(length=args.data_size or 64, img_size=args.img_size,
                               transform=transform)
    return ADE20KDataset(root=args.data_root, split=split, size=args.data_size,
                         transform=transform)


class LabelResize:
    """Wrap a dataset so labels come out at label_size (nearest)."""

    def __init__(self, ds, label_size: int):
        self.ds = ds
        self.label_size = label_size
        self.class_names = ds.class_names

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        img, label, metas = self.ds[i]
        lab = _pil_resize(label.astype(np.float32), (self.label_size, self.label_size),
                          nearest=True)
        return img, lab.astype(np.int64), metas


def build_loaders(args, mesh: Optional[Mesh] = None) -> Tuple[DataLoader, DataLoader, list]:
    """(train loader, eval loader, class names).  The v1 CLIP models score
    at ``label_size`` (``model.py:53``), the swin families at ``img_size``
    (``final.py:356``), so the labels come at that size; the v1 models take
    each image's class names tokenized (``model.py:29-32``).  Under ``mesh``
    each loader loads this rank's rows of every global batch."""
    label_target = args.label_size if args.model in V1_MODELS else args.img_size
    synthetic = args.data_name == "synthetic"
    train_ds = LabelResize(build_dataset(args, None if synthetic else "training"), label_target)
    eval_ds = LabelResize(build_dataset(args, None if synthetic else "validation"), label_target)
    coll = ADE20KTextCollator() if args.model in V1_MODELS else ADE20KCollator()
    train = DataLoader(train_ds, args.batch_size, coll, shuffle=True, seed=args.seed,
                       drop_last=True, num_workers=4, mesh=mesh)
    ev = DataLoader(eval_ds, args.batch_size, coll, shuffle=False, drop_last=True, num_workers=4,
                    mesh=mesh)
    return train, ev, train_ds.class_names


def load_prototypes() -> Optional[np.ndarray]:
    """The reference's prototype table from ``LC2IS_PROTOTYPES``, checked
    against its recorded sha256 (a mismatch warns and loads it anyway);
    None, with a warning, where the variable names no file."""
    path = os.environ.get("LC2IS_PROTOTYPES")
    if not path or not os.path.exists(path):
        print(f"[lc2is_tpu_torch] WARNING: prototype asset not found at {path} "
              "(set LC2IS_PROTOTYPES) — class_prototypes will be RANDOM-INIT; "
              "reference-checkpoint mask parity is impossible in this mode.")
        return None
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if digest != PROTO_SHA256:
        print(f"[lc2is_tpu_torch] WARNING: prototype asset {path} has sha256 {digest[:12]}…, "
              f"not the recorded reference asset ({PROTO_SHA256[:12]}…) — loading it anyway.")
    table = torch.load(path, map_location="cpu", weights_only=True)
    print(f"[lc2is_tpu_torch] class prototypes: imported reference table from {path}")
    return np.asarray(table, np.float32)


def build_model(args, class_names, device=None):
    """``zoo.ZOO[args.model]`` on ``device`` (by default ``args.device``), bf16
    compute under ``--fp16``, with the JAX CLI's keyword arguments."""
    dtype = torch.bfloat16 if args.fp16 else torch.float32
    kw = dict(dtype=dtype, device=args.device if device is None else device)
    if args.model in V1_MODELS:
        kw.update(in_size=args.img_size, out_size=args.label_size, dropout=args.dropout)
        if args.model == "base_with_text":
            kw["prototypes"] = load_prototypes()
    elif args.model in V4_MODELS:
        kw.update(class_names=tuple(class_names), dropout=args.dropout)
    elif args.model == "denseclip_ftn":
        kw.update(class_names=tuple(class_names))
    return zoo.ZOO[args.model](**kw)


def load_weights(path: str, model) -> Dict[str, torch.Tensor]:
    """``model``'s state_dict from a reference ``.pt`` or a native ``.pth``."""
    if path.endswith(".pt"):
        return import_reference_pt(path, model)
    state, _ = load_checkpoint(path)
    return state["model"]
