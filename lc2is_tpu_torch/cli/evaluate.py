"""Evaluation CLI, counterpart of ``lc2is_tpu/cli/evaluate.py`` (the working
version of the reference's ``evaluate.py``; canonical config
``evaluate.sh:1-23``: img 512, label 128, batch 16, seed 1024)::

    python -m lc2is_tpu_torch.cli.evaluate --name RUN --checkpoint step-400.pt ...

The JAX CLI's argv; ``--device cpu`` runs on the CPU.  ``--checkpoint``
takes a reference ``.pt`` or a native ``.pth``; ``--resume`` without it
evaluates the run's latest native checkpoint.  ``--gt_metrics`` adds the
GT-resolution mIoU (``metrics/gt.py``), ``--sliding`` runs the multi-scale
sliding evaluation (``engine/sliding.py``) in place of the plain one.
``--dp`` evaluates data-parallel, one process a device
(``cli/common.py::run``), each on its rows of every global batch.
"""

from __future__ import annotations

import functools

import numpy as np

from lc2is_tpu_torch.cli.common import build_loaders, build_model, load_weights, parse_args, run
from lc2is_tpu_torch.engine.engine import Engine
from lc2is_tpu_torch.engine.sliding import evaluate_sliding
from lc2is_tpu_torch.metrics.gt import segmentation_metrics


def main(argv=None):
    return run(parse_args(argv), evaluate)


def evaluate(mesh, args):
    """Evaluate on this rank of ``mesh``; returns the metrics (the same on
    every rank)."""
    np.random.seed(args.seed)

    _, eval_loader, class_names = build_loaders(args, mesh)
    model = build_model(args, class_names, mesh.device)
    compute_metrics = None
    if args.gt_metrics:
        compute_metrics = functools.partial(segmentation_metrics, bucket=args.gt_bucket,
                                            device=mesh.device)
    engine = Engine(
        name=args.name,
        model=model,
        params=load_weights(args.checkpoint, model) if args.checkpoint else None,
        mesh=mesh,
        fp16=args.fp16,
        eval_loader=eval_loader,
        out_dir=args.out_dir,
        logger=args.logger,
        seed=args.seed,
        keep_eval_outputs=args.gt_metrics,
        compute_metrics=compute_metrics,
    )
    if args.resume and not args.checkpoint:
        step = engine.resume()
        if engine.main:
            print(f"[evaluate] resumed at step {step}", flush=True)
    if args.sliding:
        metrics = evaluate_sliding(engine.model, eval_loader,
                                   scales=[float(s) for s in args.scales.split(",")],
                                   crop=args.crop, stride=args.stride,
                                   num_classes=engine.num_classes, mesh=engine.mesh)
    else:
        metrics = engine.evaluate()
    if engine.main:
        print(metrics)
    return metrics


if __name__ == "__main__":
    main()
