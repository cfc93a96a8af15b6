"""Training driver, counterpart of ``lc2is_tpu/cli/train.py`` (the
reconstruction of the reference's missing ``default.py``, invoked by
``all_args.sh:29-35``)::

    python -m lc2is_tpu_torch.cli.train --name RUN --model prompt_aux_cross_a ...

The JAX CLI's argv; ``--device cpu`` runs on the CPU.  ``--checkpoint``
starts from a native ``.pth`` or a reference ``.pt`` instead of the
torch-default initialisation; ``--resume`` goes on from the run's latest
native checkpoint.  ``--dp`` trains data-parallel, one process a device
(``cli/common.py::run``), the global ``--batch_size`` split over them.
"""

from __future__ import annotations

import numpy as np

from lc2is_tpu_torch.cli.common import build_loaders, build_model, load_weights, parse_args, run
from lc2is_tpu_torch.engine.engine import Engine
from lc2is_tpu_torch.models.zoo import FROZEN_PREFIXES


def main(argv=None):
    return run(parse_args(argv), train)


def train(mesh, args):
    """Train on this rank of ``mesh``; returns the last metrics."""
    np.random.seed(args.seed)

    train_loader, eval_loader, class_names = build_loaders(args, mesh)
    model = build_model(args, class_names, mesh.device)
    engine = Engine(
        name=args.name,
        model=model,
        params=load_weights(args.checkpoint, model) if args.checkpoint else None,
        mesh=mesh,
        fp16=args.fp16,
        train_loader=train_loader,
        eval_loader=eval_loader,
        max_epoch=args.max_epoch,
        max_steps=args.max_steps,
        exact_steps=args.exact_steps,
        eval_step=args.eval_step,
        log_step=args.log_step,
        save_step=args.save_step,
        out_dir=args.out_dir,
        logger=args.logger,
        logger_args=dict(project=args.wandb_project) if args.wandb_project else None,
        lr=args.lr,
        weight_decay=args.weight_decay,
        frozen_prefixes=FROZEN_PREFIXES.get(args.model, ()),
        seed=args.seed,
        watch_grads=args.watch_grads or args.logger == "wandb",
    )
    if args.resume:
        start = engine.resume()
        if engine.main:
            print(f"[train] resumed at step {start}", flush=True)
    metrics, _ = engine.train()
    if engine.main:
        print(metrics)
    return metrics


if __name__ == "__main__":
    main()
