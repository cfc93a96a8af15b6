"""Training driver, counterpart of ``lc2is_tpu/cli/train.py`` (the
reconstruction of the reference's missing ``default.py``, invoked by
``all_args.sh:29-35``)::

    python -m lc2is_tpu_torch.cli.train --name RUN --model prompt_aux_cross_a ...

The JAX CLI's argv; ``--device cpu`` runs on the CPU.  ``--checkpoint``
starts from a native ``.pth`` or a reference ``.pt`` instead of the
torch-default initialisation; ``--resume`` goes on from the run's latest
native checkpoint.
"""

from __future__ import annotations

import numpy as np

from lc2is_tpu_torch.cli.common import build_loaders, build_model, load_weights, parse_args
from lc2is_tpu_torch.engine.engine import Engine
from lc2is_tpu_torch.models.zoo import FROZEN_PREFIXES


def main(argv=None):
    args = parse_args(argv)
    np.random.seed(args.seed)

    train_loader, eval_loader, class_names = build_loaders(args)
    model = build_model(args, class_names)
    engine = Engine(
        name=args.name,
        model=model,
        params=load_weights(args.checkpoint, model) if args.checkpoint else None,
        device=args.device,
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
        print(f"[train] resumed at step {start}", flush=True)
    metrics, _ = engine.train()
    print(metrics)
    return metrics


if __name__ == "__main__":
    main()
