"""The per-rank functions of ``tests/test_torch_tp.py``, run by
``lc2is_tpu_torch.core.mesh.spawn`` in processes of their own on a mesh with
a model axis.  Like ``tests/torch_dp_workers.py`` (whose runs they reuse),
this module imports neither jax nor the JAX package, and each process runs
one torch thread (``spawn(..., threads=1)``).
"""

import os

import torch
import torch_dp_workers as W

from lc2is_tpu_torch.engine.checkpoint import load_checkpoint
from lc2is_tpu_torch.engine.engine import Engine
from lc2is_tpu_torch.engine.optim import make_optimizer
from lc2is_tpu_torch.parallel.sharding import REPLICATED, gather, infer_param_specs, shard

# tests/test_torch_engine.py's 4-step run with a checkpoint at step 2
RESUMABLE_RUN = dict(W.RUN, save_step=2)


def moment_shapes(engine):
    """{parameter name: (its whole shape, its AdamW moments' shapes on this
    rank)} of the trainable parameters that have moments (a parameter that
    never had a gradient has none)."""
    opt = engine.optimizer
    state = opt.adamw.state_dict()["state"]
    return {name: (tuple(p.shape), tuple(state[i]["exp_avg"].shape),
                   tuple(state[i]["exp_avg_sq"].shape))
            for i, (name, p) in enumerate(zip(opt.names, opt.params)) if i in state}


def engine_run(mesh, state, out_dir):
    """tests/test_torch_engine.py's 4-step run with its step-4 evaluation,
    checkpointing at steps 2 and 4: (logged rows, eval metrics, parameters,
    moment shapes, specs)."""
    tr, ev = W.loaders(mesh)
    eng = Engine(name="engine", model=W.tiny_model(), params=state, device="cpu", mesh=mesh,
                 train_loader=tr, eval_loader=ev, out_dir=out_dir, **RESUMABLE_RUN)
    eng.train()
    rows = W.read_log(os.path.join(eng.out_dir, "log.csv")) if eng.main else None
    return dict(rows=rows, eval=eng.eval_metrics, moments=moment_shapes(eng),
                specs=infer_param_specs(eng.model, mesh),
                params={k: v.clone() for k, v in eng.model.state_dict().items()})


def resumed_run(mesh, checkpoint, out_dir):
    """An Engine of the 4-step run resumed from ``checkpoint`` (written on
    any mesh): (its model and optimizer state equal to the checkpoint bit
    for bit as training starts, the step then, the parameters after step
    4)."""
    saved, _ = load_checkpoint(checkpoint)
    tr, _ = W.loaders(mesh)
    eng = Engine(name="engine", model=W.tiny_model(), device="cpu", mesh=mesh,
                 train_loader=tr, out_dir=out_dir, **RESUMABLE_RUN)
    start = eng.resume(checkpoint)
    same = dict(model=W.same_state(eng.model.state_dict(), saved["model"]),
                optimizer=W.same_state(eng.optimizer.state_dict(), saved["optimizer"]))
    eng.train()
    return dict(start=start, same=same, end=eng.train_step_count,
                params={k: v.clone() for k, v in eng.model.state_dict().items()})


def given_optimizer_run(mesh, state, out_dir):
    """The dropout steps of ``W.dropout_run`` with the optimizer made first,
    over the module's random initialisation, and given to the Engine, which
    then loads ``state`` into the module: the steps must start from
    ``state``, not from the weights the optimizer saw when it was made."""
    tr, _ = W.loaders(mesh, n=7, batch=4, drop_last=False)
    model = W.tiny_model(0.1, 0.2)
    eng = Engine(name="given", model=model, params=state,
                 optimizer=make_optimizer(model, mesh=mesh), device="cpu", mesh=mesh,
                 train_loader=tr, out_dir=out_dir, **W.DROPOUT_RUN)
    eng.train()
    rows = W.read_log(os.path.join(eng.out_dir, "log.csv")) if eng.main else None
    return dict(rows=rows, params={k: v.clone() for k, v in eng.model.state_dict().items()},
                images=eng.train_images)


def round_trip(mesh, whole):
    """Each tensor of ``whole`` cut to this rank's shard under both specs and
    gathered back over the model group: (equal to the whole, shard shapes)."""
    out = {}
    for name, t in whole.items():
        for label, spec in (("column", ("model", None)), ("row", (None, "model")),
                            ("replicated", REPLICATED)):
            part = shard(t, spec, mesh.model_index, mesh.model)
            back = gather(mesh, part, spec)
            out[(name, label)] = (torch.equal(back, t), tuple(part.shape))
    return out


def tp_runs(mesh, engine_state, global_batches, whole, out_dir):
    """Every run of tests/test_torch_tp.py on one mesh with a model axis."""
    return dict(dropout=W.dropout_run(mesh, engine_state, os.path.join(out_dir, "dropout")),
                engine=engine_run(mesh, engine_state, os.path.join(out_dir, "engine")),
                eval=W.eval_run(mesh, engine_state, global_batches),
                round_trip=round_trip(mesh, whole),
                coords=(mesh.rank, mesh.data_index, mesh.model_index))


def tp_runs_12(mesh, engine_state, checkpoint, out_dir):
    """The (1, 2) runs of tests/test_torch_tp.py: the dropout steps, with
    the Engine's optimizer and with one made before the Engine, and the
    4-step run resumed from a checkpoint of another mesh."""
    return dict(dropout=W.dropout_run(mesh, engine_state, os.path.join(out_dir, "dropout")),
                given=given_optimizer_run(mesh, engine_state, os.path.join(out_dir, "given")),
                resumed=resumed_run(mesh, checkpoint, os.path.join(out_dir, "resumed")),
                coords=(mesh.rank, mesh.data_index, mesh.model_index))
