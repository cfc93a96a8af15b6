"""The per-rank functions of ``tests/test_torch_mesh.py`` and
``tests/test_torch_dp.py``, run by ``lc2is_tpu_torch.core.mesh.spawn`` in
processes of their own.  A spawned process imports this module afresh, so it
imports neither jax nor the JAX package (nor ``torch_port_util``, which
does), and each process runs one torch thread (``spawn(..., threads=1)``).

Every function takes the rank's mesh first and returns plain tensors,
numbers and dicts, which the parent compares with its one-process runs.
"""

import os

import numpy as np
import torch

from lc2is_tpu_torch.core import mesh as M
from lc2is_tpu_torch.data.ade20k import SyntheticADE20K
from lc2is_tpu_torch.data.collators import ADE20KCollator
from lc2is_tpu_torch.data.loader import DataLoader
from lc2is_tpu_torch.data.transforms import Compose, Resize
from lc2is_tpu_torch.engine.engine import Engine, evaluate
from lc2is_tpu_torch.engine import sliding
from lc2is_tpu_torch.engine.sliding import dp_sliding_miou
from lc2is_tpu_torch.models import zoo

# a tiny swin (window 4, one block a stage), as tests/torch_port_util.py's
TINY_SWIN = dict(embed_dim=16, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8), window=4)
NAMES7 = tuple(f"c{i}" for i in range(7))
IMG = 64
# the steps of tests/test_torch_engine.py's run, at a batch of 4
RUN = dict(max_steps=4, exact_steps=True, log_step=1, eval_step=4, save_step=1000,
           num_classes=7, seed=5, watch_grads=True, logger="csv", progress=False)
# 7 images in batches of 4 and 3 (drop_last off): the last one does not
# divide by two ranks, and every rank runs it whole
DROPOUT_RUN = dict(max_steps=3, exact_steps=True, log_step=1, eval_step=1000, save_step=1000,
                   num_classes=7, seed=5, logger="csv", progress=False)


def tiny_model(dropout=0.0, drop_path=0.0):
    return zoo.BaseCrossA(class_names=NAMES7, swin_cfg=dict(TINY_SWIN, drop_path_rate=drop_path),
                          dec_dim=32, nhead=4, dropout=dropout, device="cpu")


def dataset(n=8):
    return SyntheticADE20K(length=n, img_size=IMG, num_classes=7, transform=Compose([Resize(IMG)]))


def loaders(mesh=None, n=8, batch=2, drop_last=True):
    """(train loader: shuffled; eval loader) of ``n`` synthetic images."""
    ds = dataset(n)
    return (DataLoader(ds, batch, ADE20KCollator(), shuffle=True, seed=3, drop_last=drop_last,
                       mesh=mesh),
            DataLoader(ds, batch, ADE20KCollator(), shuffle=False, drop_last=drop_last,
                       mesh=mesh))


def read_log(path):
    import csv

    with open(path) as f:
        return [{k: float(v) for k, v in r.items()} for r in csv.DictReader(f)]


def dropout_run(mesh, state, out_dir):
    """3 steps of the tiny model with dropout 0.1 and drop path 0.2 over 7
    images in batches of 4 (the last, 3, whole on every rank): (logged rows,
    final parameters, images trained)."""
    tr, _ = loaders(mesh, n=7, batch=4, drop_last=False)
    eng = Engine(name="dropout", model=tiny_model(0.1, 0.2), params=state, device="cpu",
                 mesh=mesh, train_loader=tr, out_dir=out_dir, **DROPOUT_RUN)
    eng.train()
    rows = read_log(os.path.join(eng.out_dir, "log.csv")) if eng.main else None
    return dict(rows=rows, params={k: v.clone() for k, v in eng.model.state_dict().items()},
                images=eng.train_images)


def engine_run(mesh, state, out_dir):
    """tests/test_torch_engine.py's 4-step run (no dropout, no drop path;
    its eval at step 4) on the mesh: (logged rows, eval metrics)."""
    tr, ev = loaders(mesh)
    eng = Engine(name="engine", model=tiny_model(), params=state, device="cpu", mesh=mesh,
                 train_loader=tr, eval_loader=ev, out_dir=out_dir, **RUN)
    eng.train()
    rows = read_log(os.path.join(eng.out_dir, "log.csv")) if eng.main else None
    return dict(rows=rows, eval=eng.eval_metrics,
                params={k: v.clone() for k, v in eng.model.state_dict().items()})


def kept_outputs(outputs, labels):
    """A ``compute_metrics`` of the kept outputs: their count and the
    outputs and labels themselves (to check the gather's order)."""
    return dict(n=len(outputs), outputs=outputs, labels=labels)


def eval_run(mesh, state, global_batches):
    """:func:`evaluate` of the tiny model with its outputs kept, over a
    loader built with the mesh (8 images, batch 4, and a last batch of 2
    with ``drop_last`` off: 10 images) and over the same global batches given
    as they are (cut on each rank): both metrics."""
    model = tiny_model()
    model.load_state_dict(state)
    _, ev = loaders(mesh, n=10, batch=4, drop_last=False)
    kw = dict(num_classes=7, keep_eval_outputs=True, compute_metrics=kept_outputs, mesh=mesh)
    return dict(loader=evaluate(model, ev, **kw),
                given=evaluate(model, global_batches, **kw))


def sliding_model(state):
    """tests/test_sliding_utils.py:99-136's tiny PromptCrossA (four classes)."""
    cfg = dict(
        text_encoder=dict(context_length=8, vocab_size=49408, transformer_width=512,
                          transformer_heads=8, transformer_layers=1, embed_dim=512),
        context_decoder=dict(transformer_width=64, transformer_heads=4, transformer_layers=1),
        context_length=4,
        text_dim=512,
    )
    model = zoo.PromptCrossA(class_names=("wall", "sky", "tree", "road"), cfg=cfg,
                             swin_cfg=TINY_SWIN, dropout=0.0, device="cpu")
    model.load_state_dict(state)
    return model.eval()


SLIDE = dict(scales=(0.75, 1.0), crop=64, stride=32, flip=True, num_classes=4)


def sliding_run(mesh, state, images, labels):
    """:func:`dp_sliding_miou` of the tiny PromptCrossA, and the
    probabilities of this rank's images that it scored."""
    model = sliding_model(state)
    seen, score = [], sliding.per_image_miou

    def record(probs, *a, **kw):
        seen.append(probs.clone())
        return score(probs, *a, **kw)

    sliding.per_image_miou = record  # this process's own module: nothing else sees it
    try:
        with torch.no_grad():
            miou = dp_sliding_miou(lambda x: model({"pixel_values": x})["outputs"],
                                   torch.from_numpy(images), torch.from_numpy(labels), mesh,
                                   **SLIDE)
    finally:
        sliding.per_image_miou = score
    return dict(miou=float(miou), probs=torch.cat(seen).numpy())


def dp_runs(mesh, engine_state, slide_state, images, labels, global_batches, out_dir):
    """Every two-rank run of tests/test_torch_dp.py in one process group."""
    return dict(dropout=dropout_run(mesh, engine_state, os.path.join(out_dir, "dropout")),
                engine=engine_run(mesh, engine_state, os.path.join(out_dir, "engine")),
                eval=eval_run(mesh, engine_state, global_batches),
                sliding=sliding_run(mesh, slide_state, images, labels))


def same_state(a, b) -> bool:
    """Nested dicts and lists of tensors and numbers equal bit for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_state(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_state(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def resumed_state(mesh, argv, checkpoint):
    """``cli/train.py``'s rank function on ``argv`` (with ``--resume``), the
    Engine's state checked against ``checkpoint`` as training starts: (step
    at the start, model equal, optimizer equal, step at the end)."""
    from lc2is_tpu_torch.cli import train as train_cli
    from lc2is_tpu_torch.cli.common import parse_args
    from lc2is_tpu_torch.engine.checkpoint import load_checkpoint

    saved, _ = load_checkpoint(checkpoint)
    seen = {}
    run = Engine.train

    def checked(self):
        seen.update(start=self.train_step_count,
                    model=same_state(self.model.state_dict(), saved["model"]),
                    optimizer=same_state(self.optimizer.state_dict(), saved["optimizer"]))
        out = run(self)
        seen["end"] = self.train_step_count
        return out

    Engine.train = checked  # this process's own class: nothing else sees it
    try:
        train_cli.train(mesh, parse_args(argv))
    finally:
        Engine.train = run
    return seen


# --- core/mesh.py alone --------------------------------------------------------

def collectives(mesh):
    """Each collective helper of core/mesh.py on this rank's values."""
    r = mesh.rank
    s = M.all_reduce_sum(mesh, torch.tensor([1.0 + r, 10.0 * r]))
    grads = [torch.full((3,), 2.0 * r), torch.full((2, 4), 1.0 + r), torch.full((1,), 4.0)]
    M.all_reduce_mean_(mesh, grads, bucket_elements=5)  # a bucket a tensor, one larger than 5
    rows = M.all_gather_rows(mesh, torch.arange(3) + 3 * r)
    module = torch.nn.Linear(2, 2)
    with torch.no_grad():
        module.weight.fill_(float(r))
        module.bias.fill_(float(r) + 0.5)
    M.replicate(mesh, module)
    M.barrier(mesh)
    return dict(sum=s, grads=grads, rows=rows, shard=rows_of(mesh, 9),
                any=M.any_rank(mesh, r == 1),
                none=M.any_rank(mesh, False), objects=M.all_gather_objects(mesh, {"rank": r}),
                broadcast=M.broadcast_object(mesh, f"from {r}"),
                weight=module.weight.detach().clone(), bias=module.bias.detach().clone(),
                mesh=(mesh.data, mesh.model, mesh.rank, str(mesh.device), mesh.shape))


def fail_on_rank_1(mesh, how):
    """Rank 1 raises, exits or hangs; rank 0 waits on it in a collective."""
    if mesh.rank == 1:
        if how == "raise":
            raise ValueError("rank 1 fails")
        if how == "exit":
            os._exit(3)
        import time

        time.sleep(3600)
    M.barrier(mesh)
    return mesh.rank


def rows_of(mesh, n):
    """This rank's rows of ``np.arange(n)`` by shard_batch."""
    return np.asarray(M.shard_batch(mesh, {"x": np.arange(n)})["x"])


class SignalAt:
    """A dataset that sends this process SIGUSR1 while item ``at`` is read
    (on rank ``rank`` of the mesh only)."""

    def __init__(self, ds, at, rank, mesh):
        self.ds, self.at, self.hit = ds, at, mesh.rank == rank

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        if self.hit and i == self.at:
            import signal

            os.kill(os.getpid(), signal.SIGUSR1)
        return self.ds[i]


def preempted_run(mesh, state, out_dir):
    """8 steps of batch 2 over 8 images; rank 1 alone gets SIGUSR1 while it
    loads its row of the 3rd batch: (steps run, checkpoints written)."""
    loader = DataLoader(SignalAt(dataset(8), 5, 1, mesh), 2, ADE20KCollator(), drop_last=True,
                        mesh=mesh)
    eng = Engine(name="pre", model=tiny_model(), params=state, device="cpu", mesh=mesh,
                 train_loader=loader, max_steps=8, exact_steps=True, log_step=10 ** 6,
                 eval_step=10 ** 6, save_step=10 ** 6, out_dir=out_dir, logger="null",
                 progress=False)
    eng.train()
    return eng.train_step_count, sorted(os.listdir(os.path.join(eng.out_dir, "checkpoints")))


def signalled(mesh, ready_dir):
    """Waits (at most 60 s) for the SIGUSR1 that the parent passes on, with
    a handler installed and a file in ``ready_dir`` saying so."""
    import signal
    import time

    seen = []
    signal.signal(signal.SIGUSR1, lambda s, f: seen.append(s))
    open(os.path.join(ready_dir, f"rank{mesh.rank}"), "w").close()
    deadline = time.monotonic() + 60
    while not seen and time.monotonic() < deadline:
        time.sleep(0.05)
    return bool(seen)
