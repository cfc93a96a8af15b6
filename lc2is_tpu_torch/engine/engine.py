"""The training step, counterpart of ``train_step`` in
``lc2is_tpu/engine/engine.py`` (:236-313), with its branch rule (:246-250):

- a model with ``return_score_map`` (the v4 family; ``bench_train.py:58-73``
  times the flagship) emits its low-res score maps, and each loss is the
  fused upsample-CE at r = labels / map (main, and the auxiliary one on
  ``low_score_map`` times ``aux_weight``, 0.4); labels that are no integer
  multiple of a map take the reference's fallback, a bilinear resize of the
  map to the labels and the plain CE (``_fused_or_plain_ce`` :271-281);
- any other model (the v1 family: ``BaseModelWithText`` returns a tuple,
  adapted by :func:`_normalize_output`) takes the plain cross-entropy of
  ``outputs`` against the labels (:297), plus the auxiliary loss when the
  model returns ``low_score_map`` (:299).

The evaluation, counterpart of the engine's ``eval_step`` (:315-324) and of
``Engine.eval_loop`` / ``Engine.evaluate`` (:404-476): :func:`eval_step` runs
the model in eval mode without gradients and returns its losses (the plain
CE of ``outputs``, the auxiliary loss times ``aux_weight``), the batch's
per-image mIoU, its confusion counts and the f32 logits; :func:`evaluate`
runs it over batches as the JAX loaders give them and reduces as the JAX
engine does.

:class:`Engine` is the JAX ``Engine`` (:55-550) around them: the same
constructor, step count, hook cadences, logging, checkpoints and resume, and
checkpoint-and-stop on SIGTERM and SIGUSR1, on one device (the card unless
the caller names another) or over a ``core/mesh.py`` (data, model) mesh:
each rank runs its data index's rows of every global batch, the step
all-reduces the mean of the gradients over every rank, the optimizer keeps
the model axis's shards of the sharded weights (``engine/optim.py``), and
the metrics are reduced over the data axis.
"""

from __future__ import annotations

import inspect
import os
import signal
import time
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from lc2is_tpu_torch.core.mesh import (DATA_AXIS, Mesh, RowDraws, Rows, all_gather_objects,
                                       all_gather_rows, all_reduce_mean_, all_reduce_sum,
                                       any_rank, barrier, broadcast_object, replicate,
                                       tag_rows, unpack_batch)
from lc2is_tpu_torch.engine import checkpoint as ckpt
from lc2is_tpu_torch.engine.loggers import make_logger
from lc2is_tpu_torch.engine.optim import Optimizer, make_optimizer
from lc2is_tpu_torch.metrics.miou import (batch_confusion, dataset_miou, per_image_miou,
                                          psum_confusion)
from lc2is_tpu_torch.models.zoo import _model_device
from lc2is_tpu_torch.nn.init import init_parameters_
from lc2is_tpu_torch.nn.losses import auxiliary_loss, cross_entropy
from lc2is_tpu_torch.ops.fused_ce import upsampled_cross_entropy
from lc2is_tpu_torch.ops.resize import resize


def _normalize_output(out) -> Dict[str, torch.Tensor]:
    """A tuple-returning model's output as the dict the step consumes: the
    last non-None item is ``outputs`` (``engine.py:46-53``)."""
    if isinstance(out, dict):
        return out
    return dict(outputs=[o for o in out if o is not None][-1])


def _fused_or_plain_ce(score_map: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The fused upsample-CE at the integer ratio r of labels to map, or,
    when there is none, CE of the map resized to the labels (bilinear)."""
    r = labels.shape[-1] // score_map.shape[-1]
    if r >= 1 and r * score_map.shape[-1] == labels.shape[-1] \
            and r * score_map.shape[-2] == labels.shape[-2]:
        return upsampled_cross_entropy(score_map, labels, r)
    return cross_entropy(resize(score_map, size=tuple(labels.shape[-2:]), method="bilinear"),
                         labels)


def train_step(model: nn.Module, optimizer: Optimizer, inputs: Dict[str, torch.Tensor],
               labels: torch.Tensor, aux_weight: float = 0.4,
               generator: Optional[torch.Generator] = None,
               criterion: Optional[Callable] = None, aux_criterion: Optional[Callable] = None,
               grad_norm: bool = False, mesh: Optional[Mesh] = None,
               rows: Optional[Rows] = None) -> Dict[str, torch.Tensor]:
    """One optimizer step on one batch; returns the detached losses
    (``train_loss``, and ``train_aux_loss`` already times ``aux_weight``).
    ``generator`` draws the drop-path and dropout masks.  Frozen parameters
    are the optimizer's business (:func:`~lc2is_tpu_torch.engine.optim.make_optimizer`
    sets ``requires_grad_(False)`` on them).  A ``criterion`` (and
    ``aux_criterion``) replaces the default losses and takes the model's
    ``outputs`` as they come (``engine.py:296-299``); ``grad_norm`` adds
    ``train_grad_norm``, the global norm of the trainable gradients before
    the optimizer clips them (``engine.py:305-308``).

    On a mesh of more than one rank (``mesh``, with ``rows`` this rank's rows
    of the global batch): where the rows are split over the data axis the
    masks are drawn for the global batch
    (:class:`~lc2is_tpu_torch.core.mesh.RowDraws`; every rank seeds
    ``generator`` alike); the trainable gradients are replaced by their mean
    over every rank before the norm and the optimizer's clip and step, and
    the losses returned are the ranks' mean.  The default losses are means
    over equal shards, so the mean of the ranks' means is the global batch's
    mean and the step is the one-process step on the global batch; a
    ``criterion`` that is no per-sample mean is the caller's business.  The
    ranks of a model group (and every rank, where the rows are not split)
    ran the same rows: their mean is their gradient, and every rank steps
    its replicated parameters on the same reduced gradient, never on its own
    (on the card the backwards' f32 atomics make two ranks' gradients part
    in the last bits)."""
    model.train()
    split = mesh is not None and rows is not None and rows.split
    reduce = mesh is not None and mesh.group is not None
    draws = RowDraws(generator, rows) if split and generator is not None else generator
    out = _normalize_output(model(inputs, generator=draws))
    if criterion is None and aux_criterion is None \
            and getattr(model, "return_score_map", None) is not None:
        losses = {"train_loss": _fused_or_plain_ce(out["outputs"], labels)}
        if "low_score_map" in out:
            losses["train_aux_loss"] = _fused_or_plain_ce(out["low_score_map"],
                                                          labels) * aux_weight
    else:
        losses = {"train_loss": (criterion or cross_entropy)(out["outputs"], labels)}
        if "low_score_map" in out:
            losses["train_aux_loss"] = (aux_criterion or auxiliary_loss)(
                out["low_score_map"], labels) * aux_weight
    optimizer.zero_grad()
    sum(losses.values()).backward()
    if reduce:
        all_reduce_mean_(mesh, [p.grad for p in optimizer.params if p.grad is not None])
        reduced = torch.stack([v.detach().float() for v in losses.values()])
        all_reduce_mean_(mesh, [reduced])
        losses = dict(zip(losses, reduced.unbind()))
    if grad_norm:
        grads = [p.grad.float() for p in optimizer.params if p.grad is not None]
        losses["train_grad_norm"] = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    optimizer.step()
    return {k: v.detach() for k, v in losses.items()}


def eval_step(model: nn.Module, inputs: Dict[str, torch.Tensor], labels: torch.Tensor,
              aux_weight: float = 0.4, num_classes: int = 151):
    """One batch in eval mode, without gradients: ``(losses, miou, cm,
    logits)``: ``eval_loss`` (the plain CE of ``outputs``) and, where the
    model returns ``low_score_map``, ``eval_aux_loss`` (the auxiliary loss
    times ``aux_weight``); the batch's mean per-image mIoU (logits bicubic ×4,
    labels nearest ×4); the (K, K) confusion counts at the logits' size; the
    logits in f32."""
    model.eval()
    with torch.no_grad():
        out = _normalize_output(model(inputs))
        losses = {"eval_loss": cross_entropy(out["outputs"], labels)}
        if "low_score_map" in out:
            losses["eval_aux_loss"] = auxiliary_loss(out["low_score_map"], labels) * aux_weight
        logits = out["outputs"].float()
        miou = per_image_miou(logits, labels, num_classes=num_classes)
        cm = batch_confusion(logits, labels, num_classes=num_classes)
    return losses, miou, cm, logits


def on_device(x, device: torch.device) -> torch.Tensor:
    """A batch entry on ``device``; integer arrays as int64."""
    x = torch.as_tensor(x)
    return (x if x.is_floating_point() else x.long()).to(device)


def model_device(model: nn.Module) -> torch.device:
    """Where the model's parameters live."""
    return next(model.parameters()).device


def evaluate(model: nn.Module, batches: Iterable, aux_weight: float = 0.4,
             num_classes: int = 151, keep_eval_outputs: bool = False,
             compute_metrics: Optional[Callable] = None,
             mesh: Optional[Mesh] = None) -> Dict[str, float]:
    """:func:`eval_step` over ``batches`` (each a dict with ``pixel_values``
    and ``label``, or ``(dict, metas)``), on the model's device.  Returns the
    mean over batches of each loss, ``eval_mIOU_label`` (the per-image mIoU
    weighted by batch size) and ``eval_mIOU_dataset`` (from the summed
    confusion counts).  With ``keep_eval_outputs`` the logits and labels are
    kept on the host, with ``gt_list`` and ``sizes`` where every image's metas
    carry them, and ``compute_metrics(**kept)``'s results are added, prefixed
    ``eval_``.

    Under a ``mesh`` each rank evaluates its rows of every batch (a batch a
    sharded loader gives, or its own cut of a global one); the per-image mIoU
    sum, the image count, each loss times this rank's share of its batch's
    rows and the int64 confusion counts are summed over the data axis (the
    ranks of a model group hold the same rows: each row counts once; a batch
    every rank holds whole counts on data index 0 only), and the kept outputs
    are gathered over the data axis to rank 0 in the batches' order, where
    ``compute_metrics`` runs; every rank returns the same metrics."""
    device = model_device(model)
    # per-image mIoU sum, images; each loss summed over the batches
    sums: Dict[str, float] = dict(miou=0.0, images=0.0)
    n_batches = 0
    cm_total = torch.zeros((num_classes, num_classes), dtype=torch.int64, device=device)
    all_outputs, all_labels, gt_list, sizes = [], [], [], []
    main = mesh is None or mesh.is_main
    data_main = mesh is None or mesh.is_data_main
    for data in batches:
        inputs, metas, rows = unpack_batch(mesh, data)
        labels = on_device(inputs.pop("label"), device)
        inputs = {k: on_device(v, device) for k, v in inputs.items() if k != "size"}
        losses, miou, cm, logits = eval_step(model, inputs, labels, aux_weight, num_classes)
        n_batches += 1
        b = int(labels.shape[0])
        counted = rows.split or data_main  # a batch every rank holds counts once
        if counted:
            sums["miou"] += float(miou) * b
            sums["images"] += b
            cm_total += cm
        for k, v in losses.items():  # every rank has every key, in one order
            sums[k] = sums.get(k, 0.0) + (float(v) * b / rows.total if counted else 0.0)
        if keep_eval_outputs:
            if rows.split:
                logits = all_gather_rows(mesh, logits, DATA_AXIS)
                labels = all_gather_rows(mesh, labels, DATA_AXIS)
                parts = all_gather_objects(mesh, metas, DATA_AXIS)
                metas = ([m for part in parts for m in part]
                         if all(isinstance(part, list) for part in parts) else None)
            if not main:
                continue
            all_outputs.append(logits.cpu().numpy())
            all_labels.append(labels.cpu().numpy())
            for m in metas if isinstance(metas, list) else ():
                if isinstance(m, dict) and "size" in m:
                    sizes.append(m["size"])
                if isinstance(m, dict) and "gt" in m:
                    gt_list.append(np.asarray(m["gt"]))
    keys = list(sums)
    if mesh is not None and mesh.group is not None:
        total = all_reduce_sum(mesh, torch.tensor([sums[k] for k in keys], dtype=torch.float64,
                                                  device=device), DATA_AXIS)
        sums = dict(zip(keys, total.tolist()))
        psum_confusion(cm_total, mesh)
    eval_metrics = {k: v / max(n_batches, 1) for k, v in sums.items()
                    if k not in ("miou", "images")}
    eval_metrics["eval_mIOU_label"] = sums["miou"] / max(sums["images"], 1)
    eval_metrics["eval_mIOU_dataset"] = float(dataset_miou(cm_total))
    if compute_metrics is None or not keep_eval_outputs:
        return eval_metrics
    metrics = None
    if main and all_outputs:
        kept = dict(outputs=np.concatenate(all_outputs), labels=np.concatenate(all_labels))
        if gt_list and sizes and len(gt_list) == len(kept["outputs"]) == len(sizes):
            kept.update(gt_list=gt_list, sizes=sizes)
        params = inspect.signature(compute_metrics).parameters
        if not any(p.kind == p.VAR_KEYWORD for p in params.values()):
            kept = {k: v for k, v in kept.items() if k in params}
        metrics = compute_metrics(**kept)
    metrics = broadcast_object(mesh, metrics)
    if metrics is None:
        return eval_metrics
    return {**eval_metrics, **{"eval_" + k: v for k, v in metrics.items()}}


class Engine:
    """Train and evaluate one model, the JAX ``Engine``'s surface
    (``engine.py:55-160``), on ``device`` or, data-parallel, on this rank's
    device of ``mesh`` (``core/mesh.py``; one process a device):

    - ``params``: a state_dict of the port's keys to load (strict); without
      one, every parameter is drawn by :func:`~lc2is_tpu_torch.nn.init.init_parameters_`
      from a generator seeded with ``seed`` (where JAX calls ``model.init``);
    - the step count is ``max(steps_in_epoch · max_epoch, max_steps)``, or
      exactly ``max_steps`` with ``exact_steps`` (``:117-125``); evaluation,
      logging and saving every ``eval_step`` / ``log_step`` / ``save_step``
      steps, by default 10 epochs, 1 epoch and 10 epochs;
    - ``fp16``: floating inputs rounded to bf16 before the model (``_cast``,
      ``:224-230``); the model's own compute dtype is the caller's;
    - a model with ``return_score_map`` False trains with the flag set for
      the step (the low-res maps into the fused upsample-CE, as JAX's clone,
      ``:246-253``) and evaluates with its ×4 head;
    - the dropout and drop-path masks come from a generator seeded with
      ``seed``, not saved in checkpoints (JAX rebuilds its key from ``seed``);
    - ``watch_grads`` logs ``train_grad_norm``; ``debug_nans`` raises
      ``FloatingPointError`` on a non-finite loss; SIGTERM and SIGUSR1 during
      :meth:`train` checkpoint and stop at the next step boundary.

    Under a mesh of more than one rank every process builds the same Engine:
    the parameters are broadcast from rank 0; each rank steps on its data
    index's rows of every global batch (a loader built with the mesh loads
    only those, another one's global batches are cut here), with
    :func:`train_step`'s all-reduced gradients; on a model axis the optimizer
    made here holds the sharded weights' shards and AdamW moments
    (``engine/optim.py``; a given ``optimizer`` is used as it is), and the
    module holds the whole weights gathered after each step.  Logged losses
    and ``train_grad_norm`` are the global ones, and ``train_images`` and the
    img/s count global images.  Rank 0 alone writes the logs and checkpoints
    (whole parameters and whole moments, the files one device writes; the
    others wait for each); every rank resumes from the same file, whatever
    the mesh that wrote it; a preemption signal on any rank stops every rank
    after the same step.  A model that mixes images across its batch
    (``mixes_batch``) computes something else on a batch split over the data
    axis, and raises there.
    """

    def __init__(
        self,
        name: str,
        model: nn.Module,
        params: Optional[Mapping[str, torch.Tensor]] = None,
        optimizer: Optional[Optimizer] = None,
        criterion: Optional[Callable] = None,
        lr_scheduler: Optional[str] = None,
        device="cuda",
        mesh: Optional[Mesh] = None,
        fp16: bool = False,
        aux_criterion: Optional[Callable] = None,
        aux_weight: float = 0.4,
        train_loader=None,
        eval_loader=None,
        compute_metrics: Optional[Callable] = None,
        max_epoch: int = 1,
        max_steps: Optional[int] = None,
        exact_steps: bool = False,
        eval_step: Optional[int] = None,
        log_step: Optional[int] = None,
        save_step: Optional[int] = None,
        out_dir: str = "./",
        logger: str = "csv",
        logger_args: Optional[Dict] = None,
        lr: float = 1e-5,
        weight_decay: float = 0.0,
        frozen_prefixes: Sequence[str] = (),
        num_classes: int = 151,
        seed: int = 1024,
        keep_eval_outputs: bool = False,
        debug_nans: bool = False,
        checkpoint_on_preemption: bool = True,
        watch_grads: bool = False,
        progress: bool = True,
    ) -> None:
        self.name = name
        self.mesh = mesh if mesh is not None and mesh.group is not None else None
        if self.mesh is not None and self.mesh.data > 1 and getattr(model, "mixes_batch", False):
            raise ValueError(f"{type(model).__name__} mixes the images of a batch: it has no "
                             "data-parallel form")
        self.main = self.mesh is None or self.mesh.is_main
        self.device = _model_device(device if mesh is None else mesh.device)
        self.model = model.to(self.device)
        self.fp16 = fp16
        self.criterion, self.aux_criterion = criterion, aux_criterion
        self.aux_weight = aux_weight
        self.train_loader, self.eval_loader = train_loader, eval_loader
        self.compute_metrics = compute_metrics
        self.num_classes = num_classes
        self.keep_eval_outputs = keep_eval_outputs
        self.debug_nans = debug_nans
        self.checkpoint_on_preemption = checkpoint_on_preemption
        self.watch_grads = watch_grads
        self.progress = progress and self.main
        self.seed = seed
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        self.steps_in_epoch = len(train_loader) if train_loader is not None else 0
        if max_steps is not None and exact_steps:
            self.train_steps = max_steps
        elif max_steps is not None:  # the reference's quirk (engine.py:38-42)
            self.train_steps = max(self.steps_in_epoch * max_epoch, max_steps)
        else:
            self.train_steps = self.steps_in_epoch * max_epoch
        self.eval_step = self.steps_in_epoch * 10 if eval_step is None else eval_step
        self.log_step = self.steps_in_epoch if log_step is None else log_step
        self.save_step = self.steps_in_epoch * 10 if save_step is None else save_step
        self.out_dir = os.path.join(out_dir, name)
        self.logger = make_logger(logger if self.main else "null", self.out_dir, logger_args)

        if params is None:
            init_parameters_(self.model, torch.Generator(device=self.device).manual_seed(seed))
        else:
            self.model.load_state_dict(params, strict=True)
        replicate(self.mesh, self.model)
        self.optimizer = optimizer if optimizer is not None else make_optimizer(
            self.model, lr=lr, weight_decay=weight_decay, schedule=lr_scheduler or "constant",
            total_steps=max(self.train_steps, 1), frozen_prefixes=frozen_prefixes, mesh=self.mesh)

        self.train_step_count = 0
        self.eval_metrics: Dict = {}
        self.all_train_metrics: Dict[str, List[float]] = {}
        self._preempted = False
        self._skip_batches = 0
        # host seconds of the last train(): in steps, waiting on the loader
        self.step_seconds = self.loader_wait_seconds = 0.0
        self.train_images = 0

    # ------------------------------------------------------------------
    def _make_bar(self, total: int, desc: str, leave: bool = True):
        """A tqdm bar (``engine.py:53,138``); None when off or tqdm is absent."""
        if not self.progress:
            return None
        try:
            from tqdm import tqdm
        except ImportError:
            return None
        return tqdm(total=total, desc=desc, leave=leave, dynamic_ncols=True)

    def _batch(self, data):
        """(inputs on the device, floating ones in bf16 under ``fp16``;
        int64 labels on the device; metas; this rank's rows of the batch)."""
        inputs, metas, rows = unpack_batch(self.mesh, data)
        labels = on_device(inputs.pop("label"), self.device)
        inputs = {k: on_device(v, self.device) for k, v in inputs.items() if k != "size"}
        if self.fp16:
            inputs = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
                      for k, v in inputs.items()}
        return inputs, labels, metas, rows

    def _step(self, inputs, labels, rows=None) -> Dict[str, torch.Tensor]:
        fused_head = (self.criterion is None and self.aux_criterion is None
                      and getattr(self.model, "return_score_map", None) is False)
        if fused_head:
            self.model.return_score_map = True
        try:
            return train_step(self.model, self.optimizer, inputs, labels, self.aux_weight,
                              self.generator, self.criterion, self.aux_criterion,
                              grad_norm=self.watch_grads, mesh=self.mesh, rows=rows)
        finally:
            if fused_head:
                self.model.return_score_map = False

    # ------------------------------------------------------------------
    def train(self):
        """Train to ``train_steps`` (or a preemption signal); returns (the last
        log and eval metrics, the checkpoint directory of the last save)."""
        self.logger.init()
        self.stop_train = self._preempted = False
        metrics, save_path = {}, None
        self.step_seconds = self.loader_wait_seconds = 0.0
        self.train_images = 0
        self._train_bar = self._make_bar(self.train_steps, "Training")
        previous = {}
        if self.checkpoint_on_preemption:
            def handler(signum, frame):
                self._preempted = True

            for sig in (signal.SIGTERM, signal.SIGUSR1):
                try:
                    previous[sig] = signal.signal(sig, handler)
                except ValueError:  # not the main thread: no handler, as in JAX
                    pass
        t0 = time.time()
        try:
            while not self.stop_train:
                metrics, save_path = self.train_loop()
        finally:
            for sig, h in previous.items():
                signal.signal(sig, h)
            if self._train_bar is not None:
                self._train_bar.close()
        self.logger.finish()
        dt = time.time() - t0
        busy = self.step_seconds + self.loader_wait_seconds
        if self.main:
            print(f"[engine] trained {self.train_step_count} steps in {dt:.1f}s "
                  f"({self.train_step_count / max(dt, 1e-9):.2f} steps/s); steps "
                  f"{self.step_seconds:.2f}s "
                  f"({self.train_images / max(self.step_seconds, 1e-9):.2f} img/s), waiting on "
                  f"the loader {self.loader_wait_seconds:.2f}s "
                  f"({100.0 * self.loader_wait_seconds / max(busy, 1e-9):.1f}%)")
        return metrics, save_path

    def train_loop(self):
        """One pass over the train loader, or fewer steps at a stop."""
        batches = iter(self.train_loader)
        try:
            return self._train_batches(batches)
        finally:
            if hasattr(batches, "close"):  # stops a prefetching loader's producer
                batches.close()

    def _train_batches(self, batches):
        log_metrics, eval_metrics, save_path = {}, {}, None
        while True:
            t_wait = time.perf_counter()
            data = next(batches, None)
            if data is None:
                break
            if self._skip_batches:  # resumed inside an epoch: its first batches are done
                self._skip_batches -= 1
                continue
            t_step = time.perf_counter()
            self.loader_wait_seconds += t_step - t_wait
            self.train_step_count += 1
            inputs, labels, _, rows = self._batch(data)
            losses = {k: float(v) for k, v in self._step(inputs, labels, rows).items()}
            self.step_seconds += time.perf_counter() - t_step
            self.train_images += rows.total
            if self._train_bar is not None:
                self._train_bar.update(1)
            if self.debug_nans and not all(np.isfinite(v) for v in losses.values()):
                raise FloatingPointError(f"non-finite loss at step {self.train_step_count}: "
                                         f"{losses}")
            for k, v in losses.items():
                self.all_train_metrics.setdefault(k, []).append(v)

            eval_metrics = self.should_eval()
            log_metrics = self.should_log()
            save_path = self.should_save()
            self._preempted = any_rank(self.mesh, self._preempted)
            if self._preempted:
                save_path = self.save()
                if self.main:
                    print(f"[engine] preemption signal: checkpointed at step "
                          f"{self.train_step_count}", flush=True)
                self.stop_train = True
                break
            if self.should_stop():
                self.stop_train = True
                break
        return {**log_metrics, **eval_metrics}, save_path

    # ------------------------------------------------------------------
    def evaluate(self) -> Dict[str, float]:
        """:func:`evaluate` over the eval loader (``engine.py:398-476``)."""
        self.eval_metrics = evaluate(self.model, self._eval_batches(), self.aux_weight,
                                     self.num_classes, self.keep_eval_outputs,
                                     self.compute_metrics, self.mesh)
        return self.eval_metrics

    def _eval_batches(self):
        bar = self._make_bar(len(self.eval_loader), "Evaluation", leave=False)
        try:
            for data in self.eval_loader:
                inputs, labels, metas, rows = self._batch(data)
                if bar is not None:
                    bar.update(1)
                yield tag_rows((dict(inputs, label=labels), metas), rows)
        finally:
            if bar is not None:
                bar.close()

    # ------------------------------------------------------------------
    def log(self) -> Dict:
        train_epoch = round(self.train_step_count / max(self.steps_in_epoch, 1), 4)
        train_metrics = {k: float(np.mean(v)) for k, v in self.all_train_metrics.items()}
        metrics = {"train_step": self.train_step_count, "train_epoch": train_epoch,
                   **train_metrics, **self.eval_metrics}
        self.logger.log(metrics)
        if self.main:
            print(f"[engine] step {self.train_step_count}: "
                  + ", ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                              for k, v in metrics.items()), flush=True)
        return metrics

    def save(self) -> str:
        """The model and optimizer state at this step, natively (rank 0
        writes whole parameters and moments, the other ranks wait for it);
        returns the checkpoint directory."""
        checkpoints_dir = os.path.join(self.out_dir, "checkpoints")
        optimizer = self.optimizer.state_dict()  # gathers sharded moments: every rank calls
        if self.main:
            ckpt.save_checkpoint(checkpoints_dir, dict(model=self.model.state_dict(),
                                                       optimizer=optimizer,
                                                       step=self.train_step_count),
                                 self.train_step_count)
        barrier(self.mesh)
        return checkpoints_dir

    def save_reference_pt(self, path: Optional[str] = None) -> str:
        """The parameters as a reference ``.pt`` (``step-{N}.pt`` by default)."""
        checkpoints_dir = os.path.join(self.out_dir, "checkpoints")
        os.makedirs(checkpoints_dir, exist_ok=True)
        path = path or os.path.join(checkpoints_dir, f"step-{self.train_step_count}.pt")
        ckpt.export_reference_pt(self.model, path)
        return path

    def resume(self, fname: Optional[str] = None) -> int:
        """Model, optimizer and step from the latest (or the given) native
        checkpoint, written on a mesh of any shape; returns the step (0 where
        there is none).  The train loader goes on from that step's epoch and
        batch."""
        fname = fname or ckpt.latest_checkpoint(os.path.join(self.out_dir, "checkpoints"))
        if fname is None:
            return 0
        state, _ = ckpt.load_checkpoint(fname)
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.train_step_count = int(state["step"])
        if self.train_loader is not None and self.steps_in_epoch:
            if hasattr(self.train_loader, "set_epoch"):
                self.train_loader.set_epoch(self.train_step_count // self.steps_in_epoch)
            self._skip_batches = self.train_step_count % self.steps_in_epoch
        return self.train_step_count

    # --- hooks (engine.py:531-550) -----------------------------------------
    def should_eval(self):
        if self.eval_loader is not None and self.train_step_count % max(self.eval_step, 1) == 0:
            return self.evaluate()
        return {}

    def should_log(self):
        if self.train_step_count % max(self.log_step, 1) == 0:
            m = self.log()
            self.all_train_metrics = {}
            return m
        return {}

    def should_save(self):
        if self.train_step_count % max(self.save_step, 1) == 0:
            return self.save()
        return None

    def should_stop(self) -> bool:
        return self.train_step_count % max(self.train_steps, 1) == 0
