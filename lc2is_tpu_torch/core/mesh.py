"""The (data, model) mesh, counterpart of ``lc2is_tpu/core/mesh.py``.

The JAX package places each batch over the ``data`` axis of one
``jax.sharding.Mesh``, the weights over its ``model`` axis
(``parallel/sharding.py``), and lets GSPMD insert the collectives.  Here the
mesh is a ``torch.distributed`` process group with one process a device
(NCCL on GPUs; gloo on the CPU, or where the caller names it).  Rank ``r``
sits at ``(r // model, r % model)``, as JAX's ``reshape(data, model)`` of
the device list: each rank has a data group (the ranks of its model index,
over which the batch is split) and a model group (the ranks of its data
index, which hold the same rows and split the weights).  Each rank runs its
data index's rows of every global batch; the training step all-reduces the
gradients over every rank; the ranks of a model group keep their shards of
the sharded weights and gather the whole ones (``engine/optim.py``).  A mesh
of one device builds no group, and everything below is then the
single-device code.

- :func:`make_mesh` sizes the mesh as JAX's does (``data · model`` equal to
  the device count, ``data=-1`` the devices over ``model``); it joins the group this
  process is already in, or the one ``torchrun``'s ``RANK``, ``WORLD_SIZE``
  and ``LOCAL_RANK`` describe.  :func:`spawn` starts one process a device
  itself and runs a function on each one's mesh.
- :func:`shard_batch` keeps this rank's contiguous rows of a global batch
  (its data index's share), or the whole batch where its rows do not divide
  by the data axis (JAX replicates such a batch,
  ``lc2is_tpu/engine/engine.py:341-350``).
- :class:`RowDraws` draws dropout and drop-path masks for the global batch
  and keeps this rank's rows, so a data-parallel step draws the masks of
  the one-process step, as JAX's single key does under its mesh.
- The collectives take an ``axis``: None (every rank), :data:`DATA_AXIS`
  (this rank's data group: the reductions of metrics, so a row is counted
  once however many model ranks hold it) or :data:`MODEL_AXIS`.
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue
import signal
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DATA_AXIS = "data"
MODEL_AXIS = "model"
# seconds a collective, the rendezvous or a spawned run may take before it
# counts as hung
TIMEOUT = 1800.0
# elements of one flattened gradient buffer of :func:`all_reduce_mean_` (128 MB of f32)
BUCKET_ELEMENTS = 1 << 25
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK")
# the inputs key of a batch that a loader already cut to this rank's rows
ROWS_KEY = "batch_rows"


@dataclass
class Mesh:
    """One process's view of the (data, model) mesh: its sizes, this
    process's rank and device, and the process groups (None for one device):
    every rank; this rank's data group (the ranks of its model index) and
    model group (the ranks of its data index), each None where its axis has
    size 1."""

    data: int
    model: int
    rank: int
    device: torch.device
    group: Optional[Any] = None
    data_group: Optional[Any] = None
    model_group: Optional[Any] = None

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def shape(self):
        """Axis sizes by name, as ``jax.sharding.Mesh.shape``."""
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def is_main(self) -> bool:
        """Rank 0: the process that writes checkpoints and logs."""
        return self.rank == 0

    @property
    def is_data_main(self) -> bool:
        """Data index 0: the rank of its data group that counts a batch every
        rank of the group holds whole."""
        return self.data_index == 0


class Rows(NamedTuple):
    """This rank's rows ``[start, stop)`` of a global batch of ``total``."""

    start: int
    stop: int
    total: int

    @property
    def split(self) -> bool:
        """True where the ranks hold different rows (False: every rank holds
        the whole batch)."""
        return self.stop - self.start != self.total


def backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def visible_devices() -> List[torch.device]:
    """Every visible GPU."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _axis_sizes(data: int, model: int, n: int):
    """(data, model) of a mesh over ``n`` devices; ``data`` -1: ``n // model``."""
    if model < 1 or n % model:
        raise ValueError(f"model axis {model} does not divide {n} devices")
    if data == -1:
        data = n // model
    if data < 1 or data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return data, model


def _axis_groups(data: int, model: int):
    """(data group, model group) of this rank, every rank building every
    group in one order (``dist.new_group`` is collective): the whole world
    for an axis that spans it, None for an axis of size 1."""
    world = dist.group.WORLD
    if model == 1:
        return world, None
    if data == 1:
        return None, world
    rank = dist.get_rank()
    mine = [None, None]
    for j in range(model):  # data groups: the ranks of model index j
        g = dist.new_group([i * model + j for i in range(data)])
        if rank % model == j:
            mine[0] = g
    for i in range(data):  # model groups: the ranks of data index i
        g = dist.new_group([i * model + j for j in range(model)])
        if rank // model == i:
            mine[1] = g
    return mine[0], mine[1]


def _joined() -> bool:
    return dist.is_initialized() or all(k in os.environ for k in TORCHRUN_ENV)


def make_mesh(data: int = -1, model: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """The (data, model) mesh of this process over ``devices`` (by default
    every visible GPU; under ``torchrun`` one a process).  A mesh of more
    than one device needs this process in a group of that size: the one it
    is in, or the one ``torchrun``'s environment names (joined here, NCCL or
    gloo by the device); otherwise it raises (start the processes with
    :func:`spawn`)."""
    if devices is None and _joined():
        world = (dist.get_world_size() if dist.is_initialized()
                 else int(os.environ["WORLD_SIZE"]))
        devices = ([torch.device("cuda", i) for i in range(world)]
                   if torch.cuda.is_available() else [torch.device("cpu")] * world)
    devs = [torch.device(d) for d in (devices if devices is not None else visible_devices())]
    data, model = _axis_sizes(data, model, len(devs))
    if len(devs) == 1:
        return Mesh(data, model, 0, devs[0])
    if not dist.is_initialized():
        if not _joined():
            raise RuntimeError(f"a mesh of {len(devs)} devices needs one process a device: "
                               "start them with lc2is_tpu_torch.core.mesh.spawn or torchrun")
        dist.init_process_group(backend_for(devs[0]), init_method="env://",
                                timeout=datetime.timedelta(seconds=TIMEOUT))
    if dist.get_world_size() != len(devs):
        raise ValueError(f"mesh of {len(devs)} devices in a group of {dist.get_world_size()}")
    rank = dist.get_rank()
    device = devs[int(os.environ.get("LOCAL_RANK", rank))]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(data, model, rank, device, dist.group.WORLD, *_axis_groups(data, model))


# --- batches --------------------------------------------------------------

def batch_rows(mesh: Optional[Mesh], total: int) -> Rows:
    """This rank's rows of a global batch of ``total``: its data index's
    contiguous ``total / data`` of them (the ranks of a model group hold the
    same rows), or all where they do not divide."""
    n = 1 if mesh is None else mesh.data
    if n == 1 or total % n:
        return Rows(0, total, total)
    per = total // n
    i = mesh.data_index
    return Rows(i * per, (i + 1) * per, total)


def _is_rows_leaf(x) -> bool:
    return hasattr(x, "shape") and len(x.shape) > 0


def _leading(tree) -> Optional[int]:
    """The leading dimension of the first array or tensor in ``tree``."""
    if _is_rows_leaf(tree):
        return len(tree)
    for v in tree.values() if isinstance(tree, dict) else (
            tree if isinstance(tree, (list, tuple)) else ()):
        n = _leading(v)
        if n is not None:
            return n
    return None


def take_rows(tree, rows: Rows):
    """``rows`` of every array, tensor and list of ``rows.total`` entries in
    ``tree`` (dicts and tuples walked); other leaves as they are."""
    if not rows.split:
        return tree
    if isinstance(tree, dict):
        return {k: take_rows(v, rows) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(take_rows(v, rows) for v in tree)
    if (_is_rows_leaf(tree) or isinstance(tree, list)) and len(tree) == rows.total:
        return tree[rows.start:rows.stop]
    return tree


def shard_batch(mesh: Optional[Mesh], batch):
    """This rank's contiguous rows of the global ``batch`` (a dict, tuple or
    list tree of arrays, tensors and per-image lists), or the whole batch
    where its leading dimension does not divide by the data axis."""
    total = _leading(batch)
    return batch if total is None else take_rows(batch, batch_rows(mesh, total))


def tag_rows(batch, rows: Rows):
    """``batch`` (an inputs dict, or a tuple that starts with one) with
    ``rows`` under ``ROWS_KEY`` in the dict: the mark of a batch that is
    already one rank's rows."""
    if isinstance(batch, dict):
        return {**batch, ROWS_KEY: rows}
    if isinstance(batch, tuple) and batch and isinstance(batch[0], dict):
        return ({**batch[0], ROWS_KEY: rows},) + batch[1:]
    raise TypeError(f"cannot tag a batch of type {type(batch).__name__} with its rows")


def unpack_batch(mesh: Optional[Mesh], data):
    """(inputs dict, metas or None, Rows) of a batch as a loader gives it (a
    dict, or ``(dict, metas, ...)``): a batch tagged by :func:`tag_rows` as
    it is, any other one cut to this rank's rows by :func:`shard_batch`."""
    inputs = dict(data[0]) if isinstance(data, tuple) else dict(data)
    metas = data[1] if isinstance(data, tuple) and len(data) > 1 else None
    rows = inputs.pop(ROWS_KEY, None)
    if rows is None:
        total = _leading(inputs)
        rows = batch_rows(mesh, 0 if total is None else total)
        inputs, metas = take_rows(inputs, rows), take_rows(metas, rows)
    return inputs, metas, rows


def replicate(mesh: Optional[Mesh], module: torch.nn.Module) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` broadcast from rank 0."""
    if _group_size(mesh) > 1:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=0, group=mesh.group)
    return module


# --- collectives (no-ops on a mesh of one device) ----------------------------

def axis_group(mesh: Optional[Mesh], axis: Optional[str] = None):
    """(process group, size) of this rank along ``axis``: None every rank,
    ``DATA_AXIS`` its data group, ``MODEL_AXIS`` its model group."""
    if mesh is None or mesh.group is None:
        return None, 1
    if axis is None:
        return mesh.group, mesh.size
    if axis == DATA_AXIS:
        return mesh.data_group, mesh.data
    if axis == MODEL_AXIS:
        return mesh.model_group, mesh.model
    raise ValueError(f"no mesh axis {axis!r}")


def _group_size(mesh: Optional[Mesh]) -> int:
    return axis_group(mesh)[1]


def all_reduce_sum(mesh: Optional[Mesh], t: torch.Tensor,
                   axis: Optional[str] = None) -> torch.Tensor:
    """``t`` summed over the ranks along ``axis`` (None: every rank), in
    place."""
    group, n = axis_group(mesh, axis)
    if n > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_reduce_mean_(mesh: Optional[Mesh], tensors: Sequence[torch.Tensor],
                     bucket_elements: int = BUCKET_ELEMENTS) -> None:
    """Each tensor replaced by its mean over every rank, through flattened
    f32 buffers of at most ``bucket_elements`` (a tensor larger than that its
    own buffer)."""
    n = _group_size(mesh)
    if n == 1 or not tensors:
        return
    bucket: List[torch.Tensor] = []
    for i, t in enumerate(tensors):
        bucket.append(t)
        last = i + 1 == len(tensors)
        if last or sum(b.numel() for b in bucket) + tensors[i + 1].numel() > bucket_elements:
            flat = torch.cat([b.reshape(-1).float() for b in bucket])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
            flat.div_(n)
            for b, part in zip(bucket, flat.split([b.numel() for b in bucket])):
                b.copy_(part.view_as(b))
            bucket = []


def any_rank(mesh: Optional[Mesh], flag: bool) -> bool:
    """True where ``flag`` is true on any rank."""
    if _group_size(mesh) == 1:
        return flag
    t = torch.tensor([1 if flag else 0], dtype=torch.int64, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return bool(t.item())


def all_gather_rows(mesh: Optional[Mesh], t: torch.Tensor,
                    axis: Optional[str] = None) -> torch.Tensor:
    """Every rank's ``t`` along ``axis`` (each of the same shape)
    concatenated along dim 0 in rank order."""
    group, n = axis_group(mesh, axis)
    if n == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def all_gather_objects(mesh: Optional[Mesh], obj, axis: Optional[str] = None) -> list:
    """Every rank's picklable ``obj`` along ``axis``, in rank order."""
    group, n = axis_group(mesh, axis)
    if n == 1:
        return [obj]
    out = [None] * n
    dist.all_gather_object(out, obj, group=group)
    return out


def broadcast_object(mesh: Optional[Mesh], obj):
    """Rank 0's picklable ``obj`` on every rank."""
    if _group_size(mesh) == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.group,
                               device=mesh.device if mesh.device.type == "cuda" else None)
    return box[0]


def barrier(mesh: Optional[Mesh]) -> None:
    if _group_size(mesh) > 1:
        if mesh.device.type == "cuda" and dist.get_backend(mesh.group) == "nccl":
            dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
        else:
            dist.barrier(group=mesh.group)


# --- random draws ---------------------------------------------------------

class RowDraws:
    """``generator``'s draws as the global batch takes them: a draw whose
    leading dimension is this rank's row count is made for the whole batch
    and cut to this rank's rows, so every rank (all seeded alike) keeps the
    rows the one-process step would give it; any other draw is made as is.
    Every draw of the models' forwards is per image and batch-first (the
    dropout and drop-path masks)."""

    def __init__(self, generator: torch.Generator, rows: Rows):
        self.generator, self.rows = generator, rows

    def rand(self, shape, device) -> torch.Tensor:
        r = self.rows
        if r.split and len(shape) > 0 and shape[0] == r.stop - r.start:
            full = torch.rand((r.total, *shape[1:]), generator=self.generator, device=device)
            return full[r.start:r.stop]
        return torch.rand(shape, generator=self.generator, device=device)


def uniform(shape, generator, device) -> torch.Tensor:
    """U[0, 1) of ``shape`` from ``generator``, a ``torch.Generator`` or a
    :class:`RowDraws`."""
    if isinstance(generator, RowDraws):
        return generator.rand(tuple(shape), device)
    return torch.rand(shape, generator=generator, device=device)


# --- processes ------------------------------------------------------------

def _child(rank, world, fn, args, data, model, devices, backend, init_method, timeout,
           threads, results):
    if threads:
        torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        out = fn(make_mesh(data, model, devices), *args)
        # pickled here, whole: a tensor put as it is would travel as a handle
        # to this process's shared memory, which dies with it
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, args: tuple = (), data: int = -1, model: int = 1,
          devices: Optional[Sequence] = None, backend: Optional[str] = None,
          init_method: Optional[str] = None, timeout: float = TIMEOUT,
          threads: Optional[int] = None) -> list:
    """``fn(mesh, *args)`` on one process a device of the (data, model)
    mesh over ``devices`` (every visible GPU by default); returns the
    results in rank order.  One device: ``fn`` runs in this process, with no
    group.  Otherwise the processes start with the ``spawn`` method (``fn``
    and ``args`` must pickle; ``fn``'s module is imported afresh in each),
    rendezvous at ``init_method`` (by default a file in a new temporary
    directory, so parallel callers never meet, nor race for a port), over
    ``backend`` (NCCL on GPUs, gloo on the CPU by default), each with
    ``threads`` torch threads (by default this process's shared out).  SIGTERM and
    SIGUSR1 sent to this process are passed to the children.  Raises when a
    child fails or dies, or when the run outlasts ``timeout`` seconds (each
    collective has the same limit); the children are stopped either way."""
    devs = [torch.device(d) for d in (devices if devices is not None else visible_devices())]
    data, model = _axis_sizes(data, model, len(devs))
    if len(devs) == 1:
        return [fn(make_mesh(data, model, devs), *args)]
    world = len(devs)
    backend = backend or backend_for(devs[0])
    scratch = None
    if init_method is None:
        scratch = tempfile.mkdtemp(prefix="lc2is_mesh_")
        init_method = f"file://{scratch}/rendezvous"
    if threads is None:
        threads = max(1, torch.get_num_threads() // world)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_child, args=(r, world, fn, args, data, model, devs, backend,
                                              init_method, timeout, threads, results),
                         daemon=True)
             for r in range(world)]
    forwarded = {}

    def forward(signum, frame):
        for p in procs:
            if p.pid is not None and p.exitcode is None:
                os.kill(p.pid, signum)

    for sig in (signal.SIGTERM, signal.SIGUSR1):
        try:
            forwarded[sig] = signal.signal(sig, forward)
        except ValueError:  # not the main thread: nothing to pass on
            pass
    out, errors = {}, []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(out) + len(errors) < world:
            try:  # drain the queue before joining: a child blocks until it is read
                rank, ok, value = results.get(timeout=0.2)
            except queue.Empty:
                pass
            else:
                if not ok:  # the others may wait on it in a collective: stop them all
                    errors.append(f"rank {rank}:\n{value}")
                    break
                out[rank] = pickle.loads(value)
                continue
            dead = [(r, p.exitcode) for r, p in enumerate(procs)
                    if p.exitcode not in (None, 0) and r not in out]
            if dead and results.empty():
                time.sleep(0.5)  # a dying child's last message may still be in flight
                if results.empty():
                    errors.append(f"ranks {dead} exited with codes (rank, code)")
                    break
            if time.monotonic() > deadline:
                errors.append(f"timed out after {timeout:.0f} s")
                break
        if errors:
            raise RuntimeError("spawned mesh run failed: " + "\n".join(errors))
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
            if p.exitcode != 0:
                raise RuntimeError(f"spawned mesh run: a child exited with {p.exitcode}")
        return [out[r] for r in range(world)]
    finally:
        for p in procs:
            if p.pid is not None and p.is_alive():
                p.terminate()
        for p in procs:
            if p.pid is not None:
                p.join(5.0)
                if p.is_alive():
                    p.kill()
                    p.join(5.0)
        results.close()
        for sig, h in forwarded.items():
            signal.signal(sig, h)
        if scratch is not None:
            shutil.rmtree(scratch, ignore_errors=True)
