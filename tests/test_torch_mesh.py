"""``lc2is_tpu_torch/core/mesh.py`` (the data axis as a process group) and the
loader's rank rows:

- ``make_mesh``'s sizes and refusals against ``lc2is_tpu.core.mesh.make_mesh``
  (``data · model`` equal to the device count, ``data=-1`` every device over
  the model axis); a mesh with a model axis sized as JAX's, and refused
  outside a group as any mesh of several devices; one device builds no
  group, more outside a group raise;
- ``shard_batch`` against the JAX engine's ``_put_batch`` on CPU meshes of
  1, 2, 4 and 8 devices: the same rows on each device where the batch
  divides, the whole batch (replicated) where it does not;
- ``RowDraws``: the ranks' draws are the rows of the one-process draw, so
  dropout and drop path draw the global batch's masks;
- the loader built with a mesh: each rank's rows concatenated rebuild every
  global batch (an indivisible last one whole on every rank), ``len`` and
  the order the global ones;
- the collectives and ``shard_batch`` on three gloo processes (``spawn``),
  and a rank that raises, exits or hangs failing the parent within its
  time limit;
- a preemption signal on one rank stopping every rank after the same step
  (rank 0 checkpoints), and SIGUSR1 sent to the spawning process passed on
  to every rank.
"""

import os
import signal
import threading
import time

import jax
import numpy as np
import pytest
import torch
import torch_dp_workers as W

from lc2is_tpu.core.mesh import make_mesh as jax_make_mesh
from lc2is_tpu.engine.engine import Engine as JEngine
from lc2is_tpu_torch.core import mesh as M
from lc2is_tpu_torch.nn.swin import drop_path
from lc2is_tpu_torch.ops.attention import dropout

CPU2 = ["cpu", "cpu"]


@pytest.mark.parametrize("data,model,n", [(-1, 1, 1), (-1, 1, 2), (2, 1, 2), (-1, 1, 8),
                                          (4, 1, 4), (3, 1, 2), (2, 1, 4), (0, 1, 2),
                                          (-1, 2, 4), (2, 2, 4), (1, 4, 4), (-1, 2, 8),
                                          (4, 2, 8), (-1, 3, 4), (2, 2, 8)])
def test_mesh_sizes_match_jax(data, model, n):
    try:
        want = dict(jax_make_mesh(data=data, model=model, devices=jax.devices()[:n]).shape)
    except AssertionError:
        with pytest.raises(ValueError, match="devices"):
            M._axis_sizes(data, model, n)
        return
    got = M._axis_sizes(data, model, n)
    assert {M.DATA_AXIS: got[0], M.MODEL_AXIS: got[1]} == want


def test_model_axis_names_the_tp_item():
    """The model axis is taken as JAX takes it; a (2, 2) mesh of four
    devices needs four processes, as any mesh of several devices."""
    want = jax_make_mesh(data=2, model=2, devices=jax.devices()[:4])
    assert dict(want.shape) == {M.DATA_AXIS: 2, M.MODEL_AXIS: 2}
    assert M._axis_sizes(2, 2, 4) == (2, 2)
    with pytest.raises(RuntimeError, match="one process a device"):
        M.make_mesh(data=2, model=2, devices=["cpu"] * 4)


def test_one_device_builds_no_group():
    mesh = M.make_mesh(devices=["cpu"])
    assert (mesh.data, mesh.model, mesh.rank, mesh.device, mesh.group) == (
        1, 1, 0, torch.device("cpu"), None)
    assert mesh.shape == {"data": 1, "model": 1} and mesh.is_main
    t = torch.ones(3)
    assert M.all_reduce_sum(mesh, t) is t and M.any_rank(mesh, False) is False
    (rows,) = M.spawn(W.rows_of, (6,), devices=["cpu"])  # in this process
    np.testing.assert_array_equal(rows, np.arange(6))


def test_one_device_mesh_engine_is_the_plain_engine(tmp_path):
    """A mesh of one device: the Engine's steps and evaluation are the
    single-device ones bit for bit (the CPU's step is deterministic)."""
    model = W.tiny_model()
    torch.manual_seed(0)
    state = {k: torch.randn_like(v) * 0.1 for k, v in model.state_dict().items()}
    got = W.engine_run(M.make_mesh(devices=["cpu"]), state, str(tmp_path / "mesh"))
    want = W.engine_run(None, state, str(tmp_path / "plain"))
    assert got["rows"] == want["rows"] and got["eval"] == want["eval"]
    assert all(torch.equal(got["params"][k], v) for k, v in want["params"].items())


def test_many_devices_outside_a_group_raise(monkeypatch):
    for k in M.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="one process a device"):
        M.make_mesh(data=2, devices=CPU2)


def _rank_meshes(n):
    """Each rank's mesh of a data axis of ``n`` (no group: the row
    arithmetic alone)."""
    return [M.Mesh(n, 1, r, torch.device("cpu")) for r in range(n)]


@pytest.mark.parametrize("n,total", [(1, 4), (2, 4), (2, 3), (4, 8), (4, 6), (8, 8), (8, 4)])
def test_shard_batch_matches_put_batch(n, total):
    jmesh = jax_make_mesh(data=n, devices=jax.devices()[:n])
    batch = {"x": np.arange(total * 3, dtype=np.float32).reshape(total, 3),
             "label": np.arange(total, dtype=np.int32)}
    placed = JEngine._put_batch(type("E", (), {"mesh": jmesh})(), batch)
    shards = sorted(placed["x"].addressable_shards,
                    key=lambda s: list(jmesh.devices.flat).index(s.device))
    for mesh, shard in zip(_rank_meshes(n), shards):
        got = M.shard_batch(mesh, batch)
        np.testing.assert_array_equal(got["x"], np.asarray(shard.data))
        rows = M.batch_rows(mesh, total)
        assert rows.split == (not placed["x"].sharding.is_fully_replicated)
        np.testing.assert_array_equal(got["label"], batch["label"][rows.start:rows.stop])


def test_unpack_batch_cuts_a_global_batch_once():
    metas = [{"i": i} for i in range(4)]
    data = ({"pixel_values": torch.arange(4.0), "label": np.arange(4)}, metas)
    mesh = _rank_meshes(2)[1]
    inputs, got_metas, rows = M.unpack_batch(mesh, data)
    assert rows == M.Rows(2, 4, 4) and got_metas == metas[2:]
    assert inputs["pixel_values"].tolist() == [2.0, 3.0]
    tagged = M.tag_rows(({k: v for k, v in inputs.items()}, got_metas), rows)
    again = M.unpack_batch(mesh, tagged)  # already this rank's rows: as it is
    assert again[2] == rows and again[0]["pixel_values"].tolist() == [2.0, 3.0]
    assert M.unpack_batch(None, data)[2] == M.Rows(0, 4, 4)


@pytest.mark.parametrize("shape", [(6,), (6, 5, 7)])
def test_row_draws_are_the_global_draws(shape):
    want = torch.rand(shape, generator=torch.Generator().manual_seed(3))
    x = torch.ones(shape)
    for n in (2, 3):
        parts, masks = [], []
        for r in range(n):
            rows = M.batch_rows(_rank_meshes(n)[r], shape[0])
            g = M.RowDraws(torch.Generator().manual_seed(3), rows)
            parts.append(M.uniform((rows.stop - rows.start,) + shape[1:], g, "cpu"))
            g = M.RowDraws(torch.Generator().manual_seed(3), rows)
            masks.append(dropout(x[rows.start:rows.stop], 0.5, g))
        assert torch.equal(torch.cat(parts), want)
        assert torch.equal(torch.cat(masks), dropout(x, 0.5, torch.Generator().manual_seed(3)))
    # a draw of another leading size (a replicated tensor) is made as it is
    g = M.RowDraws(torch.Generator().manual_seed(3), M.Rows(0, 3, 6))
    assert torch.equal(M.uniform((4,), g, "cpu"),
                       torch.rand(4, generator=torch.Generator().manual_seed(3)))


def test_drop_path_draws_the_global_batch():
    x = torch.randn(4, 3, 2, generator=torch.Generator().manual_seed(0))
    want = drop_path(x, 0.5, torch.Generator().manual_seed(9))
    got = [drop_path(x[2 * r:2 * r + 2], 0.5,
                     M.RowDraws(torch.Generator().manual_seed(9), M.Rows(2 * r, 2 * r + 2, 4)))
           for r in range(2)]
    assert torch.equal(torch.cat(got), want)


@pytest.mark.parametrize("n,batch,drop_last,workers", [(2, 4, False, 0), (2, 4, True, 2),
                                                       (4, 4, False, 2)])
def test_loader_rank_rows_rebuild_the_global_batches(n, batch, drop_last, workers):
    """10 images: batches of 4, 4 and 2 (a world of 4: the last one whole on
    every rank), shuffled by seed and epoch."""
    def loader(mesh):
        dl = W.DataLoader(W.dataset(10), batch, W.ADE20KCollator(), shuffle=True, seed=3,
                          drop_last=drop_last, num_workers=workers, mesh=mesh)
        dl.set_epoch(1)
        return dl

    want = list(loader(None))
    ranks = [loader(m) for m in _rank_meshes(n)]
    assert {len(dl) for dl in ranks} == {len(loader(None))} == {len(want)}
    got = [list(dl) for dl in ranks]
    for i, (inputs, metas) in enumerate(want):
        total = len(inputs["label"])
        parts = [g[i] for g in got]
        rows = [p[0][M.ROWS_KEY] for p in parts]
        assert all(r.total == total for r in rows)
        if total % n:  # whole on every rank
            assert all(not r.split for r in rows)
            for p in parts:
                np.testing.assert_array_equal(p[0]["pixel_values"], inputs["pixel_values"])
        else:
            for k in ("pixel_values", "label"):
                np.testing.assert_array_equal(np.concatenate([p[0][k] for p in parts]),
                                              inputs[k])
            assert [m["size"] for p in parts for m in p[1]] == [m["size"] for m in metas]


def test_collectives_on_three_processes(tmp_path):
    out = M.spawn(W.collectives, data=3, devices=["cpu"] * 3,
                  init_method=f"file://{tmp_path}/rdv", timeout=120, threads=1)
    for r, o in enumerate(out):
        assert o["mesh"] == (3, 1, r, "cpu", {"data": 3, "model": 1})
        assert o["sum"].tolist() == [6.0, 30.0]
        assert [g.tolist() for g in o["grads"]] == [[2.0] * 3, [[2.0] * 4] * 2, [4.0]]
        assert o["rows"].tolist() == list(range(9))
        assert o["shard"].tolist() == [3 * r, 3 * r + 1, 3 * r + 2]  # shard_batch of 9 rows
        assert o["any"] is True and o["none"] is False
        assert o["objects"] == [{"rank": 0}, {"rank": 1}, {"rank": 2}]
        assert o["broadcast"] == "from 0"
        assert o["weight"].tolist() == [[0.0, 0.0]] * 2 and o["bias"].tolist() == [0.5, 0.5]


@pytest.mark.parametrize("how", ["raise", "exit", "hang"])
def test_a_failed_or_hung_rank_fails_the_parent(tmp_path, how):
    with pytest.raises(RuntimeError, match="spawned mesh run"):
        M.spawn(W.fail_on_rank_1, (how,), data=2, devices=CPU2,
                init_method=f"file://{tmp_path}/rdv", timeout=6, threads=1)


def test_preemption_on_one_rank_stops_every_rank(tmp_path):
    """SIGUSR1 on rank 1 alone (while it loads the 3rd batch): both ranks
    stop after step 3, and rank 0 writes the one checkpoint."""
    model = W.tiny_model()
    torch.manual_seed(0)
    state = {k: torch.randn_like(v) * 0.1 for k, v in model.state_dict().items()}
    out = M.spawn(W.preempted_run, (state, str(tmp_path / "run")), data=2, devices=CPU2,
                  init_method=f"file://{tmp_path}/rdv", timeout=120, threads=1)
    assert out == [(3, ["step-3.json", "step-3.pth"])] * 2


def test_the_parent_passes_signals_on(tmp_path):
    """SIGUSR1 sent to the spawning process reaches every rank."""
    ready = tmp_path / "ready"
    ready.mkdir()

    def send():
        deadline = time.monotonic() + 60
        while len(os.listdir(ready)) < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        os.kill(os.getpid(), signal.SIGUSR1)

    before = signal.getsignal(signal.SIGUSR1)
    sender = threading.Thread(target=send)
    sender.start()
    try:
        out = M.spawn(W.signalled, (str(ready),), data=2, devices=CPU2,
                      init_method=f"file://{tmp_path}/rdv", timeout=120, threads=1)
    finally:
        sender.join(70)
    assert not sender.is_alive()
    assert out == [True, True]
    assert signal.getsignal(signal.SIGUSR1) is before  # spawn's forwarding is its own
