"""The port's model axis (``--tp``: ``parallel/sharding.py``, ``core/mesh.py``,
``engine/optim.py``) on gloo processes (``lc2is_tpu_torch.core.mesh.spawn``,
one torch thread each; the per-rank code in ``tests/torch_tp_workers.py``,
which imports no jax) against one process and against the JAX package on a
(2, 2) CPU mesh (``make_mesh(data=2, model=2, devices=jax.devices()[:4])``):

- ``Engine`` training of ``tests/test_torch_dp.py``'s tiny ``BaseCrossA``
  with dropout 0.1 and drop path 0.2 over 7 images in global batches of 4
  and 3: on the (1, 2) mesh the logged losses at every step and the
  parameters after 3 steps equal to one process's bit for bit (the ranks of
  a model group run the same rows, and the mean of two equal gradients is
  the gradient), also with the optimizer made before the ``Engine`` (over
  the module's random initialisation, before the ``Engine`` loads the
  state); on (2, 2) within 1e-6; the ranks' parameters bit for bit;
- ``tests/test_torch_engine.py``'s 4-step run on (2, 2) against the JAX
  ``Engine`` on its (2, 2) mesh at lr 1e-5: losses and ``train_grad_norm``
  within 1e-4 relative, the step-4 evaluation within 1e-6; every rank's
  AdamW moments of exactly its shard's shape (``infer_param_specs``), every
  rank's parameters bit for bit;
- its step-2 checkpoint (whole parameters and moments, written by rank 0)
  resumed at (1, 1) in this process and at (1, 2): the state equal to the
  checkpoint bit for bit on every rank as training starts, and both runs'
  parameters at step 4 equal bit for bit;
- ``evaluate`` with the outputs kept over 10 images in batches of 4, 4 and
  2 on (2, 2): the confusion counts equal to one process's (each row
  counted once, not once a model rank), mIoU and losses within 1e-6, the
  kept outputs gathered in dataset order;
- shard and gather round trips for both specs over the model group;
- ``cli.train.main(["--device", "cpu", "--dp", "2", "--tp", "2", ...])``
  (the full-width ``base_cross_a`` at 64²) for 4 steps against ``--dp 1``
  by ``tests/test_torch_dp.py``'s rule (the loss within 1e-6, each tensor
  of the step-4 checkpoint within 1e-6 in root-mean-square), and its
  ``--resume`` from step 2: on all four ranks the state equal to the
  checkpoint bit for bit as training starts, on to step 4.

The spawned cases of a file share one test, so that under pytest-xdist's
``--dist load`` one worker runs their processes.
"""

import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import torch
import torch_dp_workers as W
import torch_tp_workers as T

from lc2is_tpu.core.mesh import make_mesh as jax_make_mesh
from lc2is_tpu.data.ade20k import SyntheticADE20K as JSyntheticADE20K
from lc2is_tpu.data.collators import ADE20KCollator as JCollator
from lc2is_tpu.data.loader import DataLoader as JLoader
from lc2is_tpu.data.transforms import Compose as JCompose
from lc2is_tpu.data.transforms import Resize as JResize
from lc2is_tpu.engine.engine import Engine as JEngine
from lc2is_tpu.models import zoo as jzoo
from lc2is_tpu_torch.cli import train as train_cli
from lc2is_tpu_torch.core.convert import params_to_state_dict
from lc2is_tpu_torch.core.mesh import spawn
from lc2is_tpu_torch.engine.checkpoint import load_checkpoint
from lc2is_tpu_torch.engine.engine import evaluate
from lc2is_tpu_torch.parallel.sharding import COLUMN, REPLICATED, ROW
from test_torch_dp import _cli_argv, _engine_state, _eval_batches

TIMEOUT = 300.0  # seconds a spawned run may take before it counts as hung
CPU4 = ["cpu"] * 4


def _jax_engine_run(params, out_dir):
    """tests/test_torch_engine.py's run on the JAX ``Engine`` over a (2, 2)
    CPU mesh (the XLA attention, the unfused loss: the functions the port
    computes)."""
    jm = jzoo.BaseCrossA(class_names=W.NAMES7, swin_cfg=dict(W.TINY_SWIN, drop_path_rate=0.0),
                         dec_dim=32, nhead=4, dropout=0.0, attn_impl="xla")
    ds = JSyntheticADE20K(length=8, img_size=W.IMG, num_classes=7,
                          transform=JCompose([JResize(W.IMG)]))
    tr = JLoader(ds, 2, JCollator(), shuffle=True, seed=3, drop_last=True)
    ev = JLoader(ds, 2, JCollator(), shuffle=False, drop_last=True)
    eng = JEngine(name="jax", model=jm, params=params,
                  mesh=jax_make_mesh(data=2, model=2, devices=jax.devices()[:4]),
                  train_loader=tr, eval_loader=ev, out_dir=out_dir, **W.RUN)
    eng.train()
    return dict(rows=W.read_log(os.path.join(eng.out_dir, "log.csv")), eval=eng.eval_metrics)


def _check_dropout_steps(ranks, one, exact, run="dropout"):
    """The mesh's dropout steps (``run``) against one process's: bit for bit
    where ``exact``, else within 1e-6; every rank's parameters bit for
    bit."""
    got, want = ranks[0][run]["rows"], one["rows"]
    assert ranks[0][run]["images"] == one["images"] == 4 + 3 + 4
    assert [r["train_step"] for r in got] == [r["train_step"] for r in want] == [1, 2, 3]
    for g, w in zip(got, want):
        for k in ("train_loss", "train_aux_loss"):
            if k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=0 if exact else 1e-6,
                                           err_msg=k)
    params = ranks[0][run]["params"]
    for k, v in one["params"].items():
        if exact:
            assert torch.equal(params[k], v), k
        else:
            np.testing.assert_allclose(params[k].numpy(), v.numpy(), rtol=0, atol=1e-6,
                                       err_msg=k)
    for r in ranks[1:]:
        assert all(torch.equal(params[k], r[run]["params"][k]) for k in params)


def _check_engine(ranks, want):
    """The (2, 2) engine run against JAX's, and its moments' shapes."""
    got = ranks[0]["engine"]
    assert [r["train_step"] for r in got["rows"]] == [r["train_step"] for r in want["rows"]] \
        == [1, 2, 3, 4]
    for g, w in zip(got["rows"], want["rows"]):
        for k in ("train_loss", "train_grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
    for k in ("eval_loss", "eval_mIOU_label", "eval_mIOU_dataset"):
        np.testing.assert_allclose(got["eval"][k], want["eval"][k], atol=1e-6, err_msg=k)
    assert all(r["engine"]["rows"] is None for r in ranks[1:])  # rank 0 alone logs
    specs = got["specs"]
    assert {COLUMN, ROW} <= set(specs.values())
    for r in ranks:
        model_index = r["coords"][2]
        for name, (whole, mu, nu) in r["engine"]["moments"].items():
            spec = specs[name]
            share = list(whole)
            if spec != REPLICATED:
                d = spec.index("model")
                share[d] //= 2
            assert mu == nu == tuple(share), (name, spec, whole, mu, model_index)
    first = ranks[0]["engine"]["params"]  # every rank stepped on the same reduced gradient
    for r in ranks[1:]:
        assert all(torch.equal(first[k], r["engine"]["params"][k]) for k in first)


def _check_evaluate(ranks, state):
    """Each row counted once: the counts exact (the dataset mIoU), mIoU and
    losses within 1e-6, the kept outputs in dataset order on every rank."""
    model = W.tiny_model()
    model.load_state_dict(state)
    want = evaluate(model, _eval_batches(), num_classes=7, keep_eval_outputs=True,
                    compute_metrics=W.kept_outputs)
    for r in ranks:
        for source in ("loader", "given"):
            got = r["eval"][source]
            assert set(got) == set(want)
            assert got["eval_mIOU_dataset"] == want["eval_mIOU_dataset"]
            for k in ("eval_loss", "eval_mIOU_label"):
                np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
            assert got["eval_n"] == want["eval_n"] == 10
            np.testing.assert_array_equal(got["eval_labels"], want["eval_labels"])
            np.testing.assert_allclose(got["eval_outputs"], want["eval_outputs"], rtol=0,
                                       atol=1e-5)


def _check_round_trips(ranks, whole):
    for r in ranks:
        m = 2
        for (name, label), (equal, shape) in r["round_trip"].items():
            assert equal, (name, label)
            want = list(whole[name].shape)
            if label != "replicated":
                want[0 if label == "column" else 1] //= m
            assert shape == tuple(want), (name, label, shape)


def test_model_axis_against_one_process_and_the_jax_mesh(tmp_path):
    """(2, 2) and (1, 2) runs of every case, then each case's checks: one
    test, so that one xdist worker runs the processes and the JAX compiles
    once."""
    state = params_to_state_dict(_engine_state())
    rs = np.random.RandomState(0)
    whole = {"w": torch.from_numpy(rs.randn(8, 6).astype(np.float32)),
             "e": torch.from_numpy(rs.randn(4, 12).astype(np.float32))}
    port = str(tmp_path / "port")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # this process's products summed in the ranks' order
    try:
        _model_axis_runs(tmp_path, state, whole, port)
    finally:
        torch.set_num_threads(threads)


def _model_axis_runs(tmp_path, state, whole, port):
    with ThreadPoolExecutor(3) as pool:
        mesh22 = pool.submit(spawn, T.tp_runs, (state, _eval_batches(), whole, port),
                             data=2, model=2, devices=CPU4,
                             init_method=f"file://{tmp_path}/rendezvous22", timeout=TIMEOUT,
                             threads=1)
        jax_engine = pool.submit(_jax_engine_run, _engine_state(), str(tmp_path / "jax"))
        one = W.dropout_run(None, state, str(tmp_path / "one"))
        mesh22, jax_engine = mesh22.result(), jax_engine.result()
    checkpoint = os.path.join(port, "engine", "engine", "checkpoints", "step-2.pth")
    mesh12 = spawn(T.tp_runs_12, (state, checkpoint, str(tmp_path / "port12")), data=1,
                   model=2, devices=CPU4[:2], init_method=f"file://{tmp_path}/rendezvous12",
                   timeout=TIMEOUT, threads=1)
    alone = T.resumed_run(None, checkpoint, str(tmp_path / "alone"))
    assert [r["coords"] for r in mesh22] == [(0, 0, 0), (1, 0, 1), (2, 1, 0), (3, 1, 1)]
    assert [r["coords"] for r in mesh12] == [(0, 0, 0), (1, 0, 1)]
    _check_dropout_steps(mesh12, one, exact=True)
    _check_dropout_steps(mesh12, one, exact=True, run="given")
    _check_dropout_steps(mesh22, one, exact=False)
    _check_engine(mesh22, jax_engine)
    _check_evaluate(mesh22, state)
    _check_round_trips(mesh22, whole)
    ckpt, _ = load_checkpoint(checkpoint)
    assert {k: tuple(v.shape) for k, v in ckpt["model"].items()} == \
        {k: tuple(v.shape) for k, v in state.items()}  # whole parameters
    for got in [alone] + [r["resumed"] for r in mesh12]:
        assert (got["start"], got["end"], got["same"]) == (2, 4, dict(model=True,
                                                                      optimizer=True))
        assert all(torch.equal(got["params"][k], v) for k, v in alone["params"].items())


def test_cli_dp2_tp2_trains_and_resumes(tmp_path):
    """4 steps of ``--dp 2 --tp 2`` against ``--dp 1`` (each checkpoint
    tensor within 1e-6 in root-mean-square), then ``--dp 2 --tp 2 --resume``
    from the straight run's step 2: on all four ranks the model and optimizer
    state equal to the checkpoint bit for bit as training starts, on to step
    4.  Each checkpoint is 0.47 GB: each goes once it has been read."""
    out = str(tmp_path)
    ckpts = {n: os.path.join(out, n, "checkpoints") for n in ("tp", "dp1", "resumed")}
    tp = ["--tp", "2"]
    try:
        with ThreadPoolExecutor(2) as pool:  # the four processes and this one at once
            got = pool.submit(train_cli.main, _cli_argv(out, "tp", 2, 4, 2, tp))
            want = train_cli.main(_cli_argv(out, "dp1", 1, 4, 4))
            got = got.result()
        np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=0, atol=1e-6)
        a, _ = load_checkpoint(os.path.join(ckpts["tp"], "step-4.pth"))
        b, _ = load_checkpoint(os.path.join(ckpts["dp1"], "step-4.pth"))
        shutil.rmtree(ckpts["dp1"])
        assert a["model"].keys() == b["model"].keys()
        for k, v in b["model"].items():  # root-mean-square difference of each tensor
            assert a["model"][k].shape == v.shape, k
            assert (a["model"][k] - v).pow(2).mean().sqrt() <= 1e-6, k
        assert a["optimizer"]["adamw"]["state"].keys() == b["optimizer"]["adamw"]["state"].keys()
        for i, entry in b["optimizer"]["adamw"]["state"].items():  # whole moments
            assert a["optimizer"]["adamw"]["state"][i]["exp_avg"].shape == entry["exp_avg"].shape
        del a, b
        os.makedirs(ckpts["resumed"])
        for f in ("step-2.pth", "step-2.json"):
            shutil.move(os.path.join(ckpts["tp"], f), ckpts["resumed"])
        shutil.rmtree(ckpts["tp"])
        seen = spawn(W.resumed_state, (_cli_argv(out, "resumed", 2, 4, 2, ["--resume"] + tp),
                                       os.path.join(ckpts["resumed"], "step-2.pth")),
                     data=2, model=2, devices=CPU4, init_method=f"file://{tmp_path}/rendezvous",
                     timeout=TIMEOUT, threads=1)
        assert seen == [dict(start=2, model=True, optimizer=True, end=4)] * 4
        assert os.path.exists(os.path.join(ckpts["resumed"], "step-4.pth"))
    finally:
        for d in ckpts.values():
            shutil.rmtree(d, ignore_errors=True)
