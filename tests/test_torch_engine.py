"""The port's ``Engine`` (``lc2is_tpu_torch/engine/engine.py``) against the JAX
package's on a tiny ``BaseCrossA`` (dropout 0, drop path 0, as
``tests/test_torch_v4_train.py`` sets them), the same parameters, over the
same synthetic loader (the port's copy of the data modules, which
``tests/test_torch_data.py`` holds to JAX's item for item).  JAX runs on a
one-device CPU mesh, its loss through the unfused path (``attn_impl="xla"``:
the x4 map and the plain CE, the same function as the port's fused
upsample-CE).  The learning rate is the engine's default, 1e-5: at 1e-3,
Adam's first updates of gradients that are zero in exact arithmetic (the swin
key biases) take the sign of each package's float noise, and the two runs
part by 2e-4 in the gradient norm within three steps.

Stated tolerances: the logged losses at every step within 1e-4 relative,
``train_grad_norm`` within 1e-4 relative, the evaluation's metrics within
1e-6.  The port alone: the step count and the cadences (the reference's
``max(steps_in_epoch · max_epoch, max_steps)`` and ``exact_steps``) as the
JAX engine computes them; a run resumed after 2 steps and trained 2 more
equal to 4 straight steps bit for bit (the loader resumed at its epoch);
SIGUSR1 raised while the loader reads a batch: that step runs, is
checkpointed, and the run stops.
"""

import csv
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import TINY_SWIN, numpy_params

from lc2is_tpu.core.mesh import make_mesh
from lc2is_tpu.data.ade20k import SyntheticADE20K as JSyntheticADE20K
from lc2is_tpu.data.collators import ADE20KCollator as JCollator
from lc2is_tpu.data.loader import DataLoader as JLoader
from lc2is_tpu.data.transforms import Compose as JCompose
from lc2is_tpu.data.transforms import Resize as JResize
from lc2is_tpu.engine.engine import Engine as JEngine
from lc2is_tpu.models import zoo as jzoo
from lc2is_tpu_torch.core.convert import params_to_state_dict
from lc2is_tpu_torch.data.ade20k import SyntheticADE20K
from lc2is_tpu_torch.data.collators import ADE20KCollator
from lc2is_tpu_torch.data.loader import DataLoader
from lc2is_tpu_torch.data.transforms import Compose, Resize
from lc2is_tpu_torch.engine.checkpoint import latest_checkpoint, load_checkpoint
from lc2is_tpu_torch.engine.engine import Engine
from lc2is_tpu_torch.models import zoo

NAMES7 = tuple(f"c{i}" for i in range(7))
SWIN = dict(TINY_SWIN, drop_path_rate=0.0)
IMG = 64
RUN = dict(max_steps=4, exact_steps=True, log_step=1, eval_step=4, save_step=2,
           num_classes=7, seed=5, watch_grads=True, logger="csv", progress=False)


def _loaders(n=8, batch=2, port=True):
    ds_cls, comp, res, coll, dl = ((SyntheticADE20K, Compose, Resize, ADE20KCollator, DataLoader)
                                   if port else
                                   (JSyntheticADE20K, JCompose, JResize, JCollator, JLoader))
    ds = ds_cls(length=n, img_size=IMG, num_classes=7, transform=comp([res(IMG)]))
    return (dl(ds, batch, coll(), shuffle=True, seed=3, drop_last=True),
            dl(ds, batch, coll(), shuffle=False, drop_last=True))


def _mesh():
    return make_mesh(data=1, devices=jax.devices()[:1])


def _port_model():
    return zoo.BaseCrossA(class_names=NAMES7, swin_cfg=SWIN, dec_dim=32, nhead=4, device="cpu")


@pytest.fixture(scope="module")
def params():
    jm = jzoo.BaseCrossA(class_names=NAMES7, swin_cfg=SWIN, dec_dim=32, nhead=4, dropout=0.0,
                         attn_impl="xla")
    return jm, numpy_params(jm, {"pixel_values": jnp.zeros((1, 3, IMG, IMG), jnp.float32)})


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def runs(params, tmp_path_factory):
    """(JAX rows, port rows, JAX engine, port engine) of the same 4-step run."""
    jm, p = params
    out = tmp_path_factory.mktemp("engines")
    tr, ev = _loaders(port=False)
    jeng = JEngine(name="jax", model=jm, params=p, mesh=_mesh(), train_loader=tr,
                   eval_loader=ev, out_dir=str(out), **RUN)
    jeng.train()
    tr, ev = _loaders()
    peng = Engine(name="port", model=_port_model(), params=params_to_state_dict(p), device="cpu",
                  train_loader=tr, eval_loader=ev, out_dir=str(out), **RUN)
    peng.train()
    return (_rows(os.path.join(jeng.out_dir, "log.csv")),
            _rows(os.path.join(peng.out_dir, "log.csv")), jeng, peng)


def test_losses_and_grad_norm_every_step(runs):
    jrows, prows, _, _ = runs
    steps = [[float(r["train_step"]) for r in rows] for rows in (prows, jrows)]
    assert steps[0] == steps[1] == [1, 2, 3, 4]
    for jr, pr in zip(jrows, prows):
        for k in ("train_loss", "train_grad_norm"):
            np.testing.assert_allclose(float(pr[k]), float(jr[k]), rtol=1e-4, err_msg=k)


def test_eval_metrics(runs):
    *_, jeng, peng = runs
    for k in ("eval_loss", "eval_mIOU_label", "eval_mIOU_dataset"):
        np.testing.assert_allclose(peng.eval_metrics[k], jeng.eval_metrics[k], atol=1e-6,
                                   err_msg=k)


def test_checkpoints_of_the_run(runs):
    *_, peng = runs
    d = os.path.join(peng.out_dir, "checkpoints")
    assert sorted(os.listdir(d)) == ["step-2.json", "step-2.pth", "step-4.json", "step-4.pth"]
    state, meta = load_checkpoint(latest_checkpoint(d))
    assert meta == {"step": 4} and state["optimizer"]["count"] == 4
    assert all(torch.equal(state["model"][k], v) for k, v in peng.model.state_dict().items())


@pytest.mark.parametrize("n,batch,max_epoch,max_steps,exact,eval_step,log_step,save_step", [
    (8, 2, 1, None, False, None, None, None),  # defaults: 10 epochs, 1 epoch, 10 epochs
    (8, 2, 3, 5, False, 3, None, 7),  # the quirk: max(4 x 3, 5) = 12
    (8, 2, 3, 5, True, None, 2, None),  # exact_steps: 5
])
def test_step_count_and_cadences(params, tmp_path, n, batch, max_epoch, max_steps, exact,
                                 eval_step, log_step, save_step):
    jm, p = params
    kw = dict(max_epoch=max_epoch, max_steps=max_steps, exact_steps=exact, eval_step=eval_step,
              log_step=log_step, save_step=save_step, out_dir=str(tmp_path), logger="null")
    jeng = JEngine(name="j", model=jm, params=p, mesh=_mesh(),
                   train_loader=_loaders(n, batch, port=False)[0], **kw)
    peng = Engine(name="p", model=_port_model(), params=params_to_state_dict(p), device="cpu",
                  train_loader=_loaders(n, batch)[0], **kw)
    fields = ("steps_in_epoch", "train_steps", "eval_step", "log_step", "save_step")
    assert [getattr(peng, f) for f in fields] == [getattr(jeng, f) for f in fields]


def _state(engine):
    return ({k: v.clone() for k, v in engine.model.state_dict().items()},
            engine.optimizer.state_dict())


def test_resume_equals_straight_run(params, tmp_path):
    """4 steps over 2 epochs of 2 batches, against 2 steps, a checkpoint, a
    fresh engine resumed from it and 2 more steps: the same parameters,
    optimizer state and losses, bit for bit."""
    p = params_to_state_dict(params[1])
    kw = dict(device="cpu", lr=1e-3, num_classes=7, seed=5, logger="null", progress=False,
              out_dir=str(tmp_path), exact_steps=True, eval_step=10 ** 6, log_step=1)
    straight = Engine(name="a", model=_port_model(), params=p, train_loader=_loaders(4)[0],
                      max_steps=4, save_step=10 ** 6, **kw)
    straight.train()
    first = Engine(name="b", model=_port_model(), params=p, train_loader=_loaders(4)[0],
                   max_steps=2, save_step=2, **kw)
    first.train()
    resumed = Engine(name="b", model=_port_model(), params=p, train_loader=_loaders(4)[0],
                     max_steps=4, save_step=10 ** 6, **kw)
    assert resumed.resume() == 2
    resumed.train()
    assert resumed.train_step_count == 4
    (ms, os_), (mr, or_) = _state(straight), _state(resumed)
    assert all(torch.equal(ms[k], mr[k]) for k in ms)
    assert os_["count"] == or_["count"] == 4
    sa, sb = os_["adamw"]["state"], or_["adamw"]["state"]
    assert all(torch.equal(sa[i][n], sb[i][n]) for i in sa for n in sa[i])


class _SignalAt:
    """A dataset that sends this process SIGUSR1 while item ``at`` is read."""

    def __init__(self, ds, at):
        self.ds, self.at = ds, at

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        if i == self.at:
            os.kill(os.getpid(), signal.SIGUSR1)
        return self.ds[i]


def test_sigusr1_checkpoints_and_stops(params, tmp_path):
    ds = SyntheticADE20K(length=8, img_size=IMG, num_classes=7, transform=Compose([Resize(IMG)]))
    loader = DataLoader(_SignalAt(ds, 4), 2, ADE20KCollator(), drop_last=True)  # 3rd batch
    before = signal.getsignal(signal.SIGUSR1)
    eng = Engine(name="pre", model=_port_model(), params=params_to_state_dict(params[1]),
                 device="cpu", train_loader=loader, max_steps=8, exact_steps=True,
                 log_step=10 ** 6, eval_step=10 ** 6, save_step=10 ** 6, out_dir=str(tmp_path),
                 logger="null", progress=False)
    eng.train()
    assert eng.train_step_count == 3
    assert latest_checkpoint(os.path.join(eng.out_dir, "checkpoints")).endswith("step-3.pth")
    assert signal.getsignal(signal.SIGUSR1) is before  # the handler is train()'s only
