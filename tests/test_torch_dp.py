"""The port's data-parallel training and evaluation on two gloo processes
(``lc2is_tpu_torch.core.mesh.spawn``, one torch thread each; the per-rank
code in ``tests/torch_dp_workers.py``, which imports no jax) against the
same runs in one process and against the JAX package on a two-device CPU
mesh (``make_mesh(data=2, devices=jax.devices()[:2])``):

- ``Engine`` training with dropout 0.1 and drop path 0.2 over 7 images in
  global batches of 4 (the last, 3, does not divide by two ranks and runs
  whole on each): the logged losses at every step and the parameters after
  3 steps within 1e-6 of the one-process run on the global batches, the two
  ranks' parameters equal bit for bit, the global image count;
- ``tests/test_torch_engine.py``'s 4-step run (no dropout) against the JAX
  ``Engine`` on the two-device mesh at lr 1e-5: losses and
  ``train_grad_norm`` at every step within 1e-4 relative, the step-4
  evaluation within 1e-6;
- ``evaluate`` with the outputs kept, over 10 images in batches of 4, 4
  and 2 (a loader built with the mesh, and the global batches cut on each
  rank): the confusion counts equal to one process's (the dataset mIoU),
  mIoU and losses within 1e-6, the kept outputs gathered in dataset order;
- ``dp_sliding_miou`` of ``tests/test_sliding_utils.py:99-136``'s tiny
  ``PromptCrossA`` on 4 images against JAX's ``dp_sliding_miou``, rtol 2e-5;
- ``cli.train.main(["--device", "cpu", "--dp", "2", ...])`` (the
  full-width ``base_cross_a`` at 64²) for 4 steps against ``--dp 1``: the
  loss within 1e-6, each tensor of the step-4 checkpoint within 1e-6 in
  root-mean-square (elementwise does not hold: AdamW makes a whole step of a
  gradient that rounding dominates, and single swin weights part by up to
  3.7e-6 at lr 1e-5 from run to run), and ``--dp 2 --resume`` from its
  step-2 checkpoint: each rank's model and optimizer state equal to the
  checkpoint bit for bit as training starts (as ``chip_smoke.py`` phase 15b
  checks; the drop-path generator restarts from the seed, as in JAX), on to
  step 4.

Every spawned run has its own time limit; a hung or failed rank fails the
test (``tests/test_torch_mesh.py`` shows it).  The two-rank cases share one
test, so that under pytest-xdist's ``--dist load`` one worker runs their
processes and the JAX compiles.
"""

import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dp_workers as W
from torch_port_util import numpy_params

from lc2is_tpu.core.mesh import make_mesh as jax_make_mesh
from lc2is_tpu.data.ade20k import SyntheticADE20K as JSyntheticADE20K
from lc2is_tpu.data.collators import ADE20KCollator as JCollator
from lc2is_tpu.data.loader import DataLoader as JLoader
from lc2is_tpu.data.transforms import Compose as JCompose
from lc2is_tpu.data.transforms import Resize as JResize
from lc2is_tpu.engine.engine import Engine as JEngine
from lc2is_tpu.engine.sliding import dp_sliding_miou as jax_dp_sliding_miou
from lc2is_tpu.engine.sliding import multi_scale_sliding_eval as jax_multi_scale
from lc2is_tpu.metrics.miou import per_image_miou as jax_per_image_miou
from lc2is_tpu.models import zoo as jzoo
from lc2is_tpu_torch.cli import train as train_cli
from lc2is_tpu_torch.core.convert import params_to_state_dict
from lc2is_tpu_torch.core.mesh import spawn
from lc2is_tpu_torch.engine.checkpoint import load_checkpoint
from lc2is_tpu_torch.engine.engine import evaluate

TIMEOUT = 240.0  # seconds a two-rank run may take before it counts as hung
NEAR_TIE = 1e-5  # tests/test_torch_eval.py's: the two best classes this close
CPU2 = ["cpu", "cpu"]


def _jax_engine_run(params, out_dir):
    """tests/test_torch_engine.py's run on the JAX ``Engine`` over two CPU
    devices (the XLA attention, the unfused loss: the functions the port
    computes)."""
    jm = jzoo.BaseCrossA(class_names=W.NAMES7, swin_cfg=dict(W.TINY_SWIN, drop_path_rate=0.0),
                         dec_dim=32, nhead=4, dropout=0.0, attn_impl="xla")
    ds = JSyntheticADE20K(length=8, img_size=W.IMG, num_classes=7,
                          transform=JCompose([JResize(W.IMG)]))
    tr = JLoader(ds, 2, JCollator(), shuffle=True, seed=3, drop_last=True)
    ev = JLoader(ds, 2, JCollator(), shuffle=False, drop_last=True)
    eng = JEngine(name="jax", model=jm, params=params,
                  mesh=jax_make_mesh(data=2, devices=jax.devices()[:2]), train_loader=tr,
                  eval_loader=ev, out_dir=out_dir, **W.RUN)
    eng.train()
    return dict(rows=W.read_log(os.path.join(eng.out_dir, "log.csv")), eval=eng.eval_metrics)


def _slide_model():
    """tests/test_sliding_utils.py:99-136's tiny PromptCrossA."""
    cfg = dict(
        text_encoder=dict(context_length=8, vocab_size=49408, transformer_width=512,
                          transformer_heads=8, transformer_layers=1, embed_dim=512),
        context_decoder=dict(transformer_width=64, transformer_heads=4, transformer_layers=1),
        context_length=4,
        text_dim=512,
    )
    return jzoo.PromptCrossA(class_names=("wall", "sky", "tree", "road"), cfg=cfg,
                             swin_cfg=W.TINY_SWIN, dropout=0.0)


def _apply(model):
    return lambda p, x: model.apply(p, {"pixel_values": x})["outputs"]


def _jax_probs(model, params, images):
    """The single-device probabilities of JAX's ``multi_scale_sliding_eval``."""
    kw = {k: v for k, v in W.SLIDE.items() if k != "num_classes"}
    apply_fn = _apply(model)
    return np.asarray(jax.jit(lambda p, x: jax_multi_scale(lambda t: apply_fn(p, t), x, **kw))(
        params, jnp.asarray(images)))


def _jax_dp_sliding(model, params, images, labels):
    """JAX ``dp_sliding_miou`` on two devices."""
    return float(jax_dp_sliding_miou(_apply(model), params, jnp.asarray(images),
                                     jnp.asarray(labels),
                                     jax_make_mesh(data=2, devices=jax.devices()[:2]), **W.SLIDE))


def _eval_batches():
    """The eval run's 10 images as global batches of 4, 4 and 2."""
    _, ev = W.loaders(n=10, batch=4, drop_last=False)
    return list(ev)


def _engine_state():
    jm = jzoo.BaseCrossA(class_names=W.NAMES7, swin_cfg=dict(W.TINY_SWIN, drop_path_rate=0.0),
                         dec_dim=32, nhead=4, dropout=0.0, attn_impl="xla")
    return numpy_params(jm, {"pixel_values": jnp.zeros((1, 3, W.IMG, W.IMG), jnp.float32)})


def _check_dropout_steps(dp, one):
    """Dropout and drop-path masks drawn for the global batch: the two-rank
    steps are the one-process steps (``one``) on the global batches; the
    ranks' parameters equal bit for bit."""
    got, want = dp[0]["dropout"]["rows"], one["rows"]
    assert dp[0]["dropout"]["images"] == one["images"] == 4 + 3 + 4
    assert [r["train_step"] for r in got] == [r["train_step"] for r in want] == [1, 2, 3]
    for g, w in zip(got, want):
        for k in ("train_loss", "train_aux_loss"):
            if k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-6, err_msg=k)
    for k, v in one["params"].items():
        np.testing.assert_allclose(dp[0]["dropout"]["params"][k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)
    a, b = (r["dropout"]["params"] for r in dp)
    assert all(torch.equal(a[k], b[k]) for k in a)


def _check_engine_against_jax(dp, want):
    got = dp[0]["engine"]
    assert [r["train_step"] for r in got["rows"]] == [r["train_step"] for r in want["rows"]] \
        == [1, 2, 3, 4]
    for g, w in zip(got["rows"], want["rows"]):
        for k in ("train_loss", "train_grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
    for k in ("eval_loss", "eval_mIOU_label", "eval_mIOU_dataset"):
        np.testing.assert_allclose(got["eval"][k], want["eval"][k], atol=1e-6, err_msg=k)
    assert dp[1]["engine"]["rows"] is None  # rank 1 writes no log


def _check_evaluate(dp, state):
    """Both sources (a loader built with the mesh; global batches cut on each
    rank) against one process: the counts exact (the dataset mIoU), mIoU and
    losses within 1e-6, the kept outputs in dataset order on every rank."""
    model = W.tiny_model()
    model.load_state_dict(state)
    want = evaluate(model, _eval_batches(), num_classes=7, keep_eval_outputs=True,
                    compute_metrics=W.kept_outputs)
    for rank in (0, 1):
        for source in ("loader", "given"):
            got = dp[rank]["eval"][source]
            assert set(got) == set(want)
            assert got["eval_mIOU_dataset"] == want["eval_mIOU_dataset"]
            for k in ("eval_loss", "eval_mIOU_label"):
                np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
            assert got["eval_n"] == want["eval_n"] == 10
            np.testing.assert_array_equal(got["eval_labels"], want["eval_labels"])
            np.testing.assert_allclose(got["eval_outputs"], want["eval_outputs"], rtol=0,
                                       atol=1e-5)


def _check_sliding(dp, jax_miou, jax_probs, labels):
    """Each rank's probabilities (rows 0-1, 2-3) against JAX's within 1e-4,
    their argmax equal but at near-ties (the two best within NEAR_TIE); the
    port's mIoU against JAX's ``per_image_miou`` of the port's probabilities,
    and, where no argmax differs, against JAX's ``dp_sliding_miou``, rtol
    2e-5.  A tie breaks by the last bit: the random model has exact ties,
    and the port's ranks run batches of 2 where one process runs 4."""
    m0, m1 = (r["sliding"]["miou"] for r in dp)
    assert m0 == m1
    probs = np.concatenate([r["sliding"]["probs"] for r in dp])
    assert probs.shape == jax_probs.shape == (4, 4, 96, 96)
    np.testing.assert_allclose(probs, jax_probs, rtol=0, atol=1e-4)
    top2 = np.sort(jax_probs, axis=1)[:, -2:]
    flips = probs.argmax(1) != jax_probs.argmax(1)
    assert np.all(top2[:, 1][flips] - top2[:, 0][flips] <= NEAR_TIE)
    want = float(jax_per_image_miou(jnp.asarray(probs), jnp.asarray(labels), num_classes=4,
                                    upsample_logits_to_label=False))
    np.testing.assert_allclose(m0, want, rtol=2e-5, atol=2e-6)
    if not flips.any():
        np.testing.assert_allclose(m0, jax_miou, rtol=2e-5, atol=2e-6)


def test_two_ranks_against_one_process_and_the_jax_mesh(tmp_path):
    """One two-rank run of every case (the spawned processes, the JAX runs
    and the single-device JAX probabilities on threads meanwhile), then each
    case's checks: one test, so that under pytest-xdist's ``--dist load``
    one worker runs the processes and the JAX compiles once."""
    engine_state = _engine_state()
    rs = np.random.RandomState(0)
    images = rs.randn(4, 3, 96, 96).astype(np.float32)
    labels = rs.randint(0, 4, size=(4, 96, 96)).astype(np.int64)
    slide_model = _slide_model()
    slide_params = numpy_params(slide_model,
                                {"pixel_values": jnp.asarray(images[:1, :, :64, :64])})
    state = params_to_state_dict(engine_state)
    with ThreadPoolExecutor(5) as pool:
        dp = pool.submit(spawn, W.dp_runs, (state, params_to_state_dict(slide_params), images,
                                            labels, _eval_batches(), str(tmp_path / "port")),
                         data=2, devices=CPU2, init_method=f"file://{tmp_path}/rendezvous",
                         timeout=TIMEOUT, threads=1)
        jax_engine = pool.submit(_jax_engine_run, engine_state, str(tmp_path / "jax"))
        jax_probs = pool.submit(_jax_probs, slide_model, slide_params, images)
        one = pool.submit(W.dropout_run, None, state, str(tmp_path / "one"))
        jax_miou = _jax_dp_sliding(slide_model, slide_params, images, labels)
        dp, jax_engine, jax_probs, one = (dp.result(), jax_engine.result(), jax_probs.result(),
                                          one.result())
    _check_dropout_steps(dp, one)
    _check_engine_against_jax(dp, jax_engine)
    _check_evaluate(dp, state)
    _check_sliding(dp, jax_miou, jax_probs, labels)


def _cli_argv(out_dir, name, dp, steps, save_step, extra=()):
    return ["--name", name, "--out_dir", out_dir, "--seed", "7", "--data_name", "synthetic",
            "--data_size", "8", "--model", "base_cross_a", "--img_size", "64",
            "--batch_size", "4", "--logger", "null", "--device", "cpu", "--dp", str(dp),
            "--max_steps", str(steps), "--exact_steps", "--save_step", str(save_step),
            "--eval_step", "1000", "--log_step", "1", *extra]


def test_cli_dp2_trains_and_resumes(tmp_path):
    """4 steps of ``--dp 2`` against ``--dp 1`` (each checkpoint tensor
    within 1e-6 in root-mean-square), then ``--dp 2 --resume`` from the
    straight run's step 2: on both ranks the model and optimizer state equal
    to the checkpoint bit for bit as training starts, on to step 4.  Each
    checkpoint is 0.47 GB: each goes once it has been read."""
    out = str(tmp_path)
    ckpts = {n: os.path.join(out, n, "checkpoints") for n in ("dp2", "dp1", "resumed")}
    try:
        with ThreadPoolExecutor(2) as pool:  # the two processes and this one at once
            dp2 = pool.submit(train_cli.main, _cli_argv(out, "dp2", 2, 4, 2))
            dp1 = train_cli.main(_cli_argv(out, "dp1", 1, 4, 4))
            dp2 = dp2.result()
        np.testing.assert_allclose(dp2["train_loss"], dp1["train_loss"], rtol=0, atol=1e-6)
        a, _ = load_checkpoint(os.path.join(ckpts["dp2"], "step-4.pth"))
        b, _ = load_checkpoint(os.path.join(ckpts["dp1"], "step-4.pth"))
        shutil.rmtree(ckpts["dp1"])
        for k, v in b["model"].items():  # root-mean-square difference of each tensor
            assert (a["model"][k] - v).pow(2).mean().sqrt() <= 1e-6, k
        del a, b
        os.makedirs(ckpts["resumed"])
        for f in ("step-2.pth", "step-2.json"):
            shutil.move(os.path.join(ckpts["dp2"], f), ckpts["resumed"])
        shutil.rmtree(ckpts["dp2"])
        seen = spawn(W.resumed_state, (_cli_argv(out, "resumed", 2, 4, 2, ["--resume"]),
                                       os.path.join(ckpts["resumed"], "step-2.pth")),
                     data=2, devices=CPU2, init_method=f"file://{tmp_path}/rendezvous",
                     timeout=TIMEOUT, threads=1)
        assert seen == [dict(start=2, model=True, optimizer=True, end=4)] * 2
        assert os.path.exists(os.path.join(ckpts["resumed"], "step-4.pth"))
    finally:
        for d in ckpts.values():
            shutil.rmtree(d, ignore_errors=True)
