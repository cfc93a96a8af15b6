"""One training step of ``PromptFTNv1`` (its swin and frozen text tower
replaced by fixed outputs, 128²) in the port against lc2is_tpu's step on the
same numpy parameters and batch (tests/ftn_train_util.py says how, and
holds the step tests it imports); its training forward following its
generator; its step with dropout on repeating bit for bit from its seed."""

import copy

import numpy as np
import pytest
import torch
from ftn_train_util import (KEYS, _port_step, check_forward_follows_its_generator,  # noqa: F401
                            seeded, step_fixtures, test_ftn_every_trainable_gradient,
                            test_ftn_loss, test_ftn_params_after_one_adamw_step)

from lc2is_tpu_torch.models import zoo

jax_runs, step_run = step_fixtures("PromptFTNv1")


@pytest.mark.parametrize("name", ["PromptFTNv1"])
def test_ftn_forward_follows_its_generator(seeded, name):  # noqa: F811
    check_forward_follows_its_generator(seeded, name)


def test_ftn_step_with_dropout_repeats_from_its_seed(seeded):
    """``PromptFTNv1``'s step with drop path 0.1 and its decoders' dropout
    0.1 on repeats the loss and the updated parameters bit for bit from the
    same generator seed."""
    model, pin, y = seeded("PromptFTNv1")
    runs = []
    for _ in range(2):
        m = copy.deepcopy(model)
        _, losses = _port_step(m, pin, y, zoo.FROZEN_PREFIXES[KEYS["PromptFTNv1"]],
                               torch.Generator().manual_seed(1))
        runs.append((losses["train_loss"].item(), m.state_dict()))
    (a, sa), (b, sb) = runs
    assert a == b and np.isfinite(a)
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
