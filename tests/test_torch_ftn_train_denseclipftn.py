"""One training step of ``DenseCLIPFTN`` (small prompt cfg, whole at 128²)
in the port against lc2is_tpu's step on the same numpy parameters and batch
(tests/ftn_train_util.py says how, and holds the step tests it imports:
the loss, every trainable gradient, the parameters after one AdamW step);
its training forward following its generator; labels of the wrong size
raising in both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from ftn_train_util import (check_forward_follows_its_generator, seeded,  # noqa: F401
                            step_fixtures, test_ftn_every_trainable_gradient, test_ftn_loss,
                            test_ftn_params_after_one_adamw_step)
from torch_port_util import t

from lc2is_tpu.nn.losses import cross_entropy as jax_cross_entropy
from lc2is_tpu_torch.nn.losses import cross_entropy

jax_runs, step_run = step_fixtures("DenseCLIPFTN")


@pytest.mark.parametrize("name", ["DenseCLIPFTN"])
def test_ftn_forward_follows_its_generator(seeded, name):  # noqa: F811
    check_forward_follows_its_generator(seeded, name)


def test_labels_of_another_size_raise():
    """The plain CE needs labels at the map's size in both packages: a
    (1, 3, 16, 16) map against 8² labels raises, with no resize."""
    logits = np.random.RandomState(11).randn(1, 3, 16, 16).astype(np.float32)
    labels = np.zeros((1, 8, 8), np.int32)
    with pytest.raises((TypeError, ValueError)):
        jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    with pytest.raises(ValueError, match="does not match"):
        cross_entropy(t(logits), torch.from_numpy(labels).long())
