"""One training step of ``BaseFTN`` (its swin and ``FTNDecoderV2`` replaced by
one fixed decoder output, 512²) in the port against lc2is_tpu's step on the
same numpy parameters and batch (tests/ftn_train_util.py says how, and holds
the step tests this file imports: the loss, every trainable gradient, the
parameters after one AdamW step)."""

from ftn_train_util import (step_fixtures, test_ftn_every_trainable_gradient,  # noqa: F401
                             test_ftn_loss, test_ftn_params_after_one_adamw_step)

jax_runs, step_run = step_fixtures("BaseFTN")
