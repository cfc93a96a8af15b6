"""Shared helpers of the ``tests/test_torch_*.py`` parity tests: carry a
``lc2is_tpu`` params tree into the port and compare outputs as numpy.

Importing it also gives torch's intra-op thread pool a worker's share of the
cores when pytest-xdist runs the suite (every worker imports every test
module while it collects, so one import serves them all): N workers each
with a thread a core oversubscribe the CPU, and OpenMP's threads spin while
they wait, which made the port's tests 2.5 times as expensive in all as
with one thread a worker (six of the heaviest files, six workers on eight
cores: 3,252 worker-seconds against 1,310)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from lc2is_tpu_torch.core.convert import params_to_state_dict

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if _WORKERS > 1:
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // _WORKERS))

# stated tolerance: f32, per op and per module (tests/test_swin_canvas.py:47-48,
# tests/test_fused_paths.py:29); the whole slice is held to SLICE_ATOL
TOL = dict(rtol=2e-4, atol=2e-4)
SLICE_ATOL = 1e-3

# a tiny swin (window 4, one block a stage) and the small prompt cfg of
# tests/test_zoo.py:20-27
TINY_SWIN = dict(embed_dim=16, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8), window=4)


def small_denseclip_cfg():
    return dict(
        text_encoder=dict(context_length=10, vocab_size=49408, transformer_width=512,
                          transformer_heads=8, transformer_layers=1, embed_dim=512),
        context_decoder=dict(transformer_width=64, transformer_heads=4, transformer_layers=1),
        context_length=5,
        text_dim=512,
    )


def load_jax_params(module: torch.nn.Module, params) -> torch.nn.Module:
    """Load a flax params tree into ``module`` with strict=True (every
    parameter covered both ways) and return it in eval mode."""
    module.load_state_dict(params_to_state_dict(params), strict=True)
    return module.eval()


def numpy_params(model, *init_args, seed: int = 0):
    """A params tree of ``model`` (a flax module) with numpy values: the tree
    from ``jax.eval_shape(model.init, ...)`` (traced, not compiled), filled
    from ``RandomState(seed)``: LayerNorm-like 1-D ``weight``s 1 + 0.1·N,
    other vectors 0.1·N, matrices N / sqrt(fan_in) (torch (out, in) layout)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *init_args)
    rs = np.random.RandomState(seed)

    def fill(path, s):
        name = str(path[-1].key)
        if len(s.shape) == 1:
            v = (1.0 if name == "weight" else 0.0) + 0.1 * rs.randn(*s.shape)
        else:
            v = rs.randn(*s.shape) / np.sqrt(np.prod(s.shape[1:]))
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_ref(fn, *arrays):
    """``fn(*arrays)`` under ``jax.jit``, static arguments closed over by
    ``fn``: one compile, not one per eager op (and per Pallas interpret step)."""
    return jax.jit(fn)(*(jnp.asarray(a) for a in arrays))


def t(a) -> torch.Tensor:
    """numpy / jax array -> f32 CPU tensor."""
    return torch.from_numpy(np.array(a, dtype=np.float32))


def close(port: torch.Tensor, ref, **tol) -> None:
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(ref, np.float32),
                               **(tol or TOL))
