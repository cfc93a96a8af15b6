#!/usr/bin/env python3
"""Where the upsample adjoint rounds: the bf16 VJP of
``lc2is_tpu.ops.upsample.upsample_tokens`` (interpret mode: ``_adj_kernel``
at r 2, XLA's VJP of ``_xla_reference`` at r 4) against two orders of the
port's backward on the same numpy-seeded inputs, on the CPU:

- "H first": autograd through ``upsample_tokens_plain`` (each output-gradient
  column's H-adjoint rounded to bf16 first, the order of the port's backward
  before its repair, on the CPU and in the CUDA kernel);
- "W first": ``upsample_tokens_adjoint_plain`` (each row's W-adjoint rounded
  first, as ``_adj_kernel`` rounds).

For each it prints the elements that differ from JAX's VJP, the max |Δ|,
‖Δ‖/‖JAX‖, and the max |Δ| against the exact adjoint (f64 from the same bf16
gradient).

    python3 scripts/upsample_adjoint_order.py
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from lc2is_tpu.ops.upsample import upsample_tokens as jax_upsample_tokens  # noqa: E402
from lc2is_tpu_torch.ops.upsample import (upsample_tokens_adjoint_plain,  # noqa: E402
                                          upsample_tokens_plain)

CASES = [(2, (8, 8), 64, 2), (2, (5, 7), 64, 2), (2, (8, 8), 64, 4), (2, (5, 7), 64, 4)]


def main() -> int:
    print(f"torch {torch.__version__}, jax {jax.__version__}, CPU")
    for b, hw, c, r in CASES:
        rs = np.random.RandomState(0)
        x = rs.randn(b, hw[0] * hw[1], c).astype(np.float32)
        g = rs.randn(b, hw[0] * hw[1] * r * r, c).astype(np.float32)
        xj = jnp.asarray(x, jnp.bfloat16)
        _, vjp = jax.vjp(lambda a: jax_upsample_tokens(a, hw, r, interpret=True), xj)
        want = torch.from_numpy(np.array(vjp(jnp.asarray(g, jnp.bfloat16))[0].astype(jnp.float32)))
        gt = torch.from_numpy(g).bfloat16()
        xt = torch.from_numpy(x).double().requires_grad_()
        (exact,) = torch.autograd.grad(upsample_tokens_plain(xt, hw, r), xt, gt.double())
        xt = torch.from_numpy(x).bfloat16().requires_grad_()
        (h_first,) = torch.autograd.grad(upsample_tokens_plain(xt, hw, r), xt, gt)
        w_first = upsample_tokens_adjoint_plain(gt, hw, r)
        for name, got in (("H first", h_first), ("W first", w_first)):
            d = got.float() - want
            print(f"({b}, {hw[0]}x{hw[1]}, {c}) r {r} bf16, {name}: {int((d != 0).sum())} of "
                  f"{d.numel()} elements differ from JAX's VJP, max |Δ| {d.abs().max().item():.5f}, "
                  f"‖Δ‖/‖JAX‖ {(d.norm() / want.norm()).item():.2e}; max |Δ| to the exact "
                  f"adjoint {(got.double() - exact).abs().max().item():.4f} (JAX's "
                  f"{(want.double() - exact).abs().max().item():.4f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
