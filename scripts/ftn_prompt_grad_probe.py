#!/usr/bin/env python3
"""Where the f32 gradients of ``PromptFTNv2``'s prompt decoder part between
the card and the CPU, on one NVIDIA GPU:

    python3 scripts/ftn_prompt_grad_probe.py      # from the repository root

1. the port's f32 flash attention (forward and backward) and the f32 einsum
   path, each against an f64 einsum run on the card, at the prompt decoder's
   cross-attention shape (1, 8, 151, 64) over 16384 keys, and over 1024 keys
   and with 256 queries beside it (‖Δ‖ / ‖ref‖ of out, dq, dk, dv);
2. one f32 batch-1 512² ``train_step`` of ``PromptFTNv2`` (``chip_smoke.py``
   phase 13a's model, weights, inputs and labels, dropout rates zeroed) on the
   CPU and on the card, the card once through the f32 flash kernel (as the
   step runs) and once with the attention on the einsum path: the largest
   norm-relative gradient difference of each of the 8 prompt-decoder layers
   and of every other trainable parameter (the swin key biases, zero in
   exact arithmetic, left out); and, per layer, the relu units (of 151 x
   2048) whose pre-activation has another sign on the card than on the CPU,
   and those whose CPU pre-activation lies within the card-vs-CPU difference
   of 0;
3. the prompt decoder alone, fed the CPU step's own inputs (the prompts and
   the decoded 128² map) and the cotangent its output got there, in f32 on
   the CPU, in f32 on the card (flash) and in float64 on the CPU (the port's
   plain code with ``Tensor.float`` kept at float64 for that run): each f32
   run's norm-relative gradient difference from float64, per layer, and the
   relu units each f32 run switches against float64.

TF32 is off.  Fails without a CUDA device.
"""

from __future__ import annotations

import contextlib
import copy
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
import lc2is_tpu_torch.ops.attention as att  # noqa: E402
from lc2is_tpu_torch.core.convert import seeded_init_  # noqa: E402
from lc2is_tpu_torch.engine.engine import train_step  # noqa: E402
from lc2is_tpu_torch.models import zoo  # noqa: E402
from lc2is_tpu_torch.ops import _build  # noqa: E402
from lc2is_tpu_torch.ops.flash_attention import flash_attention  # noqa: E402


def rel(x, ref):
    return ((x.double() - ref).norm() / ref.norm()).item()


def attention(q, k, v):
    p = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", q, k) / q.shape[-1] ** 0.5, -1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def check_op():
    gen = torch.Generator(device="cuda").manual_seed(0)
    for lq, lk in [(151, 16384), (151, 1024), (256, 16384)]:
        q, k, v, go = (torch.randn(1, 8, n, 64, device="cuda", generator=gen)
                       for n in (lq, lk, lk, lq))
        runs = {}
        for label, fn, dt in [("flash f32", flash_attention, torch.float32),
                              ("einsum f32", attention, torch.float32),
                              ("f64", attention, torch.float64)]:
            args = [t.to(dt).clone().requires_grad_() for t in (q, k, v)]
            out = fn(*args)
            runs[label] = (out, *torch.autograd.grad(out, args, go.to(dt)))
        ref = runs.pop("f64")
        print(f"({lq} queries over {lk} keys) vs f64: " + "; ".join(
            f"{label} " + " ".join(f"{n} {rel(x, r):.2e}" for n, x, r in
                                    zip(("out", "dq", "dk", "dv"), got, ref))
            for label, got in runs.items()), flush=True)


LAYERS = 8


def pre_activation_hooks(model):
    """{layer: its linear1 output (the relu's input) in the last forward}."""
    pre = {}
    for i, layer in enumerate(model.prompt_decoder.layers):
        layer.linear1.register_forward_hook(
            lambda m, a, out, i=i: pre.__setitem__(i, out.detach().cpu().double()))
    return pre


def switched(pre, ref):
    """Per layer: (units whose sign differs from ``ref``'s, units whose |ref|
    lies within |pre - ref|)."""
    return [(int(((pre[i] > 0) != (ref[i] > 0)).sum()),
             int((ref[i].abs() <= (pre[i] - ref[i]).abs()).sum())) for i in range(LAYERS)]


def per_layer(diff):
    return [max(d for n, d in diff.items() if n.startswith(f"layers.{i}.")) for i in range(LAYERS)]


@contextlib.contextmanager
def float64_kept():
    """``Tensor.float()`` returns a float64 tensor as it is, so the port's
    plain code (which upcasts to f32 with ``.float()``) runs in float64."""
    orig = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **k: (self if self.dtype == torch.float64
                                                else orig(self, *a, **k))
    try:
        yield
    finally:
        torch.Tensor.float = orig


def decoder_grads(decoder, tgt, memory, cot, device, dtype):
    """Gradients of the prompt decoder's parameters (and of its prompts) under
    ``cot``, in training mode with its dropout rates zeroed."""
    m = copy.deepcopy(decoder).to(device=device, dtype=dtype).train()
    for sub in m.modules():  # the hooks the copy took from the step's model
        sub._forward_hooks.clear()
        sub._forward_hooks_with_kwargs.clear()
    pre = {}
    for i, layer in enumerate(m.layers):
        layer.linear1.register_forward_hook(
            lambda mod, a, out, i=i: pre.__setitem__(i, out.detach().cpu().double()))
    args = [x.detach().to(device=device, dtype=dtype).clone().requires_grad_()
            for x in (tgt, memory)]
    m(*args).backward(cot.to(device=device, dtype=dtype))
    grads = {n: p.grad.detach().cpu().double() for n, p in m.named_parameters()}
    grads["prompts"] = args[0].grad.detach().cpu().double()
    return grads, pre


def check_step():
    name = "PromptFTNv2"
    state = seeded_init_(zoo.PromptFTNv2(device="cpu"), cs.SEED).state_dict()
    inputs = cs.ftn_inputs(name, 1, cs.SEED + 20, "cpu")
    y = cs.seeded_labels(cs.SEED + 21, 1, cs.IMG, cs.IMG, device="cpu")
    captured = {}

    def grads(device):
        m, opt = cs.ftn_built(name, state, device=device)
        zoo.without_dropout(m)
        pre = pre_activation_hooks(m)
        if device == "cpu":
            def keep(mod, args, kwargs, out):
                captured.update(tgt=args[0].detach().clone(), memory=args[1].detach().clone(),
                                decoder=copy.deepcopy(mod))
                out.register_hook(lambda g: captured.__setitem__("cot", g.detach().clone()))
            m.prompt_decoder.register_forward_hook(keep, with_kwargs=True)
        out = train_step(m, opt, {k: v.to(device) for k, v in inputs.items()}, y.to(device))
        return out["train_loss"].item(), {n: p.grad.detach().cpu().double()
                                          for n, p in m.named_parameters()
                                          if p.grad is not None}, pre

    loss_c, cpu, pre_c = grads("cpu")
    gate = att.FLASH_MIN_LOGITS
    for label, min_logits in [("flash f32", gate), ("einsum", 1 << 62)]:
        att.FLASH_MIN_LOGITS = min_logits
        loss_g, gpu, pre_g = grads("cuda")
        diff = {n[len("prompt_decoder."):]: ((gpu[n] - cpu[n]).norm() / cpu[n].norm()).item()
                for n in cpu if n.startswith("prompt_decoder.")}
        rest = max(((gpu[n] - cpu[n]).norm() / cpu[n].norm()).item() for n in cpu
                   if not n.startswith("prompt_decoder.") and not n.endswith("key.bias"))
        print(f"{name} f32 step, card attention {label}: loss card {loss_g:.7f} CPU "
              f"{loss_c:.7f}; prompt-decoder layers' largest ‖Δ‖/‖ref‖ "
              f"{[f'{r:.2e}' for r in per_layer(diff)]}; every other parameter's {rest:.2e}; "
              f"relu units per layer (sign differs, |CPU pre| <= |card - CPU|) "
              f"{switched(pre_g, pre_c)}", flush=True)
    att.FLASH_MIN_LOGITS = gate

    dec, tgt, memory, cot = (captured[k] for k in ("decoder", "tgt", "memory", "cot"))
    print(f"{name} prompt decoder alone on the CPU step's inputs {tuple(tgt.shape)} over "
          f"{tuple(memory.shape)}, cotangent max |g| {cot.abs().max().item():.3e}", flush=True)
    with float64_kept():
        ref, pre_ref = decoder_grads(dec, tgt, memory, cot, "cpu", torch.float64)
    runs = {"CPU f32": decoder_grads(dec, tgt, memory, cot, "cpu", torch.float32),
            "card f32 (flash)": decoder_grads(dec, tgt, memory, cot, "cuda", torch.float32)}
    for label, (g, pre) in runs.items():
        diff = {n: ((g[n] - ref[n]).norm() / ref[n].norm()).item() for n in ref}
        print(f"  {label} vs float64: layers' largest ‖Δ‖/‖ref‖ "
              f"{[f'{r:.2e}' for r in per_layer(diff)]}, prompts' {diff['prompts']:.2e}; "
              f"relu units per layer (sign differs from float64, |f64 pre| <= |Δ|) "
              f"{switched(pre, pre_ref)}", flush=True)
    (gc, pc), (gg, pg) = runs.values()
    diff = {n: ((gg[n] - gc[n]).norm() / gc[n].norm()).item() for n in gc}
    print(f"  card vs CPU on the same inputs: layers' largest ‖Δ‖/‖ref‖ "
          f"{[f'{r:.2e}' for r in per_layer(diff)]}; relu units per layer "
          f"{switched(pg, pc)}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("ftn_prompt_grad_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]),
          flush=True)
    _build.build()
    check_op()
    check_step()
    return 0


if __name__ == "__main__":
    sys.exit(main())
