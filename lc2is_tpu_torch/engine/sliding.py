"""Multi-scale sliding-window evaluation, counterpart of
``lc2is_tpu/engine/sliding.py`` (:21-95) and of the sliding loop of
``lc2is_tpu/cli/evaluate.py`` (:61-109): the "hierarchical variant @ 640²
multi-scale sliding-window eval".

At each scale the image is resized bilinearly (``int(round(h · s))``, as
Python rounds), cut into crops of ``min(crop, sh, sw)`` at ``stride`` (the
last window flush with the edge), and all windows go through the model as
one batch, windows in (y, x) order with the images inner; the horizontally
flipped images join the same batch.  Each window's logits go to f32 before
they are added up, the sum is divided by the overlap count, the flipped half
flipped back and averaged with the other.  The f32 softmax over the classes
is resized bilinearly back to the base size, and the scales averaged.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Sequence

import torch
from torch import nn

from lc2is_tpu_torch.engine.engine import _normalize_output, model_device, on_device
from lc2is_tpu_torch.metrics.miou import per_image_miou
from lc2is_tpu_torch.ops.resize import resize


def _window_origins(size: int, crop: int, stride: int) -> List[int]:
    if size <= crop:
        return [0]
    last = size - crop
    xs = list(range(0, last + 1, stride))
    if xs[-1] != last:
        xs.append(last)
    return xs


def sliding_window_logits(forward: Callable[[torch.Tensor], torch.Tensor], image: torch.Tensor,
                          crop: int = 512, stride: int = 341) -> torch.Tensor:
    """Average-of-overlaps sliding window at one scale: ``forward`` maps
    (N, 3, c, c) to (N, K, c, c); returns (B, K, H, W) f32."""
    b, _, h, w = image.shape
    origins = [(y, x) for y in _window_origins(h, crop, stride)
               for x in _window_origins(w, crop, stride)]
    tiles = forward(torch.cat([image[:, :, y:y + crop, x:x + crop] for y, x in origins]))
    acc = torch.zeros((b, tiles.shape[1], h, w), dtype=torch.float32, device=image.device)
    cnt = torch.zeros((1, 1, h, w), dtype=torch.float32, device=image.device)
    for i, (y, x) in enumerate(origins):
        acc[:, :, y:y + crop, x:x + crop] += tiles[i * b:(i + 1) * b].float()
        cnt[:, :, y:y + crop, x:x + crop] += 1.0
    return acc / cnt


def multi_scale_sliding_eval(forward: Callable[[torch.Tensor], torch.Tensor],
                             image: torch.Tensor, scales: Sequence[float] = (0.75, 1.0, 1.25),
                             crop: int = 512, stride: int = 341, flip: bool = True
                             ) -> torch.Tensor:
    """(B, K, H, W) probabilities at the base resolution of ``image``, the
    softmax averaged over ``scales`` (and the horizontal flip)."""
    b, _, h, w = image.shape
    total = None
    for s in scales:
        sh, sw = int(round(h * s)), int(round(w * s))
        scaled = resize(image, size=(sh, sw), method="bilinear")
        c = min(crop, sh, sw)
        if flip:
            both = sliding_window_logits(forward, torch.cat([scaled, scaled.flip(-1)]), c, stride)
            logits = (both[:b] + both[b:].flip(-1)) / 2.0
        else:
            logits = sliding_window_logits(forward, scaled, c, stride)
        probs = resize(torch.softmax(logits, dim=1), size=(h, w), method="bilinear")
        total = probs if total is None else total + probs
    return total / len(scales)


def compute_dtype(model: nn.Module) -> torch.dtype:
    """The dtype the model's vision tower computes in (its ``dtype``)."""
    for m in model.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            return m.dtype
    return torch.float32


def evaluate_sliding(model: nn.Module, batches: Iterable,
                     scales: Sequence[float] = (0.75, 1.0, 1.25), crop: int = 512,
                     stride: int = 341, num_classes: int = 151) -> Dict[str, object]:
    """The multi-scale sliding evaluation with flip over ``batches`` (as
    :func:`~lc2is_tpu_torch.engine.engine.evaluate` takes them), on the
    model's device: the pixels cast to the model's compute dtype, the class
    embeddings of a model with ``embed_text`` computed once and passed as
    ``text_static``, each batch's per-image mIoU of the probabilities against
    its labels at the base size, weighted by batch size.  Returns
    ``dict(eval_mIOU_sliding=..., scales=...)``."""
    scales = tuple(float(s) for s in scales)
    device, dtype = model_device(model), compute_dtype(model)
    model.eval()
    miou_sum, n = 0.0, 0
    with torch.no_grad():
        extra = {"text_static": model.embed_text()} if hasattr(model, "embed_text") else {}

        def tile_forward(t):
            return _normalize_output(model({"pixel_values": t, **extra}))["outputs"]

        for data in batches:
            inputs = dict(data[0]) if isinstance(data, tuple) else dict(data)
            labels = on_device(inputs.pop("label"), device)
            x = on_device(inputs["pixel_values"], device).to(dtype)
            probs = multi_scale_sliding_eval(tile_forward, x, scales=scales, crop=crop,
                                             stride=stride)
            miou = per_image_miou(probs.float(), labels, num_classes=num_classes,
                                  upsample_logits_to_label=False)
            b = int(labels.shape[0])
            miou_sum += float(miou) * b
            n += b
    return dict(eval_mIOU_sliding=miou_sum / max(n, 1), scales=scales)
