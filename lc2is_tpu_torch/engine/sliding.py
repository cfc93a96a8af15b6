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

Data-parallel (``lc2is_tpu/engine/sliding.py::dp_sliding_miou`` :98-137):
each rank slides its own rows of the images, and the per-image mIoU sum and
the image count are summed over the data axis (the ranks of a model group
slide the same rows, counted once); :func:`evaluate_sliding` runs the same
way under a mesh.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence

import torch
from torch import nn

from lc2is_tpu_torch.core.mesh import (DATA_AXIS, Mesh, Rows, all_reduce_sum, batch_rows,
                                       take_rows, unpack_batch)
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


def _miou_sums(forward, x: torch.Tensor, labels: torch.Tensor, rows: Rows, mesh, scales,
               crop: int, stride: int, flip: bool, num_classes: int) -> torch.Tensor:
    """[per-image mIoU sum, images] of this rank's images (zeros on a rank
    other than its data group's first where every rank holds the whole
    batch)."""
    probs = multi_scale_sliding_eval(forward, x, scales=scales, crop=crop, stride=stride,
                                     flip=flip)
    vals = per_image_miou(probs.float(), labels, num_classes=num_classes,
                          upsample_logits_to_label=False, reduce=False)
    counted = rows.split or mesh is None or mesh.is_data_main
    return torch.stack([vals.sum(), torch.tensor(float(len(vals)), device=vals.device)]) \
        * float(counted)


def dp_sliding_miou(forward: Callable[[torch.Tensor], torch.Tensor], images: torch.Tensor,
                    labels: torch.Tensor, mesh: Optional[Mesh] = None, num_classes: int = 151,
                    scales: Sequence[float] = (0.75, 1.0, 1.25), crop: int = 512,
                    stride: int = 341, flip: bool = True) -> torch.Tensor:
    """The multi-scale sliding evaluation's mean per-image mIoU over the
    global ``images`` (B, 3, H, W) and ``labels`` (B, H, W): each rank of
    ``mesh`` slides its rows (all of them where B does not divide by the
    data axis) with ``forward`` ((N, 3, c, c) -> (N, K, c, c)), and the
    per-image values' sum and count are summed over the data group (the
    ranks of a model group slide the same rows); f32, the same on every
    rank."""
    rows = batch_rows(mesh, len(labels))
    x, y = take_rows((images, labels), rows)
    s = all_reduce_sum(mesh, _miou_sums(forward, x, y, rows, mesh, scales, crop, stride, flip,
                                        num_classes).double(), DATA_AXIS)
    return (s[0] / s[1]).float()


def evaluate_sliding(model: nn.Module, batches: Iterable,
                     scales: Sequence[float] = (0.75, 1.0, 1.25), crop: int = 512,
                     stride: int = 341, num_classes: int = 151,
                     mesh: Optional[Mesh] = None) -> Dict[str, object]:
    """The multi-scale sliding evaluation with flip over ``batches`` (as
    :func:`~lc2is_tpu_torch.engine.engine.evaluate` takes them), on the
    model's device: the pixels cast to the model's compute dtype, the class
    embeddings of a model with ``embed_text`` computed once and passed as
    ``text_static``, the per-image mIoU of the probabilities against the
    labels at the base size, averaged over the images.  Under ``mesh`` each
    rank slides its rows of every batch and the sums are reduced, as
    :func:`dp_sliding_miou`.  Returns ``dict(eval_mIOU_sliding=...,
    scales=...)``."""
    scales = tuple(float(s) for s in scales)
    device, dtype = model_device(model), compute_dtype(model)
    model.eval()
    total = torch.zeros(2, dtype=torch.float64, device=device)
    with torch.no_grad():
        extra = {"text_static": model.embed_text()} if hasattr(model, "embed_text") else {}

        def tile_forward(t):
            return _normalize_output(model({"pixel_values": t, **extra}))["outputs"]

        for data in batches:
            inputs, _, rows = unpack_batch(mesh, data)
            labels = on_device(inputs.pop("label"), device)
            x = on_device(inputs["pixel_values"], device).to(dtype)
            total += _miou_sums(tile_forward, x, labels, rows, mesh, scales, crop, stride, True,
                                num_classes).double()
    total = all_reduce_sum(mesh, total, DATA_AXIS).tolist()
    return dict(eval_mIOU_sliding=total[0] / max(total[1], 1), scales=scales)
