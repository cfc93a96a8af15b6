"""The four reference collators (``data/collator.py``) on the host, a copy of
``lc2is_tpu/data/collators.py`` over the port's tokenizer.

Each produces the ``inputs`` dict contract the models consume
(``pixel_values``, optional ``input_ids``/``attention_mask``, ``label``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from lc2is_tpu_torch.data.ade20k import CLIP_MEAN, CLIP_STD
from lc2is_tpu_torch.data.transforms import ShortestEdgeResizeCenterCrop
from lc2is_tpu_torch.ops.bpe import tokenize, tokenize_batch_padded


def change_ids(x: np.ndarray, id_mapping: np.ndarray) -> np.ndarray:
    """``OldCollator.change_ids`` (``collator.py:58-65``): rewrite label ids
    via the [[old,new],...] map with the flatten/mask trick."""
    flat = x.reshape(-1)
    mask = flat[None, :] == id_mapping[:, :1]
    flat = (1 - mask.sum(0)) * flat + (mask * id_mapping[:, 1:]).sum(0)
    return flat.reshape(x.shape)


def putback_ids(x: np.ndarray, id_mapping: np.ndarray) -> np.ndarray:
    """Inverse mapping (``model_test.py:41-48``): new ids -> original ids."""
    inv = id_mapping[:, ::-1].copy()
    return change_ids(x, inv)


def _clip_image_batch(img_list: List[np.ndarray], size: int) -> np.ndarray:
    """HF CLIPFeatureExtractor image path: shortest-edge bicubic + center
    crop + scale 1/255 + CLIP-stat normalize (evaluate.py:58)."""
    tr = ShortestEdgeResizeCenterCrop(size)
    out = []
    for img in img_list:
        x = tr(img.astype(np.float32), is_label=False) / 255.0
        x = (x - CLIP_MEAN[:, None, None]) / CLIP_STD[:, None, None]
        out.append(x)
    return np.stack(out)


def _label_batch(label_list: List[np.ndarray], size: int) -> np.ndarray:
    """HF label path (``collator.py:89-91``): 3-channel expand -> extractor
    (nearest, mean 0 / std 1, rescale 1/255) -> channel 0 ``x255 -> long``."""
    tr = ShortestEdgeResizeCenterCrop(size)
    out = []
    for label in label_list:
        x3 = np.broadcast_to(label[None].astype(np.float32), (3, *label.shape))
        y = tr(x3, is_label=True) / 255.0
        out.append((y[0] * 255.0).round().astype(np.int64))
    return np.stack(out)


class OldCollator:
    """``collator.py:6-65``: batch-level class-id compaction + per-batch
    tokenization of only the classes present."""

    def __init__(self, img_size: int = 224, label_size: Optional[int] = None, pad_value: int = 0):
        self.img_size = img_size
        self.label_size = label_size or img_size
        self.pad_value = pad_value

    def __call__(self, features: List[Any]):
        batch_img, batch_label, batch_size, batch_txt, batch_ids = [list(f) for f in zip(*features)]
        size = np.stack([np.asarray(s) for s in batch_size]).reshape(len(batch_size), -1)
        img = _clip_image_batch(batch_img, self.img_size)
        label = _label_batch(batch_label, self.label_size)

        uniq = np.unique(label)
        id_mapping = np.stack([uniq, np.arange(len(uniq))], axis=1).astype(np.int64)
        label = change_ids(label, id_mapping)

        text_id = {t: i for t, i in zip(sum(batch_txt, []), sum(batch_ids, []))}
        avail = {t: i for t, i in text_id.items() if i in uniq}
        new_txt_id = {t: int(id_mapping[id_mapping[:, 0] == i][0][1]) for t, i in avail.items()}
        new_txt = list(new_txt_id.keys())
        ids, mask = tokenize_batch_padded(new_txt) if new_txt else (np.zeros((1, 2), np.int64), np.ones((1, 2), np.int64))

        inputs = dict(pixel_values=img, label=label, input_ids=ids, attention_mask=mask, size=size)
        mappings = dict(old_new_id_mapping=id_mapping, text_new_id_mapping=new_txt_id)
        originals = dict(img=batch_img, label=batch_label, text=batch_txt, class_id=batch_ids)
        return inputs, mappings, originals


class JoinTextCollator:
    """``collator.py:68-115``: per-image class names joined with ', '."""

    def __init__(self, img_size: int = 512, label_size: int = 128, join_text: str = ", "):
        self.img_size = img_size
        self.label_size = label_size
        self.join_text = join_text

    def __call__(self, features: List[Any]):
        img_list, label_list, size_list, txt_list, ids_list = [list(f) for f in zip(*features)]
        imgs = _clip_image_batch(img_list, self.img_size)
        labels = _label_batch(label_list, self.label_size)
        joined = [self.join_text.join(ts) for ts in txt_list]
        ids, mask = tokenize_batch_padded(joined)
        sizes = np.stack([np.asarray(s) for s in size_list]).reshape(len(size_list), -1)
        inputs = dict(pixel_values=imgs, label=labels, input_ids=ids, attention_mask=mask)
        classes = dict(text=txt_list, id=ids_list)
        originals = dict(img=img_list, label=label_list, size=size_list, text=txt_list, id=ids_list)
        return inputs, classes, dict(size=sizes), originals


class FullClassesCollator:
    """``collator.py:118-164``: tokenize the deduped union of the full
    151-prompt strings."""

    def __init__(self, img_size: int = 512, label_size: int = 128):
        self.img_size = img_size
        self.label_size = label_size

    def __call__(self, features: List[Any]):
        img_list, label_list, size_list, txt_list, ids_list, classes_list = [list(f) for f in zip(*features)]
        imgs = _clip_image_batch(img_list, self.img_size)
        labels = _label_batch(label_list, self.label_size)
        classes = list(dict.fromkeys(sum(classes_list, [])))  # dedup, stable
        ids, mask = tokenize_batch_padded(classes)
        sizes = np.stack([np.asarray(s) for s in size_list]).reshape(len(size_list), -1)
        inputs = dict(pixel_values=imgs, label=labels, input_ids=ids, attention_mask=mask)
        cls = dict(text=txt_list, id=ids_list)
        originals = dict(img=img_list, label=label_list, size=size_list, text=txt_list, id=ids_list)
        return inputs, cls, dict(size=sizes), originals


class ADE20KCollator:
    """``collator.py:167-180`` (newest): concat pre-transformed tensors."""

    def __call__(self, features: List[Any]) -> Tuple[Dict[str, np.ndarray], List]:
        img_list, label_list, metas_list = [list(f) for f in zip(*features)]
        img = np.concatenate(img_list, axis=0)
        label = np.concatenate(label_list, axis=0)
        return dict(pixel_values=img, label=label), metas_list


class ADE20KTextCollator(ADE20KCollator):
    """ADE20KCollator + tokenized per-image joined class texts for the v1
    CLIP models (``collator.py:102-104`` semantics — per-image present class
    names joined with ', ' and tokenized — over the NEWEST (img, label, metas)
    dataset format).  As in the JAX package, ids are padded to a FIXED
    ``context_length`` (CLIP's 77) instead of HF's pad-to-longest, so every
    batch has one text shape; attention_mask marks real tokens exactly as HF
    padding would."""

    def __init__(self, context_length: int = 77, join_text: str = ", "):
        self.context_length = context_length
        self.join_text = join_text

    def __call__(self, features: List[Any]) -> Tuple[Dict[str, np.ndarray], List]:
        inputs, metas_list = super().__call__(features)
        joined = [self.join_text.join(m["class_texts"]) for m in metas_list]
        ids = tokenize(joined, context_length=self.context_length)
        inputs["input_ids"] = ids
        inputs["attention_mask"] = (ids != 0).astype(np.int64)
        return inputs, metas_list
