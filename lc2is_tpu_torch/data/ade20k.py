"""ADE20K acquisition + indexing + datasets on the host, a copy of
``lc2is_tpu/data/ade20k.py`` (the port imports nothing of the JAX package).

Behavioral port of the reference data layer:
- download/prepare: HTTP fetch with sha1 verify + zip extract
  (``data/ade20k/download.py:31-99``, ``prepare_ade20k.py:9-35``)
- index: ``{split}.txt`` of ``x.jpg x.png`` pairs with missing-annotation
  warnings (``data/utils.py:6-25``)
- class-name mapping from ``objectInfo150.txt`` tab/comma format, first
  synonym (``data/dataset.py:56-61``); ids are 1-based, background 0 excluded
- ``ADE20K`` dataset semantics (``data/dataset.py:111-172``): PIL load,
  to-tensor 0-1 image / raw long label, ImageNet normalization, one RNG key
  split across img+label random transforms (the torch shared-RNG-state trick
  at ``dataset.py:145-149`` made deterministic), metas with size + present
  class ids/texts
- plus a deterministic synthetic dataset so CI and benchmarks never need the
  2 GB download (SURVEY.md §4).
"""

from __future__ import annotations

import hashlib
import os
import zipfile
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

ADE20K_URLS = [
    (
        "http://data.csail.mit.edu/places/ADEchallenge/ADEChallengeData2016.zip",
        "219e1696abb36c8ba3a3afe7fb2f4b4606a897c7",
    ),
    (
        "http://data.csail.mit.edu/places/ADEchallenge/release_test.zip",
        "e05747892219d10e9243933371a497e905a4860c",
    ),
]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)


def check_sha1(filename: str, sha1_hash: str) -> bool:
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url: str, path: str, overwrite: bool = False, sha1_hash: Optional[str] = None) -> str:
    """sha1-verified streaming HTTP download with a progress bar
    (``download.py:31-99`` semantics: an existing file with a mismatching
    hash is RE-downloaded, not trusted; progress is chunked over
    content-length).  Requires network egress — in the sealed environment
    use ``synthetic=True`` datasets."""
    import urllib.request

    fname = os.path.join(path, url.split("/")[-1])
    # reference gate (download.py:61-64): re-download on overwrite, absence,
    # OR a stale/corrupt existing file
    if os.path.exists(fname) and not overwrite and (sha1_hash is None or check_sha1(fname, sha1_hash)):
        return fname
    os.makedirs(path, exist_ok=True)
    print(f"Downloading {fname} from {url}...")
    with urllib.request.urlopen(url) as r:
        if getattr(r, "status", 200) not in (None, 200):
            raise RuntimeError(f"Failed downloading url {url}")
        total = r.headers.get("content-length")
        total_kb = int(int(total) / 1024.0 + 0.5) if total else None
        try:
            from tqdm import tqdm

            bar = tqdm(total=total_kb, unit="KB", unit_scale=False, dynamic_ncols=True)
        except Exception:  # offline-image safety; reference hard-imports tqdm
            bar = None
        with open(fname, "wb") as f:
            while True:
                chunk = r.read(1024)
                if not chunk:
                    break
                f.write(chunk)
                if bar is not None:
                    bar.update(1)
        if bar is not None:
            bar.close()
    if sha1_hash and not check_sha1(fname, sha1_hash):
        # the reference only warns here (download.py:92-97); a corrupt
        # archive would then crash the extractor, so we raise instead —
        # the next call re-downloads (hash-gate above)
        raise RuntimeError(f"sha1 mismatch for {fname}; re-run to re-download")
    return fname


def prepare_ade20k(root: str, overwrite: bool = False) -> Path:
    """``prepare_ade20k.py``: download + extract into {root}/ade20k/data."""
    dataset_dir = Path(root) / "ade20k"
    dl = dataset_dir / "downloads"
    dl.mkdir(parents=True, exist_ok=True)
    for url, checksum in ADE20K_URLS:
        fname = download(url, str(dl), overwrite=overwrite, sha1_hash=checksum)
        with zipfile.ZipFile(fname) as zf:
            zf.extractall(path=str(dataset_dir / "data"))
    return dataset_dir / "data" / "ADEChallengeData2016"


def create_text_file(folder: str, image_path: str, label_path: str, split: str) -> str:
    """``data/utils.py:6-25`` — write '{l}.jpg {l}.png' index lines."""
    imgs = os.listdir(image_path)
    labels = os.listdir(label_path)
    label_stems = [l.rsplit(".", 1)[0] for l in labels]
    missing = sum(1 for img in imgs if img.rsplit(".", 1)[0] not in label_stems)
    if missing:
        print(f"Number of missing annotation: {missing}")
    file_name = os.path.join(folder, split + ".txt")
    with open(file_name, "w") as w:
        w.writelines(f"{l}.jpg {l}.png\n" for l in sorted(label_stems))
    return file_name


def read_txt_file(file: str) -> List[List[str]]:
    return [line.strip("\n").split(" ") for line in open(file).readlines()]


def parse_object_info(info_file: str) -> List[Dict]:
    """``dataset.py:56-61``: id + first synonym + full synonym list."""
    lines = open(info_file).readlines()
    info = [c.strip("\n").split("\t") for c in lines]
    return [
        dict(id=int(info[i][0]), cls=info[i][-1].split(", ")[0], text_list=info[i][-1].split(", "))
        for i in range(1, len(info))
    ]


ADE20K_CLASS_NAMES_FALLBACK = [f"class {i}" for i in range(1, 151)]


class ADE20KDataset:
    """The newest-generation ``ADE20K`` dataset (``dataset.py:111-172``)."""

    def __init__(
        self,
        root: Optional[str] = None,
        split: str = "validation",
        size: Optional[int] = None,
        transform: Optional[Callable] = None,
        normalize: str = "imagenet",
        seed: int = 0,
    ) -> None:
        self.root = root or os.path.join(os.getcwd(), "data/ade20k/data/ADEChallengeData2016")
        self.split = split
        self.transform = transform
        self.normalize = normalize
        self.seed = seed
        self.epoch = 0
        self.img_folder = os.path.join(self.root, "images", split)
        self.label_folder = os.path.join(self.root, "annotations", split)
        info_file = os.path.join(self.root, "objectInfo150.txt")
        if os.path.exists(info_file):
            self.mapping = parse_object_info(info_file)
        else:
            self.mapping = [dict(id=i + 1, cls=n, text_list=[n]) for i, n in enumerate(ADE20K_CLASS_NAMES_FALLBACK)]
        self.class_names = ["none"] + [m["cls"] for m in self.mapping]

        data_file = os.path.join(self.root, split + ".txt")
        if os.path.exists(data_file):
            self.data = read_txt_file(data_file)
        elif os.path.isdir(self.img_folder):
            data_file = create_text_file(self.root, self.img_folder, self.label_folder, split)
            self.data = read_txt_file(data_file)
        else:
            raise FileNotFoundError(
                f"ADE20K not found at {self.root}; run lc2is_tpu_torch.cli.prepare_data "
                f"or use SyntheticADE20K"
            )
        if size:
            self.data = self.data[:size]

    def __len__(self):
        return len(self.data)

    def set_epoch(self, epoch: int) -> None:
        """Advance the aug RNG stream (call once per epoch, like a torch
        DistributedSampler) so every (seed, epoch, index) triple maps to one
        deterministic augmentation, independent of global RNG state."""
        self.epoch = int(epoch)

    def _item_seed(self, index: int) -> int:
        # SeedSequence mixes (base seed, epoch, index) into a well-spread
        # 31-bit seed; reproducible regardless of np.random global state.
        return int(np.random.SeedSequence([self.seed, self.epoch, index]).generate_state(1)[0] >> 1)

    def __getitem__(self, index: int):
        from PIL import Image

        img_path, label_path = self.data[index]
        img = Image.open(os.path.join(self.img_folder, img_path)).convert("RGB")
        label = Image.open(os.path.join(self.label_folder, label_path))
        img = np.asarray(img, dtype=np.float32).transpose(2, 0, 1) / 255.0  # to_tensor
        label = np.asarray(label, dtype=np.int64)  # pil_to_tensor, no scaling
        metas = self.get_metas(label)
        if self.transform is not None:
            if self.normalize == "imagenet":
                img = (img - IMAGENET_MEAN[:, None, None]) / IMAGENET_STD[:, None, None]
            # one seed drives both transforms — the deterministic version of
            # the torch get/set_rng_state trick (dataset.py:145-149); derived
            # from (seed, epoch, index), not the global NumPy stream
            seed = self._item_seed(index)
            img = self.transform(img, seed=seed, is_label=False)[None]
            label = self.transform(label[None].astype(np.float32), seed=seed, is_label=True)[0]
            label = label.astype(np.int64)[None]
        else:
            img = img[None]
            label = label[None]
        return img, label, metas

    def get_metas(self, label: np.ndarray) -> Dict:
        size = tuple(label.shape)
        class_ids = np.unique(label).tolist()
        if 0 in class_ids:
            class_ids.remove(0)
        class_texts = [self.mapping[i - 1]["cls"] for i in class_ids]
        # gt = the ORIGINAL-resolution label, so eval can run the GT-path
        # mIoU (metrics.py:61-79) the reference intends but never wires up
        # (its eval_outputs lack gt_list/sizes — SURVEY.md §8).
        return dict(size=size, class_ids=class_ids, class_texts=class_texts, gt=label)


class ADE20KClassDataset(ADE20KDataset):
    """The older-generation ``ADE20K_Dataset`` (``dataset.py:17-61``): raw
    uint8 image + label + size + per-image present class ids/texts, consumed
    by OldCollator/JoinTextCollator.  ids are 1-based; background 0 dropped;
    class text = first synonym."""

    def __init__(self, root: Optional[str] = None, split: str = "validation",
                 size: Optional[int] = None) -> None:
        super().__init__(root=root, split=split, size=size, transform=None)

    def __getitem__(self, index: int):
        from PIL import Image

        img_path, label_path = self.data[index]
        img = np.asarray(Image.open(os.path.join(self.img_folder, img_path)).convert("RGB"),
                         dtype=np.uint8).transpose(2, 0, 1)
        label = np.asarray(Image.open(os.path.join(self.label_folder, label_path)).convert("L"),
                           dtype=np.int64)
        size = np.asarray([label.shape], dtype=np.int64)
        class_ids = np.unique(label).tolist()
        if 0 in class_ids:
            class_ids.remove(0)  # not a class (dataset.py:46-49)
        class_texts = [self.mapping[i - 1]["cls"] for i in class_ids]
        return img, label, size, class_texts, class_ids


class ADE20KFullClassDataset(ADE20KDataset):
    """``ADE20K_DatasetFullClass`` (``dataset.py:63-109``): adds the full
    151-name prompt list ('a photo of a ...', background 'none') and keeps
    background in per-image ids (text 'none')."""

    def __init__(self, root: Optional[str] = None, split: str = "validation",
                 size: Optional[int] = None) -> None:
        super().__init__(root=root, split=split, size=size, transform=None)
        self.full_mapping = [dict(id=0, cls="none", text_list=["none"])] + self.mapping

    def __getitem__(self, index: int):
        from PIL import Image

        img_path, label_path = self.data[index]
        img = np.asarray(Image.open(os.path.join(self.img_folder, img_path)).convert("RGB"),
                         dtype=np.uint8).transpose(2, 0, 1)
        label = np.asarray(Image.open(os.path.join(self.label_folder, label_path)).convert("L"),
                           dtype=np.int64)
        size = np.asarray([label.shape], dtype=np.int64)
        class_ids = np.unique(label).tolist()
        class_texts = [self.mapping[i - 1]["cls"] if i != 0 else "none" for i in class_ids]
        classes = ["a photo of a " + m["cls"] for m in self.mapping]  # dataset.py:95
        return img, label, size, class_texts, class_ids, classes


class SyntheticADE20K:
    """Deterministic fake ADE20K: blocky label maps + correlated images.
    Same item/meta contract as ADE20KDataset; no files needed."""

    def __init__(
        self,
        length: int = 64,
        img_size: int = 512,
        num_classes: int = 151,
        split: str = "validation",
        transform: Optional[Callable] = None,
        seed: int = 0,
    ) -> None:
        self.length = length
        self.img_size = img_size
        self.num_classes = num_classes
        self.transform = transform
        self.seed = seed
        self.mapping = [dict(id=i + 1, cls=f"thing {i + 1}", text_list=[f"thing {i + 1}"]) for i in range(num_classes - 1)]
        self.class_names = ["none"] + [m["cls"] for m in self.mapping]

    def __len__(self):
        return self.length

    def _gen(self, index: int):
        rng = np.random.RandomState(self.seed * 100003 + index)
        s = self.img_size
        cells = 8
        lab_small = rng.randint(0, self.num_classes, size=(cells, cells))
        label = np.kron(lab_small, np.ones((s // cells, s // cells), dtype=np.int64))
        palette = rng.rand(self.num_classes, 3).astype(np.float32)
        img = palette[label].transpose(2, 0, 1)
        img += 0.05 * rng.randn(3, s, s).astype(np.float32)
        return np.clip(img, 0, 1), label.astype(np.int64)

    def __getitem__(self, index: int):
        img, label = self._gen(index)
        metas_label = label
        size = tuple(label.shape)
        class_ids = np.unique(label).tolist()
        if 0 in class_ids:
            class_ids.remove(0)
        class_texts = [self.mapping[i - 1]["cls"] for i in class_ids]
        metas = dict(size=size, class_ids=class_ids, class_texts=class_texts, gt=metas_label)
        if self.transform is not None:
            img = (img - IMAGENET_MEAN[:, None, None]) / IMAGENET_STD[:, None, None]
            seed = int(np.random.randint(0, 2 ** 31 - 1))
            img = self.transform(img, seed=seed, is_label=False)[None]
            label = self.transform(label[None].astype(np.float32), seed=seed, is_label=True)[0]
            label = label.astype(np.int64)[None]
        else:
            img = img[None]
            label = label[None]
        return img.astype(np.float32), label, metas
