"""Logging backends: wandb (if it imports), CSV and null, counterpart of
``lc2is_tpu/engine/loggers.py``.

The reference logs to wandb (``engine.py:50-52,181-182``): init at train
start, one dict a log step with the ``a_b -> a/b`` key rename, finish at the
end.  The CSV and null loggers serve machines without wandb; asking for wandb
where it does not import falls back to CSV and says so.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Optional


def rename_keys(metrics: Dict) -> Dict:
    """``engine.py:182``: "train_loss" -> "train/loss" (every underscore)."""
    return {"/".join(k.split("_")): v for k, v in metrics.items()}


class NullLogger:
    def init(self, **kwargs):
        pass

    def log(self, metrics: Dict):
        pass

    def finish(self):
        pass


class CSVLogger:
    """One row a ``log`` call in ``{out_dir}/{name}.csv``, the columns those
    of the first row."""

    def __init__(self, out_dir: str, name: str = "log"):
        self.path = os.path.join(out_dir, f"{name}.csv")
        os.makedirs(out_dir, exist_ok=True)
        self._fieldnames = None

    def init(self, **kwargs):
        pass

    def log(self, metrics: Dict):
        metrics = {k: (float(v) if hasattr(v, "__float__") else v) for k, v in metrics.items()}
        exists = os.path.exists(self.path)
        if self._fieldnames is None:
            self._fieldnames = list(metrics.keys())
        row = {k: metrics.get(k, "") for k in self._fieldnames}
        with open(self.path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._fieldnames)
            if not exists:
                w.writeheader()
            w.writerow(row)

    def finish(self):
        pass


class WandbLogger:
    def __init__(self, **init_kwargs):
        import wandb  # only where it is installed

        self._wandb = wandb
        self._init_kwargs = init_kwargs

    def init(self, **kwargs):
        self._wandb.init(**{**self._init_kwargs, **kwargs})

    def log(self, metrics: Dict):
        self._wandb.log(rename_keys(metrics))

    def finish(self):
        self._wandb.finish()


def make_logger(kind: str, out_dir: str = "./", logger_args: Optional[Dict] = None):
    """``"wandb"``, ``"csv"`` or anything else (null)."""
    if kind == "wandb":
        try:
            return WandbLogger(**(logger_args or {}))
        except ImportError:
            print("wandb not installed; falling back to csv logger")
            kind = "csv"
    if kind == "csv":
        return CSVLogger(out_dir)
    return NullLogger()
