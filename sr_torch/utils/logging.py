"""Structured metrics logging: JSONL always, TensorBoard optionally.

Port of ``sr/utils/logging.py``. The primary sink is an append-only JSONL
file (machine-readable, crash-safe), one line a record with the JAX
package's keys and the same ``ts`` stamp. TensorBoard is a secondary sink
through ``torch.utils.tensorboard``, which needs the ``tensorboard``
package; where it does not import, the logger is inactive and every call
does nothing, as the JAX package's logger is without ``tensorflow``. That
is the reference's behaviour for an optional sink, not a device fallback.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any

import numpy as np


class JSONLLogger:
    """Append-only JSONL metrics log."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self._fh = open(path, "a", buffering=1)

    def log(self, record: dict[str, Any]) -> None:
        rec = {"ts": round(time.time(), 3)}
        for k, v in record.items():
            if isinstance(v, (np.floating, np.integer)):
                v = v.item()
            rec[k] = v
        self._fh.write(json.dumps(rec) + "\n")

    __call__ = log

    def close(self):
        self._fh.close()


class TensorBoardLogger:
    """Optional TB sink (scalar/image/histogram); inactive, and every call a
    no-op, when ``torch.utils.tensorboard`` cannot import."""

    def __init__(self, log_dir: str):
        self._writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self._writer = SummaryWriter(log_dir)

    @property
    def active(self) -> bool:
        return self._writer is not None

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._writer is None:
            return
        self._writer.add_scalar(tag, float(value), global_step=step)

    def image(self, tag: str, img: np.ndarray, step: int) -> None:
        """img: (H, W, C) float [0,1] or uint8."""
        if self._writer is None:
            return
        if img.dtype != np.uint8:
            img = np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)
        self._writer.add_image(tag, img, global_step=step, dataformats="HWC")

    def histogram(self, tag: str, values: np.ndarray, step: int) -> None:
        if self._writer is None:
            return
        self._writer.add_histogram(tag, np.asarray(values), global_step=step)

    def flush(self):
        if self._writer is not None:
            self._writer.flush()

    def close(self):
        if self._writer is not None:
            self._writer.close()
