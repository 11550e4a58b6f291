"""Metrics logging (the JAX package's train/metrics.py): every scalar to
``<log_dir>/metrics.jsonl``, and to TensorBoard event files when
``torch.utils.tensorboard`` imports (it needs the tensorboard package)."""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsWriter:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self._tb = SummaryWriter(log_dir)

    def scalar(self, tag: str, value: float, step: int):
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        self._jsonl.write(json.dumps({"tag": tag, "value": float(value),
                                      "step": int(step),
                                      "time": time.time()}) + "\n")

    def scalars(self, metrics: Dict[str, float], step: int, prefix: str = ""):
        for k, v in metrics.items():
            self.scalar(prefix + k, v, step)

    def flush(self):
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
