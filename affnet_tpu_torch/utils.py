"""Small utilities: the training metrics log.

``MetricsLogger`` is a copy of ``affnet_tpu/utils.py``'s.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any


class MetricsLogger:
    """Append-only JSONL metrics with a monotonically increasing step."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self._f = open(path, "a")

    def log(self, step: int, **metrics: Any) -> None:
        rec = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            rec[k] = float(v) if hasattr(v, "__float__") else v
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()
