"""Small utilities: the precision policy and the training metrics log.

``MetricsLogger`` is a copy of ``affnet_tpu/utils.py``'s.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any

import torch


@contextlib.contextmanager
def float32_math():
    """float32 tensors mean float32 math on the card, as the JAX package
    pins at import (``affnet_tpu/__init__.py``): TF32 off for cuDNN
    convolutions and CUDA matmuls inside the block, the caller's flags
    restored after it.  The public entry points (the extractor's ``run``,
    ``train.train_loop`` and its step, ``LAFShapeOptimizer.optimize``) run
    under it, whatever flags the caller set.  bf16 convolutions (the
    extractor's ``fast`` mode) are explicit dtypes and do not read these
    flags.  Usable as a decorator: ``@float32_math()``."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


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
