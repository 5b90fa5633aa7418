"""Small utilities: the precision policy, stage timers, profiler traces
and the training metrics log.

Counterparts of ``affnet_tpu/utils.py``:

  - :func:`fence` and :class:`StageTimer` — wall-clock stage timing that
    waits for the card (a synchronize and a device -> host read of one
    element per tensor, as JAX's ``fence`` reads one with ``device_get``)
  - :func:`profiler_trace` — a ``torch.profiler`` trace context writing a
    Chrome trace (JAX's writes a TensorBoard trace)
  - :class:`MetricsLogger` — structured JSONL metrics (a copy of JAX's)
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict

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


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def fence(tree) -> None:
    """Wait until every tensor of a nested dict, list or tuple is computed:
    synchronize its CUDA device, then read one element of it on the host.
    Leaves that are not tensors are ignored."""
    for t in _tensors(tree):
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        t.detach().reshape(-1)[:1].cpu()


class StageTimer:
    """Accumulating per-stage wall-clock timer.

    with timer.stage('detect'):
        out = detect(...)
        fence(out)
    print(timer.report())
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, tree=None):
        t0 = time.perf_counter()
        yield
        if tree is not None:
            fence(tree)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name}: {1000 * total:.1f} ms total "
                         f"({1000 * total / n:.1f} ms/call x {n})")
        return "\n".join(lines)


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """A ``torch.profiler`` context recording the CPU, and the card's
    kernels and copies when CUDA is available; on exit it writes a Chrome
    trace ``<pid>.<ns>.pt.trace.json`` into ``log_dir`` (view it in
    chrome://tracing or Perfetto).  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"{os.getpid()}.{time.time_ns()}.pt.trace.json"))


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
