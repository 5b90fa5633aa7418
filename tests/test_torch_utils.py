"""The port's stage timers and profiler trace (affnet_tpu_torch.utils) on
the CPU, with the report text held to JAX's StageTimer (affnet_tpu.utils)
on the same totals."""

import glob
import json
import os
import time

import torch

from affnet_tpu import utils as ju
from affnet_tpu_torch import utils as tu


def test_stage_timer_totals_and_report_match_jax():
    timer = tu.StageTimer()
    for _ in range(3):
        with timer.stage("short"):
            time.sleep(0.001)
        with timer.stage("long", tree={"x": torch.ones(3)}):
            time.sleep(0.004)
    assert timer.counts == {"short": 3, "long": 3}
    assert timer.totals["long"] >= 0.012 and timer.totals["short"] >= 0.003
    assert timer.totals["long"] > timer.totals["short"]
    lines = timer.report().splitlines()
    assert lines[0].startswith("long: ") and lines[1].startswith("short: ")
    ref = ju.StageTimer()
    ref.totals, ref.counts = dict(timer.totals), dict(timer.counts)
    assert timer.report() == ref.report()
    assert tu.StageTimer().report() == ""


def test_fence_walks_nested_trees(monkeypatch):
    read = []
    real = torch.Tensor.cpu

    def spy(self, *a, **kw):
        read.append(self.numel())
        return real(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", spy)
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": [torch.zeros(()), (torch.ones(4, 5), "text", 3)],
            "c": {"d": torch.empty(0)}, "e": None}
    tu.fence(tree)
    # One element of each tensor (none of the empty one) read on the host.
    assert read == [1, 1, 1, 0]
    tu.fence(torch.ones(2))
    tu.fence([])


def test_profiler_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    log_dir = str(tmp_path / "trace")
    with tu.profiler_trace(log_dir):
        x = torch.ones(64, 64)
        (x @ x).sum()
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)
