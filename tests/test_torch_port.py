"""Port hygiene: no JAX in the port, the kernel build's contract, and
chip_smoke.py's refusal to run without a card."""

import glob
import os
import re
import subprocess
import sys

import pytest
import torch

from affnet_tpu_torch.kernels import build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_and_chip_smoke_import_no_jax():
    code = (
        "import sys\n"
        "import affnet_tpu_torch, affnet_tpu_torch.detector\n"
        "import affnet_tpu_torch.models, affnet_tpu_torch.ops\n"
        "import affnet_tpu_torch.train, affnet_tpu_torch.data\n"
        "import affnet_tpu_torch.ops.batched_sampler\n"
        "import affnet_tpu_torch.kernels.build\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'affnet_tpu' or m.startswith('affnet_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def test_sources_have_no_pytorch_headers():
    srcs = glob.glob(os.path.join(build.CSRC_DIR, "*.cu*"))
    assert {os.path.basename(s) for s in build.sources()} >= {
        "blur.cu", "detect.cu", "topk.cu", "patches.cu", "patches_bwd.cu"}
    pattern = re.compile(r'#\s*include\s*[<"](torch|ATen|c10|pybind11|Python)')
    for path in srcs:
        with open(path) as f:
            assert not pattern.search(f.read()), path


def test_one_nvcc_call_into_hashed_build_dir():
    out = build.library_path()
    assert os.path.dirname(out) == build.BUILD_DIR
    assert build.source_hash() in os.path.basename(out)
    cmd = build.nvcc_command("/x/nvcc", out)
    assert cmd[0] == "/x/nvcc"
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert cmd[cmd.index("-o") + 1] == out
    assert sorted(c for c in cmd if c.endswith(".cu")) == build.sources()
    assert set(build.SIGNATURES) == {
        "launch_blur", "launch_detect_octave", "launch_row_topm",
        "launch_sample_patches", "launch_sample_patches_bwd"}


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_chip_smoke_refuses_without_cuda(monkeypatch, capsys):
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main([]) != 0
    assert capsys.readouterr().out == ""
