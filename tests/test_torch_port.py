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
        "import affnet_tpu_torch.ops.pyramid_sampler\n"
        "import affnet_tpu_torch.shape_opt, affnet_tpu_torch.reproj\n"
        "import affnet_tpu_torch.models.sift, affnet_tpu_torch.cli\n"
        "import affnet_tpu_torch.cli.optimize_shapes\n"
        "import affnet_tpu_torch.cli.hesaffnet\n"
        "import affnet_tpu_torch.cli.hesaffbaum\n"
        "import affnet_tpu_torch.cli.extract_geom\n"
        "import affnet_tpu_torch.onepass, affnet_tpu_torch.models.dense\n"
        "import affnet_tpu_torch.models.handcrafted\n"
        "import affnet_tpu_torch.io_formats, affnet_tpu_torch.ops.cuda_conv\n"
        "import affnet_tpu_torch.kernels.build\n"
        "import affnet_tpu_torch.keypoints, affnet_tpu_torch.match\n"
        "import affnet_tpu_torch.export, affnet_tpu_torch.utils\n"
        "import affnet_tpu_torch.cli.detect_affine_shape\n"
        "import affnet_tpu_torch.cli.describe_keypoints\n"
        "import affnet_tpu_torch.cli.match_demo\n"
        "import affnet_tpu_torch.cli.eval_graf\n"
        "import affnet_tpu_torch.cli.profile_pipeline\n"
        "import affnet_tpu_torch.cli.train_affnet\n"
        "import affnet_tpu_torch.cli.train_orinet\n"
        "import affnet_tpu_torch.cli.train_descriptor\n"
        "import affnet_tpu_torch.cli.gen_ds, affnet_tpu_torch.losses\n"
        "import affnet_tpu_torch.augmentation, affnet_tpu_torch.models.zoo\n"
        "import affnet_tpu_torch.parallel, affnet_tpu_torch.hpatches\n"
        "import affnet_tpu_torch.cli.eval_hpatches\n"
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
        "blur.cu", "detect.cu", "topk.cu", "patches.cu", "patches_bwd.cu",
        "conv.cu"}
    pattern = re.compile(r'#\s*include\s*[<"](torch|ATen|c10|pybind11|Python)')
    for path in srcs:
        with open(path) as f:
            assert not pattern.search(f.read()), path


def test_one_nvcc_call_into_hashed_build_dir():
    """One nvcc call per source (started together), one link into the
    hashed library path."""
    out = build.library_path()
    assert os.path.dirname(out) == build.BUILD_DIR
    assert build.source_hash() in os.path.basename(out)
    objs = []
    for src in build.sources():
        cmd = build.compile_command("/x/nvcc", src, src + ".o")
        assert cmd[0] == "/x/nvcc" and "-c" in cmd
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert [c for c in cmd if c.endswith(".cu")] == [src]
        assert cmd[cmd.index("-o") + 1] == src + ".o"
        objs.append(src + ".o")
    cmd = build.link_command("/x/nvcc", objs, out)
    assert cmd[0] == "/x/nvcc" and "-shared" in cmd
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[cmd.index("-o") + 1] == out
    assert cmd[-len(objs):] == objs
    assert set(build.SIGNATURES) == {
        "launch_blur", "launch_detect_stencil", "launch_detect_dedup",
        "launch_detect_refine", "launch_row_topm", "launch_sample_patches",
        "launch_sample_patches_bwd", "launch_conv_flat"}


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


def test_sampler_and_topk_launch_signatures():
    """B3 takes the flat vector and its length (no padded matrix); B4's
    forward and backward take the base grid as a device pointer (no
    by-value table, so no limit on the patch size)."""
    P, I = build._P, build._I
    assert build.SIGNATURES["launch_row_topm"] == [P, I, P, P, P, I, I, P]
    fwd = build.SIGNATURES["launch_sample_patches"]
    bwd = build.SIGNATURES["launch_sample_patches_bwd"]
    assert len(fwd) == 16 and fwd[9] is P and fwd[11:13] == [I, I]
    assert len(bwd) == 17 and bwd[9] is P and bwd[13:15] == [I, I]
