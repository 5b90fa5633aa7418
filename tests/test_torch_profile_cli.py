"""The port's profile_pipeline program on the CPU, against the JAX
package's on the same image (the 120x160 reference image of
``tests/fixtures/detector_golden.npz``, as ``.npy`` for the port and PNG
for JAX): the same header and stage names, one fenced call per stage and
run, and a Chrome trace of the port's operations."""

import glob
import json
import os

import numpy as np
import jax

from affnet_tpu.cli import profile_pipeline as jprofile
from affnet_tpu_torch.cli import profile_pipeline

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


def test_profile_pipeline_runs_and_traces(tmp_path, capsys):
    from PIL import Image
    img = np.clip(np.load(os.path.join(FIX, "detector_golden.npz"))["img"],
                  0, 255).astype(np.uint8)
    npy, png = str(tmp_path / "img.npy"), str(tmp_path / "img.png")
    np.save(npy, img)
    Image.fromarray(img).save(png)
    trace = str(tmp_path / "trace")
    timer = profile_pipeline.main([npy, "--nfeats", "100",
                                   "--runs", "1", "--trace", trace,
                                   "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "image 160x120, 100 features, 1 runs:"
    assert {ln.split(":")[0] for ln in out[1:4]} == set(
        profile_pipeline.STAGES)
    assert timer.counts == {s: 1 for s in profile_pipeline.STAGES}
    assert out[4] == f"profiler trace -> {trace}"
    files_ = glob.glob(os.path.join(trace, "*.pt.trace.json"))
    assert len(files_) == 1
    with open(files_[0]) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any(n.startswith("aten::conv") for n in names)
    # JAX's program prints the same header and stage names.
    with jax.default_device(jax.devices("cpu")[0]):
        jprofile.main([png, "--nfeats", "100", "--runs", "1"])
    jout = capsys.readouterr().out.splitlines()
    assert jout[0] == out[0]
    assert {ln.split(":")[0] for ln in jout[1:4]} == set(
        profile_pipeline.STAGES)
