"""The port's external-keypoint API (affnet_tpu_torch.keypoints) against
the JAX package's (affnet_tpu.keypoints) on the same inputs, on the CPU.

Inputs: the 120x160 reference image of ``tests/fixtures/
detector_golden.npz`` and keypoints made with numpy from a seed (sizes 2-30
px, many within 3 x size of the border, so most patches reach past the
image).  JAX samples through its XLA gather (the conftest turns its Pallas
sampler off), the port through B4's plain version.

Tolerances (largest differences measured on these inputs, CPU, in
brackets): ``lafs_from_keypoints`` rtol 1e-6 / atol 1e-7 (float32 rounding
of the same expressions); the sampler on the same LAFs rtol 5e-5 / atol
5e-3 grey levels, as in tests/test_torch_patches.py.  Through the nets,
whose float32 convolutions sum in another order: shapes atol 1e-5 (2.4e-6),
LAFs atol 1e-3 px (4.1e-4), angles 1e-3 degrees modulo 360 (2.3e-4),
descriptors atol 1e-4 (7.9e-6), and the desc patches atol 0.1 grey levels
(0.034: their LAFs differ by the shapes' and angles' rounding).
"""

import os

import numpy as np
import pytest
import torch

from affnet_tpu import keypoints as jk
from affnet_tpu.models import AffNetFast as JAffNetFast
from affnet_tpu.models import HardTFeatNet as JHardTFeatNet
from affnet_tpu.models import OriNetFast32 as JOriNetFast32
from affnet_tpu.models import SIFTNet as JSIFTNet
from affnet_tpu.models.convert import load_pretrained as jload
from affnet_tpu_torch import keypoints as tk
from affnet_tpu_torch.cli import pretrained
from affnet_tpu_torch.models import (AffNetFast, HardTFeatNet, OriNetFast32,
                                     SIFTNet)
from affnet_tpu_torch.ops import cuda_patches

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture(scope="module")
def img():
    return np.load(os.path.join(FIX, "detector_golden.npz"))["img"].astype(
        np.float32)


def _keypoints(seed, n, h, w, border=False):
    rng = np.random.RandomState(seed)
    size = rng.uniform(2.0, 30.0, n)
    if border:      # centres within 3 x size of an edge, some outside it
        x = np.where(rng.rand(n) < 0.5, rng.uniform(-2, 3, n) * size / 2,
                     w - rng.uniform(-2, 3, n) * size / 2)
        y = rng.uniform(0, h, n)
    else:
        x, y = rng.uniform(0, w, n), rng.uniform(0, h, n)
    angle = rng.uniform(-180.0, 180.0, n)
    return x.astype(np.float32), y.astype(np.float32), size.astype(
        np.float32), angle.astype(np.float32)


def _angle_diff(a, b):
    return np.abs((a - b + 180.0) % 360.0 - 180.0)


@pytest.mark.parametrize("with_angle", [False, True])
def test_lafs_from_keypoints_matches_jax(with_angle):
    x, y, size, angle = _keypoints(0, 50, 120, 160)
    ang = angle if with_angle else None
    got = tk.lafs_from_keypoints(x, y, size, ang, (120, 160), 6.0).numpy()
    ref = np.asarray(jk.lafs_from_keypoints(x, y, size, ang, (120, 160),
                                            6.0))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    # The JAX test's geometry: (x/w, y/h), r = mr * size / 2 / min(h, w),
    # a 90-degree OpenCV angle is a rotation by -90 degrees.
    lafs = tk.lafs_from_keypoints([50.0, 100.0], [40.0, 80.0], [4.0, 8.0],
                                  [0.0, 90.0], (160, 200)).numpy()
    r1 = 6.0 * 8.0 / 2.0 / 160.0
    np.testing.assert_allclose(lafs[0, :, 2], [50 / 200, 40 / 160],
                               rtol=1e-6)
    np.testing.assert_allclose(lafs[1, :2, :2], [[0.0, -r1], [r1, 0.0]],
                               atol=1e-6)


STAGES = {
    "none": (False, False, None),
    "shape": (True, False, None),
    "shape_ori": (True, True, None),
    "shape_ori_sift": (True, True, "SIFT"),
    "shape_ori_tfeat": (True, True, "TFeat"),
}


def _nets(stage):
    shape, ori, desc = STAGES[stage]
    port = [pretrained(AffNetFast(), "AffNetFast") if shape else None,
            pretrained(OriNetFast32(), "OriNetFast") if ori else None,
            {"SIFT": lambda: SIFTNet(patch_size=32),
             "TFeat": lambda: pretrained(HardTFeatNet(), "HardTFeatNet"),
             None: lambda: None}[desc]()]
    params = {}
    jnets = [None, None, None]
    if shape:
        jnets[0], params["aff"] = JAffNetFast, jload("AffNetFast")
    if ori:
        jnets[1], params["ori"] = JOriNetFast32, jload("OriNetFast")
    if desc == "SIFT":
        jnets[2] = JSIFTNet(patch_size=32)
    elif desc == "TFeat":
        jnets[2], params["desc"] = JHardTFeatNet, jload("HardTFeatNet")
    return port, jnets, params


def _compare(got, ref):
    assert set(ref) - {"n_overflow"} == set(got)
    atol = {"lafs": 1e-3, "shape": 1e-5, "patches": 0.1, "descs": 1e-4}
    for k, tol in atol.items():
        if k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=tol,
                                       err_msg=k)
    if "angle" in ref:
        assert _angle_diff(got["angle"], ref["angle"]).max() < 1e-3


@pytest.mark.parametrize("stage", list(STAGES))
def test_describe_keypoints_matches_jax(img, stage):
    h, w = img.shape
    x, y, size, angle = _keypoints(1, 40, h, w)
    port, jnets, params = _nets(stage)
    got = tk.describe_keypoints(img, x, y, size, angle, 6.0, *port,
                                device="cpu")
    ref = jk.describe_keypoints(img, x, y, size, angle, params, 6.0, *jnets)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    _compare(got, ref)
    if "descs" in got:
        np.testing.assert_allclose(np.linalg.norm(got["descs"], axis=1),
                                   1.0, atol=1e-5)


def test_process_keypoints_matches_jax_at_the_border(img):
    """Keypoints at the border with sizes up to 30 px: most samples lie
    outside the image and contribute zero, in both packages."""
    h, w = img.shape
    x, y, size, angle = _keypoints(2, 60, h, w, border=True)
    port, jnets, params = _nets("shape_ori_tfeat")
    lafs = tk.lafs_from_keypoints(x, y, size, angle, (h, w))
    with torch.inference_mode():
        got = tk.process_keypoints(torch.from_numpy(img), lafs, *port)
    got = {k: v.numpy() for k, v in got.items()}
    ref = jk.process_keypoints(img, np.asarray(lafs), params, *jnets)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    assert int(ref["n_overflow"]) == 0
    _compare(got, ref)
    # Most desc patches reach past the image: their outer samples are 0.
    outside = (got["patches"] == 0).mean(axis=(1, 2))
    assert (outside > 0.2).mean() > 0.5


def test_patches_match_jax_xla_gather(img):
    """The one-level sampler of the keypoint site against JAX's XLA gather
    over the same buffer and tables, at PS 32 (the shape, ori and desc
    sites) and PS 19."""
    from affnet_tpu.ops.patches import extract_patches_pyramid
    h, w = img.shape
    x, y, size, angle = _keypoints(3, 50, h, w)
    lafs = tk.lafs_from_keypoints(x, y, size, angle, (h, w))
    for ps in (32, 19):
        got = tk._extract(torch.from_numpy(img), lafs, ps, True).numpy()
        ref = extract_patches_pyramid(
            img, np.asarray(lafs), np.zeros(50, np.int32),
            np.zeros(1, np.int32), np.array([h], np.int32),
            np.array([w], np.int32), ps=ps)
        np.testing.assert_allclose(got, np.asarray(ref), rtol=5e-5,
                                   atol=5e-3)


def test_process_keypoints_launch_plan(img, monkeypatch):
    """One sampler call per stage, each over the image itself (a one-level
    buffer at row 0), and no sampler call without nets."""
    calls = []
    real = cuda_patches.extract_patches_pyramid

    def spy(buf, lafs, lvl, offs, hs, ws, ps=32, **kw):
        calls.append((buf.data_ptr(), tuple(buf.shape), ps,
                      offs.tolist(), hs.tolist(), ws.tolist(),
                      int(lvl.abs().sum())))
        return real(buf, lafs, lvl, offs, hs, ws, ps=ps, **kw)

    monkeypatch.setattr(tk, "extract_patches_pyramid", spy)
    x, y, size, angle = _keypoints(4, 10, *img.shape)
    t = torch.from_numpy(img)
    lafs = tk.lafs_from_keypoints(x, y, size, angle, img.shape)
    port, _, _ = _nets("shape_ori_tfeat")
    with torch.inference_mode():
        out = tk.process_keypoints(t, lafs)
        assert calls == [] and set(out) == {"lafs"}
        tk.process_keypoints(t, lafs, *port)
    h, w = img.shape
    assert calls == [(t.data_ptr(), (h, w), 32, [0], [h], [w], 0)] * 3
