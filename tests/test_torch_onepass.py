"""The OnePassSIR slice (affnet_tpu_torch/onepass.py, models/dense.py)
against the JAX package and the reference golden
(tests/fixtures/onepass_golden.npz, as tests/test_onepass.py uses it).

Tolerances:
- ``local_norm_2d``: atol 1e-5 on values in [-6, 6] (measured 2.4e-7);
- the dense map: the golden's atol 1e-4 (measured 2.7e-6), JAX atol 1e-5
  (measured 6.0e-7), under the nchw layout and under flat;
- the detector: the golden's (responses atol 0.1 rtol 1e-4, LAFs atol
  1e-2), and against JAX the same keypoints in the same order, responses
  atol 0.1 rtol 1e-4, LAFs atol 1e-2 (measured 0.0094 and 0.0045),
  descriptors atol 1e-3 (measured 3.5e-4)."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from affnet_tpu.detector import DetectorConfig as JConfig
from affnet_tpu.models import SIFTNet as JSIFTNet
from affnet_tpu.models import cnn as jcnn
from affnet_tpu.models.convert import load_pretrained as jax_load_pretrained
from affnet_tpu.models.dense import AffNetFastFullConv as JDense
from affnet_tpu.models.dense import local_norm_2d as jlocal_norm_2d
from affnet_tpu.onepass import OnePassSIR as JOnePassSIR
from affnet_tpu.onepass import _dense_boundary_ok as j_dense_boundary_ok
from affnet_tpu_torch.detector import DetectorConfig
from affnet_tpu_torch.models import SIFTNet, cnn
from affnet_tpu_torch.models.dense import (AffNetFastFullConv, local_norm_2d,
                                           reflect_index)
from affnet_tpu_torch.onepass import OnePassSIR, _dense_boundary_ok
from affnet_tpu_torch.ops import launch_counts

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
GOLDEN = dict(border=15, mr_size=5.192, num_baum_iters=0)


@pytest.fixture(scope="module")
def golden():
    return np.load(os.path.join(FIX, "onepass_golden.npz"))


@pytest.fixture(scope="module")
def dense():
    return AffNetFastFullConv.pretrained()


def _cpu():
    return jax.default_device(jax.devices("cpu")[0])


def test_reflect_index_matches_numpy_beyond_the_map():
    for n in (1, 2, 3, 5, 14, 16):
        for pad in (0, 1, 3, 14, 16, 40):
            np.testing.assert_array_equal(
                reflect_index(n, pad).numpy(),
                np.pad(np.arange(n), pad, mode="reflect"))


@pytest.mark.parametrize("hw", [(9, 12), (14, 20), (16, 16), (40, 52)])
def test_local_norm_2d_matches_jax(hw):
    """The 16-pixel reflect pad reaches past maps under 17 px (an octave can
    be 14 px at border 5): numpy's repeated reflection, as JAX pads."""
    x = (np.random.RandomState(sum(hw)).rand(2, 1, *hw) * 255).astype(
        np.float32)
    got = local_norm_2d(torch.from_numpy(x)).numpy()
    with _cpu():
        ref = np.asarray(jlocal_norm_2d(jnp.asarray(x)))
    assert np.isfinite(got).all() and np.abs(got).max() <= 6.0
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("layout", ["nchw", "flat"])
def test_dense_map_matches_golden_and_jax(golden, dense, layout):
    with torch.no_grad(), cnn.eval_layout(layout):
        out = dense(torch.from_numpy(golden["img"])).numpy()
    assert out.shape == golden["dense_map"].shape == (1, 120, 160, 4)
    np.testing.assert_allclose(out, golden["dense_map"], atol=1e-4)
    with _cpu():
        ref = np.asarray(JDense()(jax_load_pretrained("AffNetFast"),
                                  jnp.asarray(golden["img"])))
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_flat_dense_trunk_runs_b7_layers(dense, monkeypatch):
    """On a 20x24 image the padded 48x52 map is within B7's contract: the
    flat stack takes the six trunk layers (B7's plain version on the CPU)
    and the 3-output head runs stock.  Held to JAX's nchw dense map; JAX's
    own flat layout agrees with its nchw one there (1.2e-7)."""
    img = (np.random.RandomState(7).rand(20, 24) * 255).astype(np.float32)
    calls = []
    real = cnn.conv_flat

    def spy(x, w, bias, hw, *args, **kw):
        calls.append(tuple(hw))
        return real(x, w, bias, hw, *args, **kw)

    monkeypatch.setattr(cnn, "conv_flat", spy)
    with torch.no_grad(), cnn.eval_layout("flat"):
        out = dense(torch.from_numpy(img)).numpy()
    assert calls == [(48, 52)] * 3 + [(24, 26)] * 2 + [(12, 13)]
    params = jax_load_pretrained("AffNetFast")
    old = jcnn.EVAL_CONV_LAYOUT
    try:
        with _cpu():
            ref = np.asarray(JDense()(params, jnp.asarray(img)))
            jcnn.EVAL_CONV_LAYOUT = "flat"
            ref_flat = np.asarray(JDense()(params, jnp.asarray(img)))
    finally:
        jcnn.EVAL_CONV_LAYOUT = old
    np.testing.assert_allclose(out, ref, atol=1e-5)
    np.testing.assert_allclose(ref_flat, ref, atol=1e-5)


def _jax_onepass(img, cfg, **kw):
    params = {"aff": jax_load_pretrained("AffNetFast")}
    desc = JSIFTNet(patch_size=32) if kw.get("describe") else None
    with _cpu():
        return JOnePassSIR(JConfig(**cfg), desc_net=desc)(
            img, params=params, **kw)


def _assert_same_keypoints(out, ref, keys=("resp", "lafs")):
    assert np.array_equal(out["orig_idx"], ref["orig_idx"])
    assert out["n_detected"] == ref["n_detected"]
    np.testing.assert_allclose(out["resp"], ref["resp"], atol=0.1, rtol=1e-4)
    np.testing.assert_allclose(out["lafs"], ref["lafs"], atol=1e-2)
    if "descs" in keys:
        np.testing.assert_allclose(out["descs"], ref["descs"], atol=1e-3)


def test_onepass_topk_matches_golden_and_jax(golden, dense):
    cfg = dict(num_features=50, **GOLDEN)
    before = launch_counts()
    out = OnePassSIR(DetectorConfig(**cfg), shape_net=dense,
                     device="cpu")(golden["img"])
    assert launch_counts() == before
    assert len(out["resp"]) == len(golden["resp"]) == 50
    np.testing.assert_allclose(out["resp"], golden["resp"], atol=0.1,
                               rtol=1e-4)
    np.testing.assert_allclose(out["lafs"], golden["lafs"], atol=1e-2)
    _assert_same_keypoints(out, _jax_onepass(golden["img"], cfg))


def test_onepass_describe_sift_matches_jax(golden, dense):
    cfg = dict(num_features=30, patch_size=32, **GOLDEN)
    out = OnePassSIR(DetectorConfig(**cfg), shape_net=dense,
                     desc_net=SIFTNet(patch_size=32),
                     device="cpu")(golden["img"], describe=True)
    assert out["descs"].shape == (30, 128)
    np.testing.assert_allclose(np.linalg.norm(out["descs"], axis=1), 1.0,
                               atol=1e-3)
    _assert_same_keypoints(out, _jax_onepass(golden["img"], cfg,
                                             describe=True),
                           keys=("resp", "lafs", "descs"))


def test_onepass_threshold_mode_matches_jax(golden, dense):
    """th 28.41 keeps every survivor of the 3x boundary gate in scan order;
    JAX's cap (32) binds, so it retries at the next power of two and
    returns the same set.  ``do_ori`` with no ori_net: the handcrafted
    orientation."""
    cfg = dict(num_features=50, th=28.41, max_keypoints=32, **GOLDEN)
    out = OnePassSIR(DetectorConfig(**cfg), shape_net=dense,
                     device="cpu")(golden["img"], do_ori=True)
    ref = _jax_onepass(golden["img"], cfg, do_ori=True)
    assert out["n_detected"] == len(out["resp"]) > 32
    assert np.all(np.diff(out["orig_idx"]) > 0)
    _assert_same_keypoints(out, ref)


def test_dense_boundary_ok_matches_jax():
    rng = np.random.RandomState(11)
    sc = (rng.rand(6, 9) * 0.1).astype(np.float32)
    yy, xx = (rng.rand(2, 6, 9) * 1.2 - 0.1).astype(np.float32)
    A = (rng.rand(6, 9, 2, 2) * 2 - 1).astype(np.float32)
    got = _dense_boundary_ok(*(torch.from_numpy(a) for a in (sc, yy, xx, A)),
                             3.0).numpy()
    with _cpu():
        ref = np.asarray(j_dense_boundary_ok(*(jnp.asarray(a) for a in
                                               (sc, yy, xx, A)), 3.0))
    assert got.dtype == np.bool_ and 0 < got.sum() < got.size
    np.testing.assert_array_equal(got, ref)
