"""The handcrafted estimators (affnet_tpu_torch/models/handcrafted.py) and
the HesAffBaum configuration of the extractor against the JAX package and
the reference goldens.

Tolerances:
- the estimators on the same patches: shapes atol 1e-5 (measured 4.5e-6),
  angles atol 1e-5 (the same bin; the last step rounds within an ulp), at
  most 1 bin in 100 flipped by a near-tie (measured: none);
- the golden: tests/test_detector.py's, LAFs atol 1e-2 and the count
  equal;
- the extractor against JAX's at 16 Baumberg iterations: the loop is
  chaotic for a few keypoints (uniform noise of 1e-5 grey levels on the
  120x160 image flips 3-4 of 56 keypoints and moves 5 of the 53 common
  LAFs farther than 1e-2 px, 2 of them over 1 px, in the port alone), so
  the keypoint sets may differ by 3 on each side and 15% of the common
  LAFs may lie farther than 1e-2 px; measured: 2 and 1 keypoints on one
  side only, 6 of 55 LAFs over 1e-2 (the largest 28 px).  At 2 iterations
  every common LAF is within 1e-2 px;
- the handcrafted orientation after detection: the same keypoints, at most
  2 of 200 orientations a bin apart (measured: none)."""

import math
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from affnet_tpu.detector import DetectorConfig as JConfig
from affnet_tpu.detector import ScaleSpaceAffinePatchExtractor as JExtractor
from affnet_tpu.models import handcrafted as jhc
from affnet_tpu_torch.detector import (DetectorConfig,
                                       ScaleSpaceAffinePatchExtractor)
from affnet_tpu_torch.models import AffineShapeEstimator, OrientationDetector
from affnet_tpu_torch.models import handcrafted as hc

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
BAUM = dict(border=5, mr_size=5.192, num_baum_iters=16)


@pytest.fixture(scope="module")
def golden():
    return np.load(os.path.join(FIX, "detector_golden.npz"))


def _patches(ps, n=200, seed=0):
    """Noise patches and patches cut from the fixture image."""
    rng = np.random.RandomState(seed)
    img = np.load(os.path.join(FIX, "detector_golden.npz"))["img"]
    ys = rng.randint(0, img.shape[0] - ps, n // 2)
    xs = rng.randint(0, img.shape[1] - ps, n // 2)
    cut = np.stack([img[y:y + ps, x:x + ps] for y, x in zip(ys, xs)])
    noise = rng.rand(n - n // 2, ps, ps) * 255
    return np.concatenate([cut, noise]).astype(np.float32)


@pytest.mark.parametrize("ps", [19, 32])
def test_estimators_match_jax(ps):
    p = _patches(ps)
    with jax.default_device(jax.devices("cpu")[0]):
        ref_A = np.asarray(jhc.affine_shape_estimator(jnp.asarray(p), ps))
        ref_ang = np.asarray(jhc.orientation_detector(jnp.asarray(p), ps))
        ref_rot = np.asarray(jhc.OrientationDetector(ps)(None,
                                                        jnp.asarray(p)))
    pt = torch.from_numpy(p)
    A = AffineShapeEstimator(ps)(pt).numpy()
    np.testing.assert_allclose(A, ref_A, atol=1e-5)
    det = OrientationDetector(ps)
    ang = det.angle(pt).numpy()
    bin_w = 2 * math.pi / hc.NUM_ANG_BINS
    flips = int((np.abs(ang - ref_ang) > 0.5 * bin_w).sum())
    assert flips <= len(p) // 100
    same = np.abs(ang - ref_ang) <= 0.5 * bin_w
    np.testing.assert_allclose(ang[same], ref_ang[same], atol=1e-5)
    np.testing.assert_allclose(det(pt).numpy()[same], ref_rot[same],
                               atol=1e-5)
    # Angles are bin centres: -(2 pi idx / 36 - pi).
    idx = (math.pi - ang) / bin_w
    np.testing.assert_allclose(idx, np.round(idx), atol=1e-4)


def test_affine_shape_estimator_identity_on_isotropic():
    ps = 19
    yy, xx = np.mgrid[0:ps, 0:ps].astype(np.float32)
    r2 = (yy - ps // 2) ** 2 + (xx - ps // 2) ** 2
    blob = torch.from_numpy(np.exp(-r2 / 20.0)[None].astype(np.float32))
    A = AffineShapeEstimator(ps)(blob).numpy()
    np.testing.assert_allclose(A[0], np.eye(2), atol=0.05)
    det = A[0, 0, 0] * A[0, 1, 1] - A[0, 0, 1] * A[0, 1, 0]
    np.testing.assert_allclose(det, 1.0, atol=1e-4)


def test_affine_shape_estimator_elongated():
    ps = 19
    yy, xx = np.mgrid[0:ps, 0:ps].astype(np.float32)
    stripes = (np.sin(xx * 2.0) + 0.2 * np.sin(yy * 1.3))[None]
    A = AffineShapeEstimator(ps)(torch.from_numpy(
        stripes.astype(np.float32))).numpy()
    assert A[0, 0, 0] < A[0, 1, 1]


def test_orientation_detector_rotation_consistency():
    ps = 19
    base = np.random.RandomState(3).rand(ps, ps).astype(np.float32)
    det = OrientationDetector(ps)
    a0 = float(det.angle(torch.from_numpy(base[None]))[0])
    a90 = float(det.angle(torch.from_numpy(np.rot90(base).copy()[None]))[0])
    diff = (a0 - a90 + np.pi) % (2 * np.pi) - np.pi
    assert abs(abs(diff) - np.pi / 2) < 0.3


def test_circular_gauss_kernel_matches_jax():
    for kw in (dict(kernlen=19), dict(kernlen=32, sigma=32 / 6.0),
               dict(sigma=2.0, circ_zeros=True), dict(kernlen=19, py2=True),
               dict(kernlen=9, norm=False)):
        np.testing.assert_array_equal(hc.circular_gauss_kernel(**kw),
                                      jhc.circular_gauss_kernel(**kw))


def test_extractor_defaults_to_baumberg_golden(golden):
    """No shape_net: the handcrafted estimator, 16 iterations, against the
    reference's HesAffBaum golden."""
    det = ScaleSpaceAffinePatchExtractor(
        DetectorConfig(num_features=50, **BAUM), device="cpu")
    out = det(golden["img"])
    assert len(out["resp"]) == len(golden["baum_resp"])
    np.testing.assert_allclose(out["lafs"], golden["baum_lafs"], atol=1e-2)
    np.testing.assert_allclose(out["resp"], golden["baum_resp"], atol=0.1,
                               rtol=1e-4)


def _jax_extract(img, cfg, **call):
    with jax.default_device(jax.devices("cpu")[0]):
        return JExtractor(JConfig(fused_detect=False, **cfg))(img, **call)


@pytest.mark.parametrize("iters", [16, 2])
def test_extractor_baumberg_matches_jax(golden, iters):
    cfg = dict(BAUM, num_features=200, num_baum_iters=iters)
    out = ScaleSpaceAffinePatchExtractor(DetectorConfig(**cfg),
                                         device="cpu")(golden["img"])
    ref = _jax_extract(golden["img"], cfg)
    only_ours = np.setdiff1d(out["orig_idx"], ref["orig_idx"]).size
    only_jax = np.setdiff1d(ref["orig_idx"], out["orig_idx"]).size
    assert only_ours <= 3 and only_jax <= 3
    common, gi, ri = np.intersect1d(out["orig_idx"], ref["orig_idx"],
                                    return_indices=True)
    assert len(common) >= 40
    np.testing.assert_allclose(out["resp"][gi], ref["resp"][ri], atol=0.1,
                               rtol=1e-4)
    err = np.abs(out["lafs"][gi] - ref["lafs"][ri]).reshape(
        len(common), -1).max(axis=1)
    allowed = 0 if iters <= 2 else len(common) * 15 // 100
    assert (err > 1e-2).sum() <= allowed, np.sort(err)[-8:]


def test_handcrafted_orientation_matches_jax(golden):
    """do_ori with no ori_net: the handcrafted orientation on the detected
    keypoints (no shape stage), against JAX's."""
    cfg = dict(num_features=200, border=5, mr_size=5.192, num_baum_iters=0)
    out = ScaleSpaceAffinePatchExtractor(DetectorConfig(**cfg),
                                         device="cpu")(golden["img"],
                                                       do_ori=True)
    ref = _jax_extract(golden["img"], cfg, do_ori=True)
    assert np.array_equal(out["orig_idx"], ref["orig_idx"])
    ang = np.arctan2(out["lafs"][:, 0, 1], out["lafs"][:, 0, 0])
    ref_ang = np.arctan2(ref["lafs"][:, 0, 1], ref["lafs"][:, 0, 0])
    diff = np.abs((ang - ref_ang + np.pi) % (2 * np.pi) - np.pi)
    flips = diff > 1e-3
    assert flips.sum() <= 2
    np.testing.assert_allclose(out["lafs"][~flips], ref["lafs"][~flips],
                               atol=1e-2)
