"""The extraction slice as a whole: the port's ScaleSpaceAffinePatchExtractor
against the JAX one on the same image and weights (the bench.py config with
fewer features), and against the reference goldens.

Tolerances are tests/test_detector.py's: responses atol=0.1 rtol=1e-4,
LAFs atol=1e-2, descriptors atol=1e-3.  At 640x800 float32 rounding (the JAX
program contracts multiply-adds into FMAs; PyTorch rounds each op) reorders
near-tied responses and flips a few ill-conditioned decisions; the allowances
below are the ones ROADMAP.md Queue C records."""

import os

import numpy as np
import jax
import pytest
import torch

from affnet_tpu.detector import DetectorConfig as JConfig
from affnet_tpu.detector import ScaleSpaceAffinePatchExtractor as JExtractor
from affnet_tpu.models import AffNetFast as JAffNetFast
from affnet_tpu.models import HardTFeatNet as JHardTFeatNet
from affnet_tpu.models.convert import load_pretrained as jax_load_pretrained
from affnet_tpu_torch import load_pretrained
from affnet_tpu_torch.detector import (DetectorConfig,
                                       ScaleSpaceAffinePatchExtractor)
from affnet_tpu_torch.models import AffNetFast, HardTFeatNet, params_from_jax
from affnet_tpu_torch.laf import sc_y_x_to_lafs
from affnet_tpu_torch.ops import launch_counts
from affnet_tpu_torch.ops.nms import masked_topk
from affnet_tpu_torch.ops.scalespace import build_flat_pyramid
from test_torch_detect import old_detection_chain

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
BENCH = dict(border=5, mr_size=5.192, num_baum_iters=1, patch_size=32)


def _port(num_features, **kw):
    aff, desc = AffNetFast(), HardTFeatNet()
    aff.load_state_dict(params_from_jax(load_pretrained("AffNetFast")))
    desc.load_state_dict(params_from_jax(load_pretrained("HardTFeatNet")))
    return ScaleSpaceAffinePatchExtractor(
        DetectorConfig(num_features=num_features, **{**BENCH, **kw}),
        shape_net=aff, desc_net=desc, device="cpu")


def _jax(img, num_features):
    det = JExtractor(JConfig(num_features=num_features, th=None, **BENCH),
                     shape_net=JAffNetFast, desc_net=JHardTFeatNet)
    params = {"aff": jax_load_pretrained("AffNetFast"),
              "desc": jax_load_pretrained("HardTFeatNet")}
    return det(img, params=params, describe=True)


@pytest.fixture(scope="module")
def small():
    img = np.load(os.path.join(FIX, "detector_golden.npz"))["img"]
    with jax.default_device(jax.devices("cpu")[0]):
        ref = _jax(img, 256)
    return ref, _port(256)(img, describe=True)


@pytest.fixture(scope="module")
def fullres():
    img = np.load(os.path.join(FIX, "detector_golden_fullres.npz"))["img"]
    with jax.default_device(jax.devices("cpu")[0]):
        ref = _jax(img, 500)
    return ref, _port(500)(img, describe=True)


def test_small_image_identical_order(small):
    ref, got = small
    assert set(got) == set(ref)
    assert got["n_detected"] == ref["n_detected"]
    np.testing.assert_array_equal(got["orig_idx"], ref["orig_idx"])
    for k in ("oct_idx", "level_idx"):
        np.testing.assert_array_equal(got[k], ref[k])
    np.testing.assert_allclose(got["resp"], ref["resp"], atol=0.1, rtol=1e-4)
    np.testing.assert_allclose(got["lafs"], ref["lafs"], atol=1e-2)
    np.testing.assert_allclose(got["descs"], ref["descs"], atol=1e-3)
    diff = np.abs(got["patches"] - ref["patches"])
    assert np.quantile(diff, 0.999) < 0.05 and diff.max() < 3.0


def test_fullres_two_stage_topk_slice(fullres):
    """640x800 has more than 2^18 responses, so detection goes through the
    two-stage top-k (B3's plain version)."""
    ref, got = fullres
    assert got["n_detected"] == ref["n_detected"]
    assert len(got["resp"]) == len(ref["resp"]) == 500
    common, ri, gi = np.intersect1d(ref["orig_idx"], got["orig_idx"],
                                    return_indices=True)
    assert len(common) >= 500 - 2            # recorded: 1 differs
    # Order: the common keypoints keep their relative order, up to swaps of
    # responses equal within the response tolerance.
    by_port = ri[np.argsort(gi)]
    seq = ref["resp"][by_port]
    assert np.all(np.diff(seq) <= 0.1 + 1e-4 * seq[1:])
    np.testing.assert_allclose(got["resp"][gi], ref["resp"][ri], atol=0.1,
                               rtol=1e-4)
    for k, tol, allowed in (("lafs", 1e-2, 2), ("descs", 1e-3, 2)):
        err = np.abs(got[k][gi] - ref[k][ri]).reshape(len(common), -1)
        assert (err.max(axis=1) > tol).sum() <= allowed, k   # recorded: 1
    for k in ("oct_idx", "level_idx"):
        np.testing.assert_array_equal(got[k][gi], ref[k][ri])


def test_matches_reference_goldens():
    """The committed outputs of the original torch code (120x160 crop), at
    tests/test_detector.py's tolerances."""
    g = np.load(os.path.join(FIX, "detector_golden.npz"))
    kw = dict(num_features=50, border=5, mr_size=5.192)
    det = ScaleSpaceAffinePatchExtractor(DetectorConfig(**kw), device="cpu")
    out = det(g["img"])
    np.testing.assert_allclose(out["resp"], g["det_resp"], atol=0.1,
                               rtol=1e-4)
    np.testing.assert_allclose(out["lafs"], g["det_lafs"], atol=1e-2)
    aff = AffNetFast()
    aff.load_state_dict(params_from_jax(load_pretrained("AffNetFast")))
    det = ScaleSpaceAffinePatchExtractor(
        DetectorConfig(num_baum_iters=1, **kw), shape_net=aff, device="cpu")
    out = det(g["img"])
    assert len(out["resp"]) == len(g["aff_resp"])
    np.testing.assert_allclose(out["lafs"], g["aff_lafs"], atol=1e-2)


def _old_multiscale_detect(det, img):
    """``_multiscale_detect`` as it was before the detection stage was split:
    the full maps of every octave, the border mask and octave map per
    center level, the concatenated vectors, the selection, and (sigma, y,
    x) gathered from the full maps."""
    cfg = det.cfg
    p = det._plan(*img.shape)
    plan = p.plan
    pyr, flat = build_flat_pyramid(img, plan, py2=cfg.py2)
    chunks = [[] for _ in range(4)]
    for o in range(plan.n_octaves):
        resp, syx = old_detection_chain(pyr[o].contiguous(), plan.sigmas[o],
                                        cfg.effective_th, int(cfg.mr_size))
        for acc, m in zip(chunks, (resp, syx[:, 0], syx[:, 1], syx[:, 2])):
            acc.append(m.reshape(-1))
    resp_all, sc_all, y_all, x_all = (torch.cat(c) for c in chunks)
    survivor = resp_all > 0
    if cfg.threshold_mode:
        idxs = torch.nonzero(survivor)[:, 0]
        vals, valid = resp_all[idxs], survivor[idxs]
    else:
        vals, idxs, valid = masked_topk(
            resp_all, min(cfg.prefilter_count(), p.total))
    syx = torch.stack([sc_all[idxs], y_all[idxs], x_all[idxs]], -1)
    return {"flat": flat, "resp": vals, "lafs": sc_y_x_to_lafs(syx),
            "valid": valid, "orig_idx": idxs,
            "n_detected": survivor.sum()}


@pytest.mark.parametrize("fixture", ["detector_golden.npz",
                                     "detector_golden_fullres.npz"])
@pytest.mark.parametrize("th", [None, -1.0])
def test_detection_stage_unchanged_on_fixtures(fixture, th):
    """The level buffer, responses, selected indices and LAFs from the
    stencil, dedup and refine equal the full-map chain's bit for bit, in
    top-k mode and in the HesAffNet program's threshold mode."""
    img = torch.from_numpy(np.load(os.path.join(FIX, fixture))["img"])
    det = ScaleSpaceAffinePatchExtractor(
        DetectorConfig(num_features=500, th=th,
                       **{**BENCH, "num_baum_iters": 0}), device="cpu")
    got = det._multiscale_detect(img, det._plan(*img.shape))
    ref = _old_multiscale_detect(det, img)
    assert int(ref["n_detected"]) > 200
    for k, v in ref.items():
        assert torch.equal(got[k], v), k


def test_cpu_run_launches_no_kernel(small):
    before = launch_counts()
    _port(32)(np.load(os.path.join(FIX, "detector_golden.npz"))["img"],
              describe=True)
    assert launch_counts() == before


def test_config_and_device_checks(monkeypatch):
    with pytest.raises(ValueError, match="shape_net"):
        ScaleSpaceAffinePatchExtractor(DetectorConfig(num_baum_iters=1),
                                       device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ScaleSpaceAffinePatchExtractor(DetectorConfig())
    cfg = DetectorConfig(num_features=2000, num_baum_iters=1)
    assert cfg.prefilter_count() == 3000 and cfg.final_count() == 2000


def report() -> None:
    """Print the parity statistics ROADMAP.md Queue C records:
    ``python tests/test_torch_detector.py`` (from the repository root)."""
    import jax.numpy as jnp
    from affnet_tpu.ops.pallas_blur import gaussian_blur_pallas
    from affnet_tpu_torch.ops.scalespace import gaussian_blur
    full = np.load(os.path.join(FIX, "detector_golden_fullres.npz"))["img"]
    for sigma in (1.227, 1.52, 2.45):
        jb = np.asarray(gaussian_blur_pallas(jnp.asarray(full), sigma))
        tb = gaussian_blur(torch.from_numpy(full), sigma).numpy()
        print(f"blur 640x800 sigma {sigma}: max|diff| vs interpreted "
              f"Pallas {np.abs(jb - tb).max():.3g}")
    for name, img, k in (
            ("120x160", np.load(os.path.join(FIX, "detector_golden.npz"))
             ["img"], 256),
            ("640x800", full, 500)):
        ref, got = _jax(img, k), _port(k)(img, describe=True)
        common, ri, gi = np.intersect1d(ref["orig_idx"], got["orig_idx"],
                                        return_indices=True)
        moved = np.nonzero(ref["orig_idx"][:len(got["orig_idx"])]
                           != got["orig_idx"][:len(ref["orig_idx"])])[0]
        print(f"{name}: {len(got['resp'])} vs {len(ref['resp'])} keypoints, "
              f"{len(ref['resp']) - len(common)} not shared, order differs "
              f"at positions {moved.tolist()} (JAX resp "
              f"{ref['resp'][moved].tolist()})")
        print(f"  shared resp max|diff| "
              f"{np.abs(got['resp'][gi] - ref['resp'][ri]).max():.3g}")
        for key, tol in (("lafs", 1e-2), ("descs", 1e-3), ("patches", 5e-3)):
            err = np.abs(got[key][gi] - ref[key][ri]).reshape(
                len(common), -1).max(axis=1)
            worst = int(np.argmax(err))
            print(f"  {key}: max|diff| {err.max():.3g} (orig_idx "
                  f"{common[worst]}), {(err > tol).sum()} keypoints over "
                  f"{tol}")


if __name__ == "__main__":
    import conftest  # noqa: F401  (interpret-mode Pallas, XLA gather path)
    with jax.default_device(jax.devices("cpu")[0]):
        report()
