"""The HesAffNet program slice against the JAX package: threshold mode with
the orientation stage, the Oxford ellipse conversion and file format, and
the command-line program.

On the 120x160 fixture the JAX extractor runs with the flat layout (its
Pallas conv interpreted, as tests/conftest.py sets) and a small
``max_keypoints``, so it takes its power-of-2 cap retry; the port runs the
flat layout too (B7's plain version on the CPU).  On the 640x800 fixture
the JAX program holds some 8k patches per net, which its interpreted
Pallas conv takes minutes for, so there the JAX side runs its stock layout,
the flat layout's own reference (tests/test_models.py holds the two within
5e-6 per net), against the port under the flat layout.

Tolerances are the port's detector tests' (tests/test_torch_detector.py):
responses atol 0.1 rtol 1e-4, LAFs atol 1e-2 with at most 2 keypoints
over it.  At 640x800 threshold mode keeps every NMS survivor, the weak
ones too, so float32 rounding (the JAX program contracts multiply-adds
into FMAs) flips a few NMS decisions between near-equal neighbours and a
few ill-conditioned eig-ratio gates (ROADMAP Queue C): the keypoint sets
may differ by 6 keypoints on each side, just above the 5 and 4 of 7077
measured, where the top-k detector tests admit 2 of 500."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from affnet_tpu import io_formats as jio
from affnet_tpu.cli import hesaffnet as jcli
from affnet_tpu.detector import DetectorConfig as JConfig
from affnet_tpu.detector import ScaleSpaceAffinePatchExtractor as JExtractor
from affnet_tpu.laf import lafs_to_ells as jlafs_to_ells
from affnet_tpu.laf import svd2x2 as jsvd2x2
from affnet_tpu.models import AffNetFast as JAffNetFast
from affnet_tpu.models import OriNetFast32 as JOriNetFast32
from affnet_tpu.models import cnn as jcnn
from affnet_tpu.models.convert import load_pretrained as jax_load_pretrained
from affnet_tpu_torch import io_formats
from affnet_tpu_torch.cli import hesaffnet
from affnet_tpu_torch.detector import (DetectorConfig,
                                       ScaleSpaceAffinePatchExtractor)
from affnet_tpu_torch.laf import lafs_to_ells, svd2x2
from affnet_tpu_torch.models import cnn
from affnet_tpu_torch.ops import launch_counts

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
PROGRAM = dict(num_features=2000, border=5, mr_size=5.192, num_baum_iters=1)


def _img(name):
    return np.load(os.path.join(FIX, f"{name}.npz"))["img"]


def _warm_flat_constants(params):
    """JAX's flat stack keeps its one-hot downsampling matrices in an
    ``lru_cache``; built first inside a jit trace, the cache holds that
    trace's tracers, and the next trace (the cap retry re-jits) fails with
    UnexpectedTracerError.  Built first eagerly, they are constants: run
    each net once outside any trace (the matrices' values are the same
    either way)."""
    jcnn._onehot_even.cache_clear()
    for net, key in ((JAffNetFast, "aff"), (JOriNetFast32, "ori")):
        net(params[key], jnp.zeros((1, net.ps, net.ps), jnp.float32))


def _jax_run(img, th, cap, layout):
    old = jcnn.EVAL_CONV_LAYOUT
    jcnn.EVAL_CONV_LAYOUT = layout
    params = {"aff": jax_load_pretrained("AffNetFast"),
              "ori": jax_load_pretrained("OriNetFast")}
    try:
        with jax.default_device(jax.devices("cpu")[0]):
            if layout == "flat":
                _warm_flat_constants(params)
            det = JExtractor(JConfig(th=th, max_keypoints=cap, **PROGRAM),
                             shape_net=JAffNetFast, ori_net=JOriNetFast32)
            out = det(img, params=params, do_ori=True)
    finally:
        jcnn.EVAL_CONV_LAYOUT = old
    return out, det.cfg.max_keypoints


def _port_run(img, th, cap, layout="flat"):
    with cnn.eval_layout(layout):
        det = hesaffnet.make_extractor(th=th, max_keypoints=cap, do_ori=True,
                                       device="cpu")
        return det(img, do_ori=True)


def _compare(got, ref, max_flips):
    assert got["n_detected"] == ref["n_detected"]
    # Scan order: the reference's torch.nonzero order.
    assert np.all(np.diff(got["orig_idx"]) > 0)
    assert np.all(np.diff(ref["orig_idx"]) > 0)
    common, ri, gi = np.intersect1d(ref["orig_idx"], got["orig_idx"],
                                    return_indices=True)
    assert len(ref["orig_idx"]) - len(common) <= max_flips
    assert len(got["orig_idx"]) - len(common) <= max_flips
    np.testing.assert_allclose(got["resp"][gi], ref["resp"][ri], atol=0.1,
                               rtol=1e-4)
    err = np.abs(got["lafs"][gi] - ref["lafs"][ri]).reshape(len(common), -1)
    assert (err.max(axis=1) > 1e-2).sum() <= 2
    for k in ("oct_idx", "level_idx"):
        np.testing.assert_array_equal(got[k][gi], ref[k][ri])
    return common


@pytest.mark.parametrize("th", [-1.0, 28.41])
def test_threshold_mode_with_orientation_matches_jax_flat(th):
    img = _img("detector_golden")
    ref, jax_cap = _jax_run(img, th, 64, "flat")
    got = _port_run(img, th, 64)
    assert got["n_detected"] > 64 and jax_cap >= got["n_detected"]
    common = _compare(got, ref, max_flips=0)
    assert len(common) == len(got["orig_idx"]) > 0
    # The port keeps every survivor whatever the cap, as JAX after its
    # retry does.
    assert set(got) == set(ref)


def test_threshold_mode_fullres_matches_jax():
    img = _img("detector_golden_fullres")
    ref, _ = _jax_run(img, -1.0, 4096, "nchw")
    got = _port_run(img, -1.0, 4096)
    assert got["n_detected"] > 4096
    _compare(got, ref, max_flips=6)


def test_threshold_mode_flat_matches_nchw_in_port():
    img = _img("detector_golden")
    a = _port_run(img, -1.0, 16384, "flat")
    b = _port_run(img, -1.0, 16384, "nchw")
    np.testing.assert_array_equal(a["orig_idx"], b["orig_idx"])
    np.testing.assert_allclose(a["lafs"], b["lafs"], rtol=1e-4, atol=1e-4)


def test_threshold_config_and_checks():
    cfg = DetectorConfig(th=-1.0, max_keypoints=16384, **PROGRAM)
    assert cfg.threshold_mode and cfg.effective_th == -1.0
    top = DetectorConfig(**PROGRAM)
    assert not top.threshold_mode and top.effective_th == 0.0
    assert top.prefilter_count() == 3000 and top.final_count() == 2000
    det = ScaleSpaceAffinePatchExtractor(
        DetectorConfig(th=-1.0, border=5, mr_size=5.192), device="cpu")
    with pytest.raises(ValueError, match="ori_net"):
        det(_img("detector_golden"), do_ori=True)
    # Without a shape stage, threshold mode keeps every survivor.
    before = launch_counts()
    out = det(_img("detector_golden"))
    assert launch_counts() == before
    assert len(out["resp"]) == out["n_detected"] > 0
    assert np.all(np.diff(out["orig_idx"]) > 0)


def test_svd2x2_and_lafs_to_ells_match_jax():
    rng = np.random.RandomState(0)
    lafs = np.concatenate([rng.uniform(-20, 20, (64, 2, 2)),
                           rng.uniform(0, 500, (64, 2, 1))], 2)
    lafs = lafs.astype(np.float32)
    with jax.default_device(jax.devices("cpu")[0]):
        ref = np.asarray(jlafs_to_ells(jnp.asarray(lafs)))
        ju, js, jv = map(np.asarray, jsvd2x2(jnp.asarray(lafs[:, :, :2])))
    got = lafs_to_ells(torch.from_numpy(lafs)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-7)
    u, s, v = (t.numpy() for t in svd2x2(torch.from_numpy(lafs[:, :, :2])))
    for a, b in ((u, ju), (s, js), (v, jv)):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(u @ s @ np.swapaxes(v, 1, 2), lafs[:, :, :2],
                               rtol=1e-4, atol=1e-3)


def test_write_ells_bytes_match_jax(tmp_path):
    rng = np.random.RandomState(1)
    ells = np.concatenate([rng.uniform(0, 800, (40, 2)),
                           rng.uniform(-0.1, 0.1, (40, 3))], 1)
    ells = ells.astype(np.float32)
    ours, theirs = tmp_path / "ours.txt", tmp_path / "theirs.txt"
    io_formats.write_ells(str(ours), ells)
    jio.write_ells(str(theirs), ells)
    assert ours.read_bytes() == theirs.read_bytes()
    np.testing.assert_array_equal(io_formats.read_ells(str(ours)),
                                  jio.read_ells(str(theirs)))
    empty = tmp_path / "empty.txt"
    io_formats.write_ells(str(empty), np.zeros((0, 5), np.float32))
    assert io_formats.read_ells(str(empty)).shape == (0, 5)


def test_cli_matches_jax_cli(tmp_path, capsys):
    from PIL import Image
    img = np.clip(_img("detector_golden"), 0, 255).astype(np.uint8)
    png = str(tmp_path / "img.png")
    Image.fromarray(img).save(png)
    ours, theirs = str(tmp_path / "ours.txt"), str(tmp_path / "theirs.txt")
    hesaffnet.main([png, ours, "--device", "cpu", "--do-ori",
                    "--max-keypoints", "64"])
    with jax.default_device(jax.devices("cpu")[0]):
        jcli.main([png, theirs, "--do-ori", "--max-keypoints", "64"])
    printed = capsys.readouterr().out.splitlines()
    got, ref = io_formats.read_ells(ours), jio.read_ells(theirs)
    assert printed[0] == f"{len(got)} affine regions -> {ours}"
    assert len(ref) > 64
    # The same regions up to 2 gate flips, matched by their centres.
    d = np.abs(got[:, None, :2] - ref[None, :, :2]).max(-1)
    gi, ri = np.nonzero(d < 1e-2)
    assert len(set(gi)) == len(gi) and len(set(ri)) == len(ri)
    assert len(got) - len(gi) <= 2 and len(ref) - len(ri) <= 2
    np.testing.assert_allclose(got[gi, 2:], ref[ri, 2:], rtol=1e-2,
                               atol=1e-6)


def test_cli_refuses_mesh(tmp_path):
    with pytest.raises(SystemExit, match="mesh"):
        hesaffnet.main(["a.png", str(tmp_path / "o.txt"), "--mesh", "4",
                        "--device", "cpu"])
