"""The shape-optimization slice against the JAX package on the same numpy
inputs: the LAF helpers, ``get_snn``, SIFT, the GT correspondences, kernel
B6's plain version (autograd through the flat-pyramid sampler) against the
JAX ``make_pyramid_sampler_diff`` (Pallas forward in interpret mode, custom
VJP), ``LAFShapeOptimizer``, the history files and the ``optimize_shapes``
program.  Each tolerance is stated where it is asserted."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from affnet_tpu import laf as jlaf
from affnet_tpu import losses as jlosses
from affnet_tpu import reproj as jreproj
from affnet_tpu import shape_opt as jshape_opt
from affnet_tpu.models.sift import sift_describe as jsift
from affnet_tpu.ops.pallas_patches import make_pyramid_sampler_diff as jdiff
from affnet_tpu_torch import laf, losses, reproj, shape_opt
from affnet_tpu_torch.models.sift import sift_describe
from affnet_tpu_torch.ops.patches import laf_cotangent_replay
from affnet_tpu_torch.ops.pyramid_sampler import make_pyramid_sampler_diff
from test_torch_patches import _fake_pyramid, _random_lafs

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


def _pixel_lafs(seed, n=40):
    rng = np.random.RandomState(seed)
    lafs = _random_lafs(rng, n, (5.0, 30.0))
    lafs[:, 0, 2] = rng.uniform(0, 160, n)
    lafs[:, 1, 2] = rng.uniform(0, 120, n)
    return lafs


# ---------------------------------------------------------------------------
# Helpers of the path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wh", [(160, 120), (800, 640)])
def test_normalize_lafs_matches_jax(wh):
    lafs = _pixel_lafs(0)
    got = laf.normalize_lafs(torch.from_numpy(lafs), *wh).numpy()
    ref = np.asarray(jlaf.normalize_lafs(jnp.asarray(lafs), *wh))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)   # one division
    back = laf.denormalize_lafs(torch.from_numpy(got), *wh).numpy()
    np.testing.assert_allclose(back, lafs, rtol=1e-6, atol=1e-5)


def test_lafs_to_h_frames_matches_jax():
    lafs = _pixel_lafs(1)
    got = laf.lafs_to_h_frames(torch.from_numpy(lafs)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jlaf.lafs_to_h_frames(jnp.asarray(lafs))))


@pytest.mark.parametrize("n,d", [(8, 128), (50, 128)])
def test_get_snn_matches_jax(n, d):
    rng = np.random.RandomState(n)
    a = rng.randn(n, d).astype(np.float32)
    p = (a + 0.3 * rng.randn(n, d)).astype(np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    got = losses.get_snn(torch.from_numpy(a), torch.from_numpy(p)).numpy()
    ref = np.asarray(jlosses.get_snn(jnp.asarray(a), jnp.asarray(p)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["uniform", "smooth"])
def test_sift_describe_matches_jax(kind):
    """PS 32, unit-norm 128-D descriptors within atol 1e-5."""
    rng = np.random.RandomState(3)
    if kind == "uniform":
        p = rng.uniform(0, 255, (20, 32, 32)).astype(np.float32)
    else:
        y, x = np.mgrid[0:32, 0:32].astype(np.float32)
        f = rng.uniform(0.05, 0.4, (20, 2, 1, 1))
        p = (128 + 100 * np.sin(f[:, 0] * x + 3 * f[:, 1] * y)
             + rng.normal(0, 2, (20, 32, 32))).astype(np.float32)
    got = sift_describe(torch.from_numpy(p), 32).numpy()
    ref = np.asarray(jsift(jnp.asarray(p), 32))
    assert got.shape == ref.shape == (20, 128)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_gt_correspondence_indexes_match_jax():
    """The 120x160 golden's LAFs and the same LAFs mapped by a known
    homography (shuffled, some moved away): identical (distance, index,
    index) triples."""
    g = np.load(os.path.join(FIX, "detector_golden.npz"))
    lafs1 = np.asarray(g["aff_lafs"], np.float32)
    n = len(lafs1)
    H = np.array([[0.9, 0.05, 8.0], [-0.04, 1.1, -5.0], [1e-4, -2e-4, 1.0]],
                 np.float32)
    rng = np.random.RandomState(0)
    lafs2 = np.asarray(jreproj.reproject_lafs(jnp.asarray(lafs1),
                                              jnp.asarray(H)))
    lafs2 = lafs2[rng.permutation(n)].copy()
    lafs2[: n // 4, :, 2] += rng.uniform(3, 20, (n // 4, 2))
    lafs2[:, :, 2] += rng.normal(0, 0.3, (n, 2))
    got = reproj.get_gt_correspondence_indexes(lafs1, lafs2, H, 1.0)
    ref = jreproj.get_gt_correspondence_indexes(lafs1, lafs2, H, 1.0)
    assert 0 < len(ref[1]) < n
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[2], ref[2])
    # The distances go through |a|^2 + |b|^2 - 2 a.b at pixel coordinates
    # up to 200: the two matmuls' rounding (a float32 ulp of 4e4 is 4e-3)
    # cancels into the root; measured 4.1e-3.
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=2e-2)
    got_r = reproj.reproject_lafs(torch.from_numpy(lafs1),
                                  torch.from_numpy(H)).numpy()
    ref_r = np.asarray(jreproj.reproject_lafs(jnp.asarray(lafs1),
                                              jnp.asarray(H)))
    np.testing.assert_allclose(got_r, ref_r, rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# Kernel B6's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ps,align", [(19, False), (32, False), (32, True)])
def test_pyramid_sampler_plain_matches_jax(ps, align):
    """tests/test_pallas_patches.py:265-298's setup: forward within 5e-3
    (the Pallas forward computes its fractions in window coordinates),
    buffer gradient within 1e-5 of its largest magnitude (the same
    scatter-add in another order: tens of overlapping samples per pixel;
    measured 3.6e-6 of it), LAF gradient rtol 5e-4 / atol 2e-3 (the JAX
    tolerance between its two formulations); the level index gets no
    gradient."""
    rng = np.random.RandomState(21)
    buf, offs, hs, ws = _fake_pyramid(rng, [(96, 128), (48, 64)])
    n = 16
    lafs = _random_lafs(rng, n, (0.05, 0.2))
    lvl = rng.randint(0, 2, n).astype(np.int32)
    wgt = rng.uniform(-1, 1, (n, ps, ps)).astype(np.float32)

    sampler = jdiff(jnp.asarray(offs), jnp.asarray(hs), jnp.asarray(ws), ps,
                    align)

    def jloss(b, l, lf):
        return (sampler(b, l, lf) * wgt).sum()

    with jax.default_device(jax.devices("cpu")[0]):
        lvl_f = jnp.asarray(lvl.astype(np.float32))
        ref = np.asarray(sampler(jnp.asarray(buf), jnp.asarray(lafs), lvl_f))
        jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(buf),
                                               jnp.asarray(lafs), lvl_f)
    assert np.all(np.asarray(jg[2]) == 0)

    sample = make_pyramid_sampler_diff(*(torch.from_numpy(a)
                                         for a in (offs, hs, ws)), ps, align)
    b = torch.from_numpy(buf).requires_grad_(True)
    lf = torch.from_numpy(lafs).requires_grad_(True)
    lv = torch.from_numpy(lvl)
    out = sample(b, lf, lv)
    assert np.abs(out.detach().numpy() - ref).max() < 5e-3
    (out * torch.from_numpy(wgt)).sum().backward()
    ref_b = np.asarray(jg[0])
    np.testing.assert_allclose(b.grad.numpy(), ref_b, rtol=0,
                               atol=1e-5 * np.abs(ref_b).max())
    np.testing.assert_allclose(lf.grad.numpy(), np.asarray(jg[1]),
                               rtol=5e-4, atol=2e-3)
    assert not lv.requires_grad and lv.grad is None


@pytest.mark.parametrize("ps,align", [(19, False), (32, False), (32, True)])
def test_pyramid_laf_cotangent_replay_matches_autograd_and_jax(ps, align):
    """The replay of B6 backward's order (``laf_cotangent_replay``, on the
    pyramid's table and the forward's levels) on
    test_pyramid_sampler_plain_matches_jax's inputs: within rtol 1e-4 /
    atol 1e-4 of its largest magnitude of autograd's plain LAF cotangent
    (the kernel tests' bound: another summation order) and within the JAX
    tolerance rtol 5e-4 / atol 2e-3 of JAX's custom VJP."""
    rng = np.random.RandomState(21)
    buf, offs, hs, ws = _fake_pyramid(rng, [(96, 128), (48, 64)])
    n = 16
    lafs = _random_lafs(rng, n, (0.05, 0.2))
    lvl = rng.randint(0, 2, n).astype(np.int32)
    wgt = rng.uniform(-1, 1, (n, ps, ps)).astype(np.float32)
    sampler = jdiff(jnp.asarray(offs), jnp.asarray(hs), jnp.asarray(ws), ps,
                    align)
    with jax.default_device(jax.devices("cpu")[0]):
        jg = np.asarray(jax.grad(lambda l: (sampler(
            jnp.asarray(buf), l, jnp.asarray(lvl.astype(np.float32)))
            * wgt).sum())(jnp.asarray(lafs)))
    tabs = [torch.from_numpy(a) for a in (offs, hs, ws)]
    sample = make_pyramid_sampler_diff(*tabs, ps, align)
    lf = torch.from_numpy(lafs).requires_grad_(True)
    (sample(torch.from_numpy(buf), lf, torch.from_numpy(lvl))
     * torch.from_numpy(wgt)).sum().backward()
    got = laf_cotangent_replay(torch.from_numpy(buf), torch.from_numpy(lafs),
                               torch.from_numpy(lvl), *tabs,
                               torch.from_numpy(wgt), ps=ps,
                               align_corners=align)
    torch.testing.assert_close(got, lf.grad, rtol=1e-4,
                               atol=1e-4 * float(lf.grad.abs().max()))
    np.testing.assert_allclose(got.numpy(), jg, rtol=5e-4, atol=2e-3)


def test_pyramid_sampler_plain_laf_cotangent_only():
    """With a buffer that needs no gradient, only the LAFs get one."""
    rng = np.random.RandomState(5)
    buf, offs, hs, ws = _fake_pyramid(rng, [(64, 80), (32, 40)])
    lafs = _random_lafs(rng, 6, (0.1, 0.3))
    sample = make_pyramid_sampler_diff(*(torch.from_numpy(a)
                                         for a in (offs, hs, ws)), 32, False)
    b = torch.from_numpy(buf)
    lf = torch.from_numpy(lafs).requires_grad_(True)
    sample(b, lf, torch.tensor([0, 1, 1, 0, 1, 0])).sum().backward()
    assert b.grad is None and torch.isfinite(lf.grad).all()
    assert float(lf.grad.abs().sum()) > 0


# ---------------------------------------------------------------------------
# LAFShapeOptimizer, histories, the program
# ---------------------------------------------------------------------------

def _onepass_problem():
    """tests/test_onepass.py:54-79: 8 LAFs on the 120x160 golden image,
    the second view's shapes perturbed."""
    img = np.load(os.path.join(FIX, "onepass_golden.npz"))["img"]
    rng = np.random.RandomState(0)
    n = 8
    lafs1 = np.zeros((n, 2, 3), np.float32)
    lafs1[:, 0, 0] = lafs1[:, 1, 1] = 16.0
    lafs1[:, 0, 2] = rng.uniform(40, 120, n)
    lafs1[:, 1, 2] = rng.uniform(40, 80, n)
    lafs2 = lafs1.copy()
    lafs2[:, :2, :2] += rng.randn(n, 2, 2).astype(np.float32) * 3.0
    return img, lafs1, lafs2


@pytest.fixture(scope="module")
def onepass_histories():
    img, lafs1, lafs2 = _onepass_problem()
    with jax.default_device(jax.devices("cpu")[0]):
        ref = jshape_opt.LAFShapeOptimizer(
            descriptor=lambda p: jsift(p, 32),
            loss_fn=jlosses.descriptor_dist, lr=0.05).optimize(
                lafs1, lafs2, img, img, n_iters=12)
    got = shape_opt.LAFShapeOptimizer(
        descriptor=lambda p: sift_describe(p, 32),
        loss_fn=losses.descriptor_dist, lr=0.05, device="cpu").optimize(
            lafs1, lafs2, img, img, n_iters=12)
    return ref, got


def test_shape_optimizer_matches_jax(onepass_histories):
    """SIFT, PosDist, Adam lr 0.05, 12 steps.  Measured: loss within 1e-6
    relative, LAFs within 8.0e-5 px after 12 steps, SNN within 3e-6.
    Bounds: loss rtol 1e-5; LAFs atol 2e-4 px; shape difference atol
    5e-5; SNN atol 1e-5.  Adam's first steps are about lr * sign(g): a
    gradient element within rounding of zero could take the other sign and
    move one entry by 2 * lr = 0.1 px, which these bounds would show; none
    does here."""
    ref, got = onepass_histories
    assert len(got["loss"]) == len(ref["loss"]) == 12
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["shape_diff"], ref["shape_diff"],
                               atol=5e-5)
    for key in ("lafs1", "lafs2"):
        assert len(got[key]) == 13
        np.testing.assert_allclose(np.stack(got[key]), np.stack(ref[key]),
                                   rtol=0, atol=2e-4)
    np.testing.assert_allclose(np.stack(got["snn"]), np.stack(ref["snn"]),
                               atol=1e-5)


def test_shape_optimizer_loss_and_shape_difference_fall(onepass_histories):
    _, got = onepass_histories
    assert got["loss"][-1] < got["loss"][0]
    assert got["shape_diff"][-1] < got["shape_diff"][0]
    # The centers stay fixed.
    np.testing.assert_array_equal(got["lafs1"][-1][:, :, 2],
                                  got["lafs1"][0][:, :, 2])


def _history(n=3, iters=2, seed=1):
    rng = np.random.RandomState(seed)
    frames = []
    for _ in range(iters + 1):
        lafs = np.zeros((n, 2, 3), np.float32)
        lafs[:, 0, 0] = lafs[:, 1, 1] = rng.uniform(8, 20, n)
        lafs[:, 0, 2] = rng.uniform(40, 120, n)
        lafs[:, 1, 2] = rng.uniform(40, 80, n)
        frames.append(lafs)
    return {"lafs1": frames, "lafs2": frames[::-1],
            "loss": [1.0, 0.5], "shape_diff": [1.0, 0.6, 0.4],
            "snn": [np.ones(n), 0.5 * np.ones(n)]}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_history_files_interchange(tmp_path, writer):
    """The port's npz is read by the JAX package's load_history and the
    other way round, unchanged."""
    hist = _history()
    f = str(tmp_path / "hist.npz")
    save, load = ((shape_opt.save_history, jshape_opt.load_history)
                  if writer == "port"
                  else (jshape_opt.save_history, shape_opt.load_history))
    save(hist, f)
    loaded = load(f)
    for key in hist:
        np.testing.assert_array_equal(np.stack(loaded[key]),
                                      np.stack(hist[key]))


def test_render_history(tmp_path):
    pytest.importorskip("matplotlib")
    img = np.load(os.path.join(FIX, "onepass_golden.npz"))["img"]
    out = shape_opt.render_history(_history(), img,
                                   str(tmp_path / "opt.mp4"), fps=4)
    assert os.path.exists(out) and os.path.getsize(out) > 0


def test_optimize_shapes_cli_shear(tmp_path):
    """The program in shear mode on a PNG of the 120x160 fixture, 3 steps on
    the CPU: GT pairs found, the loss falls, npz (readable by the JAX
    package) and animation written."""
    from PIL import Image
    from affnet_tpu_torch.cli.optimize_shapes import main

    img = np.load(os.path.join(FIX, "detector_golden.npz"))["img"]
    inp = str(tmp_path / "img.png")
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(inp)
    out = str(tmp_path / "opt")
    hist = main([inp, "--mode", "shear", "--nfeats", "24", "--steps", "3",
                 "--out", out, "--device", "cpu"])
    assert hist["loss"][-1] < hist["loss"][0]
    d = jshape_opt.load_history(out + ".npz")
    assert len(d["lafs1"]) == 4 and d["lafs1"][0].shape[1:] == (2, 3)
    assert len(d["lafs1"][0]) >= 2
    assert os.path.exists(out + ".gif") or os.path.exists(out + ".mp4")
