"""The flagship's fast mode against the JAX package on the same numpy inputs:
kernel B4-bf16's plain version against the JAX sampler with
``mxu_dtype=bf16`` (interpret mode), the bf16 nets against JAX's
``with_dtype(jnp.bfloat16)``, and the fast extractor (``fast=True``,
``desc_dtype="float16"``) against JAX's on the 120x160 and 640x800
fixtures, with the JAX sampler in interpret mode so that both packages
sample in bf16.  Each tolerance is stated where it is asserted."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from affnet_tpu.detector import DetectorConfig as JConfig
from affnet_tpu.detector import ScaleSpaceAffinePatchExtractor as JExtractor
from affnet_tpu.models import AffNetFast as JAffNetFast
from affnet_tpu.models import HardTFeatNet as JHardTFeatNet
from affnet_tpu.models.convert import load_pretrained as jax_load_pretrained
from affnet_tpu.ops import patches as jpatches
from affnet_tpu.ops.pallas_patches import extract_patches_window_matmul
from affnet_tpu_torch import load_pretrained
from affnet_tpu_torch.detector import (DetectorConfig,
                                       ScaleSpaceAffinePatchExtractor)
from affnet_tpu_torch.models import AffNetFast, HardTFeatNet, params_from_jax
from affnet_tpu_torch.ops import cuda_patches
from affnet_tpu_torch.ops.patches import (extract_patches_from_flat_pyramid,
                                          to_bf16)
from test_torch_patches import _fake_pyramid, _random_lafs

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
BENCH = dict(border=5, mr_size=5.192, num_baum_iters=1, patch_size=32)
FAST = dict(fast=True, desc_dtype="float16")


# ---------------------------------------------------------------------------
# B4-bf16's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [4, 5, 6])
def test_bf16_sampler_matches_jax(seed):
    """tests/test_pallas_patches.py:143-157's setup.  Both bf16 samplers
    are within 2.5 grey levels of float32.  The port against JAX: at most
    1.0 grey level (a column weight whose float32 fraction differs by an
    ulp can round to the neighbouring bf16 value, one bf16 step of a weight
    below 1 times a value up to 255; measured 0.93), and the 99th
    percentile of the differences at most 0.01 (measured 0.0012)."""
    rng = np.random.RandomState(seed)
    buf, offs, hs, ws = _fake_pyramid(rng, [(100, 160), (50, 80)])
    lafs = _random_lafs(rng, 16, (0.02, 0.2))
    lvl = rng.randint(0, 2, 16).astype(np.int32)
    jargs = [jnp.asarray(a) for a in (buf, lafs, lvl, offs, hs, ws)]
    with jax.default_device(jax.devices("cpu")[0]):
        ref32 = np.asarray(jpatches.extract_patches_from_flat_pyramid(
            *jargs, ps=32))
        ref16 = np.asarray(extract_patches_window_matmul(
            *jargs, ps=32, window_rows=96, window_cols=256,
            patches_per_step=8, fallback_slots=4, mxu_dtype=jnp.bfloat16,
            interpret=True))
    targs = [torch.from_numpy(a) for a in (buf, lafs, lvl, offs, hs, ws)]
    got16 = extract_patches_from_flat_pyramid(*targs, ps=32,
                                              bf16=True).numpy()
    assert np.abs(ref16 - ref32).max() < 2.5
    assert np.abs(got16 - ref32).max() < 2.5
    d = np.abs(got16 - ref16)
    assert d.max() <= 1.0 and np.quantile(d, 0.99) <= 0.01


def test_bf16_sampler_rounding():
    """Exactly the stated arithmetic: bf16 corner values and column
    weights, float32 row sums and row weights.  A patch that samples the
    level at pixel positions (fx = fy = 0) returns the bf16-rounded
    pixels; out-of-level corners contribute zero."""
    rng = np.random.RandomState(0)
    buf = rng.uniform(0, 255, (8, 8)).astype(np.float32)
    tables = [torch.tensor([0], dtype=torch.int32),
              torch.tensor([8], dtype=torch.int32),
              torch.tensor([8], dtype=torch.int32)]
    # PS 8 on the 8x8 level, A = 0.5, t = (0.5, 0.5): sample (i, j) lies
    # exactly on pixel (i, j) (every coordinate is a dyadic float32).
    lafs = torch.tensor([[[0.5, 0.0, 0.5], [0.0, 0.5, 0.5]]])

    def sample():
        return extract_patches_from_flat_pyramid(
            torch.from_numpy(buf), lafs, torch.tensor([0]), *tables, ps=8,
            bf16=True)[0]

    b = to_bf16(torch.from_numpy(buf))
    torch.testing.assert_close(sample(), b, rtol=0, atol=0)
    # Half a pixel to the right: the sum of the bf16 neighbours' halves in
    # float32; the last column's right neighbour is outside the level.
    lafs[0, 0, 2] += 0.5 / 8
    got = sample()
    torch.testing.assert_close(got[:, :7], 0.5 * b[:, :7] + 0.5 * b[:, 1:],
                               rtol=0, atol=0)
    torch.testing.assert_close(got[:, 7], 0.5 * b[:, 7], rtol=0, atol=0)
    assert not torch.equal(b, torch.from_numpy(buf))


def test_bf16_wrapper_counts_nothing_on_cpu():
    """On CPU tensors the wrapper runs the plain version: no launch."""
    rng = np.random.RandomState(1)
    buf, offs, hs, ws = _fake_pyramid(rng, [(40, 50)])
    lafs = _random_lafs(rng, 5, (0.1, 0.3))
    before = (cuda_patches.launches, cuda_patches.launches_bf16)
    got, ovf = cuda_patches.extract_patches_pyramid(
        *(torch.from_numpy(a) for a in (buf, lafs)),
        torch.zeros(5, dtype=torch.int32),
        *(torch.from_numpy(a) for a in (offs, hs, ws)), bf16=True)
    assert ovf == 0 and got.dtype == torch.float32
    assert (cuda_patches.launches, cuda_patches.launches_bf16) == before


# ---------------------------------------------------------------------------
# bf16 nets
# ---------------------------------------------------------------------------

def _patches(kind):
    rng = np.random.RandomState(7)
    if kind == "uniform":
        return rng.uniform(0, 255, (24, 32, 32)).astype(np.float32)
    img = np.load(os.path.join(FIX, "detector_golden.npz"))["img"]
    ys, xs = rng.randint(0, 120 - 32, 24), rng.randint(0, 160 - 32, 24)
    return np.stack([img[y:y + 32, x:x + 32] for y, x in zip(ys, xs)]
                    ).astype(np.float32)


@pytest.mark.parametrize("kind", ["uniform", "image"])
@pytest.mark.parametrize("name,tol", [
    # Shapes: measured 1.2e-7 (the chains round at the same places).
    ("AffNetFast", 1e-5),
    # Descriptors: measured 5.2e-4.  A bf16 conv output rounds the other
    # way where the two packages' float32 sums (1152 and 4096 terms in the
    # last two convs) differ by their order: 2e-4 to 4e-4 of the outputs
    # (measured), which the tanh chain carries on.  The float32 descriptor
    # gate is 1e-3.
    ("HardTFeatNet", 1e-3)])
def test_bf16_nets_match_jax(name, tol, kind):
    p = _patches(kind)
    jnet = {"AffNetFast": JAffNetFast, "HardTFeatNet": JHardTFeatNet}[name]
    net = {"AffNetFast": AffNetFast, "HardTFeatNet": HardTFeatNet}[name]()
    net.load_state_dict(params_from_jax(load_pretrained(name)))
    with jax.default_device(jax.devices("cpu")[0]):
        ref = np.asarray(jnet.with_dtype(jnp.bfloat16)(
            jax_load_pretrained(name), jnp.asarray(p)))
        ref32 = np.asarray(jnet(jax_load_pretrained(name), jnp.asarray(p)))
    fast = net.with_dtype(torch.bfloat16)
    with torch.no_grad():
        got = fast(torch.from_numpy(p))
        got32 = net(torch.from_numpy(p)).numpy()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=tol)
    # bf16 is bf16: it differs from float32 more than the two packages
    # differ from each other (measured 4.6x for HardTFeatNet, over 1e4x for
    # AffNetFast).
    assert np.abs(got.numpy() - got32).max() > 2 * np.abs(
        got.numpy() - ref).max()
    np.testing.assert_allclose(got32, ref32, rtol=0, atol=1e-5)


def test_with_dtype_copies_and_trains_in_float32():
    net = AffNetFast()
    fast = net.with_dtype(torch.bfloat16)
    assert net.compute_dtype is None and fast.compute_dtype is torch.bfloat16
    p = torch.from_numpy(_patches("image"))
    fast.train()
    net.train()
    torch.testing.assert_close(fast(p), net(p), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The fast extractor
# ---------------------------------------------------------------------------

def _port(num_features, **kw):
    aff, desc = AffNetFast(), HardTFeatNet()
    aff.load_state_dict(params_from_jax(load_pretrained("AffNetFast")))
    desc.load_state_dict(params_from_jax(load_pretrained("HardTFeatNet")))
    return ScaleSpaceAffinePatchExtractor(
        DetectorConfig(num_features=num_features, **BENCH, **kw),
        shape_net=aff, desc_net=desc, device="cpu")


def _jax_fast(img, num_features):
    """JAX fast mode with its Pallas sampler (bf16, interpret mode) at both
    patch sites, as the flagship runs it; the suite's default XLA gather
    would sample in float32."""
    det = JExtractor(JConfig(num_features=num_features, th=None, **BENCH,
                             **FAST),
                     shape_net=JAffNetFast, desc_net=JHardTFeatNet)
    params = {"aff": jax_load_pretrained("AffNetFast"),
              "desc": jax_load_pretrained("HardTFeatNet")}
    old = jpatches.USE_PALLAS
    jpatches.USE_PALLAS = True
    try:
        with jax.default_device(jax.devices("cpu")[0]):
            return det(img, params=params, describe=True)
    finally:
        jpatches.USE_PALLAS = old


@pytest.fixture(scope="module")
def small_fast():
    img = np.load(os.path.join(FIX, "detector_golden.npz"))["img"]
    return _jax_fast(img, 256), _port(256, **FAST)(img, describe=True), img


@pytest.fixture(scope="module")
def fullres_fast():
    img = np.load(os.path.join(FIX, "detector_golden_fullres.npz"))["img"]
    return _jax_fast(img, 500), _port(500, **FAST)(img, describe=True)


def _unit_f16(descs):
    assert descs.dtype == np.float16 and np.isfinite(descs).all()
    np.testing.assert_allclose(
        np.linalg.norm(descs.astype(np.float32), axis=1), 1.0, atol=1e-3)


def test_fast_small_image_matches_jax(small_fast):
    """120x160, 256 features.  Identical keypoints in identical order (the
    float32 slice's rule); responses at the float32 tolerances (detection
    is float32).  A bf16 patch sample can differ by a grey level (see
    test_bf16_sampler_matches_jax), which the bf16 AffNet turns into a
    shape difference: LAFs within 1.0 px (measured 0.46), descriptors
    within 0.05 (measured 0.032); float16 unit-norm descriptors."""
    ref, got, _ = small_fast
    assert set(got) == set(ref)
    assert got["n_detected"] == ref["n_detected"]
    np.testing.assert_array_equal(got["orig_idx"], ref["orig_idx"])
    np.testing.assert_allclose(got["resp"], ref["resp"], atol=0.1, rtol=1e-4)
    np.testing.assert_allclose(got["lafs"], ref["lafs"], rtol=0, atol=1.0)
    assert ref["descs"].dtype == np.float16
    _unit_f16(got["descs"])
    np.testing.assert_allclose(got["descs"].astype(np.float32),
                               ref["descs"].astype(np.float32), atol=0.05)


def test_fast_fullres_matches_jax(fullres_fast):
    """640x800, 500 features: the float32 slice's rules (at most 2 set
    changes, order up to near-ties; measured: the same 500 keypoints),
    LAFs within 1.0 px (measured 0.42), descriptors within 0.05 (measured
    0.0081)."""
    ref, got = fullres_fast
    assert got["n_detected"] == ref["n_detected"]
    assert len(got["resp"]) == len(ref["resp"]) == 500
    common, ri, gi = np.intersect1d(ref["orig_idx"], got["orig_idx"],
                                    return_indices=True)
    assert len(common) >= 500 - 2
    by_port = ri[np.argsort(gi)]
    seq = ref["resp"][by_port]
    assert np.all(np.diff(seq) <= 0.1 + 1e-4 * seq[1:])
    np.testing.assert_allclose(got["lafs"][gi], ref["lafs"][ri], rtol=0,
                               atol=1.0)
    _unit_f16(got["descs"])
    np.testing.assert_allclose(got["descs"][gi].astype(np.float32),
                               ref["descs"][ri].astype(np.float32),
                               atol=0.05)


def test_fast_against_float32_port(small_fast):
    """Fast mode changes only what bf16 touches: the same detections, and
    the keypoint set differs only where the eig-ratio/boundary gate flips
    on bf16 shapes (and the re-top-k refills): at most 8 of 121 (measured
    4 kept in fast mode only, 2 in float32 only)."""
    _, fast, img = small_fast
    f32 = _port(256)(img, describe=True)
    assert fast["n_detected"] == f32["n_detected"]
    only_fast = np.setdiff1d(fast["orig_idx"], f32["orig_idx"])
    only_f32 = np.setdiff1d(f32["orig_idx"], fast["orig_idx"])
    assert len(only_fast) + len(only_f32) <= 8
    assert f32["descs"].dtype == np.float32
