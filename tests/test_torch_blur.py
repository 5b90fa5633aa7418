"""Kernel B1's plain version (affnet_tpu_torch.ops.cuda_blur) against the
JAX blur: the Pallas kernel run interpreted, and the XLA formulation; the
level buffer written in place against the stacked and copied pyramid it
replaces, bit for bit.

Tolerance atol=1e-5 on [0, 1] images, as tests/test_ops.py holds the JAX
blur against the reference fixture."""

import math
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from affnet_tpu.ops import scalespace as jss
from affnet_tpu.ops.pallas_blur import gaussian_blur_pallas
from affnet_tpu_torch.ops import cuda_blur
from affnet_tpu_torch.ops import scalespace as tss

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.mark.parametrize("py2", [False, True])
@pytest.mark.parametrize("sigma", [1.52, 1.227, 2.46])
def test_blur_matches_fixture_and_jax(sigma, py2):
    data = np.load(os.path.join(FIX, "gaussian_blur.npz"))
    img = data["img"]
    key = f"blur_{sigma}_py2" if py2 else f"blur_{sigma}"
    got = tss.gaussian_blur(torch.from_numpy(img), sigma, py2=py2).numpy()
    np.testing.assert_allclose(got, data[key], atol=1e-5)
    jp = np.asarray(gaussian_blur_pallas(jnp.asarray(img), sigma, py2=py2))
    np.testing.assert_allclose(got, jp, atol=1e-5)


@pytest.mark.parametrize("sigma", [0.8, 1.52, 2.45])
def test_blur_random_matches_jax(sigma):
    rng = np.random.RandomState(0)
    img = rng.rand(67, 93).astype(np.float32)
    got = tss.gaussian_blur(torch.from_numpy(img), sigma).numpy()
    jp = np.asarray(gaussian_blur_pallas(jnp.asarray(img), sigma))
    jx = np.asarray(jss.gaussian_blur_xla(jnp.asarray(img), sigma))
    np.testing.assert_allclose(got, jp, atol=1e-5)
    # Op by op (unfused), XLA rounds every multiply and add as PyTorch does.
    np.testing.assert_array_equal(got, jx)


def test_blur_radius_beyond_image():
    """The JAX entry falls back to its XLA blur when the radius exceeds the
    image; the clamped-index plain version computes the same function."""
    img = np.random.RandomState(1).rand(5, 6).astype(np.float32)
    got = tss.gaussian_blur(torch.from_numpy(img), 3.0).numpy()
    jp = np.asarray(gaussian_blur_pallas(jnp.asarray(img), 3.0))
    np.testing.assert_allclose(got, jp, atol=1e-5)


def test_blur_constant_image_stays_constant():
    img = torch.full((50, 70), 3.25)
    out = tss.gaussian_blur(img, 2.0).numpy()
    np.testing.assert_allclose(out, 3.25, rtol=0, atol=1e-5)


def test_blur_wrapper_uses_plain_on_cpu_without_counting():
    img = torch.rand(20, 30)
    taps = tss.gauss_kernel_1d(1.3)
    before = cuda_blur.launches
    out = cuda_blur.blur(img, taps)
    assert cuda_blur.launches == before
    torch.testing.assert_close(out, cuda_blur.blur_plain(img, taps),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_blur.blur_cuda(img, taps)


@pytest.mark.parametrize("sigma", [0.5, 1.6, 2.45, 4.0])
@pytest.mark.parametrize("py2", [False, True])
def test_gauss_kernel_equal_to_jax(sigma, py2):
    np.testing.assert_array_equal(tss.gauss_kernel_1d(sigma, py2),
                                  jss.gauss_kernel_1d(sigma, py2))


def _stacked_flat_pyramid(img, plan, py2):
    """The pyramid as the port built it before the level buffer was written
    in place: blurred levels stacked per octave, the stride-2 downsample as
    a copy, then every level copied into a zeroed row-padded buffer."""
    step = 2.0 ** (1.0 / plan.n_levels)
    curr = tss.gaussian_blur(img, math.sqrt(plan.init_sigma ** 2 - 0.25),
                             py2=py2)
    pyr = []
    for _ in range(plan.n_octaves):
        levels = [curr]
        cs = plan.init_sigma
        for i in range(1, plan.levels_per_octave):
            levels.append(tss.gaussian_blur(
                levels[-1], cs * math.sqrt(step * step - 1.0), py2=py2))
            cs *= step
            if i == plan.n_levels:
                next_first = tss.downsample2(levels[-1])
        pyr.append(torch.stack(levels))
        curr = next_first
    rows, wmax = plan.padded_buffer_shape()
    buf = torch.zeros((rows, wmax))
    r0 = 0
    for octave in pyr:
        _, h, w = octave.shape
        for lvl in octave:
            buf[r0:r0 + h, :w] = lvl
            r0 += h
    return pyr, buf


@pytest.mark.parametrize("hw,border", [((96, 128), 5), ((120, 160), 5),
                                       ((37, 29), 3), ((77, 160), 12)])
@pytest.mark.parametrize("n_levels", [1, 3, 6])
@pytest.mark.parametrize("py2", [False, True])
def test_pyramid_writer_equals_stacked_copies(hw, border, n_levels, py2):
    """The level buffer written in place, level by level (one blur launch
    each, the downsample and the padding folded in), equals the stacked
    and copied pyramid bit for bit; each octave is a view of it.
    ``n_levels=1`` is the shape optimizer's pyramid (35-tap blurs)."""
    img = torch.from_numpy(
        np.random.RandomState(hw[0]).rand(*hw).astype(np.float32) * 255)
    plan = tss.make_plan(*hw, n_levels, 1.6, border)
    pyr, buf = tss.build_flat_pyramid(img, plan, py2=py2)
    ref_pyr, ref = _stacked_flat_pyramid(img, plan, py2)
    assert torch.equal(buf, ref)
    for got, want in zip(pyr, ref_pyr):
        assert torch.equal(got, want)
        assert got.data_ptr() >= buf.data_ptr() and got.stride(1) == \
            buf.shape[1]
    steps = tss.pyramid_steps(plan, py2)
    assert len(steps) == 1 + plan.n_octaves * (n_levels + 1)
    assert [s.dst for s in steps if s.down] == [
        (o, n_levels) for o in range(plan.n_octaves - 1)]


@pytest.mark.parametrize("n_taps", [1, 9, 71, 201])
def test_blur_level_plain_writes(n_taps):
    """One launch's plain version into a pitched buffer of stale values:
    the level, zeros in the padding of its rows and of the source's, and
    the stride-2 samples; any odd tap count, radius beyond the image."""
    taps = (np.ones(1, np.float32) if n_taps == 1 else
            tss.gauss_kernel_1d((n_taps - 1) / 6.0 + 0.01))
    assert len(taps) == n_taps
    h, w, pitch = 13, 17, 30
    buf = torch.full((3 * h, pitch), 7.0)
    src = torch.from_numpy(
        np.random.RandomState(n_taps).rand(h, w).astype(np.float32))
    buf[:h, :w] = src
    cuda_blur.blur_level(buf[:h, :w], buf[h:2 * h, :w], taps, pad_to=pitch,
                         down=buf[2 * h:2 * h + 7, :9], zero_src_pad=True)
    want = cuda_blur.blur_plain(src, taps)
    assert torch.equal(buf[h:2 * h, :w], want)
    assert torch.equal(buf[2 * h:2 * h + 7, :9], want[::2, ::2])
    assert torch.all(buf[:2 * h, w:] == 0)
    assert torch.all(buf[2 * h:, 9:] == 7.0) and torch.equal(buf[:h, :w], src)


def test_blur_level_wrapper_dispatch():
    buf = torch.rand(20, 40)
    before = cuda_blur.launches
    cuda_blur.blur_level(buf[:10, :30], buf[10:, :30], [0.25, 0.5, 0.25])
    assert cuda_blur.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        cuda_blur.blur_level_cuda(buf[:10, :30], buf[10:, :30],
                                  [0.25, 0.5, 0.25])
