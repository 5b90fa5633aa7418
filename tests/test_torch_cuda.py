"""Each CUDA kernel against its plain version on the card, at small shapes.

Marked ``cuda``; skipped without a card.  The card's machine has no JAX, so
run these there without the repository's conftest (which imports JAX):

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from affnet_tpu_torch.ops import (batched_sampler, cuda_blur, cuda_detect,
                                  cuda_patches, cuda_topk)
from affnet_tpu_torch.ops.patches import extract_patches_batched
from affnet_tpu_torch.ops.scalespace import gauss_kernel_1d

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("hw", [(1, 1), (5, 6), (77, 160), (130, 257)])
def test_blur_kernel(dev, hw):
    img = torch.rand(hw, device=dev) * 255
    for sigma in (0.8, 1.52, 3.0):
        taps = gauss_kernel_1d(sigma)
        before = cuda_blur.launches
        got = cuda_blur.blur(img, taps)
        assert cuda_blur.launches == before + 1
        torch.testing.assert_close(got, cuda_blur.blur_plain(img, taps),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("hw", [(3, 4), (15, 20), (77, 160)])
@pytest.mark.parametrize("n_levels", [3, 5, 7])
def test_detect_kernel(dev, hw, n_levels):
    levels = torch.rand((n_levels,) + hw, device=dev) * 50
    sigmas = [1.6 * 2 ** (i / 3) for i in range(n_levels)]
    for th in (0.0, 5.0):
        got = cuda_detect.detect_octave(levels, sigmas, th)
        ref = cuda_detect.detect_octave_plain(levels, sigmas, th)
        assert torch.equal(got[:, 0] > 0, ref[:, 0] > 0)
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)


def test_topk_kernel(dev):
    x = torch.rand(300, 1024, device=dev)
    x[5, 100] = x[5, 7] = 2.0
    x[17, :20] = 0.5
    x[250:] = -1.0
    for m in (1, 16, 32):
        for a, r in zip(cuda_topk.row_topm(x, m),
                        cuda_topk.row_topm_plain(x, m)):
            assert torch.equal(a, r)


@pytest.mark.parametrize("align", [False, True])
def test_patches_kernel(dev, align):
    rng = np.random.RandomState(0)
    buf = torch.rand(150, 160, device=dev) * 255
    offs = torch.tensor([0, 100], dtype=torch.int32, device=dev)
    hs = torch.tensor([100, 50], dtype=torch.int32, device=dev)
    ws = torch.tensor([160, 80], dtype=torch.int32, device=dev)
    A = rng.uniform(-0.3, 0.3, (50, 2, 2))
    t = rng.uniform(-0.1, 1.1, (50, 2, 1))
    lafs = torch.tensor(np.concatenate([A, t], 2), dtype=torch.float32,
                        device=dev)
    lvl = torch.tensor(rng.randint(0, 2, 50), dtype=torch.int32, device=dev)
    for ps in (19, 32):
        got, ovf = cuda_patches.extract_patches_pyramid(
            buf, lafs, lvl, offs, hs, ws, ps=ps, align_corners=align)
        ref, _ = cuda_patches.extract_patches_pyramid(
            buf, lafs, lvl, offs, hs, ws, ps=ps, align_corners=align,
            use_kernel=False)
        assert ovf == 0
        torch.testing.assert_close(got, ref, rtol=5e-5, atol=5e-3)


def _batched_inputs(dev, n=40, h=64, pert=0.4, seed=0):
    g = torch.Generator().manual_seed(seed)
    imgs = torch.rand((n, h, h), generator=g)
    lafs = torch.tensor([[0.5, 0.0, 0.5], [0.0, 0.5, 0.5]]).repeat(n, 1, 1)
    lafs[:, :, :2] += pert * (2 * torch.rand((n, 2, 2), generator=g) - 1)
    return imgs.to(dev), lafs.to(dev)


@pytest.mark.parametrize("ps,align", [(64, False), (32, False), (32, True)])
def test_batched_forward_kernel(dev, ps, align):
    """B5 forward (B4's kernel on per-sample tables) equals the plain
    version bit for bit, and counts one launch."""
    imgs, lafs = _batched_inputs(dev)
    before = cuda_patches.launches_batched
    before_ps = cuda_patches.launches_batched_ps.get(ps, 0)
    got = batched_sampler.sample_batched(imgs, lafs, ps=ps,
                                         align_corners=align)
    assert cuda_patches.launches_batched == before + 1
    assert cuda_patches.launches_batched_ps[ps] == before_ps + 1
    ref = extract_patches_batched(imgs, lafs, ps=ps, align_corners=align)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.parametrize("ps,align,pert", [(32, False, 0.4),
                                           (64, False, 0.4),
                                           (32, True, 0.4),
                                           (32, False, 3.0)])
def test_batched_backward_kernel(dev, ps, align, pert):
    """B5 backward against autograd of the plain version: LAF cotangent
    rtol 1e-4 / atol 1e-4 of its largest magnitude (another summation
    order), image cotangent rtol 1e-5 / atol 1e-5 (atomics).  The LAF
    cotangent is the same from run to run."""
    imgs, lafs = _batched_inputs(dev, pert=pert)
    g = 2 * torch.rand((imgs.shape[0], ps, ps), device=dev) - 1

    def grads(fn):
        im = imgs.clone().requires_grad_(True)
        lf = lafs.clone().requires_grad_(True)
        (fn(im, lf) * g).sum().backward()
        return im.grad, lf.grad

    before = cuda_patches.launches_bwd
    gi, gl = grads(lambda im, lf: batched_sampler.sample_batched(
        im, lf, ps=ps, align_corners=align))
    assert cuda_patches.launches_bwd == before + 1
    ri, rl = grads(lambda im, lf: extract_patches_batched(
        im, lf, ps=ps, align_corners=align))
    torch.testing.assert_close(gl, rl, rtol=1e-4,
                               atol=1e-4 * float(rl.abs().max()))
    torch.testing.assert_close(gi, ri, rtol=1e-5, atol=1e-5)
    _, gl2 = grads(lambda im, lf: batched_sampler.sample_batched(
        im, lf, ps=ps, align_corners=align))
    assert torch.equal(gl, gl2)


def test_batched_backward_only_what_is_needed(dev):
    """The training rewarp asks for the LAF cotangent only."""
    imgs, lafs = _batched_inputs(dev)
    lf = lafs.clone().requires_grad_(True)
    batched_sampler.sample_batched(imgs, lf).sum().backward()
    assert imgs.grad is None and lf.grad is not None
    im = imgs.clone().requires_grad_(True)
    batched_sampler.sample_batched(im, lafs).sum().backward()
    assert torch.isfinite(im.grad).all()


def test_batched_backward_nonfinite_lafs_write_nothing(dev):
    imgs, lafs = _batched_inputs(dev, n=4)
    lafs[1, 0, 0] = float("nan")
    lafs[2, 1, 2] = float("inf")
    im = imgs.clone().requires_grad_(True)
    batched_sampler.sample_batched(im, lafs).sum().backward()
    assert torch.all(im.grad[1:3] == 0)
    assert torch.isfinite(im.grad).all() and im.grad[0].abs().sum() > 0
