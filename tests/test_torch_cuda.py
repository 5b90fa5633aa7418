"""Each CUDA kernel against its plain version on the card, at small shapes.

Marked ``cuda``; skipped without a card.  The card's machine has no JAX, so
run these there without the repository's conftest (which imports JAX):

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import itertools
import os

import numpy as np
import pytest
import torch

from affnet_tpu_torch import load_pretrained
from affnet_tpu_torch.cli import extract_geom, hesaffbaum, hesaffnet
from affnet_tpu_torch.detector import (DetectorConfig,
                                       ScaleSpaceAffinePatchExtractor)
from affnet_tpu_torch.models import (AffNetFast, HardTFeatNet, OriNetFast32,
                                     cnn, params_from_jax, zoo)
from affnet_tpu_torch.ops import (batched_sampler, cuda_blur, cuda_conv,
                                  cuda_detect, cuda_patches, cuda_topk)
from affnet_tpu_torch.kernels.build import launch, stream_of
from affnet_tpu_torch.models.cnn import init_params
from affnet_tpu_torch.ops.conv_flat import (ACTIVATIONS, conv_layer_plain,
                                            out_extent)
from affnet_tpu_torch.utils import float32_math
from affnet_tpu_torch.ops.patches import (batched_tables,
                                          extract_patches_batched,
                                          extract_patches_from_flat_pyramid,
                                          laf_cotangent_replay)
from affnet_tpu_torch.ops.pyramid_sampler import make_pyramid_sampler_diff
from affnet_tpu_torch.ops import launch_counts
from affnet_tpu_torch.ops.scalespace import (build_flat_pyramid,
                                             gauss_kernel_1d, make_plan)

FIX = os.path.join(os.path.dirname(__file__), "fixtures")

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# Tap counts 1 (the identity), 9, 15, 71 (a radius beyond one shared-memory
# chunk) and 201 (several chunks each way), on sizes that cross the 64x32
# tiles and on images smaller than the radius.
BLUR_TAPS = [np.array([1.0], np.float32)] + [
    gauss_kernel_1d(s) for s in (0.8, 1.227, 1.52, 2.4, 3.0, 11.7, 33.4)]


@pytest.mark.parametrize("hw", [(1, 1), (5, 6), (77, 160), (130, 257)])
def test_blur_kernel(dev, hw):
    img = torch.rand(hw, device=dev) * 255
    for taps in BLUR_TAPS:
        before = cuda_blur.launches
        got = cuda_blur.blur(img, taps)
        assert cuda_blur.launches == before + 1
        assert torch.equal(got, cuda_blur.blur_plain(img, taps)), len(taps)
    assert {len(t) for t in BLUR_TAPS} >= {1, 9, 15, 71, 201}


@pytest.mark.parametrize("hw", [(37, 29), (130, 257)])
def test_blur_level_kernel_writes(dev, hw):
    """One B1 launch into a pitched buffer: the level, the zeroed padding of
    both rows, and the stride-2 samples, against the plain version on a
    buffer of stale values."""
    h, w = hw
    pitch = w + 70
    bufs = [torch.full((3 * h, pitch), 7.0, device=dev) for _ in range(2)]
    for buf in bufs:
        buf[:h, :w] = torch.rand(hw, generator=torch.Generator().manual_seed(
            0)).to(dev) * 255
    taps = gauss_kernel_1d(1.52)
    for buf, fn in zip(bufs, (cuda_blur.blur_level_cuda,
                              cuda_blur.blur_level_plain)):
        fn(buf[:h, :w], buf[h:2 * h, :w], taps, pad_to=pitch,
           down=buf[2 * h:2 * h + (h + 1) // 2, :(w + 1) // 2],
           zero_src_pad=True)
    assert torch.equal(bufs[0], bufs[1])
    assert torch.all(bufs[0][:2 * h, w:] == 0)


@pytest.mark.parametrize("hw,n_levels,py2", [((96, 128), 3, False),
                                             ((300, 517), 3, True),
                                             ((300, 517), 6, False)])
def test_pyramid_kernel(dev, hw, n_levels, py2):
    """The row-padded buffer through B1 equals the plain writer's bit for
    bit, with one launch per level."""
    img = torch.rand(hw, device=dev) * 255
    plan = make_plan(*hw, n_levels, 1.6, 5)
    before = cuda_blur.launches
    pyr, buf = build_flat_pyramid(img, plan, py2=py2)
    assert cuda_blur.launches == before + 1 + plan.n_octaves * (n_levels + 1)
    ref_pyr, ref = build_flat_pyramid(img, plan, py2=py2, use_kernel=False)
    assert torch.equal(buf, ref)
    assert all(torch.equal(a, b) for a, b in zip(pyr, ref_pyr))


@pytest.mark.parametrize("hw", [(3, 4), (15, 20), (77, 160)])
@pytest.mark.parametrize("n_levels", [3, 5, 6, 7, 8])
def test_detect_kernel(dev, hw, n_levels):
    """The full maps of one octave through the stencil and the refine at
    every pixel equal the plain full-map chain bit for bit."""
    levels = torch.rand((n_levels,) + hw, device=dev) * 50
    sigmas = [1.6 * 2 ** (i / 3) for i in range(n_levels)]
    for th in (0.0, 5.0):
        got = cuda_detect.detect_octave(levels, sigmas, th)
        ref = cuda_detect.detect_octave_plain(levels, sigmas, th)
        assert torch.equal(got[:, 0] > 0, ref[:, 0] > 0)
        assert torch.equal(got, ref)


def _stage_inputs(dev, n_levels, hw=(300, 517), border=5):
    img = torch.rand(hw, device=dev) * 255
    plan = make_plan(*hw, n_levels, 1.6, border)
    pyr, buf = build_flat_pyramid(img, plan)
    return plan, pyr, buf


@pytest.mark.parametrize("n_levels", [3, 6])
@pytest.mark.parametrize("th", [0.0, 5.0])
def test_detect_stage_kernels(dev, n_levels, th):
    """B2's three launches against their plain versions on a pyramid in the
    level buffer: the stencil's responses and counters, the dedup, and the
    refine at every survivor and at random entries, bit for bit."""
    plan, pyr, buf = _stage_inputs(dev, n_levels)
    nc = n_levels
    outs = []
    for uk in (True, False):
        chunks, counters = [], []
        for o in range(plan.n_octaves):
            h, w = plan.octave_shapes[o]
            r = torch.empty((nc, h, w), device=dev)
            c = torch.zeros(cuda_detect.n_counters(nc + 2), dtype=torch.int32,
                            device=dev)
            before = cuda_detect.launches
            cuda_detect.detect_stencil(pyr[o], plan.sigmas[o], th, 5, r, c,
                                       use_kernel=uk)
            assert cuda_detect.launches == before + uk
            chunks.append(r.reshape(-1))
            counters.append(c)
        outs.append((torch.cat(chunks), torch.stack(counters)))
    (resp, cnt), (ref, ref_cnt) = outs
    assert torch.equal(resp, ref) and torch.equal(cnt, ref_cnt)
    assert int((resp > 0).sum()) > 100
    octaves, off = [], 0
    for h, w in plan.octave_shapes:
        octaves.append((off, h * w))
        off += nc * h * w
    before = cuda_detect.launches_dedup
    cuda_detect.dedup(resp, cnt, octaves)
    assert cuda_detect.launches_dedup == before + 1
    cuda_detect.dedup(ref, ref_cnt, octaves, use_kernel=False)
    assert torch.equal(resp, ref)
    det_offsets = [o + k * hw for o, hw in octaves for k in range(nc)]
    ext = [plan.flat_index(o, k) for o in range(plan.n_octaves)
           for k in range(nc)]
    offs, hs, ws = plan.level_dims_padded()
    tables = cuda_detect.RefineTables(
        torch.tensor(det_offsets, device=dev), torch.tensor(ext, device=dev),
        *(torch.tensor(a, device=dev) for a in (offs, hs, ws)),
        *cuda_detect.RefineTables.level_tables(plan, dev))
    g = torch.Generator().manual_seed(n_levels)
    idxs = torch.cat([torch.nonzero(resp > 0)[:, 0],
                      torch.randint(0, resp.numel(), (5000,),
                                    generator=g).to(dev)])
    before = cuda_detect.launches_refine
    got = cuda_detect.refine(buf, idxs, tables, th)
    assert cuda_detect.launches_refine == before + 1
    assert torch.equal(got, cuda_detect.refine_plain(buf, idxs, tables, th))


@pytest.mark.parametrize("n_levels", [3, 6])
def test_extractor_detection_on_card(dev, n_levels):
    """The extractor at n_levels 3 and 6: one B1 launch per level, one
    stencil per octave, one dedup and one refine, and the same keypoints
    and shapes as its plain path on the card."""
    img = np.load(os.path.join(FIX, "detector_golden_fullres.npz"))["img"]
    outs = []
    for uk in (True, False):
        det = ScaleSpaceAffinePatchExtractor(
            DetectorConfig(num_features=500, border=5, mr_size=5.192,
                           n_levels=n_levels), device=dev, use_kernels=uk)
        before = launch_counts()
        outs.append(det(img))
        n_oct = det._plan(*img.shape).plan.n_octaves
        got = {k: launch_counts()[k] - before[k]
               for k in ("blur", "detect", "dedup", "refine")}
        assert got == ({"blur": 1 + n_oct * (n_levels + 1), "detect": n_oct,
                        "dedup": 1, "refine": 1} if uk else
                       dict.fromkeys(got, 0)), got
    for k in outs[1]:
        np.testing.assert_array_equal(outs[0][k], outs[1][k], err_msg=k)


def test_topk_kernel(dev):
    x = torch.rand(300, 1024, device=dev)
    x[5, 100] = x[5, 7] = 2.0
    x[17, :20] = 0.5
    x[250:] = -1.0
    for m in (1, 16, 32):
        for a, r in zip(cuda_topk.row_topm_flat(x.reshape(-1), m),
                        cuda_topk.row_topm_plain(x, m)):
            assert torch.equal(a, r)


@pytest.mark.parametrize("m", [1, 16, 32])
def test_topk_kernel_flat_ragged(dev, m):
    """B3 on a flat vector whose length is no multiple of 1024 (the
    entries past the end read as -1): bit-identical to the plain version,
    with ties inside and across rows, an all-equal row, rows with more
    than 16 positives or more candidates than the kernel ranks at once,
    negatives above and below -1, and sparse detector-like rows."""
    rng = np.random.RandomState(m)
    n = 12 * 1024 + 333
    x = np.zeros(n, np.float32)
    x[:1024] = rng.exponential(1.0, 1024)
    x[5] = x[100] = 50.0
    x[1024:1064] = 0.5
    x[2048:3072] = 0.25
    x[3072:4096] = rng.uniform(-3.0, -0.5, 1024)
    x[4096:5120] = -2.0
    x[5120:6144] = -1.0
    x[6144 + np.arange(0, 1024, 3)] = 1.0
    x[7168 + 3] = x[8192 + 3] = 7.5
    sparse = rng.choice(np.arange(9216, n), 300, replace=False)
    x[sparse] = rng.exponential(2.0, 300)
    xt = torch.from_numpy(x).to(dev)
    before = cuda_topk.launches
    got = cuda_topk.row_topm_flat(xt, m)
    assert cuda_topk.launches == before + 1
    for a, r in zip(got, cuda_topk.row_topm_flat_plain(xt, m)):
        assert torch.equal(a, r)


def _patch_inputs(dev, n=50, scale=0.3, seed=0):
    rng = np.random.RandomState(seed)
    buf = torch.rand(150, 160, device=dev) * 255
    offs = torch.tensor([0, 100], dtype=torch.int32, device=dev)
    hs = torch.tensor([100, 50], dtype=torch.int32, device=dev)
    ws = torch.tensor([160, 80], dtype=torch.int32, device=dev)
    A = rng.uniform(-scale, scale, (n, 2, 2))
    t = rng.uniform(-0.1, 1.1, (n, 2, 1))
    lafs = torch.tensor(np.concatenate([A, t], 2), dtype=torch.float32,
                        device=dev)
    lvl = torch.tensor(rng.randint(0, 2, n), dtype=torch.int32, device=dev)
    return buf, lafs, lvl, offs, hs, ws


@pytest.mark.parametrize("align", [False, True])
def test_patches_kernel(dev, align):
    """B4 equals its plain version bit for bit at the templated patch
    sizes (32, 64) and at generic ones (19, 65, 96)."""
    buf, lafs, lvl, offs, hs, ws = _patch_inputs(dev)
    for ps in (19, 32, 64, 65, 96):
        got, ovf = cuda_patches.extract_patches_pyramid(
            buf, lafs, lvl, offs, hs, ws, ps=ps, align_corners=align)
        ref, _ = cuda_patches.extract_patches_pyramid(
            buf, lafs, lvl, offs, hs, ws, ps=ps, align_corners=align,
            use_kernel=False)
        assert ovf == 0
        assert torch.equal(got, ref), ps


@pytest.mark.parametrize("bf16", [False, True])
def test_patches_kernel_large_footprints_and_nonfinite(dev, bf16):
    """Footprints far beyond a patch's own size (elongated LAFs of scale
    up to 3, most samples outside the level) are exact; a NaN or infinite
    LAF gives what the plain version gives (NaN samples), reads nothing
    out of bounds, and leaves the other patches exact."""
    buf, lafs, lvl, offs, hs, ws = _patch_inputs(dev, n=40, scale=3.0)
    lafs[:, 0, 0] *= 8.0
    lafs[3, 0, 0] = float("nan")
    lafs[7, 1, 2] = float("inf")
    lafs[9, 1, 1] = -float("inf")
    for ps in (32, 65):
        got, _ = cuda_patches.extract_patches_pyramid(
            buf, lafs, lvl, offs, hs, ws, ps=ps, bf16=bf16)
        torch.cuda.synchronize()
        ref, _ = cuda_patches.extract_patches_pyramid(
            buf, lafs, lvl, offs, hs, ws, ps=ps, use_kernel=False, bf16=bf16)
        torch.testing.assert_close(got, ref, rtol=0, atol=0, equal_nan=True)
        assert torch.isnan(got[[3, 7, 9]]).all()
        ok = torch.ones(40, dtype=torch.bool)
        ok[[3, 7, 9]] = False
        assert torch.equal(got[ok], ref[ok])


def _batched_inputs(dev, n=40, h=64, pert=0.4, seed=0):
    g = torch.Generator().manual_seed(seed)
    imgs = torch.rand((n, h, h), generator=g)
    lafs = torch.tensor([[0.5, 0.0, 0.5], [0.0, 0.5, 0.5]]).repeat(n, 1, 1)
    lafs[:, :, :2] += pert * (2 * torch.rand((n, 2, 2), generator=g) - 1)
    return imgs.to(dev), lafs.to(dev)


@pytest.mark.parametrize("ps,align", [(64, False), (32, False), (32, True),
                                      (65, False), (96, True)])
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
                                           (32, False, 3.0),
                                           (65, False, 0.4),
                                           (96, True, 0.4)])
def test_batched_backward_kernel(dev, ps, align, pert):
    """B5 backward against autograd of the plain version: LAF cotangent
    rtol 1e-4 / atol 1e-4 of its largest magnitude (another summation
    order), image cotangent rtol 1e-5 / atol 1e-5 (atomics).  The LAF
    cotangent equals the replay of the kernel's order bit for bit, and so
    is the same from run to run."""
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
    n, h, w = imgs.shape
    assert torch.equal(gl, laf_cotangent_replay(
        imgs.reshape(n * h, w), lafs, *batched_tables(n, h, w, dev), g,
        ps=ps, align_corners=align))
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


@pytest.mark.parametrize("ps", [32, 65])
def test_backward_laf_route_writes_no_buffer(dev, ps):
    """The LAF-only route gets no buffer cotangent to write (a null
    pointer: a write would fault at the synchronize), allocates none and
    leaves its inputs as they were; its result is the LAF cotangent of the
    route that also writes the buffer's."""
    imgs, lafs = _batched_inputs(dev, pert=1.5)
    n, h, w = imgs.shape
    buf = imgs.reshape(n * h, w)
    tables = batched_tables(n, h, w, dev)
    g = 2 * torch.rand((n, ps, ps), device=dev) - 1
    copies = [t.clone() for t in (buf, lafs, g)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    gb, gl = cuda_patches.sample_bwd_cuda(buf, lafs, tables, g, ps, False,
                                          False, True)
    torch.cuda.synchronize()
    assert gb is None
    assert torch.cuda.max_memory_allocated() - before < buf.numel() * 4
    assert all(torch.equal(a, b) for a, b in zip((buf, lafs, g), copies))
    gb2, gl2 = cuda_patches.sample_bwd_cuda(buf, lafs, tables, g, ps, False,
                                            True, True)
    assert torch.equal(gl, gl2) and float(gb2.abs().sum()) > 0


def test_batched_backward_nonfinite_lafs_write_nothing(dev):
    imgs, lafs = _batched_inputs(dev, n=4)
    lafs[1, 0, 0] = float("nan")
    lafs[2, 1, 2] = float("inf")
    im = imgs.clone().requires_grad_(True)
    batched_sampler.sample_batched(im, lafs).sum().backward()
    assert torch.all(im.grad[1:3] == 0)
    assert torch.isfinite(im.grad).all() and im.grad[0].abs().sum() > 0


def _pyramid_inputs(dev, n=60, seed=0, scale=0.3):
    """A three-level flat pyramid buffer, its tables, LAFs and levels."""
    g = torch.Generator().manual_seed(seed)
    buf = torch.rand(175, 160, generator=g) * 255
    tables = [torch.tensor(v, dtype=torch.int32)
              for v in ([0, 100, 150], [100, 50, 25], [160, 80, 40])]
    A = scale * (2 * torch.rand((n, 2, 2), generator=g) - 1)
    t = 1.2 * torch.rand((n, 2, 1), generator=g) - 0.1
    lafs = torch.cat([A, t], 2)
    lvl = torch.randint(0, 3, (n,), generator=g, dtype=torch.int32)
    return (buf.to(dev), [x.to(dev) for x in tables], lafs.to(dev),
            lvl.to(dev))


@pytest.mark.parametrize("ps,align", [(32, False), (19, True)])
def test_bf16_patches_kernel(dev, ps, align):
    """B4-bf16 equals its plain version bit for bit and counts one bf16
    launch (and no float32 one)."""
    buf, tables, lafs, lvl = _pyramid_inputs(dev)
    before = (cuda_patches.launches, cuda_patches.launches_bf16)
    got, _ = cuda_patches.extract_patches_pyramid(
        buf, lafs, lvl, *tables, ps=ps, align_corners=align, bf16=True)
    assert (cuda_patches.launches, cuda_patches.launches_bf16) == (
        before[0], before[1] + 1)
    ref, _ = cuda_patches.extract_patches_pyramid(
        buf, lafs, lvl, *tables, ps=ps, align_corners=align,
        use_kernel=False, bf16=True)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    f32, _ = cuda_patches.extract_patches_pyramid(
        buf, lafs, lvl, *tables, ps=ps, align_corners=align)
    assert 0 < float((got - f32).abs().max()) < 2.5


@pytest.mark.parametrize("ps,align", [(32, False), (19, True)])
def test_pyramid_forward_kernel(dev, ps, align):
    """B6 forward (B4's kernel on the pyramid's table) equals the plain
    version bit for bit and counts one B6 forward launch."""
    buf, tables, lafs, lvl = _pyramid_inputs(dev)
    sample = make_pyramid_sampler_diff(*tables, ps, align)
    before = (cuda_patches.launches, cuda_patches.launches_pyramid)
    got = sample(buf, lafs, lvl)
    assert (cuda_patches.launches, cuda_patches.launches_pyramid) == (
        before[0], before[1] + 1)
    ref = extract_patches_from_flat_pyramid(buf, lafs, lvl, *tables, ps=ps,
                                            align_corners=align)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.parametrize("ps,align,scale", [(32, False, 0.3),
                                            (19, True, 0.3),
                                            (32, False, 3.0)])
def test_pyramid_backward_kernel(dev, ps, align, scale):
    """B6 backward against autograd of the plain version, at the levels the
    forward used: LAF cotangent rtol 1e-4 / atol 1e-4 of its largest
    magnitude (another summation order), buffer cotangent rtol 1e-5 / atol
    1e-5 of its largest magnitude (atomics, many samples per pixel).  The
    LAF cotangent equals the replay of the kernel's order bit for bit, and
    so is the same from run to run."""
    buf, tables, lafs, lvl = _pyramid_inputs(dev, scale=scale)
    g = 2 * torch.rand((lafs.shape[0], ps, ps), device=dev) - 1

    def grads(fn):
        b = buf.clone().requires_grad_(True)
        lf = lafs.clone().requires_grad_(True)
        (fn(b, lf) * g).sum().backward()
        return b.grad, lf.grad

    sample = make_pyramid_sampler_diff(*tables, ps, align)
    before = cuda_patches.launches_pyramid_bwd
    gb, gl = grads(lambda b, lf: sample(b, lf, lvl))
    assert cuda_patches.launches_pyramid_bwd == before + 1
    rb, rl = grads(lambda b, lf: extract_patches_from_flat_pyramid(
        b, lf, lvl, *tables, ps=ps, align_corners=align))
    torch.testing.assert_close(gl, rl, rtol=1e-4,
                               atol=1e-4 * float(rl.abs().max()))
    torch.testing.assert_close(gb, rb, rtol=1e-5,
                               atol=1e-5 * float(rb.abs().max()))
    assert torch.equal(gl, laf_cotangent_replay(buf, lafs, lvl, *tables, g,
                                                ps=ps, align_corners=align))
    _, gl2 = grads(lambda b, lf: sample(b, lf, lvl))
    assert torch.equal(gl, gl2)


def test_pyramid_backward_only_what_is_needed(dev):
    """Shape optimization asks for the LAF cotangent only; the level index
    is an integer tensor and gets none."""
    buf, tables, lafs, lvl = _pyramid_inputs(dev)
    sample = make_pyramid_sampler_diff(*tables, 32, False)
    lf = lafs.clone().requires_grad_(True)
    sample(buf, lf, lvl).sum().backward()
    assert buf.grad is None and lf.grad is not None
    assert not lvl.requires_grad
    b = buf.clone().requires_grad_(True)
    sample(b, lafs, lvl).sum().backward()
    assert torch.isfinite(b.grad).all() and float(b.grad.abs().sum()) > 0


def _extractor(dev, **kw):
    aff, desc = AffNetFast(), HardTFeatNet()
    aff.load_state_dict(params_from_jax(load_pretrained("AffNetFast")))
    desc.load_state_dict(params_from_jax(load_pretrained("HardTFeatNet")))
    return ScaleSpaceAffinePatchExtractor(
        DetectorConfig(num_features=256, border=5, mr_size=5.192,
                       num_baum_iters=1, **kw),
        shape_net=aff, desc_net=desc, device=dev)


def test_extractor_float32_under_default_flags(dev):
    """The precision policy: with PyTorch's default flags (TF32 on for cuDNN
    convolutions) the extractor's outputs equal those with TF32 off, and the
    caller's flags are restored."""
    img = np.load(os.path.join(FIX, "detector_golden_fullres.npz"))["img"]
    det = _extractor(dev)
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        outs = []
        for flag in (True, False):
            torch.backends.cudnn.allow_tf32 = flag
            torch.backends.cuda.matmul.allow_tf32 = flag
            outs.append(det(img, describe=True))
            assert torch.backends.cudnn.allow_tf32 is flag
            assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    for k in outs[1]:
        np.testing.assert_array_equal(outs[0][k], outs[1][k], err_msg=k)


def test_fast_extractor_matches_plain_fast(dev):
    """Fast mode through B4-bf16 at both sites against its plain version on
    the card: keypoints identical, patches within 1e-3 of their largest
    magnitude (chip_smoke.py's rule for the float32 path); descriptors
    float16 and unit norm."""
    img = np.load(os.path.join(FIX, "detector_golden_fullres.npz"))["img"]
    kw = dict(fast=True, desc_dtype="float16")
    before = cuda_patches.launches_bf16
    got = _extractor(dev, **kw)(img, describe=True)
    assert cuda_patches.launches_bf16 == before + 2
    ref = _extractor(dev, **kw)
    ref.use_kernels = False
    ref = ref(img, describe=True)
    np.testing.assert_array_equal(got["orig_idx"], ref["orig_idx"])
    np.testing.assert_allclose(got["patches"], ref["patches"], rtol=0,
                               atol=1e-3 * np.abs(ref["patches"]).max())
    assert got["descs"].dtype == np.float16
    norms = np.linalg.norm(got["descs"].astype(np.float32), axis=1)
    assert np.abs(norms - 1.0).max() < 1e-3


# (C, O, k, pad, stride, H, N): the seven layer shapes of the flagship's
# flat stack (AffNetFast's trunk, HardTFeatNet's 7x7 VALID layer) at the
# layer's stride and real C, on patch counts that leave a partial last
# block; OriNetFast's 4x4 maps; HardNet's widest layer; a 13x13 map with
# 24 outputs (odd rows, an output count not a multiple of 16); and aff3 at
# the HesAffNet program's 34274 patches.
CONV_CASES = [
    (1, 16, 3, 1, 1, 32, 5), (16, 16, 3, 1, 1, 32, 3),
    (16, 32, 3, 1, 2, 32, 3), (32, 32, 3, 1, 1, 16, 7),
    (32, 64, 3, 1, 2, 16, 9), (64, 64, 3, 1, 1, 8, 37),
    (1, 32, 7, 0, 1, 32, 4), (16, 32, 3, 1, 1, 32, 3),
    (64, 64, 3, 1, 1, 4, 11), (128, 128, 3, 1, 1, 8, 19),
    (16, 24, 3, 1, 1, 13, 9), (16, 32, 3, 1, 2, 32, 34274),
]


@pytest.mark.parametrize("case", CONV_CASES)
@pytest.mark.parametrize("act", ["none", "relu", "tanh", "elu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_kernel(dev, case, act, dtype):
    """B7 (B7-bf16) against its plain version, the layer's own work:
    float32 within 1e-5 of the output's largest magnitude (another
    summation order, the card's tanhf/expm1f), bf16 within that plus one
    bf16 ulp of the value; one launch on the matching counter."""
    c, o, k, pad, stride, h, n = case
    g = torch.Generator().manual_seed(sum(case))
    x = torch.randn((c, n * h * h), generator=g)
    w = torch.randn((k, k, c, o), generator=g) / (k * k * c) ** 0.5
    b = 0.1 * torch.randn((o,), generator=g)
    x, w, b = x.to(dev, dtype), w.to(dev), b.to(dev)
    before = (cuda_conv.launches, cuda_conv.launches_bf16)
    got = cuda_conv.conv_flat(x, w, b, (h, h), pad, act, stride)
    bf16 = dtype == torch.bfloat16
    assert (cuda_conv.launches, cuda_conv.launches_bf16) == (
        before[0] + (not bf16), before[1] + bf16)
    ho = (h + 2 * pad - k) // stride + 1
    assert got.dtype == dtype and got.shape == (o, n * ho * ho)
    with float32_math():
        ref = conv_layer_plain(x, w, b, (h, h), pad, act, stride).float()
    tol = 1e-5 * float(ref.abs().max()) + (ref.abs() * 2.0 ** -7 if bf16
                                           else 0.0)
    assert bool(torch.all((got.float() - ref).abs() <= tol))


def test_conv_kernel_checks(dev):
    x = torch.zeros((1, 2 * 64 * 64), device=dev)
    w = torch.zeros((3, 3, 1, 8), device=dev)
    with pytest.raises(ValueError, match="kh <= 7"):
        cuda_conv.conv_flat(x, torch.zeros((9, 9, 1, 8), device=dev),
                            None, (64, 64), 4)
    with pytest.raises(ValueError, match="float32"):
        cuda_conv.conv_flat(x.half(), w, None, (64, 64), 1)
    with pytest.raises(ValueError, match="stride"):
        cuda_conv.conv_flat(x, w, None, (64, 64), 1, stride=3)
    with pytest.raises(ValueError, match="C=1 rows, the weights C=8"):
        cuda_conv.conv_flat(x, torch.zeros((3, 3, 8, 8), device=dev),
                            None, (64, 64), 1)
    with pytest.raises(ValueError, match="multiple of 8"):
        cuda_conv.conv_flat(x, torch.zeros((3, 3, 1, 12), device=dev),
                            None, (64, 64), 1)


def _pretrained(cls, name):
    net = cls()
    net.load_state_dict(params_from_jax(load_pretrained(name)))
    return net


@pytest.mark.parametrize("cls,name,launch_count", [
    (AffNetFast, "AffNetFast", 6), (OriNetFast32, "OriNetFast", 6),
    (HardTFeatNet, "HardTFeatNet", 1)])
def test_flat_nets_kernel_vs_plain(dev, cls, name, launch_count):
    """The pretrained nets under the flat layout through B7 against the
    same stack through its plain version: the features the heads read
    within 1e-5 (float32 sums in another order).  The heads are the same
    code on both paths and are not compared: on noise patches OriNet's
    (x0, x1) can lie near 1e-3 from the origin, where its atan2 turns
    their 2e-7 difference into up to 5e-5 of the rotation."""
    net = _pretrained(cls, name).to(dev)
    p = torch.rand((300, 32, 32), device=dev)
    with cnn.eval_layout("flat"), torch.inference_mode(), float32_math():
        before = cuda_conv.launches
        flat_feats = net.feature_vectors(p)
        assert cuda_conv.launches == before + launch_count
        ref = net.feature_vectors(p, use_kernels=False)
        assert cuda_conv.launches == before + launch_count
    with cnn.eval_layout("nchw"), torch.inference_mode(), float32_math():
        nchw = net.feature_vectors(p)
    torch.testing.assert_close(flat_feats, ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(flat_feats, nchw, rtol=1e-4, atol=1e-4)


def test_b7_takes_matches_the_launcher(dev):
    """``cuda_conv.b7_takes`` against ``launch_conv_flat`` itself (called
    as ``conv_flat_cuda`` calls it, past the wrapper's own check): the
    launcher refuses a layer exactly when ``b7_takes`` does, over
    tests/test_torch_conv.py's grid of kernel sizes, pads, strides,
    channels, map sizes and both dtypes."""
    for k, pad, stride, c, o, hw, dt in itertools.product(
            (3, 5, 7), (0, 1, 2, 3), (1, 2), (1, 16, 64), (8, 24, 64),
            (8, 16, 32, 40, 66), (torch.float32, torch.bfloat16)):
        if 2 * pad > k - 1 or k > hw + 2 * pad:
            continue
        x = torch.zeros((c, hw * hw), dtype=dt, device=dev)
        wk = cuda_conv.pack_weights(torch.zeros((k, k, c, o), device=dev),
                                    dt)
        b = torch.zeros((o,), device=dev)
        ho, wo = out_extent((hw, hw), k, pad, stride)
        out = torch.empty((o, ho * wo), dtype=dt, device=dev)
        try:
            launch("launch_conv_flat", x.data_ptr(), wk.data_ptr(),
                   b.data_ptr(), out.data_ptr(), c, o, 1, hw, hw, k, stride,
                   pad, ACTIVATIONS.index("relu"),
                   int(dt == torch.bfloat16), stream_of(x))
            launched = True
        except RuntimeError:
            launched = False
        assert launched == cuda_conv.b7_takes(c, o, k, pad, stride, hw, hw,
                                              dt), (k, pad, stride, c, o,
                                                    hw, dt)
    torch.cuda.synchronize()


@pytest.mark.parametrize("k,pad", [(5, 2), (7, 1)])
def test_flat_net_routes_around_b7_on_card(dev, k, pad):
    """A net whose middle layer B7 does not take (5x5; 7x7 at pad 1) under
    the flat layout on the card: one B7 launch (the first layer), no
    failed launch, the features within 1e-5 of the plain path's and 1e-4
    of the nchw layout's, as test_flat_nets_kernel_vs_plain holds the
    zoo's nets."""
    nn = torch.nn
    net = init_params(zoo.PatchNet([
        nn.Conv2d(1, 16, 3, 1, 1, bias=False), cnn.batch_norm(16), nn.ReLU(),
        nn.Conv2d(16, 16, k, 1, pad, bias=False), cnn.batch_norm(16),
        nn.ReLU(),
        nn.Conv2d(16, 32, 3, 2, 1, bias=False), cnn.batch_norm(32),
        nn.ReLU(), nn.AdaptiveAvgPool2d(1)]),
        torch.Generator().manual_seed(k)).to(dev).eval()
    p = torch.rand((300, 32, 32), device=dev)
    with cnn.eval_layout("flat"), torch.inference_mode(), float32_math():
        before = cuda_conv.launches
        flat_feats = net.feature_vectors(p)
        torch.cuda.synchronize()
        assert cuda_conv.launches == before + 1
        ref = net.feature_vectors(p, use_kernels=False)
    with cnn.eval_layout("nchw"), torch.inference_mode(), float32_math():
        nchw = net.feature_vectors(p)
    torch.testing.assert_close(flat_feats, ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(flat_feats, nchw, rtol=1e-4, atol=1e-4)


def test_hesaffnet_program_flat_on_card(dev):
    """The HesAffNet program (th=-1, do_ori) on the 640x800 fixture with the
    flat layout: 12 B7 launches, keypoints against the plain path within 2
    per 1000 gate flips."""
    img = np.load(os.path.join(FIX, "detector_golden_fullres.npz"))["img"]
    with cnn.eval_layout("flat"):
        det = hesaffnet.make_extractor(do_ori=True, device=dev)
        before = cuda_conv.launches
        ells, out = hesaffnet.image_to_ells(det, img, do_ori=True)
        assert cuda_conv.launches == before + 12
        _, ref = hesaffnet.image_to_ells(
            hesaffnet.make_extractor(do_ori=True, device=dev,
                                     use_kernels=False), img, do_ori=True)
    assert np.isfinite(ells).all() and ells.shape == (len(out["resp"]), 5)
    assert out["n_detected"] == ref["n_detected"] > 4096
    n = len(ref["orig_idx"])
    assert np.setdiff1d(out["orig_idx"], ref["orig_idx"]).size <= 2 * n // 1000
    assert np.setdiff1d(ref["orig_idx"], out["orig_idx"]).size <= 2 * n // 1000


def _baumberg_site_lafs(det, img):
    """The extractor's inputs at the Baumberg site (PS 19), iteration by
    iteration: (level buffer, tables, extraction levels, the LAFs of each
    of the ``num_baum_iters`` iterations), as ``_affine_shape`` makes
    them."""
    with torch.inference_mode(), float32_math():
        p = det._plan(*img.shape)
        cand = det._multiscale_detect(img, p)
        lafs0 = torch.cat([det.cfg.mr_size * cand["lafs"][:, :, 0:2],
                           cand["lafs"][:, :, 2:]], dim=2)
        lvl = cand["ext_level"].to(torch.int32)
        base_A = torch.eye(2, device=img.device).expand(len(lafs0), 2, 2)
        lafs, all_lafs = lafs0, []
        for _ in range(det.cfg.num_baum_iters):
            all_lafs.append(lafs.contiguous())
            patches = extract_patches_from_flat_pyramid(
                cand["flat"], lafs, lvl, *p.tables, ps=det.shape_net.ps)
            base_A = det.shape_net(patches) @ base_A
            lafs = torch.cat([base_A @ lafs0[:, :, 0:2], lafs0[:, :, 2:]],
                             dim=2)
    return cand["flat"], p.tables, lvl, all_lafs


def test_patches_kernel_at_the_baumberg_site(dev):
    """B4's generic instance at PS 19 on the 16 Baumberg iterations' LAFs
    of the 640x800 fixture (3000 candidates, shapes growing elongated):
    bit-identical to the plain sampler at every iteration."""
    img = torch.from_numpy(np.load(os.path.join(
        FIX, "detector_golden_fullres.npz"))["img"]).to(dev)
    det = hesaffbaum.make_extractor(device=dev)
    buf, tables, lvl, all_lafs = _baumberg_site_lafs(det, img)
    assert len(all_lafs) == 16 and len(all_lafs[0]) == 3000
    for i, lafs in enumerate(all_lafs):
        before = cuda_patches.launches
        got = cuda_patches.extract_patches_cuda(buf, lafs, lvl, *tables,
                                                ps=19)
        assert cuda_patches.launches == before + 1
        ref = extract_patches_from_flat_pyramid(buf, lafs, lvl, *tables,
                                                ps=19)
        assert torch.equal(got, ref), i


def test_hesaffbaum_on_card(dev):
    """The HesAffBaum program's extractor on the 640x800 fixture: 16 B4
    launches and one B3 launch per image, and the plain path's output bit
    for bit (every kernel of the path is bit-identical to its plain
    version, and the estimator is the same PyTorch on both)."""
    img = np.load(os.path.join(FIX, "detector_golden_fullres.npz"))["img"]
    outs = []
    for uk in (True, False):
        det = hesaffbaum.make_extractor(device=dev, use_kernels=uk)
        before = launch_counts()
        outs.append(det(img))
        got = {k: launch_counts()[k] - before[k] for k in ("patches", "topk")}
        assert got == ({"patches": 16, "topk": 1} if uk
                       else {"patches": 0, "topk": 0})
    assert len(outs[0]["resp"]) > 1000
    for k in outs[1]:
        np.testing.assert_array_equal(outs[0][k], outs[1][k], err_msg=k)


def test_refine_kernel_at_every_survivor(dev):
    """B2's refine at every NMS survivor of the 640x800 fixture (the
    OnePassSIR gate's site), bit-identical to refine_plain."""
    img = torch.from_numpy(np.load(os.path.join(
        FIX, "detector_golden_fullres.npz"))["img"]).to(dev)
    det = extract_geom.make_extractor(device=dev)
    with torch.inference_mode():
        p = det._plan(*img.shape)
        flat, resp = det._responses(img, p)
        surv = torch.nonzero(resp > 0)[:, 0]
        before = cuda_detect.launches_refine
        got = cuda_detect.refine_cuda(flat, surv, p.refine_tables, 0.0)
        assert cuda_detect.launches_refine == before + 1
        ref = cuda_detect.refine_plain(flat, surv, p.refine_tables, 0.0)
    assert len(surv) > 3000
    assert torch.equal(got, ref)


@pytest.mark.parametrize("th", [None, 28.41])
def test_onepass_on_card(dev, th):
    """OnePassSIR on the 640x800 fixture, top-k (2000, SIFT descriptors)
    and threshold mode (th 28.41, OriNetFast32): the plain path's keypoints
    bit for bit; B2's refine at every survivor (and at the top-k's indices
    in top-k mode), B3 in top-k mode only."""
    img = np.load(os.path.join(FIX, "detector_golden_fullres.npz"))["img"]
    outs = []
    for uk in (True, False):
        det = extract_geom.make_extractor(
            th=th, do_ori=th is not None,
            descriptor=None if th else "SIFT", device=dev, use_kernels=uk)
        before = launch_counts()
        outs.append(det(img, do_ori=th is not None, describe=th is None))
        got = {k: launch_counts()[k] - before[k]
               for k in ("refine", "topk", "patches")}
        want = {"refine": 2 if th is None else 1,
                "topk": 1 if th is None else 0, "patches": 1}
        assert got == (want if uk else dict.fromkeys(want, 0)), got
    assert outs[0]["n_detected"] == outs[1]["n_detected"] > 2000
    assert np.array_equal(outs[0]["orig_idx"], outs[1]["orig_idx"])
    for k in outs[1]:
        np.testing.assert_allclose(outs[0][k], outs[1][k], rtol=0, atol=1e-5,
                                   err_msg=k)


def _border_keypoints(seed, n, h, w):
    """x, y, size (2-30 px) and OpenCV angles; half the centres within 3 x
    size of the left or right edge, some outside the image."""
    rng = np.random.RandomState(seed)
    size = rng.uniform(2.0, 30.0, n)
    x = rng.uniform(0, w, n)
    edge = rng.rand(n) < 0.5
    off = rng.uniform(-1.0, 3.0, n) * size
    x[edge] = np.where(rng.rand(edge.sum()) < 0.5, off[edge],
                       w - off[edge])
    return (x.astype(np.float32), rng.uniform(0, h, n).astype(np.float32),
            size.astype(np.float32),
            rng.uniform(-180, 180, n).astype(np.float32))


def test_patches_kernel_at_the_keypoint_site(dev):
    """B4 over the image as a one-level buffer (external keypoints, many
    corners outside it): bit-identical to its plain version at each of the
    three stages, three launches per process_keypoints call, and the
    outputs equal the plain path's on the card."""
    from affnet_tpu_torch import keypoints
    img = torch.from_numpy(np.load(os.path.join(
        FIX, "detector_golden_fullres.npz"))["img"]).to(dev)
    h, w = img.shape
    lafs = keypoints.lafs_from_keypoints(
        *_border_keypoints(0, 3000, h, w), (h, w)).to(dev)
    nets = []
    for cls, name in ((AffNetFast, "AffNetFast"),
                      (OriNetFast32, "OriNetFast"),
                      (HardTFeatNet, "HardTFeatNet")):
        net = cls()
        net.load_state_dict(params_from_jax(load_pretrained(name)))
        nets.append(net.to(dev))
    for ps in (32, 19):
        got = keypoints._extract(img, lafs, ps, True)
        assert torch.equal(got, keypoints._extract(img, lafs, ps, False))
    with torch.inference_mode():
        before = cuda_patches.launches
        out = keypoints.process_keypoints(img, lafs, *nets)
        assert cuda_patches.launches == before + 3
        ref = keypoints.process_keypoints(img, lafs, *nets,
                                          use_kernels=False)
        assert cuda_patches.launches == before + 3
    assert torch.equal(out["patches"], ref["patches"])
    assert ((out["patches"] == 0).float().mean((1, 2)) > 0.2).any()
    for k in ref:
        assert float((out[k] - ref[k]).abs().max()) <= 1e-5, k


def test_snn_match_on_card_matches_cpu(dev):
    """snn_match on the card (TF32 off) against the CPU on the same
    descriptors: the same nearest neighbours and masks wherever the ratio
    is not within 1e-5 of the threshold."""
    from affnet_tpu_torch import match
    rng = np.random.RandomState(0)
    d1 = rng.normal(size=(2000, 128)).astype(np.float32)
    d2 = np.concatenate([d1[:1200] + 0.4 * rng.normal(size=(1200, 128)),
                         rng.normal(size=(900, 128))]).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    got = match.snn_match(torch.from_numpy(d1).to(dev),
                          torch.from_numpy(d2).to(dev))
    ref = match.snn_match(torch.from_numpy(d1), torch.from_numpy(d2))
    got = [t.cpu().numpy() for t in got]
    ref = [t.numpy() for t in ref]
    clear = np.abs(ref[3] - 0.8) > 1e-5
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(got[0][clear], ref[0][clear])
    np.testing.assert_array_equal(got[1][clear], ref[1][clear])
    np.testing.assert_allclose(got[3], ref[3], rtol=1e-5, atol=1e-5)
    t1, t2 = match.snn_match_host(d1, d2, device=dev)
    assert 100 < len(t1) == len(t2)


def test_export_round_trip_on_card(dev):
    """AffNetFast and HardTFeatNet exported on the card and reloaded: the
    module's output within 1e-6 at two batch sizes."""
    from affnet_tpu_torch import export
    for cls, name in ((AffNetFast, "AffNetFast"),
                      (HardTFeatNet, "HardTFeatNet")):
        net = cls()
        net.load_state_dict(params_from_jax(load_pretrained(name)))
        net = net.to(dev)
        loaded = export.load_exported(export.export_patch_net(net))
        for n in (300, 77):
            x = torch.rand((n, 32, 32), device=dev)
            with torch.no_grad(), float32_math():
                ref = net(x)
                got = loaded(x)
            assert got.device.type == "cuda"
            assert float((got - ref).abs().max()) <= 1e-6, name


# ---------------------------------------------------------------------------
# The trainers' new B5 sites: the OriNet step and the triplet step
# ---------------------------------------------------------------------------

def _train_views(dev, views, n=64, seed=0):
    """``views`` stacks of n 64x64 patches in [0, 1] (one class per row)
    from the committed fixture, on the card."""
    from affnet_tpu_torch.data import synthetic_pairs_from_image
    img = np.load(os.path.join(FIX, "detector_golden_fullres.npz"))["img"]
    patches, _ = synthetic_pairs_from_image(img, n_classes=n,
                                            views_per_class=views, seed=seed)
    return tuple(torch.from_numpy(patches[v::views].astype(np.float32)
                                  / 255.0).to(dev) for v in range(views))


def _site_warps(dev, site):
    """(the site's PS 64 warp: images, LAFs; the PS 32 rewarp's full
    patches and (N, 2, 2) shapes from an initialized net in train mode)."""
    from affnet_tpu_torch import train
    gen = torch.Generator(device=dev).manual_seed(1)
    if site == "ori":
        a, p = _train_views(dev, 2)
        lafs = train.orinet_lafs(train.draw_orinet(len(a), gen), 64, 64)
        fulls = [batched_sampler.sample_batched(a, lafs, ps=64), p]
        imgs, net = a, OriNetFast32()
    else:
        views = _train_views(dev, 3)
        views = (views[0], views[1], views[2].flip(0))   # other classes
        all_lafs = train.draw_affnet_lafs(len(views[0]), 3.0, gen, True,
                                          negative=True)
        fulls = [batched_sampler.sample_batched(x, laf, ps=64)
                 for x, laf in zip(views, all_lafs)]
        imgs, lafs, net = views[2], all_lafs[2], AffNetFast()
    net = init_params(net, torch.Generator().manual_seed(0),
                      gain=net.init_gain).to(dev).train()
    with torch.no_grad():
        shapes = torch.cat([net(f[:, 16:48, 16:48]) for f in fulls])
    return imgs, lafs, torch.cat(fulls), shapes


@pytest.mark.parametrize("site", ["ori", "triplet"])
def test_batched_kernel_at_the_trainer_sites(dev, site):
    """B5 at the OriNet step's sites (the anchors' PS 64 warp by rotation x
    scale with shifts; the PS 32 rewarp of the 2N patches by the predicted
    rotations) and the triplet step's (the negatives' PS 64 warp; the
    rewarp of 3N): forwards bit for bit against the plain version, the
    rewarp's LAF cotangent equal to its replay."""
    from affnet_tpu_torch.augmentation import warp_by_predicted_transform
    imgs, lafs, full, shapes = _site_warps(dev, site)
    before = cuda_patches.launches_batched_ps.get(64, 0)
    got = batched_sampler.sample_batched(imgs, lafs, ps=64)
    assert cuda_patches.launches_batched_ps[64] == before + 1
    assert torch.equal(got, extract_patches_batched(imgs, lafs, ps=64))
    assert torch.equal(warp_by_predicted_transform(full, shapes, 32),
                       warp_by_predicted_transform(full, shapes, 32,
                                                   use_kernel=False))
    base = torch.tensor([[0.5, 0.0, 0.5], [0.0, 0.5, 0.5]],
                        device=dev).expand(len(full), 2, 3)
    lafs32 = torch.cat([0.5 * (shapes @ base[:, :, :2]), base[:, :, 2:]], 2)
    g = 2 * torch.rand((len(full), 32, 32), device=dev) - 1
    lf = lafs32.clone().requires_grad_(True)
    before = cuda_patches.launches_bwd
    (batched_sampler.sample_batched(full, lf, ps=32) * g).sum().backward()
    assert cuda_patches.launches_bwd == before + 1
    n, h, w = full.shape
    assert torch.equal(lf.grad, laf_cotangent_replay(
        full.reshape(n * h, w), lafs32, *batched_tables(n, h, w, dev), g,
        ps=32))


@pytest.mark.parametrize("kind", ["orinet", "triplet"])
def test_trainer_step_kernels_vs_plain(dev, kind):
    """One OriNet step and one triplet AffNet step (HardTFeatNet frozen)
    through the kernels and through the plain sampler on the card, from
    the same state and generator: the kernel step launches (1 + 1, 1) and
    (3 + 1, 1) B5 forwards and backwards; loss rtol 1e-5, gradients within
    1e-3 and parameters after SGD within 1e-5 of each tensor's largest
    magnitude, BatchNorm statistics within 1e-6 (chip_smoke.py's
    tolerances)."""
    from affnet_tpu_torch import train
    from affnet_tpu_torch.ops import reset_launch_counts
    views = _train_views(dev, 2 if kind == "orinet" else 3, n=128)
    if kind == "triplet":
        views = (views[0], views[1], views[2].flip(0))
    cfg = train.TrainConfig(
        arch="OriNetFast32" if kind == "orinet" else "AffNetFast",
        descriptor="TFeat", lr=0.005, batch_size=128, n_pairs=128 * 13,
        loss="HardNet" if kind == "orinet" else "random_sampling")
    desc = train.make_descriptor("TFeat", load_pretrained("HardTFeatNet"),
                                 dev)
    make = (train.make_orinet_train_step if kind == "orinet"
            else train.make_affnet_train_step)
    runs = []
    for use_kernels in (True, False):
        net = OriNetFast32() if kind == "orinet" else AffNetFast()
        net = init_params(net, torch.Generator().manual_seed(0),
                          gain=net.init_gain).to(dev).train()
        state = train.init_state(net, cfg)
        reset_launch_counts()
        m = make(desc, cfg, use_kernels)(
            state, views, torch.Generator(device=dev).manual_seed(7), 3.0)
        runs.append((float(m["loss"]), launch_counts(),
                     {n: p.grad.clone() for n, p in net.named_parameters()},
                     {k: v.clone() for k, v in net.state_dict().items()
                      if v.is_floating_point()}))
    (lk, ck, gk, sk), (lp, cp, gp, sp) = runs
    n64, n32 = (1, 1) if kind == "orinet" else (3, 1)
    assert (ck.get("batched_fwd_ps64"), ck.get("batched_fwd_ps32"),
            ck["batched_bwd"]) == (n64, n32, 1)
    assert cp["batched_fwd"] == 0 and cp["batched_bwd"] == 0
    assert abs(lk - lp) <= 1e-5 * abs(lp)
    for k in gp:
        assert float((gk[k] - gp[k]).abs().max()) <= 1e-3 * float(
            gp[k].abs().max()), k
    for k in sp:
        tol = 1e-6 if "running" in k else 1e-5 * float(sp[k].abs().max())
        assert float((sk[k] - sp[k]).abs().max()) <= tol, k
