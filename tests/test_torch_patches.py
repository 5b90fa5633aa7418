"""Kernel B4's plain version (affnet_tpu_torch.ops.patches sampler) against
the JAX XLA gather path, plus level selection and sample extents.

Tolerance rtol=5e-5, atol=5e-3 (tests/test_pallas_patches.py), and 1e-5 on
the torch grid_sample fixture (tests/test_ops.py)."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from affnet_tpu.ops import patches as jp
from affnet_tpu.ops.pallas_patches import sample_extents as j_extents
from affnet_tpu_torch.ops import cuda_patches
from affnet_tpu_torch.ops import patches as tp

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


def _fake_pyramid(rng, shapes):
    wmax = max(w for _, w in shapes)
    rows, row_off, pos = [], [], 0
    for h, w in shapes:
        lvl = rng.uniform(0, 255, (h, w)).astype(np.float32)
        rows.append(np.pad(lvl, ((0, 0), (0, wmax - w))))
        row_off.append(pos)
        pos += h
    return (np.concatenate(rows, 0), np.array(row_off, np.int32),
            np.array([h for h, _ in shapes], np.int32),
            np.array([w for _, w in shapes], np.int32))


def _random_lafs(rng, n, scale_range):
    ang = rng.uniform(0, 2 * np.pi, n)
    c, s = np.cos(ang), np.sin(ang)
    rot = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], 1)
    elong = rng.uniform(0.5, 2.0, n)
    diag = np.zeros((n, 2, 2))
    diag[:, 0, 0] = elong
    diag[:, 1, 1] = 1.0 / elong
    A = (rot @ diag) * rng.uniform(*scale_range, n)[:, None, None]
    t = rng.uniform(-0.1, 1.1, (n, 2, 1))
    return np.concatenate([A, t], axis=2).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("ps,align", [(32, False), (19, False), (32, True),
                                      (19, True), (65, False), (96, True)])
def test_sampler_matches_jax_xla(ps, align):
    rng = np.random.RandomState(ps + align)
    buf, offs, hs, ws = _fake_pyramid(
        rng, [(100, 160), (50, 80), (25, 40), (13, 20)])
    n = 41
    lafs = _random_lafs(rng, n, (0.02, 0.4))
    lvl = rng.randint(0, 4, n).astype(np.int32)
    ref = np.asarray(jp.extract_patches_from_flat_pyramid(
        *(jnp.asarray(a) for a in (buf, lafs, lvl, offs, hs, ws)), ps=ps,
        align_corners=align))
    got, ovf = cuda_patches.extract_patches_pyramid(
        *_t(buf, lafs, lvl, offs, hs, ws), ps=ps, align_corners=align)
    assert ovf == 0
    np.testing.assert_allclose(got.numpy(), ref, rtol=5e-5, atol=5e-3)


@pytest.mark.parametrize("ps", [19, 32])
@pytest.mark.parametrize("align", [True, False])
def test_sampler_matches_grid_sample_fixture(ps, align):
    data = np.load(os.path.join(FIX, "grid_sample.npz"))
    img = data["img"]
    n = data["lafs"].shape[0]
    one = lambda v: np.array([v], np.int32)
    got = tp.extract_patches_from_flat_pyramid(
        *_t(img, data["lafs"], np.zeros(n, np.int32), one(0),
            one(img.shape[0]), one(img.shape[1])), ps=ps,
        align_corners=align).numpy()
    key = f"patches{ps}" if align else f"patches{ps}_ac0"
    np.testing.assert_allclose(got, data[key], atol=1e-5)


def test_base_grid_equals_jax():
    """Bit-equal for align_corners=False; for True, np.linspace (float64,
    rounded once) and jnp.linspace (float32 interpolation) differ by up to
    one float32 ulp."""
    for ps in (19, 32):
        gx, _ = jp._base_grid(ps, False)
        np.testing.assert_array_equal(tp.base_lin(ps, False),
                                      np.asarray(gx)[0])
        gx, _ = jp._base_grid(ps, True)
        np.testing.assert_allclose(tp.base_lin(ps, True), np.asarray(gx)[0],
                                   rtol=0, atol=1.2e-7)


def test_select_levels_and_extents_match_jax():
    rng = np.random.RandomState(5)
    table = np.array([1.6 * 2 ** (i / 3) for i in range(15)], np.float32)
    dlafs = _random_lafs(rng, 200, (1.0, 400.0))
    got = tp.select_levels_for_lafs(torch.from_numpy(dlafs),
                                    torch.from_numpy(table), 32).numpy()
    ref = np.asarray(jp.select_levels_for_lafs(jnp.asarray(dlafs),
                                               jnp.asarray(table), 32))
    np.testing.assert_array_equal(got, ref)
    lafs = _random_lafs(rng, 200, (0.01, 0.5))
    lafs[3, 0, 0] = np.nan
    hs = np.array([100, 50, 25], np.int32)
    ws = np.array([160, 80, 40], np.int32)
    lvl = rng.randint(0, 3, 200).astype(np.int32)
    for align in (False, True):
        teu, tev = tp.sample_extents(*_t(lafs, lvl, hs, ws), 32, align)
        jeu, jev = j_extents(*(jnp.asarray(a) for a in (lafs, lvl, hs, ws)),
                             32, align)
        np.testing.assert_allclose(teu.numpy(), np.asarray(jeu), rtol=1e-6)
        np.testing.assert_allclose(tev.numpy(), np.asarray(jev), rtol=1e-6)
        assert np.isinf(teu[3].item())


def _kernel_paths(buf, lafs, lvl, offs, hs, ws, ps, align, bf16):
    """csrc/patches.cu's float operations replayed on the CPU, each rounded
    to float32: (the masked path at every sample, the unclamped path, and
    where the unclamped path may run: all four corners in the level)."""
    f32 = torch.float32
    lin = torch.from_numpy(tp.base_lin(ps, align))
    gx, gy = lin[None, None, :], lin[None, :, None]
    lv = lvl.long()
    w, h = ws[lv][:, None, None], hs[lv][:, None, None]
    wf, hf = w.to(f32), h.to(f32)
    a = lafs[:, :, :, None, None]
    m = torch.minimum(hf, wf)
    xs = m * (a[:, 0, 0] * gx + a[:, 0, 1] * gy) + wf * a[:, 0, 2]
    ys = m * (a[:, 1, 0] * gx + a[:, 1, 1] * gy) + hf * a[:, 1, 2]
    if align:
        u, v = (xs * (wf - 1.0)) / wf, (ys * (hf - 1.0)) / hf
    else:
        u, v = xs - 0.5, ys - 0.5
    fx, fy = u - torch.floor(u), v - torch.floor(v)
    big = float(2 ** 31 - 1)
    x0, y0 = (torch.nan_to_num(torch.floor(t), nan=0.0).clamp(-big - 1, big)
              .to(torch.int64) for t in (u, v))
    gx1, gy1 = 1 - fx, 1 - fy
    x1 = torch.where(x0 != big, x0 + 1, x0)
    y1 = torch.where(y0 != big, y0 + 1, y0)
    mx0, mx1 = (((t >= 0) & (t < w)).to(f32) for t in (x0, x1))
    my0, my1 = (((t >= 0) & (t < h)).to(f32) for t in (y0, y1))
    flat, pitch = buf.reshape(-1), buf.shape[1]
    base = offs[lv].long()[:, None, None] * pitch

    def at(yc, xc):
        return flat[base + yc * pitch + xc]

    yc0, yc1 = (t.clamp(max=h - 1).clamp(min=0) for t in (y0, y1))
    xc0, xc1 = (t.clamp(max=w - 1).clamp(min=0) for t in (x0, x1))
    c = [at(yc0, xc0), at(yc0, xc1), at(yc1, xc0), at(yc1, xc1)]
    if bf16:
        b = tp.to_bf16
        cx0, cx1 = b(gx1) * mx0, b(fx) * mx1
        slow = (gy1 * (b(c[0]) * (cx0 * my0) + b(c[1]) * (cx1 * my0))
                + fy * (b(c[2]) * (cx0 * my1) + b(c[3]) * (cx1 * my1)))
    else:
        wx0, wx1, wy0, wy1 = gx1 * mx0, fx * mx1, gy1 * my0, fy * my1
        slow = (c[0] * (wx0 * wy0) + c[1] * (wx1 * wy0)
                + c[2] * (wx0 * wy1) + c[3] * (wx1 * wy1))
    inside = (x0 >= 0) & (x0 < w - 1) & (y0 >= 0) & (y0 < h - 1)
    ys0 = torch.where(inside, y0, 0)
    xs0 = torch.where(inside, x0, 0)
    c = [at(ys0, xs0), at(ys0, xs0 + 1), at(ys0 + 1, xs0),
         at(ys0 + 1, xs0 + 1)]
    if bf16:
        b = tp.to_bf16
        cx0, cx1 = b(gx1), b(fx)
        fast = (gy1 * (b(c[0]) * cx0 + b(c[1]) * cx1)
                + fy * (b(c[2]) * cx0 + b(c[3]) * cx1))
    else:
        fast = (c[0] * (gx1 * gy1) + c[1] * (fx * gy1)
                + c[2] * (gx1 * fy) + c[3] * (fx * fy))
    return slow, fast, inside


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("ps,align", [(32, False), (19, True)])
def test_kernel_order_of_operations_equals_plain(ps, align, bf16):
    """The kernel's two paths, replayed with torch on the CPU, equal the
    plain sampler bit for bit (the zero's sign included, int32 views):
    the masked path at every sample, the unclamped one wherever a sample's
    corners lie in its level.  Negative buffer values, samples far outside
    the level and a NaN LAF included."""
    rng = np.random.RandomState(ps + 2 * align + bf16)
    buf, offs, hs, ws = _fake_pyramid(rng, [(60, 80), (30, 40), (15, 20)])
    buf -= 60.0
    lafs = np.concatenate([_random_lafs(rng, 30, (0.05, 0.4)),
                           _random_lafs(rng, 10, (1.0, 3.0))])
    lafs[7, 0, 1] = np.nan
    lvl = rng.randint(0, 3, 40).astype(np.int32)
    args = _t(buf, lafs, lvl, offs, hs, ws)
    ref = tp.extract_patches_from_flat_pyramid(*args, ps=ps,
                                               align_corners=align,
                                               bf16=bf16)
    slow, fast, inside = _kernel_paths(*args, ps, align, bf16)
    assert 0 < int(inside.sum()) < inside.numel()
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(slow), nan) and bool(nan[7].all())
    ok = ~nan
    assert torch.equal(slow[ok].view(torch.int32), ref[ok].view(torch.int32))
    sel = inside & ok
    assert torch.equal(fast[sel].view(torch.int32),
                       ref[sel].view(torch.int32))


@pytest.mark.parametrize("ps", [65, 96])
def test_sampler_wrappers_have_no_patch_size_limit(monkeypatch, ps):
    """The forward and backward wrappers take any patch size: with the
    launch captured (no card here), each passes ``ps`` and the base grid
    as a device array of ps values, and counts one launch."""
    calls = []
    monkeypatch.setattr(cuda_patches, "check_tensor", lambda *a: None)
    monkeypatch.setattr(cuda_patches, "stream_of", lambda t: 0)
    monkeypatch.setattr(cuda_patches, "launch",
                        lambda name, *args: calls.append((name, args)))
    rng = np.random.RandomState(ps)
    buf, offs, hs, ws = _fake_pyramid(rng, [(40, 50)])
    lafs = _random_lafs(rng, 3, (0.1, 0.2))
    args = _t(buf, lafs, np.zeros(3, np.int32), offs, hs, ws)
    before = (cuda_patches.launches, cuda_patches.launches_bwd)
    out = cuda_patches.extract_patches_cuda(*args, ps=ps)
    g = torch.zeros((3, ps, ps))
    cuda_patches.sample_bwd_cuda(args[0], args[1], tuple(args[2:]), g, ps,
                                 False, False, True)
    assert out.shape == (3, ps, ps)
    assert (cuda_patches.launches, cuda_patches.launches_bwd) == (
        before[0] + 1, before[1] + 1)
    lin = cuda_patches.lin_device(ps, False, "cpu")
    np.testing.assert_array_equal(lin.numpy(), tp.base_lin(ps, False))
    (fwd, fa), (bwd, ba) = calls
    assert fwd == "launch_sample_patches" and fa[9] == lin.data_ptr()
    assert fa[11:13] == (3, ps)
    assert bwd == "launch_sample_patches_bwd" and ba[9] == lin.data_ptr()
    assert ba[13:15] == (3, ps)


def test_patches_wrapper_dispatch():
    rng = np.random.RandomState(2)
    buf, offs, hs, ws = _fake_pyramid(rng, [(40, 50)])
    lafs = _random_lafs(rng, 3, (0.1, 0.2))
    args = _t(buf, lafs, np.zeros(3, np.int32), offs, hs, ws)
    before = cuda_patches.launches
    cuda_patches.extract_patches_pyramid(*args, ps=8)
    assert cuda_patches.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        cuda_patches.extract_patches_cuda(*args, ps=8)
