"""The port's train-time augmentation against the JAX package's, given the
same LAFs (``jax.random`` draws cannot be reproduced, so the random parts
are checked for their distribution and the warps on shared numpy LAFs).

Tolerances: warped patches max |diff| 5e-5 on [0, 1] images (the batched
sampler's, tests/test_torch_batched_sampler.py); the LAF algebra 1e-6; the
gradient of the rewarp with respect to the predicted transform rtol 5e-4 /
atol 2e-3 (tests/test_pallas_patches.py:259-260)."""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from affnet_tpu import augmentation as jaug
from affnet_tpu import laf as jlaf
from affnet_tpu.ops.patches import extract_patches_batched as j_batched
from affnet_tpu_torch import augmentation as aug
from affnet_tpu_torch import laf as tlaf


def _data(seed, n=8, h=64):
    rng = np.random.RandomState(seed)
    return rng.uniform(0, 1, (n, h, h)).astype(np.float32), rng


def _warp_lafs(rng, n, max_tilt=3.0):
    """Rotation x det-1 tilt LAFs from numpy draws through the JAX algebra,
    as extract_random_laf composes them."""
    phi_r = rng.uniform(-math.pi, math.pi, n).astype(np.float32)
    tilt = rng.uniform(1 / max_tilt, max_tilt, n).astype(np.float32)
    phi = rng.uniform(-math.pi, math.pi, n).astype(np.float32)
    A = np.asarray(jlaf.rotation_matrix(jnp.asarray(phi_r))
                   @ jlaf.get_normalized_affine_shape(jnp.asarray(tilt),
                                                      jnp.asarray(phi))
                   @ (0.5 * jnp.eye(2)))
    t = np.full((n, 2, 1), 0.5, np.float32)
    return np.concatenate([A, t], 2).astype(np.float32)


def test_laf_algebra_matches_jax():
    rng = np.random.RandomState(0)
    ang = rng.uniform(-4, 4, 50).astype(np.float32)
    tilt = rng.uniform(1 / 3, 3, 50).astype(np.float32)
    np.testing.assert_allclose(
        tlaf.rotation_matrix(torch.from_numpy(ang)).numpy(),
        np.asarray(jlaf.rotation_matrix(jnp.asarray(ang))), atol=1e-6)
    got = tlaf.get_normalized_affine_shape(torch.from_numpy(tilt),
                                           torch.from_numpy(ang)).numpy()
    ref = np.asarray(jlaf.get_normalized_affine_shape(jnp.asarray(tilt),
                                                      jnp.asarray(ang)))
    np.testing.assert_allclose(got, ref, atol=1e-6)
    np.testing.assert_allclose(np.linalg.det(got), 1.0, atol=1e-5)


def test_rectify_up_is_up_gradient_matches_jax():
    rng = np.random.RandomState(1)
    A = rng.uniform(-1.5, 1.5, (20, 2, 2)).astype(np.float32)
    w = rng.uniform(-1, 1, (20, 2, 2)).astype(np.float32)
    gj = jax.grad(lambda a: (jlaf.rectify_up_is_up(a) * w).sum())(
        jnp.asarray(A))
    ta = torch.from_numpy(A).requires_grad_(True)
    (tlaf.rectify_up_is_up(ta) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(gj), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("crop", [32, 31])
def test_warp_and_crop_matches_jax(crop):
    data, rng = _data(2)
    lafs = _warp_lafs(rng, data.shape[0])
    crop_t, full_t = aug.warp_and_crop(torch.from_numpy(data),
                                       torch.from_numpy(lafs), crop)
    full_j = np.asarray(j_batched(jnp.asarray(data), jnp.asarray(lafs),
                                  ps=64))
    st = (64 - crop) // 2
    assert np.abs(full_t.numpy() - full_j).max() < 5e-5
    assert crop_t.shape == (data.shape[0], crop, crop)
    np.testing.assert_array_equal(crop_t.numpy(),
                                  full_t.numpy()[:, st:st + crop,
                                                 st:st + crop])


@pytest.mark.parametrize("crop,align", [(32, False), (32, True),
                                        (31, False)])
def test_warp_by_predicted_transform_matches_jax(crop, align):
    """Both branches: the fused PS = crop sampling (align_corners False, even
    margin) and the PS = H warp then crop; value and the gradient with
    respect to the transform (the B5 backward's LAF cotangent)."""
    data, rng = _data(3 + crop + align)
    n = data.shape[0]
    trans = (np.eye(2, dtype=np.float32)
             + rng.uniform(-0.4, 0.4, (n, 2, 2)).astype(np.float32))
    g = rng.uniform(-1, 1, (n, crop, crop)).astype(np.float32)

    def loss_j(tr):
        out = jaug.warp_by_predicted_transform(jnp.asarray(data), tr, crop,
                                               align_corners=align)
        return (out * jnp.asarray(g)).sum(), out

    (_, ref), gj = jax.value_and_grad(loss_j, has_aux=True)(
        jnp.asarray(trans))
    tt = torch.from_numpy(trans).requires_grad_(True)
    out = aug.warp_by_predicted_transform(torch.from_numpy(data), tt, crop,
                                          align_corners=align)
    (out * torch.from_numpy(g)).sum().backward()
    assert out.shape == (n, crop, crop)
    assert np.abs(out.detach().numpy() - np.asarray(ref)).max() < 5e-5
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(gj), rtol=5e-4,
                               atol=2e-3)


def test_fused_rewarp_equals_crop_of_full_warp():
    """The fused branch's premise: with align_corners False, the center crop
    of the PS = 64 warp and the PS = 32 warp at half scale agree."""
    data, rng = _data(4)
    n = data.shape[0]
    trans = torch.from_numpy(np.eye(2, dtype=np.float32) + rng.uniform(
        -0.3, 0.3, (n, 2, 2)).astype(np.float32))
    fused = aug.warp_by_predicted_transform(torch.from_numpy(data), trans, 32)
    base = aug._base_lafs(n)
    lafs = torch.cat([trans @ base[:, :, :2], base[:, :, 2:]], 2)
    full = aug.sample_batched(torch.from_numpy(data), lafs, ps=64)
    torch.testing.assert_close(fused, full[:, 16:48, 16:48], rtol=0,
                               atol=1e-5)


def test_random_draws_have_the_reference_distribution():
    g = torch.Generator().manual_seed(0)
    n = 4000
    rot, inv = aug.get_random_rotation_lafs(n, math.pi, g)
    A = rot[:, :, :2]
    np.testing.assert_allclose((A @ A.transpose(1, 2)).numpy(),
                               np.tile(0.25 * np.eye(2), (n, 1, 1)),
                               atol=1e-6)
    torch.testing.assert_close(inv @ (2 * A), torch.eye(2).expand(n, 2, 2),
                               rtol=0, atol=1e-6)
    assert torch.all(rot[:, :, 2] == 0.5)
    aff = aug.get_random_norm_affine_lafs(n, 3.0, g)
    det = torch.linalg.det(aff[:, :, :2] * 2)
    torch.testing.assert_close(det, torch.ones(n), rtol=0, atol=1e-5)
    assert torch.all(aff[:, 0, 1] == 0)          # rectified up-is-up
    sw, sh = aug.get_random_shifts(n, 4, g)
    assert set(sw.unique().tolist()) <= {x / 2 for x in range(-2, 6)}
    assert sh.min() >= -1.0 and sh.max() <= 2.5
    # Anchor and positive share the rotation for 'Rot'-free archs.
    g1 = torch.Generator().manual_seed(5)
    lafs, rot_l, _ = aug.random_warp_lafs(16, math.pi, 3.0, g1)
    lafs_p, rot_p, inv_p = aug.random_warp_lafs(16, rot_l, 3.0, g1)
    assert rot_p is rot_l and inv_p is None
    assert lafs.shape == lafs_p.shape == (16, 2, 3)


def test_extract_random_laf_is_its_draw_then_warp():
    data, _ = _data(6)
    td = torch.from_numpy(data)
    crop, full, rot, inv = aug.extract_random_laf(
        td, math.pi, 3.0, 32, generator=torch.Generator().manual_seed(9))
    lafs, rot2, inv2 = aug.random_warp_lafs(
        data.shape[0], math.pi, 3.0, torch.Generator().manual_seed(9))
    crop2, full2 = aug.warp_and_crop(td, lafs, 32)
    torch.testing.assert_close(rot, rot2, rtol=0, atol=0)
    torch.testing.assert_close(inv, inv2, rtol=0, atol=0)
    torch.testing.assert_close(full, full2, rtol=0, atol=0)
    torch.testing.assert_close(crop, crop2, rtol=0, atol=0)
