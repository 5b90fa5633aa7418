"""The Frobenius half of the port's ``reproj.py`` against the JAX
package's, on the same seeded LAFs and homography (numpy inputs handed to
both).

View 2 holds view 1's LAFs mapped by H, with seeded noise, a few
outliers and a permutation, so the matchers find pairs and miss some.
Tolerances: matrices and distances rtol 1e-5 / atol 1e-4 (float32 sums of
3x3 products of frames at 20 px scale, and two 3x3 inverses in another
order); indices and masks exactly (the inputs keep distances apart);
the L2 distances of whole frames (``inv_to_eye=False``) atol 2e-2: the
expansion |a|^2 + |b|^2 - 2ab cancels terms of ~4.5e4 (centres at 150
px), whose float32 ulp of 4e-3 the two sum orders place differently
(measured 3.7e-3 at a distance of 1.41);
losses rtol 1e-5; gradients of the losses rtol 1e-4 / atol 1e-6;
``affine_aug``'s image atol 1e-5 on [0, 1] pixels with JAX's uniforms,
its homography rtol 1e-5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from affnet_tpu import reproj as jreproj
from affnet_tpu_torch import reproj

H = np.array([[1.05, 0.08, 12.0], [-0.06, 0.97, -7.0],
              [2e-4, -1e-4, 1.0]], np.float32)


def _lafs(seed=0, n=24):
    """(lafs1, lafs2): view 2 is view 1 mapped by H plus noise, its last
    four rows moved far away, rows permuted."""
    rng = np.random.RandomState(seed)
    A = (rng.rand(n, 2, 2) - 0.5 + np.eye(2)) * 20.0
    lafs1 = np.concatenate([A, rng.rand(n, 2, 1) * 150 + 20],
                           2).astype(np.float32)
    l2 = np.asarray(jreproj.reproject_lafs(jnp.asarray(lafs1),
                                           jnp.asarray(H)))
    l2 = l2 + rng.randn(*l2.shape).astype(np.float32) * 0.3
    l2[-4:, :, 2] += 300.0
    return lafs1, l2[rng.permutation(n)].astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(got, ref, **tol):
    tol = tol or dict(rtol=1e-5, atol=1e-4)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    if ref.dtype == bool or np.issubdtype(ref.dtype, np.integer):
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, **tol)


def test_grid_matrices_equal_jax():
    for w, h in ((64, 48), (1920, 1080)):
        np.testing.assert_array_equal(reproj.px2grid_A(w, h),
                                      jreproj.px2grid_A(w, h))
        np.testing.assert_array_equal(reproj.grid2px_A(w, h),
                                      jreproj.grid2px_A(w, h))


@pytest.mark.parametrize("align_corners", [False, True])
def test_affine_aug_with_jax_uniforms(align_corners):
    img = np.random.RandomState(1).rand(40, 56).astype(np.float32)
    key = jax.random.PRNGKey(7)
    ref_img, ref_H = jreproj.affine_aug(jnp.asarray(img), key,
                                        align_corners=align_corners)
    u = np.asarray(jax.random.uniform(key, (3, 3)))
    got_img, got_H = reproj.affine_aug_core(_t(img), _t(u),
                                            align_corners=align_corners)
    _close(got_img, ref_img, atol=1e-5, rtol=0)
    _close(got_H, ref_H, rtol=1e-5, atol=1e-5)
    # The drawing wrapper is the core on the generator's uniforms.
    gen = torch.Generator().manual_seed(3)
    a_img, a_H = reproj.affine_aug(_t(img), gen)
    u2 = torch.rand((3, 3), generator=torch.Generator().manual_seed(3))
    b_img, b_H = reproj.affine_aug_core(_t(img), u2)
    assert torch.equal(a_img, b_img) and torch.equal(a_H, b_H)


def test_frobenius_pieces_match_jax():
    lafs1, lafs2 = _lafs()
    lhf1 = np.asarray(jreproj.lafs_to_h_frames(jnp.asarray(lafs1)))
    lhf2 = np.asarray(jreproj.lafs_to_h_frames(jnp.asarray(lafs2)))
    inv1 = reproj.inverse_lhfs(_t(lhf1))
    _close(inv1, jreproj.inverse_lhfs(jnp.asarray(lhf1)))
    jinv1 = jreproj.inverse_lhfs(jnp.asarray(lhf1))
    for skip in (False, True):
        _close(reproj.frobenius_canonical_dist(_t(np.asarray(jinv1)),
                                               _t(lhf2), skip),
               jreproj.frobenius_canonical_dist(jinv1, jnp.asarray(lhf2),
                                                skip))
    s1, s2 = reproj.lhf_scale(_t(lhf1)), reproj.lhf_scale(_t(lhf2))
    _close(s1, jreproj.lhf_scale(jnp.asarray(lhf1)))
    _close(reproj.ratio_matrix(s2, s1),
           jreproj.ratio_matrix(jnp.asarray(s2.numpy()),
                                jnp.asarray(s1.numpy())))


@pytest.mark.parametrize("skip", [False, True])
def test_gt_correspondence_fro_mask_matches_jax(skip):
    lafs1, lafs2 = _lafs(1)
    ref = jreproj.gt_correspondence_fro_mask(
        jnp.asarray(lafs1), jnp.asarray(lafs2), jnp.asarray(H), 0.5, skip)
    got = reproj.gt_correspondence_fro_mask(_t(lafs1), _t(lafs2), _t(H),
                                            0.5, skip)
    for g, r in zip(got, ref):
        _close(g, r)
    # The four outliers' centres moved, not their shapes.
    assert int(got[2].sum()) == len(lafs1) - (0 if skip else 4)


@pytest.mark.parametrize("kw", [
    dict(), dict(do_up_is_up=True), dict(inv_to_eye=False),
    dict(inv_to_eye=False, skip_center_in_fro=True, dist_threshold=30.0),
    dict(scale_diff_coef=0.0, skip_center_in_fro=True)])
def test_gt_correspondence_fro_and_center_mask_matches_jax(kw):
    lafs1, lafs2 = _lafs(2)
    ref = jreproj.gt_correspondence_fro_and_center_mask(
        jnp.asarray(lafs1), jnp.asarray(lafs2), jnp.asarray(H), **kw)
    got = reproj.gt_correspondence_fro_and_center_mask(
        _t(lafs1), _t(lafs2), _t(H), **kw)
    assert len(got) == len(ref) == 4
    tol = {} if kw.get("inv_to_eye", True) else dict(rtol=0, atol=2e-2)
    for g, r in zip(got, ref):
        _close(g, r, **tol)


def test_closest_correspondences_matches_jax():
    lafs1, lafs2 = _lafs(3)
    lhf1 = jreproj.lafs_to_h_frames(jnp.asarray(lafs1))
    lhf2 = jreproj.reproject_lafs(jnp.asarray(lafs2),
                                  jnp.linalg.inv(jnp.asarray(H)), True)
    ref = jreproj.closest_correspondences(lhf1, lhf2, 5.0, 0.4)
    got = reproj.closest_correspondences(_t(np.asarray(lhf1)),
                                         _t(np.asarray(lhf2)), 5.0, 0.4)
    for g, r in zip(got, ref):
        _close(g, r)
    assert 0 < int(got[0].sum()) < len(lafs1)


@pytest.mark.parametrize("name,kw", [
    ("laf_magic", dict()), ("laf_magic", dict(t=0.0, aff=2.0)),
    ("laf_magic", dict(sc=0.0, aff=0.0)), ("laf_magic_fro", dict())])
def test_laf_magic_losses_and_gradients_match_jax(name, kw):
    lafs1, lafs2 = _lafs(4)

    def jloss(l1):
        out = getattr(jreproj, name)(l1, jnp.asarray(lafs2), jnp.asarray(H),
                                     **kw)
        return jnp.sum(out[0] * out[1]), out

    (jval, ref), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(lafs1))
    t1 = _t(lafs1).requires_grad_(True)
    got = getattr(reproj, name)(t1, _t(lafs2), _t(H), **kw)
    val = (got[0] * got[1]).sum()
    val.backward()
    for g, r in zip(got, ref):
        _close(g, r)
    np.testing.assert_allclose(float(val), float(jval), rtol=1e-5)
    _close(t1.grad, jgrad, rtol=1e-4, atol=1e-6)


def test_identity_loss_matches_jax():
    rng = np.random.RandomState(6)
    A = (np.eye(2, 3) + 0.3 * rng.randn(9, 2, 3)).astype(np.float32)
    A[0] = np.eye(2, 3)
    A[1, 0, 2] = 500.0                          # past the clip at 100
    got = reproj.identity_loss(_t(A))
    np.testing.assert_allclose(float(got),
                               float(jreproj.identity_loss(jnp.asarray(A))),
                               rtol=1e-6)
