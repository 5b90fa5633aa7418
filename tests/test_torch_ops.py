"""The port's plain ops against the JAX package on the same inputs: pyramid
plan and buffer, LAF algebra, Hessian response, NMS pieces."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from affnet_tpu import laf as jlaf
from affnet_tpu.ops import hessian as jhess
from affnet_tpu.ops import nms as jnms
from affnet_tpu.ops import scalespace as jss
from affnet_tpu_torch import laf as tlaf
from affnet_tpu_torch.ops import hessian as thess
from affnet_tpu_torch.ops import nms as tnms
from affnet_tpu_torch.ops import scalespace as tss


@pytest.mark.parametrize("hw,border", [((1080, 1920), 5), ((640, 800), 5),
                                       ((120, 160), 5), ((96, 128), 12),
                                       ((37, 29), 3)])
def test_plan_equals_jax(hw, border):
    jp = jss.make_plan(*hw, 3, 1.6, border)
    tp = tss.make_plan(*hw, 3, 1.6, border)
    assert tp.octave_shapes == jp.octave_shapes
    assert tp.sigmas == jp.sigmas and tp.pix_dists == jp.pix_dists
    for a, b in zip(tp.level_dims_padded(), jp.level_dims_padded()):
        np.testing.assert_array_equal(a, b)
    assert tp.padded_buffer_shape() == jp.padded_buffer_shape()
    np.testing.assert_array_equal(tp.sigma_pixdist_table(),
                                  jp.sigma_pixdist_table())


def test_plan_1080p_has_seven_octaves():
    assert tss.make_plan(1080, 1920, 3, 1.6, 5).n_octaves == 7


def test_flat_pyramid_matches_jax():
    img = np.random.RandomState(0).rand(96, 128).astype(np.float32)
    plan = jss.make_plan(96, 128, 3, 1.6, 5)
    _, jbuf = jss.build_flat_pyramid(jnp.asarray(img), plan)
    pyr, tbuf = tss.build_flat_pyramid(torch.from_numpy(img),
                                       tss.make_plan(96, 128, 3, 1.6, 5))
    assert [tuple(o.shape) for o in pyr] == [
        (5, h, w) for h, w in plan.octave_shapes]
    assert tuple(tbuf.shape) == jbuf.shape
    np.testing.assert_allclose(tbuf.numpy(), np.asarray(jbuf), atol=1e-5)


@pytest.mark.parametrize("hw,n_levels,py2", [((96, 128), 6, False),
                                             ((77, 160), 3, True),
                                             ((37, 29), 4, False)])
def test_flat_pyramid_writer_matches_jax(hw, n_levels, py2):
    """The level buffer written in place (one blur launch a level) against
    JAX's build_flat_pyramid at other level counts and the py2 taps."""
    img = np.random.RandomState(1).rand(*hw).astype(np.float32)
    plan = jss.make_plan(*hw, n_levels, 1.6, 3)
    _, jbuf = jss.build_flat_pyramid(jnp.asarray(img), plan, py2=py2)
    _, tbuf = tss.build_flat_pyramid(torch.from_numpy(img),
                                     tss.make_plan(*hw, n_levels, 1.6, 3),
                                     py2=py2)
    assert tuple(tbuf.shape) == jbuf.shape
    np.testing.assert_allclose(tbuf.numpy(), np.asarray(jbuf), atol=1e-5)


def test_downsample_is_stride_two():
    x = torch.arange(7 * 9, dtype=torch.float32).reshape(7, 9)
    np.testing.assert_array_equal(tss.downsample2(x).numpy(),
                                  x.numpy()[::2, ::2])


def _rand_A(rng, n):
    return rng.uniform(-2, 2, (n, 2, 2)).astype(np.float32)


def test_laf_functions_match_jax():
    rng = np.random.RandomState(1)
    A = _rand_A(rng, 64)
    A[0] = [[1.0, 0.0], [0.3, 1.0]]
    for got, ref in zip(tlaf.eig2x2_vals(torch.from_numpy(A)),
                        jlaf.eig2x2_vals(jnp.asarray(A))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(
        tlaf.rectify_up_is_up(torch.from_numpy(A)).numpy(),
        np.asarray(jlaf.rectify_up_is_up(jnp.asarray(A))), rtol=1e-5,
        atol=1e-6)
    lafs = np.concatenate([0.1 * A, rng.uniform(0, 1, (64, 2, 1))],
                          axis=2).astype(np.float32)
    np.testing.assert_array_equal(
        tlaf.check_touch_boundary(torch.from_numpy(lafs)).numpy(),
        np.asarray(jlaf.check_touch_boundary(jnp.asarray(lafs))))
    np.testing.assert_allclose(
        tlaf.denormalize_lafs(torch.from_numpy(lafs), 160, 120).numpy(),
        np.asarray(jlaf.denormalize_lafs(jnp.asarray(lafs), 160, 120)),
        rtol=1e-6)
    syx = rng.uniform(0, 1, (10, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tlaf.sc_y_x_to_lafs(torch.from_numpy(syx)).numpy(),
        np.asarray(jlaf.sc_y_x_to_lafs(jnp.asarray(syx))))


def test_hessian_and_nms_pieces_match_jax():
    rng = np.random.RandomState(2)
    imgs = [rng.rand(23, 31).astype(np.float32) * 50 for _ in range(3)]
    rs_t = [thess.clipped_response(torch.from_numpy(x), s, 1.0)
            for x, s in zip(imgs, (1.6, 2.0, 2.5))]
    rs_j = [jhess.clipped_response(jnp.asarray(x), s, 1.0)
            for x, s in zip(imgs, (1.6, 2.0, 2.5))]
    for a, b in zip(rs_t, rs_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-3)
    nm_t = tnms.nms3d_center(*rs_t).numpy()
    nm_j = np.asarray(jnms.nms3d_center(*rs_j))
    np.testing.assert_array_equal(nm_t > 0, nm_j > 0)
    for a, b in zip(tnms.softargmax_scale_y_x(*rs_t, (1.6, 2.0, 2.5)),
                    jnms.softargmax_scale_y_x(*rs_j, (1.6, 2.0, 2.5))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    np.testing.assert_array_equal(tnms.border_mask(23, 31, 5).numpy(),
                                  np.asarray(jnms.border_mask(23, 31, 5)))
    np.testing.assert_array_equal(tnms.border_mask(8, 31, 5).numpy(), 0.0)
    octmap = (rng.rand(23, 31) > 0.8).astype(np.float32)
    nmsed = nm_t / 10.0
    for a, b in zip(tnms.update_octave_map(torch.from_numpy(octmap),
                                           torch.from_numpy(nmsed)),
                    jnms.update_octave_map(jnp.asarray(octmap),
                                           jnp.asarray(nmsed))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# The public helpers by their JAX names: nms2d, build_pyramid,
# extract_patches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("threshold", [0.0, 0.5])
def test_nms2d_matches_jax(threshold):
    """Equal outputs, ties within 1e-5 included (planted equal maxima)."""
    x = np.random.RandomState(3).rand(19, 27).astype(np.float32)
    x[5, 5] = x[5, 6] = 2.0
    got = tnms.nms2d(torch.from_numpy(x), threshold).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jnms.nms2d(jnp.asarray(x), threshold)))
    assert got[5, 5] == got[5, 6] == 2.0


def test_build_pyramid_matches_jax():
    """pyr[octave][level] with JAX's shapes, each a view of the flat
    buffer, within the flat pyramid test's 1e-5."""
    img = np.random.RandomState(4).rand(64, 96).astype(np.float32)
    plan = tss.make_plan(64, 96, border=5)
    ref = jss.build_pyramid(jnp.asarray(img), jss.make_plan(64, 96, border=5))
    pyr = tss.build_pyramid(torch.from_numpy(img), plan)
    assert [len(o) for o in pyr] == [len(o) for o in ref]
    base = pyr[0][0].untyped_storage().data_ptr()
    for got_o, ref_o in zip(pyr, ref):
        for got, r in zip(got_o, ref_o):
            assert tuple(got.shape) == r.shape
            assert got.untyped_storage().data_ptr() == base
            np.testing.assert_allclose(got.numpy(), np.asarray(r), atol=1e-5)


@pytest.mark.parametrize("ps,align_corners", [(19, True), (32, False)])
def test_extract_patches_matches_jax(ps, align_corners):
    """Patches of one image at normalized LAFs, some reaching past the
    border, against JAX's XLA sampler: atol 2.55e-3 grey levels, 1e-5 of
    the 0-255 range (the same four-corner sum; XLA contracts multiply-adds
    into FMAs where PyTorch rounds each product; measured 1.2e-3); no
    kernel launch on the CPU."""
    from affnet_tpu.ops import patches as jpatches
    from affnet_tpu_torch.ops import launch_counts
    from affnet_tpu_torch.ops import patches as tpatches
    rng = np.random.RandomState(5)
    img = (rng.rand(48, 64) * 255).astype(np.float32)
    A = (rng.rand(9, 2, 2) - 0.5) * 0.4 + 0.2 * np.eye(2)
    lafs = np.concatenate([A, rng.rand(9, 2, 1) * 1.2 - 0.1],
                          2).astype(np.float32)
    ref = np.asarray(jpatches.extract_patches(
        jnp.asarray(img), jnp.asarray(lafs), ps=ps,
        align_corners=align_corners))
    before = launch_counts()
    got = tpatches.extract_patches(torch.from_numpy(img),
                                   torch.from_numpy(lafs), ps=ps,
                                   align_corners=align_corners)
    assert launch_counts() == before
    assert got.shape == (9, ps, ps)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5 * 255)
    assert (ref == 0).any()                 # some samples fell outside
