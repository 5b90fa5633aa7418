"""The rest of the LAF algebra (affnet_tpu_torch/laf.py) against the JAX
package's on the same seeded inputs.

Tolerances: float32 elementwise chains, rtol 1e-5 / atol 1e-6 (XLA may
contract a multiply-add into an FMA where PyTorch rounds twice); the
ellipse round trip at the JAX tests' rtol/atol 2e-3; the host-side numpy
functions exactly."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from affnet_tpu import laf as jlaf
from affnet_tpu_torch import laf

RTOL, ATOL = 1e-5, 1e-6


def _rand_spd(rng, n):
    A = rng.rand(n, 2, 2) - 0.5
    M = A @ np.transpose(A, (0, 2, 1)) + 0.2 * np.eye(2)
    return [M[:, 0, 0].astype(np.float32), M[:, 0, 1].astype(np.float32),
            M[:, 1, 1].astype(np.float32)]


def _both(fn_t, fn_j, *arrays):
    got = fn_t(*[torch.from_numpy(a) for a in arrays])
    ref = fn_j(*[jnp.asarray(a) for a in arrays])
    if isinstance(got, tuple):
        return [g.numpy() for g in got], [np.asarray(r) for r in ref]
    return got.numpy(), np.asarray(ref)


def test_invsqrt2x2_sym_matches_jax_with_zero_b_rows():
    rng = np.random.RandomState(0)
    a, b, c = _rand_spd(rng, 64)
    b[::4] = 0.0                  # the mask: no rotation where b == 0
    b[1] = 1e-30                  # b != 0 but tiny: 2b + eps ~ eps
    a[2] = c[2]                   # r1 = 0: sign(0) = 0
    got, ref = _both(laf.invsqrt2x2_sym, jlaf.invsqrt2x2_sym, a, b, c)
    for g, r in zip(got, ref):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL)
    # b == 0: the input is diagonal, so is the output.
    assert np.all(got[1][::4] == 0.0)


def test_abc2a_rectify_dense_scale_elongation_collapsed():
    rng = np.random.RandomState(1)
    a, b, c = _rand_spd(rng, 16)
    got, ref = _both(laf.abc2A, jlaf.abc2A, a, b, c)
    np.testing.assert_array_equal(got, ref)
    dense = (rng.rand(3, 5, 7, 4) - 0.5).astype(np.float32)
    dense[..., 0] += 1.0
    dense[..., 3] += 1.0
    got, ref = _both(laf.rectify_up_is_up_dense, jlaf.rectify_up_is_up_dense,
                     dense)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    # The dense rectify equals the batched one on the same matrices.
    batched = laf.rectify_up_is_up(torch.from_numpy(dense).reshape(
        3, 5, 7, 2, 2)).reshape(3, 5, 7, 4).numpy()
    np.testing.assert_allclose(got, batched, rtol=RTOL, atol=ATOL)
    lafs = (rng.rand(32, 2, 3) - 0.5).astype(np.float32)
    lafs[:4, 0, 0] *= 40.0         # elongated: collapsed at th 10
    for fn in ("laf_scale", "laf_elongation"):
        got, ref = _both(getattr(laf, fn), getattr(jlaf, fn), lafs)
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=ATOL)
    for th in (3.0, 10.0):
        n = laf.num_collapsed(torch.from_numpy(lafs), th)
        assert n.dtype == torch.float32
        assert float(n) == float(jlaf.num_collapsed(jnp.asarray(lafs), th))


def test_sc_y_x_and_a_to_lafs():
    rng = np.random.RandomState(2)
    syx = rng.rand(4, 10, 3).astype(np.float32)
    A = (rng.rand(4, 10, 4) - 0.5).astype(np.float32)
    got, ref = _both(laf.sc_y_x_and_A_to_lafs, jlaf.sc_y_x_and_A_to_lafs,
                     syx, A)
    assert got.shape == (4, 10, 2, 3)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", [3, 4])
def test_ells_to_lafs_matches_jax_and_round_trips(seed):
    rng = np.random.RandomState(seed)
    n = 32
    ells = np.zeros((n, 5), np.float32)
    ells[:, :2] = rng.rand(n, 2) * 100
    ells[:, 2], ells[:, 3], ells[:, 4] = _rand_spd(rng, n)
    ells[::5, 3] = 0.0             # axis-aligned ellipses: b == 0
    got, ref = _both(laf.ells_to_lafs, jlaf.ells_to_lafs, ells)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    assert np.all(got[:, 0, 1] == 0.0)          # upright
    back = laf.lafs_to_ells(torch.from_numpy(got)).numpy()
    np.testing.assert_allclose(back, ells, rtol=2e-3, atol=2e-3)
    jback = np.asarray(jlaf.lafs_to_ells(jnp.asarray(ref)))
    np.testing.assert_allclose(back, jback, rtol=1e-4, atol=1e-5)


def test_convert_lafs_to_a23_all_formats():
    rng = np.random.RandomState(5)
    n = 8
    x, y, s = rng.rand(n) * 10, rng.rand(n) * 10, rng.rand(n) + 0.5
    a = rng.rand(n, 4) - 0.5
    seven = np.stack([x, y, s, a[:, 0], a[:, 1], a[:, 2], a[:, 3]], -1)
    six = np.stack([x, y, a[:, 0], a[:, 1], a[:, 2], a[:, 3]], -1)
    a23 = rng.rand(n, 2, 3).astype(np.float32)
    for arr in (seven, six, a23, seven.astype(np.float32)):
        got = laf.convert_lafs_to_a23(arr)
        ref = jlaf.convert_lafs_to_a23(arr)
        assert got.dtype == ref.dtype and got.shape == (n, 2, 3)
        np.testing.assert_array_equal(got, ref)
    out = laf.convert_lafs_to_a23(a23)
    out[0, 0, 0] = -1.0             # a copy, not a view
    assert a23[0, 0, 0] != -1.0
    with pytest.raises(ValueError, match="Unknown LAF format"):
        laf.convert_lafs_to_a23(np.zeros((3, 5)))


def test_visualize_lafs_writes_a_figure(tmp_path):
    img = np.random.RandomState(6).rand(40, 50) * 255
    lafs = np.array([[[5.0, 0.0, 20.0], [1.0, 4.0, 25.0]]], np.float32)
    for i, fmt in enumerate((lafs, lafs.reshape(1, 6)[:, [2, 5, 0, 1, 3, 4]])):
        path = tmp_path / f"lafs{i}.png"
        laf.visualize_lafs(img, fmt, save_to=str(path))
        assert path.stat().st_size > 0
    # The boundary points it draws are the JAX package's.
    np.testing.assert_allclose(laf.laf_to_boundary_pts(lafs[0]),
                               jlaf.laf_to_boundary_pts(lafs[0]), rtol=1e-12)
