"""Kernel B5's plain version — the per-sample patch sampler of the training
warps, autograd through ``ops.patches.extract_patches_batched`` — against
the JAX package on the same numpy inputs.

Tolerances: forward max |diff| 5e-5 against ``_extract_patches_batched_xla``
and the LAF cotangent at rtol 5e-4 / atol 2e-3 against ``jax.grad``
(tests/test_pallas_patches.py:259-260).  The image cotangent is the same
scatter-add in both packages; atol 1e-5 on [-1, 1] upstream weights."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from affnet_tpu.ops.pallas_patches import extract_patches_batched_pallas
from affnet_tpu.ops.patches import _extract_patches_batched_xla
from affnet_tpu_torch.ops import batched_sampler, cuda_patches
from affnet_tpu_torch.ops.patches import (batched_tables,
                                          extract_patches_batched,
                                          laf_cotangent_replay)


def _inputs(seed, n=12, h=64, pert=0.15):
    rng = np.random.RandomState(seed)
    imgs = rng.uniform(0, 1, (n, h, h)).astype(np.float32)
    lafs = np.tile(np.array([[0.5, 0.0, 0.5], [0.0, 0.5, 0.5]], np.float32),
                   (n, 1, 1))
    lafs[:, :2, :2] += rng.uniform(-pert, pert, (n, 2, 2)).astype(np.float32)
    lafs[:, :, 2] += rng.uniform(-0.05, 0.05, (n, 2)).astype(np.float32)
    wgt = rng.uniform(-1, 1, (n,)).astype(np.float32)
    return imgs, lafs, rng, wgt


@pytest.mark.parametrize("ps,align", [(64, False), (32, False), (32, True),
                                      (19, False)])
def test_forward_matches_jax_xla(ps, align):
    imgs, lafs, _, _ = _inputs(ps + align)
    got = extract_patches_batched(torch.from_numpy(imgs),
                                  torch.from_numpy(lafs), ps=ps,
                                  align_corners=align).numpy()
    ref = np.asarray(_extract_patches_batched_xla(
        jnp.asarray(imgs), jnp.asarray(lafs), ps=ps, align_corners=align))
    assert got.shape == (imgs.shape[0], ps, ps)
    assert np.abs(got - ref).max() < 5e-5


def test_forward_matches_jax_pallas_entry():
    """The JAX training warps' own entry (Pallas forward, interpreted)."""
    imgs, lafs, _, _ = _inputs(3)
    got = extract_patches_batched(torch.from_numpy(imgs),
                                  torch.from_numpy(lafs), ps=32).numpy()
    ref = np.asarray(extract_patches_batched_pallas(
        jnp.asarray(imgs), jnp.asarray(lafs), ps=32))
    assert np.abs(got - ref).max() < 5e-5


@pytest.mark.parametrize("ps,align,pert", [(32, False, 0.15),
                                           (64, False, 0.15),
                                           (32, True, 0.15),
                                           (32, False, 1.5)])
def test_cotangents_match_jax_grad(ps, align, pert):
    """LAF and image cotangents; pert 1.5 sends many samples outside the
    image (masked corners), as an untrained AffNet's rewarp does."""
    imgs, lafs, rng, _ = _inputs(10 * ps + align, pert=pert)
    n = imgs.shape[0]
    g = rng.uniform(-1, 1, (n, ps, ps)).astype(np.float32)

    def loss_j(l, im):
        return (_extract_patches_batched_xla(im, l, ps=ps,
                                             align_corners=align)
                * jnp.asarray(g)).sum()

    gj_l, gj_i = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(lafs),
                                                  jnp.asarray(imgs))
    t_lafs = torch.from_numpy(lafs).requires_grad_(True)
    t_imgs = torch.from_numpy(imgs).requires_grad_(True)
    out = batched_sampler.sample_batched(t_imgs, t_lafs, ps=ps,
                                         align_corners=align)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(t_lafs.grad.numpy(), np.asarray(gj_l),
                               rtol=5e-4, atol=2e-3)
    np.testing.assert_allclose(t_imgs.grad.numpy(), np.asarray(gj_i),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("ps,align,pert", [(32, False, 0.15),
                                           (64, False, 0.15),
                                           (32, True, 0.15),
                                           (32, False, 1.5),
                                           (65, True, 0.15)])
def test_laf_cotangent_replay_matches_autograd_and_jax(ps, align, pert):
    """The replay of the backward kernel's order (``laf_cotangent_replay``)
    computes the LAF cotangent: within rtol 1e-4 / atol 1e-4 of its largest
    magnitude of autograd's plain cotangent (the kernel tests' bound:
    another summation order), and within the JAX test's rtol 5e-4 / atol
    2e-3 of ``jax.grad``, on test_cotangents_match_jax_grad's cases (PS 65:
    the generic instance's order)."""
    imgs, lafs, rng, _ = _inputs(10 * ps + align, pert=pert)
    n = imgs.shape[0]
    g = rng.uniform(-1, 1, (n, ps, ps)).astype(np.float32)

    def loss_j(l):
        return (_extract_patches_batched_xla(jnp.asarray(imgs), l, ps=ps,
                                             align_corners=align)
                * jnp.asarray(g)).sum()

    gj_l = np.asarray(jax.grad(loss_j)(jnp.asarray(lafs)))
    t_lafs = torch.from_numpy(lafs).requires_grad_(True)
    out = extract_patches_batched(torch.from_numpy(imgs), t_lafs, ps=ps,
                                  align_corners=align)
    (out * torch.from_numpy(g)).sum().backward()
    ref = t_lafs.grad
    tables = batched_tables(n, imgs.shape[1], imgs.shape[2], "cpu")
    got = laf_cotangent_replay(
        torch.from_numpy(imgs).reshape(-1, imgs.shape[2]),
        torch.from_numpy(lafs), *tables, torch.from_numpy(g), ps=ps,
        align_corners=align)
    assert got.shape == (n, 2, 3) and got.dtype == torch.float32
    torch.testing.assert_close(got, ref, rtol=1e-4,
                               atol=1e-4 * float(ref.abs().max()))
    np.testing.assert_allclose(got.numpy(), gj_l, rtol=5e-4, atol=2e-3)


def test_cpu_tensors_take_the_plain_version():
    imgs, lafs, _, _ = _inputs(5, n=4)
    counts = (cuda_patches.launches, cuda_patches.launches_batched,
              cuda_patches.launches_bwd)
    t_lafs = torch.from_numpy(lafs).requires_grad_(True)
    out = batched_sampler.sample_batched(torch.from_numpy(imgs), t_lafs)
    out.sum().backward()
    assert (cuda_patches.launches, cuda_patches.launches_batched,
            cuda_patches.launches_bwd) == counts
    torch.testing.assert_close(out, extract_patches_batched(
        torch.from_numpy(imgs), torch.from_numpy(lafs)), rtol=0, atol=0)


def test_batched_tables():
    idx, offs, hs, ws = batched_tables(3, 64, 48, "cpu")
    assert idx.dtype == offs.dtype == hs.dtype == ws.dtype == torch.int32
    assert idx.tolist() == [0, 1, 2]
    assert offs.tolist() == [0, 64, 128]
    assert hs.tolist() == [64] * 3 and ws.tolist() == [48] * 3


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never run the plain version: CPU tensors raise."""
    imgs, lafs, _, _ = _inputs(6, n=2)
    buf = torch.from_numpy(imgs).reshape(-1, 64)
    tables = batched_tables(2, 64, 64, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_patches.sample_batched_cuda(buf, torch.from_numpy(lafs),
                                         tables, 32, False)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_patches.sample_bwd_cuda(buf, torch.from_numpy(lafs), tables,
                                     torch.zeros(2, 32, 32), 32, False,
                                     False, True)
    with pytest.raises(ValueError, match="CUDA"):
        batched_sampler.BatchedSample.apply(torch.from_numpy(imgs),
                                            torch.from_numpy(lafs), 32,
                                            False)
