"""The port's descriptor losses against ``affnet_tpu.losses`` on the same
numpy inputs: every reduction and type of the HardNet loss, the L2Net and
random-sampling losses and the global orthogonal regularization.

Tolerances: values rtol 1e-5; input gradients rtol 1e-5 with atol 1e-7
(the gradients are O(1e-2); the atol covers entries that cancel to zero).
The ``random`` reduction draws its permutation from ``jax.random`` in the
JAX package; the test passes the same permutation to the port.
"""

import itertools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from affnet_tpu import losses as jlosses
from affnet_tpu_torch import losses


def _descs(seed, n=16, d=128, negatives=False):
    rng = np.random.RandomState(seed)

    def unit(x):
        return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(
            np.float32)

    a = rng.randn(n, d)
    out = [unit(a), unit(a + 0.4 * rng.randn(n, d))]
    if negatives:
        out.append(unit(a + 1.2 * rng.randn(n, d)))
    return out


def _check(tfn, jfn, arrays):
    n_args = len(arrays)
    ref, grads = jax.value_and_grad(jfn, argnums=tuple(range(n_args)))(
        *[jnp.asarray(x) for x in arrays])
    ts = [torch.from_numpy(x).requires_grad_(True) for x in arrays]
    val = tfn(*ts)
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(ref), rtol=1e-5)
    for t, g in zip(ts, grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("reduce,loss_type,swap", list(itertools.product(
    ["min", "average", "random"], ["triplet_margin", "softmax",
                                   "contrastive"], [False, True])))
def test_loss_hardnet_matches_jax(reduce, loss_type, swap):
    a, p = _descs(len(reduce) + 3 * len(loss_type) + int(swap))
    key = jax.random.PRNGKey(5)
    perm = torch.from_numpy(np.array(jax.random.permutation(key, len(a))))
    kw = dict(anchor_swap=swap, batch_reduce=reduce, loss_type=loss_type)
    _check(lambda x, y: losses.loss_hardnet(x, y, perm=perm, **kw),
           lambda x, y: jlosses.loss_hardnet(x, y, rng=key, **kw), [a, p])


def test_loss_hardnet_random_draws_from_the_generator():
    a, p = (torch.from_numpy(x) for x in _descs(1))
    got = losses.loss_hardnet(a, p, batch_reduce="random",
                              generator=torch.Generator().manual_seed(3))
    perm = torch.randperm(len(a), generator=torch.Generator().manual_seed(3))
    assert torch.equal(got, losses.loss_hardnet(a, p, batch_reduce="random",
                                                perm=perm))
    with pytest.raises(ValueError, match="batch_reduce"):
        losses.loss_hardnet(a, p, batch_reduce="max")
    with pytest.raises(ValueError, match="loss type"):
        losses.loss_hardnet(a, p, loss_type="hinge")


@pytest.mark.parametrize("swap", [False, True])
def test_loss_l2net_matches_jax(swap):
    _check(lambda x, y: losses.loss_l2net(x, y, anchor_swap=swap),
           lambda x, y: jlosses.loss_l2net(x, y, anchor_swap=swap),
           _descs(11 + swap))
    with pytest.raises(ValueError, match="softmax"):
        losses.loss_l2net(*(torch.from_numpy(x) for x in _descs(0)),
                          loss_type="triplet_margin")


@pytest.mark.parametrize("loss_type,swap", list(itertools.product(
    ["triplet_margin", "softmax", "contrastive"], [False, True])))
def test_loss_random_sampling_matches_jax(loss_type, swap):
    kw = dict(anchor_swap=swap, loss_type=loss_type)
    _check(lambda x, y, z: losses.loss_random_sampling(x, y, z, **kw),
           lambda x, y, z: jlosses.loss_random_sampling(x, y, z, **kw),
           _descs(21 + len(loss_type) + swap, negatives=True))


def test_global_orthogonal_regularization_matches_jax():
    a, _, n = _descs(31, negatives=True)
    # Negatives nearly orthogonal to their anchors keep the hinge's second
    # term at 0; correlated ones make it positive: both branches.
    ortho = n - 0.99 * (a * n).sum(1, keepdims=True) * a
    for neg in (ortho, n):
        _check(losses.global_orthogonal_regularization,
               jlosses.global_orthogonal_regularization, [a, neg])
    d = (a * ortho).sum(1)
    assert (d ** 2).mean() < 1.0 / a.shape[1] < ((a * n).sum(1) ** 2).mean()
