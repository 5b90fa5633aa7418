"""The port's matching (affnet_tpu_torch.match) against the JAX package's
(affnet_tpu.match) on the same seeded descriptors, on the CPU.

The descriptors are unit vectors made with numpy from a seed, with no
near-ties (checked: every row's two nearest distances differ by more than
1e-5, and no ratio lies within 1e-4 of the threshold), so the nearest
neighbours, the masks and the tentative matches must be equal.  Distances
and ratios agree to rtol 1e-5 / atol 1e-4: the expansion
|a|^2 + |p|^2 - 2 a.p rounds in another order in XLA, a few 1e-7 on values
near 2, which is some 1e-7 in a distance near 1.4 (the nearest distances
of these descriptors lie above 0.19: at most 2e-6) and 3e-5 in one of 0.01
(measured on the planted case).  One planted case shows the reference's
column masking, one has duplicate descriptors (the first index among exact
ties, in both packages).
"""

import numpy as np
import pytest
import torch

from affnet_tpu import match as jm
from affnet_tpu_torch import match as tm


def _unit(rng, n, d=128):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _views(seed, n1=300, n2=260, noise=0.3):
    """desc2 holds noisy copies of the first rows of desc1 and unrelated
    rows: some rows match, some do not."""
    rng = np.random.RandomState(seed)
    d1 = _unit(rng, n1)
    k = min(n1, n2) * 2 // 3
    d2 = np.concatenate([d1[:k] + noise * _unit(rng, k) / np.sqrt(2),
                         _unit(rng, n2 - k)])
    d2 = d2[rng.permutation(n2)]
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    return d1, d2.astype(np.float32)


def _no_near_ties(d1, d2, thr):
    d = np.sqrt(np.abs((d1 ** 2).sum(1)[:, None] + (d2 ** 2).sum(1)[None]
                       - 2 * d1.astype(np.float64) @ d2.T.astype(np.float64)))
    two = np.sort(d, axis=1)[:, :2]
    ratio = np.asarray(jm.snn_match(d1, d2, thr)[3])
    return (float((two[:, 1] - two[:, 0]).min()) > 1e-5
            and float(np.abs(ratio - thr).min()) > 1e-4)


def _check(got, ref, exact_idx=True):
    gi, gm, gd, gr = (t.numpy() for t in got)
    ri, rm, rd, rr = (np.asarray(t) for t in ref)
    if exact_idx:
        np.testing.assert_array_equal(gi, ri)
        np.testing.assert_array_equal(gm, rm)
    np.testing.assert_allclose(gd, rd, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(gr, rr, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("seed,thr", [(0, 0.8), (1, 0.8), (2, 0.9)])
def test_snn_match_matches_jax(seed, thr):
    d1, d2 = _views(seed)
    assert _no_near_ties(d1, d2, thr)
    got = tm.snn_match(torch.from_numpy(d1), torch.from_numpy(d2), thr)
    _check(got, jm.snn_match(d1, d2, thr))
    assert 50 < int(got[1].sum()) < len(d1)        # both outcomes occur
    t1, t2 = tm.snn_match_host(d1, d2, thr, device="cpu")
    j1, j2 = jm.snn_match_host(d1, d2, thr)
    np.testing.assert_array_equal(t1, j1)
    np.testing.assert_array_equal(t2, j2)
    assert t1.dtype == t2.dtype == np.int64


def test_snn_match_masks_matched_columns_for_all_rows():
    """Row 0's nearest column is 0 and its second nearest column 1, which
    is row 1's nearest: the reference masks both columns for every row, so
    row 0's second minimum is column 2's distance and row 0 matches.  A
    per-row second minimum would give a ratio near 1 and no match."""
    rng = np.random.RandomState(5)
    base = _unit(rng, 3)
    c = _unit(rng, 2)
    d2 = np.stack([base[0], base[0] + 0.05 * c[0], base[2]])
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    d1 = np.stack([base[0] + 0.1 * c[1], d2[1] + 0.01 * c[0]])
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    d1, d2 = d1.astype(np.float32), d2.astype(np.float32)
    idx, mask, min_d, ratio = tm.snn_match(torch.from_numpy(d1),
                                           torch.from_numpy(d2))
    assert idx.tolist() == [0, 1] and mask.tolist() == [True, True]
    dist = tm.distance_matrix(torch.from_numpy(d1), torch.from_numpy(d2))
    per_row = dist[0, 0] / torch.sort(dist[0]).values[1]
    assert float(per_row) > 0.8 > float(ratio[0])
    _check((idx, mask, min_d, ratio), jm.snn_match(d1, d2))


def test_snn_match_duplicates():
    """Duplicate columns: the first index among the exact ties, and the
    duplicate left unmasked gives ratio 1 (no match); duplicate rows give
    the same match twice."""
    d1, d2 = _views(3, 40, 30)
    d2 = np.concatenate([d2[:5], d2[:5], d2[5:]])      # columns 0-4 twice
    d1 = np.concatenate([d1, d1[:4]])                  # rows 0-3 twice
    got = tm.snn_match(torch.from_numpy(d1), torch.from_numpy(d2))
    ref = jm.snn_match(d1, d2)
    _check(got, ref)
    idx, mask = got[0].numpy(), got[1].numpy()
    assert not (idx[:, None] == np.arange(5, 10)[None]).any()
    hit_dup = np.isin(idx, np.arange(5))
    assert hit_dup.any() and not mask[hit_dup].any()
    np.testing.assert_array_equal(idx[-4:], idx[:4])


def test_snn_match_empty_rows():
    d1, d2 = _views(4, 10, 10)
    idx, mask, min_d, ratio = tm.snn_match(torch.from_numpy(d1[:0]),
                                           torch.from_numpy(d2))
    assert idx.shape == mask.shape == min_d.shape == ratio.shape == (0,)
    t1, t2 = tm.snn_match_host(d1[:0], d2, device="cpu")
    assert len(t1) == len(t2) == 0


@pytest.mark.parametrize("with_negative", [False, True])
def test_distance_vectors_pairwise_matches_jax(with_negative):
    rng = np.random.RandomState(6)
    a, p, n = (_unit(rng, 50) for _ in range(3))
    neg = n if with_negative else None
    got = tm.distance_vectors_pairwise(
        torch.from_numpy(a), torch.from_numpy(p),
        None if neg is None else torch.from_numpy(neg))
    ref = jm.distance_vectors_pairwise(a, p, neg)
    if not with_negative:
        got, ref = (got,), (ref,)
    assert len(got) == len(ref) == (3 if with_negative else 1)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-6)
