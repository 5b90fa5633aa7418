"""Kernel B3's plain version (affnet_tpu_torch.ops.cuda_topk) and the exact
global top-k (affnet_tpu_torch.ops.nms.masked_topk) against the JAX package:
bit-identical, ties included."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from affnet_tpu.ops import nms as jnms
from affnet_tpu.ops.pallas_topk import row_topm_pallas
from affnet_tpu_torch.ops import cuda_topk
from affnet_tpu_torch.ops import nms as tnms

N_BIG = (1 << 18) + 4096


def _tied_rows(seed):
    rng = np.random.RandomState(seed)
    x = rng.exponential(1.0, (300, 1024)).astype(np.float32)
    x[5, 100] = x[5, 7] = x[5].max() + 1.0      # tie for a row's first max
    x[17, :20] = 9.99                           # a run of equal values
    x[40:60, 3] = 7.5                           # equal values across rows
    x[41, 900] = 7.5
    x[250:] = -1.0                              # padding-only rows
    return x


@pytest.mark.parametrize("m", [8, 16])
def test_row_topm_bit_identical_to_jax(m):
    x = _tied_rows(m)
    pv, pc, plo = row_topm_pallas(jnp.asarray(x), m)
    xv, xc, xlo = jnms._row_topm(jnp.asarray(x), m)
    tv, tc, tlo = (t.numpy() for t in cuda_topk.row_topm_flat(
        torch.from_numpy(x).reshape(-1), m))
    for ours, pallas, xla in ((tv, pv, xv), (tc, pc, xc), (tlo, plo, xlo)):
        np.testing.assert_array_equal(ours, np.asarray(pallas))
        np.testing.assert_array_equal(ours, np.asarray(xla))
    assert tc.dtype == np.int32


def _flat_cases(seed):
    """A flat vector of 9 * 1024 + 333 entries: a dense row with a tie for
    its first max, a run of equal values, more than 16 positives in a
    sparse row, an all-equal row, negatives above and below -1, a row all
    below -1, equal values across rows, a ragged last row."""
    rng = np.random.RandomState(seed)
    n = 9 * 1024 + 333
    v = np.zeros(n, np.float32)
    v[:1024] = rng.exponential(1.0, 1024)
    v[7] = v[900] = v[:1024].max() + 1.0
    v[1024 + 10:1024 + 30] = 9.99
    v[1024 + rng.choice(np.arange(40, 1024), 40, replace=False)] = \
        rng.uniform(1.0, 2.0, 40)
    v[2048:3072] = 0.25
    v[3072:4096] = rng.uniform(-3.0, -0.5, 1024)
    v[4096:5120] = -2.0
    v[5120 + 3] = v[6144 + 3] = 7.5
    v[8192:] = rng.exponential(1.0, n - 8192)
    return v


@pytest.mark.parametrize("m", [1, 16, 32])
def test_row_topm_flat_plain_equals_jax_on_padded_copy(m):
    """B3's flat contract (no padded copy; the entries past the end read
    as -1) in its plain version equals JAX's _row_topm on the vector
    padded with -1, bit for bit."""
    v = _flat_cases(m)
    b = -(-v.size // 1024)
    padded = np.pad(v, (0, b * 1024 - v.size), constant_values=-1.0)
    xv, xc, xlo = jnms._row_topm(jnp.asarray(padded.reshape(b, 1024)), m)
    tv, tc, tlo = (t.numpy() for t in cuda_topk.row_topm_flat(
        torch.from_numpy(v), m))
    for ours, xla in ((tv, xv), (tc, xc), (tlo, xlo)):
        np.testing.assert_array_equal(ours, np.asarray(xla))
    assert tc.dtype == np.int32 and tv.shape == (b, m)


def test_two_stage_topk_passes_the_flat_vector(monkeypatch):
    """two_stage_topk hands B3 the flat vector itself (no padded copy) and
    equals the full stable sort on a ragged length."""
    rng = np.random.RandomState(4)
    v = np.zeros(N_BIG + 333, np.float32)
    v[rng.choice(v.size, 3000, replace=False)] = rng.exponential(2.0, 3000)
    v[-5:] = 4.0
    seen = []
    real = tnms.row_topm_flat

    def spy(values, m, use_kernel=True):
        seen.append(values)
        return real(values, m, use_kernel)

    monkeypatch.setattr(tnms, "row_topm_flat", spy)
    x = torch.from_numpy(v)
    got = tnms.two_stage_topk(x, 1000)
    ref = tnms.sorted_topk(x, 1000)
    assert len(seen) == 1 and seen[0] is x
    np.testing.assert_array_equal(got[0].numpy(), ref[0].numpy())
    np.testing.assert_array_equal(got[1].numpy(), ref[1].numpy())


def _check_equal(v, k):
    """Values equal jnms.masked_topk exactly; indices equal on every
    positive entry (zero entries are invalid padding in both)."""
    jv, ji, jvalid = (np.asarray(a) for a in jnms.masked_topk(jnp.asarray(v),
                                                              k))
    tv, ti, tvalid = (t.numpy() for t in tnms.masked_topk(torch.from_numpy(v),
                                                          k))
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tvalid, jvalid)
    np.testing.assert_array_equal(ti[jv > 0], ji[jv > 0])


def test_masked_topk_ties_at_k_boundary():
    rng = np.random.RandomState(0)
    v = np.zeros(N_BIG, np.float32)
    strong = rng.choice(N_BIG, 300, replace=False)
    v[strong] = rng.uniform(5.0, 10.0, 300).astype(np.float32)
    tied = rng.choice(np.setdiff1d(np.arange(N_BIG), strong), 400,
                      replace=False)
    v[tied] = 2.5
    _check_equal(v, 500)


def test_masked_topk_clustered_row_takes_full_sort(monkeypatch):
    v = np.zeros(N_BIG, np.float32)
    v[2048 + 2 * np.arange(64)] = np.linspace(100.0, 50.0, 64)
    rng = np.random.RandomState(1)
    weak = rng.choice(np.arange(10000, N_BIG), 500, replace=False)
    v[weak] = rng.uniform(0.1, 1.0, 500).astype(np.float32)
    calls = []
    real = tnms.sorted_topk
    monkeypatch.setattr(tnms, "sorted_topk",
                        lambda x, k: calls.append(x.numel()) or real(x, k))
    _check_equal(v, 100)
    assert N_BIG in calls            # the exactness check chose the full sort


def test_masked_topk_fewer_positives_than_k():
    rng = np.random.RandomState(2)
    v = np.zeros(N_BIG, np.float32)
    v[rng.choice(N_BIG, 200, replace=False)] = rng.exponential(3.0, 200)
    _check_equal(v, 4096)


def test_masked_topk_dense_random():
    v = np.random.RandomState(3).exponential(1.0, N_BIG).astype(np.float32)
    _check_equal(v, 2000)


def test_masked_topk_small_path():
    v = np.array([0.0, 3.0, 1.0, 3.0, 0.5], np.float32)
    vals, idxs, valid = tnms.masked_topk(torch.from_numpy(v), 3)
    np.testing.assert_array_equal(vals.numpy(), [3.0, 3.0, 1.0])
    np.testing.assert_array_equal(idxs.numpy(), [1, 3, 2])
    np.testing.assert_array_equal(valid.numpy(), [True, True, True])


def test_row_topm_wrapper_dispatch():
    x = torch.from_numpy(_tied_rows(3)).reshape(-1)
    before = cuda_topk.launches
    cuda_topk.row_topm_flat(x, 4)
    assert cuda_topk.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        cuda_topk.row_topm_flat_cuda(x, 4)
