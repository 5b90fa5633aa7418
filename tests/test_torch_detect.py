"""Kernel B2's plain versions (affnet_tpu_torch.ops.cuda_detect) against the
JAX fused detection kernel run interpreted: identical NMS survivor masks,
sigma/y/x maps at atol=1e-5, responses at the JAX fused test's tolerance;
and the stage's plain stencil, dedup and refine against the chain they
replace (full maps, border mask, update_octave_map), bit for bit."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from affnet_tpu.ops import scalespace as jss
from affnet_tpu.ops.pallas_detect import detect_octave_fused
from affnet_tpu_torch.ops import cuda_detect
from affnet_tpu_torch.ops import scalespace as tss
from affnet_tpu_torch.ops.nms import border_mask, update_octave_map

SIGMAS = [1.6, 2.0159, 2.5398, 3.2, 4.0317]


def _compare(levels_np, sigmas, th):
    fused = detect_octave_fused([jnp.asarray(l) for l in levels_np],
                                sigmas, th, tile_h=32, interpret=True)
    got = cuda_detect.detect_octave(torch.from_numpy(np.stack(levels_np)),
                                    sigmas, th).numpy()
    assert got.shape == (len(levels_np) - 2, 4) + levels_np[0].shape
    for lc, (nm, sc, y, x) in enumerate(fused):
        nm, sc, y, x = (np.asarray(m) for m in (nm, sc, y, x))
        np.testing.assert_array_equal(got[lc, 0] > 0, nm > 0)
        np.testing.assert_allclose(got[lc, 0], nm, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(got[lc, 1], sc, atol=1e-5)
        np.testing.assert_allclose(got[lc, 2], y, atol=1e-5)
        np.testing.assert_allclose(got[lc, 3], x, atol=1e-5)


@pytest.mark.parametrize("hw", [(77, 160), (32, 40), (15, 20)])
@pytest.mark.parametrize("th", [0.0, 5.0])
def test_detect_matches_jax_fused(hw, th):
    rng = np.random.RandomState(hw[0] * 1000 + hw[1])
    levels = [(rng.rand(*hw) * 50).astype(np.float32) for _ in range(5)]
    _compare(levels, SIGMAS, th)


def test_detect_two_octave_pyramid():
    """Both octaves of a 96x128 image's pyramid (border 12 gives two)."""
    img = np.random.RandomState(7).rand(96, 128).astype(np.float32) * 255
    plan = jss.make_plan(96, 128, 3, 1.6, 12)
    assert plan.n_octaves == 2
    pyr = jss.build_pyramid(jnp.asarray(img), plan)
    for o in range(plan.n_octaves):
        _compare([np.asarray(l) for l in pyr[o]], plan.sigmas[o], 0.0)


def test_detect_wrapper_dispatch():
    levels = torch.rand(5, 12, 14)
    before = cuda_detect.launches
    out = cuda_detect.detect_octave(levels, SIGMAS, 0.0)
    assert cuda_detect.launches == before
    torch.testing.assert_close(
        out, cuda_detect.detect_octave_plain(levels, SIGMAS, 0.0),
        rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_detect.detect_octave_cuda(levels, SIGMAS, 0.0)


# ---------------------------------------------------------------------------
# The stage's plain versions (stencil, dedup, refine) against the chain they
# replace: full maps, border mask and update_octave_map per center level.
# ---------------------------------------------------------------------------

def old_detection_chain(levels, sigmas, th, border):
    """The detection of one octave as the extractor computed it before the
    stage was split: the full (L - 2, 4, H, W) maps, the border mask and
    ``update_octave_map`` per center level.  Returns the deduplicated
    responses (L - 2, H, W) and the (sc, y, x) maps (L - 2, 3, H, W)."""
    h, w = levels.shape[1:]
    maps = cuda_detect.detect_octave_plain(levels, sigmas, th)
    bmask = border_mask(h, w, border)
    octmap = torch.zeros((h, w))
    resp = []
    for nmsed_raw, _, _, _ in maps:
        nmsed, octmap = update_octave_map(octmap, nmsed_raw * bmask)
        resp.append(nmsed)
    return torch.stack(resp), maps[:, 1:]


def _new_chain(levels, sigmas, th, border):
    """The stencil, the dedup and the refine at every entry of one octave."""
    n, h, w = levels.shape
    resp, counters = cuda_detect.stencil_plain(levels, sigmas, th, border)
    flat = resp.reshape(-1).clone()
    cuda_detect.dedup_plain(flat, counters[None], [(0, h * w)])
    tables = cuda_detect.RefineTables.for_octave(h, w, sigmas, "cpu")
    syx = cuda_detect.refine_plain(levels.reshape(n * h, w),
                                   torch.arange(flat.numel()), tables, th)
    return (resp, flat.view(n - 2, h, w),
            syx.view(n - 2, h, w, 3).permute(0, 3, 1, 2))


@pytest.mark.parametrize("hw", [(77, 160), (32, 40), (15, 20)])
@pytest.mark.parametrize("th", [0.0, 5.0])
def test_stage_plain_equals_old_chain(hw, th):
    """Masked responses, deduplicated responses and (sigma, y, x) at every
    entry equal the old chain bit for bit."""
    rng = np.random.RandomState(hw[0] * 1000 + hw[1])
    levels = torch.from_numpy((rng.rand(5, *hw) * 50).astype(np.float32))
    raw, resp, syx = _new_chain(levels, SIGMAS, th, 5)
    ref, ref_syx = old_detection_chain(levels, SIGMAS, th, 5)
    full = cuda_detect.detect_octave_plain(levels, SIGMAS, th)
    assert torch.equal(raw, full[:, 0] * border_mask(*hw, 5))
    assert torch.equal(resp, ref)
    assert torch.equal(syx, ref_syx)


def test_stage_two_octave_pyramid():
    """Both octaves of a 96x128 image's pyramid in the level buffer (border
    12 gives two), through one response vector and one dedup: equal to the
    old chain per octave."""
    img = torch.from_numpy(
        np.random.RandomState(7).rand(96, 128).astype(np.float32) * 255)
    plan = tss.make_plan(96, 128, 3, 1.6, 12)
    assert plan.n_octaves == 2
    pyr, buf = tss.build_flat_pyramid(img, plan)
    n = plan.n_levels
    chunks, counters, octaves, refs, off = [], [], [], [], 0
    for o, (h, w) in enumerate(plan.octave_shapes):
        r, c = cuda_detect.stencil_plain(pyr[o], plan.sigmas[o], 0.0, 5)
        chunks.append(r.reshape(-1))
        counters.append(c)
        octaves.append((off, h * w))
        off += n * h * w
        refs.append(old_detection_chain(pyr[o].contiguous(), plan.sigmas[o],
                                        0.0, 5))
    resp = torch.cat(chunks)
    cuda_detect.dedup_plain(resp, torch.stack(counters), octaves)
    det_offsets = [o + k * hw for o, hw in octaves for k in range(n)]
    ext = [plan.flat_index(o, k) for o in range(plan.n_octaves)
           for k in range(n)]
    offs, hs, ws = plan.level_dims_padded()
    tables = cuda_detect.RefineTables(
        torch.tensor(det_offsets), torch.tensor(ext),
        *(torch.from_numpy(a) for a in (offs, hs, ws)),
        *cuda_detect.RefineTables.level_tables(plan, "cpu"))
    syx = cuda_detect.refine_plain(buf, torch.arange(resp.numel()), tables,
                                   0.0)
    for o, (ref, ref_syx) in enumerate(refs):
        off, hw = octaves[o]
        h, w = plan.octave_shapes[o]
        assert torch.equal(resp[off:off + n * hw].view(n, h, w), ref)
        got = syx[off:off + n * hw].view(n, h, w, 3).permute(0, 3, 1, 2)
        assert torch.equal(got, ref_syx)


@pytest.mark.parametrize("hw", [(77, 160), (32, 40), (15, 20)])
@pytest.mark.parametrize("th", [0.0, 5.0])
def test_refine_matches_jax_fused_at_survivors(hw, th):
    """(sigma, y, x) from the refine at the survivors equal JAX's
    interpreted fused maps gathered there, at atol 1e-5."""
    rng = np.random.RandomState(hw[0] * 1000 + hw[1])
    levels = (rng.rand(5, *hw) * 50).astype(np.float32)
    _, resp, syx = _new_chain(torch.from_numpy(levels), SIGMAS, th, 0)
    fused = detect_octave_fused([jnp.asarray(l) for l in levels], SIGMAS, th,
                                tile_h=32, interpret=True)
    keep = resp.numpy() > 0
    assert keep.sum() > 0
    for lc, (_, sc, y, x) in enumerate(fused):
        for m, ref in enumerate((sc, y, x)):
            np.testing.assert_allclose(syx[lc, m].numpy()[keep[lc]],
                                       np.asarray(ref)[keep[lc]], atol=1e-5)


@pytest.mark.parametrize("n_levels", [3, 6, 8])
def test_detect_levels_match_jax_fused(n_levels):
    """Octaves of 3, 6 and 8 levels (n_levels 1, 4 and 6) through the full
    maps and through the stage's plain versions, against JAX's fused
    kernel."""
    rng = np.random.RandomState(n_levels)
    levels = [(rng.rand(40, 56) * 50).astype(np.float32)
              for _ in range(n_levels)]
    sigmas = [1.6 * 2 ** (i / max(1, n_levels - 2)) for i in range(n_levels)]
    _compare(levels, sigmas, 0.0)
    raw, _, syx = _new_chain(torch.from_numpy(np.stack(levels)), sigmas, 0.0,
                             0)
    fused = detect_octave_fused([jnp.asarray(l) for l in levels], sigmas,
                                0.0, tile_h=32, interpret=True)
    for lc, (nm, sc, y, x) in enumerate(fused):
        np.testing.assert_array_equal(raw[lc].numpy() > 0,
                                      np.asarray(nm) > 0)
        for m, ref in enumerate((sc, y, x)):
            np.testing.assert_allclose(syx[lc, m].numpy(), np.asarray(ref),
                                       atol=1e-5)


_BELOW_ONE = float(np.nextafter(np.float32(1.0), np.float32(0.0)))


def _dedup_case(name):
    """Three center levels on a 6x8 octave with designed survivors."""
    r = torch.zeros((3, 6, 8))
    if name == "0_1_2_survivors":
        r[1, 2, 3] = 4.0
        r[2, 1, 1], r[2, 4, 6] = 3.0, 0.5
    elif name == "claims_at_one":
        # Level 0 claims (1, 1) with exactly 1.0 but not (2, 2) with the
        # float just below 1.0; level 1 keeps (2, 2) and loses (1, 1).
        r[0, 1, 1], r[0, 2, 2], r[0, 4, 4] = 1.0, _BELOW_ONE, 2.0
        r[1, 1, 1], r[1, 2, 2], r[1, 3, 5] = 7.0, 6.0, 0.25
        r[2, 1, 1], r[2, 2, 2] = 3.0, 3.0
    elif name == "claim_drops_a_level":
        # Level 1 has 2 survivors, one claimed: 1 left, so it is dropped
        # and claims nothing for level 2.
        r[0, 1, 1], r[0, 3, 3] = 2.0, 2.0
        r[1, 1, 1], r[1, 4, 6] = 5.0, 5.0
        r[2, 4, 6], r[2, 0, 0] = 1.5, 1.5
    elif name == "dropped_level_claims_nothing":
        r[0, 2, 2] = 9.0
        r[1, 2, 2], r[1, 5, 7] = 1.0, 1.0
        r[2, 2, 2], r[2, 5, 7], r[2, 0, 1] = 2.0, 2.0, 2.0
    return r


@pytest.mark.parametrize("name", ["0_1_2_survivors", "claims_at_one",
                                  "claim_drops_a_level",
                                  "dropped_level_claims_nothing"])
def test_dedup_edge_cases_equal_update_octave_map(name):
    r = _dedup_case(name)
    octmap = torch.zeros(r.shape[1:])
    ref = []
    for nm in r:
        masked, octmap = update_octave_map(octmap, nm)
        ref.append(masked)
    got = r.reshape(-1).clone()
    cuda_detect.dedup_plain(got, cuda_detect.count_survivors(r)[None],
                            [(0, r[0].numel())])
    assert torch.equal(got.view(r.shape), torch.stack(ref))


def test_stage_wrappers_dispatch():
    levels = torch.rand(5, 12, 14) * 50
    resp = torch.empty(3, 12, 14)
    counters = torch.zeros(7, dtype=torch.int32)
    before = (cuda_detect.launches, cuda_detect.launches_dedup,
              cuda_detect.launches_refine)
    cuda_detect.detect_stencil(levels, SIGMAS, 0.0, 2, resp, counters)
    r, c = cuda_detect.stencil_plain(levels, SIGMAS, 0.0, 2)
    assert torch.equal(resp, r) and torch.equal(counters, c)
    cuda_detect.dedup(resp.view(-1), counters[None], [(0, 12 * 14)])
    tables = cuda_detect.RefineTables.for_octave(12, 14, SIGMAS, "cpu")
    cuda_detect.refine(levels.view(60, 14), torch.arange(10), tables, 0.0)
    assert (cuda_detect.launches, cuda_detect.launches_dedup,
            cuda_detect.launches_refine) == before
    for fn, args in (
            (cuda_detect.stencil_cuda, (levels, SIGMAS, 0.0, 2, resp,
                                        counters)),
            (cuda_detect.dedup_cuda, (resp.view(-1), counters[None],
                                      [(0, 168)])),
            (cuda_detect.refine_cuda, (levels.view(60, 14),
                                       torch.arange(10), tables, 0.0))):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args)
