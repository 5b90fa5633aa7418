#!/usr/bin/env python3
"""GPU smoke check of the PyTorch/CUDA port (affnet_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py [--seed 0] [--images 3]

Phases, each timed and each fatal on failure:

  1. build   — compile csrc/*.cu with one nvcc call (affnet_tpu_torch/_build/).
  2. kernels — every kernel of the extraction path against its plain PyTorch
               version on the card, at the shapes the 1080p main path gives
               it, and timed beside the plain version, a PyTorch library call
               where one computes the same function, and its bound.
  3. main    — HesAffNet + HardTFeat extraction (2000 features, 1080x1920,
               pretrained AffNetFast + HardTFeatNet) through the public
               extractor on seeded images; every kernel must have launched;
               outputs checked against the plain versions on the card and
               against the committed reference goldens on a small image.
  4. times   — end-to-end ms per image (host clock, synchronized).
  5. train kernels — kernel B5 (the training warps' sampler: B4's kernel on
               per-sample tables, and its backward csrc/patches_bwd.cu)
               against its plain version at the shapes of one training step
               (PS 64 warps of 1024 64x64 patches, the PS 32 rewarp of
               2048), timed beside the plain version, F.affine_grid +
               F.grid_sample and its bound.
  6. train   — AffNet training at the published width through train_loop
               (AffNetFast, batch 1024, HardNegC against the frozen
               HardTFeatNet, SGD lr 0.005, synthetic pairs from the committed
               fixture): finite losses, 3 B5 forward and 1 B5 backward
               launches per step, weights and BatchNorm statistics moved, one
               step equal to the plain path's on the card, PosDist falling
               on a fixed batch; ms per training step and pairs/s.

Kernel times ("ms") are device times from torch.profiler (CUPTI): the
card's busy time per call, without the host's launch overhead.  The log
also prints each kernel's median per-call time between CUDA events, which
includes that overhead.

TF32 is switched off for cuDNN convolutions and matmuls for the whole run, so
the nets compute in float32 like the JAX reference.  Imports torch, numpy and
the standard library only.  The last line of stdout is
{"ok": true, "device": {...}}; the line before it the per-kernel JSON.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from affnet_tpu_torch import load_pretrained
from affnet_tpu_torch.data import (DevicePairDataset, PairDataset,
                                   synthetic_pairs_from_image)
from affnet_tpu_torch.detector import (DetectorConfig,
                                       ScaleSpaceAffinePatchExtractor)
from affnet_tpu_torch.kernels import build
from affnet_tpu_torch.models import AffNetFast, HardTFeatNet, params_from_jax
from affnet_tpu_torch.models.cnn import init_params
from affnet_tpu_torch.ops import (EXTRACTION_KERNELS, cuda_blur, cuda_detect,
                                  cuda_patches, cuda_topk, launch_counts,
                                  reset_launch_counts)
from affnet_tpu_torch.ops.nms import M_CAND, ROW_S
from affnet_tpu_torch.ops.patches import (base_lin, batched_tables,
                                          extract_patches_batched)
from affnet_tpu_torch.ops.scalespace import build_pyramid, gauss_kernel_1d
from affnet_tpu_torch.train import (TrainConfig, draw_affnet_lafs,
                                    init_state, make_affnet_train_step,
                                    make_descriptor, tilt_for_epoch,
                                    train_loop)

H, W = 1080, 1920
NFEATS = 2000
ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")

# H100 SXM published peaks (NVIDIA data sheet): HBM rate and float32 rate
# outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

# bench.py's flagship configuration in float32 top-k mode.
CONFIG = DetectorConfig(num_features=NFEATS, border=5, mr_size=5.192,
                        num_baum_iters=1, patch_size=32)


def log(msg: str) -> None:
    print(msg, flush=True)


def make_images(seed: int, n: int) -> list:
    """n distinct 1080x1920 float32 images from the committed 640x800 graf
    fixture: tiled, resampled, flipped/rolled per image, plus seeded noise."""
    base = np.load(os.path.join(FIXTURES, "detector_golden_fullres.npz"))["img"]
    tiled = torch.from_numpy(np.tile(base, (2, 3)))[None, None]
    big = F.interpolate(tiled, size=(H, W), mode="bilinear",
                        align_corners=False)[0, 0].numpy()
    out = []
    for i in range(n):
        rng = np.random.RandomState(seed + i)
        img = np.roll(big, (rng.randint(H), rng.randint(W)), axis=(0, 1))
        if rng.rand() < 0.5:
            img = img[:, ::-1]
        img = img + rng.normal(0.0, 2.0, img.shape)
        out.append(np.ascontiguousarray(np.clip(img, 0, 255), np.float32))
    return out


def pretrained_nets():
    aff = AffNetFast()
    aff.load_state_dict(params_from_jax(load_pretrained("AffNetFast")))
    desc = HardTFeatNet()
    desc.load_state_dict(params_from_jax(load_pretrained("HardTFeatNet")))
    return aff, desc


def time_ms(fn, reps: int, tries: int = 3) -> float:
    """Device time of one fn() call in ms: the summed intervals of its
    kernels and copies on the card (CUPTI through torch.profiler) over reps
    warmed calls, divided by reps.  Host time between launches is not
    counted.  The profiler has returned a window without any device
    record on the card's machine, so an empty window is measured again, up
    to ``tries`` times, and logged."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and "Activity Buffer" not in e.name)
        if us > 0:
            return us / reps / 1e3
        log(f"time_ms: the profiler saw no device time (try {attempt + 1} "
            f"of {tries})")
    raise AssertionError("the profiler saw no device time")


def event_median_ms(fn, reps: int) -> float:
    """Median wall time of one fn() call on the card's clock: CUDA events
    recorded around each call (includes the host's launch path)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def check_blur(img: torch.Tensor) -> dict:
    sigma = math.sqrt(1.6 ** 2 - 0.5 ** 2)       # the initial pyramid blur
    taps = gauss_kernel_1d(sigma)
    got = cuda_blur.blur_cuda(img, taps)
    ref = cuda_blur.blur_plain(img, taps)
    err = float((got - ref).abs().max())
    # atol 1e-5 on [0, 1] data, scaled to this image's range.
    require(err <= 1e-5 * float(ref.abs().max()), f"blur: max err {err}")
    k = len(taps)
    pad = k // 2
    conv = torch.nn.Conv2d(1, 1, k, padding=pad, padding_mode="replicate",
                           bias=False).to(img.device)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.outer(taps, taps))[None, None])
    x4 = img[None, None]
    t_bytes, by = bound_ms(2 * img.numel() * 4, 4 * k * img.numel())
    return dict(
        name="blur", err=err, shape=tuple(img.shape),
        ms=time_ms(lambda: cuda_blur.blur_cuda(img, taps), 20),
        event_ms=event_median_ms(lambda: cuda_blur.blur_cuda(img, taps), 20),
        plain_ms=time_ms(lambda: cuda_blur.blur_plain(img, taps), 5),
        library_ms=time_ms(lambda: conv(x4), 5),
        bound_ms=t_bytes, bound_by=by)


def check_detect(levels: torch.Tensor, sigmas) -> dict:
    got = cuda_detect.detect_octave_cuda(levels, sigmas, 0.0)
    ref = cuda_detect.detect_octave_plain(levels, sigmas, 0.0)
    require(torch.equal(got[:, 0] > 0, ref[:, 0] > 0),
            "detect: NMS survivor sets differ")
    err_maps = float((got[:, 1:] - ref[:, 1:]).abs().max())
    err_resp = float((got[:, 0] - ref[:, 0]).abs().max())
    require(err_maps <= 1e-5, f"detect: sigma/y/x max err {err_maps}")
    require(err_resp <= 1e-5 * float(ref[:, 0].abs().max()),
            f"detect: response max err {err_resp}")
    n_px = levels.shape[1] * levels.shape[2]
    n_lv = levels.shape[0]
    # per pixel: 14 flops per level response; per center level 27 maxes,
    # 3 NMS flops and ~140 soft-argmax flops.
    flops = n_px * (14 * n_lv + (n_lv - 2) * 170)
    t_bytes, by = bound_ms(n_px * 4 * (n_lv + 4 * (n_lv - 2)), flops)
    return dict(
        name="detect", err=max(err_maps, err_resp),
        shape=tuple(levels.shape),
        ms=time_ms(lambda: cuda_detect.detect_octave_cuda(levels, sigmas,
                                                          0.0), 20),
        event_ms=event_median_ms(lambda: cuda_detect.detect_octave_cuda(
            levels, sigmas, 0.0), 20),
        plain_ms=time_ms(lambda: cuda_detect.detect_octave_plain(
            levels, sigmas, 0.0), 5),
        library_ms=None, bound_ms=t_bytes, bound_by=by)


def check_topk(resp_all: torch.Tensor, seed: int) -> dict:
    n = resp_all.numel()
    b = -(-n // ROW_S)
    x2d = F.pad(resp_all, (0, b * ROW_S - n), value=-1.0).reshape(b, ROW_S)
    x2d = x2d.clone()
    # Planted ties: equal values inside rows and the same value across rows.
    g = torch.Generator(device="cpu").manual_seed(seed)
    rows = torch.randint(0, b, (64,), generator=g).to(x2d.device)
    top = float(x2d.max()) + 1.0
    x2d[rows, 7] = top
    x2d[rows, 900] = top
    x2d[rows[:8], :40] = 0.5 * top
    got = cuda_topk.row_topm_cuda(x2d, M_CAND)
    ref = cuda_topk.row_topm_plain(x2d, M_CAND)
    for a, r, what in zip(got, ref, ("vals", "cols", "leftover")):
        require(torch.equal(a, r), f"row_topm: {what} not bit-identical")
    err = float((got[0] - ref[0]).abs().max())
    # read once, write (vals, cols) + leftover; ~2 ops per value per round.
    t_bytes, by = bound_ms(x2d.numel() * 4 + b * (8 * M_CAND + 4),
                           2 * (M_CAND + 1) * x2d.numel())
    return dict(
        name="topk", err=err, shape=tuple(x2d.shape),
        ms=time_ms(lambda: cuda_topk.row_topm_cuda(x2d, M_CAND), 20),
        event_ms=event_median_ms(lambda: cuda_topk.row_topm_cuda(x2d, M_CAND),
                                 20),
        plain_ms=time_ms(lambda: cuda_topk.row_topm_plain(x2d, M_CAND), 5),
        library_ms=time_ms(lambda: torch.topk(x2d, M_CAND, dim=1), 20),
        bound_ms=t_bytes, bound_by=by)


def _sample_positions(lafs, level, offs, hs, ws, ps, align):
    """Level-local sample coordinates (u, v) of every sample (the sampler's
    coordinate math) and each patch's level row offset, height and width,
    shaped (N, 1, 1)."""
    lin = torch.from_numpy(base_lin(ps, align)).to(lafs.device)
    gx, gy = lin[None, :].expand(ps, ps), lin[:, None].expand(ps, ps)
    lv = level.long()
    h = hs[lv].float()[:, None, None]
    w = ws[lv].float()[:, None, None]
    m = torch.minimum(h, w)
    A = lafs[:, None, None]
    u = m * (A[..., 0, 0] * gx + A[..., 0, 1] * gy) + w * A[..., 0, 2]
    v = m * (A[..., 1, 0] * gx + A[..., 1, 1] * gy) + h * A[..., 1, 2]
    if align:
        u, v = u * (w - 1.0) / w, v * (h - 1.0) / h
    else:
        u, v = u - 0.5, v - 0.5
    return u, v, offs[lv].long()[:, None, None], h, w


def _n_touched(buf, u, v, row0, h, w) -> int:
    """Buffer elements this run's samples need: their in-level corners."""
    touched = []
    for dy in (0, 1):
        for dx in (0, 1):
            xc, yc = torch.floor(u) + dx, torch.floor(v) + dy
            ok = (xc >= 0) & (xc <= w - 1) & (yc >= 0) & (yc <= h - 1)
            flat = (row0 + yc.long()) * buf.shape[1] + xc.long()
            touched.append(flat[ok])
    return int(torch.unique(torch.cat(touched)).numel())


def check_patches(site: str, buf, lafs, level, tables, ps=32,
                  align=False) -> dict:
    offs, hs, ws = tables
    got = cuda_patches.extract_patches_cuda(buf, lafs, level, offs, hs, ws,
                                            ps=ps, align_corners=align)
    ref, _ = cuda_patches.extract_patches_pyramid(
        buf, lafs, level, offs, hs, ws, ps=ps, align_corners=align,
        use_kernel=False)
    err = float((got - ref).abs().max())
    require(bool(torch.all((got - ref).abs() <= 5e-3 + 5e-5 * ref.abs())),
            f"patches ({site}): max err {err}")
    u, v, row0, h, w = _sample_positions(lafs, level, offs, hs, ws, ps,
                                         align)
    n_touched = _n_touched(buf, u, v, row0, h, w)
    n = lafs.shape[0]
    t_bytes, by = bound_ms(n_touched * 4 + n * (24 + 4) + n * ps * ps * 4,
                           30 * n * ps * ps)
    # Yardstick: F.grid_sample over the whole buffer at the same sample
    # positions (zero padding at the buffer's edges, not the level's).
    gxn = (2.0 * u + 1.0) / buf.shape[1] - 1.0
    gyn = (2.0 * (v + row0) + 1.0) / buf.shape[0] - 1.0
    grid = torch.stack([gxn, gyn], -1).reshape(1, n * ps, ps, 2)
    b4 = buf[None, None]
    return dict(
        name=f"patches_{site}", err=err, shape=(n, ps, ps),
        ms=time_ms(lambda: cuda_patches.extract_patches_cuda(
            buf, lafs, level, offs, hs, ws, ps=ps, align_corners=align), 20),
        event_ms=event_median_ms(lambda: cuda_patches.extract_patches_cuda(
            buf, lafs, level, offs, hs, ws, ps=ps, align_corners=align), 20),
        plain_ms=time_ms(lambda: cuda_patches.extract_patches_pyramid(
            buf, lafs, level, offs, hs, ws, ps=ps, align_corners=align,
            use_kernel=False), 5),
        library_ms=time_ms(lambda: F.grid_sample(
            b4, grid, mode="bilinear", padding_mode="zeros",
            align_corners=False), 20),
        bound_ms=t_bytes, bound_by=by)


def phase_kernels(det, img: torch.Tensor, seed: int) -> dict:
    """Main-path inputs from one image through the extractor's stages, then
    each kernel against its plain version at those shapes."""
    res = {}
    res["blur"] = check_blur(img)
    p = det._plan(H, W)
    res["detect"] = check_detect(build_pyramid(img, p.plan)[0],
                                 p.plan.sigmas[0])
    res["topk"] = check_topk(det._responses(img, p)[1], seed)
    cand = det._multiscale_detect(img, p)
    cand["lafs"] = torch.cat([CONFIG.mr_size * cand["lafs"][:, :, 0:2],
                              cand["lafs"][:, :, 2:]], dim=2)
    res["patches_shape"] = check_patches(
        "shape", cand["flat"], cand["lafs"].contiguous(),
        cand["ext_level"].to(torch.int32), p.tables)
    cand = det._sort_for_describe(det._affine_shape(cand, p), p, H, W)
    res["patches_desc"] = check_patches(
        "desc", cand["flat"], cand["lafs"].contiguous(),
        cand["desc_level"].to(torch.int32), p.tables)
    return res


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------

def check_outputs(out: dict, i: int) -> None:
    n = len(out["resp"])
    require(n == NFEATS, f"image {i}: {n} valid keypoints, expected {NFEATS}")
    d = out["descs"]
    require(d.shape == (NFEATS, 128) and np.isfinite(d).all(),
            f"image {i}: descriptors not finite / wrong shape {d.shape}")
    norms = np.linalg.norm(d, axis=1)
    require(np.abs(norms - 1.0).max() < 1e-3, f"image {i}: norms {norms}")
    require(np.isfinite(out["lafs"]).all(), f"image {i}: LAFs not finite")


def check_golden(device) -> None:
    """The committed reference goldens (the original torch code's outputs
    on a 120x160 crop) through the kernels on the card, at the JAX package's
    test tolerances (tests/test_detector.py)."""
    g = np.load(os.path.join(FIXTURES, "detector_golden.npz"))
    kw = dict(num_features=50, border=5, mr_size=5.192)
    det = ScaleSpaceAffinePatchExtractor(
        DetectorConfig(num_baum_iters=0, **kw), device=device)
    out = det(g["img"])
    require(len(out["resp"]) == 50, "golden: detection count")
    np.testing.assert_allclose(out["resp"], g["det_resp"], atol=0.1,
                               rtol=1e-4)
    np.testing.assert_allclose(out["lafs"], g["det_lafs"], atol=1e-2)
    aff, _ = pretrained_nets()
    det = ScaleSpaceAffinePatchExtractor(
        DetectorConfig(num_baum_iters=1, **kw), shape_net=aff, device=device)
    out = det(g["img"])
    require(len(out["resp"]) == len(g["aff_resp"]), "golden: shape count")
    np.testing.assert_allclose(out["lafs"], g["aff_lafs"], atol=1e-2)


def phase_main(det, det_plain, imgs) -> dict:
    reset_launch_counts()
    t0 = time.perf_counter()
    outs = [det(img, describe=True) for img in imgs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    log(f"main path launches ({len(imgs)} images): {json.dumps(counts)}")
    for name in EXTRACTION_KERNELS:
        require(counts[name] > 0,
                f"kernel {name} was not launched on the main path")
    for i, out in enumerate(outs):
        check_outputs(out, i)
        ref = det_plain(imgs[i], describe=True)
        require(np.array_equal(out["orig_idx"], ref["orig_idx"]),
                f"image {i}: keypoints differ from the plain path on the card")
        for k in ("resp", "lafs", "descs", "patches"):
            err = float(np.abs(out[k] - ref[k]).max())
            require(err <= 1e-3 * max(1.0, float(np.abs(ref[k]).max())),
                    f"image {i}: {k} differs from the plain path by {err}")
        log(f"image {i}: {len(out['resp'])} keypoints, n_detected "
            f"{out['n_detected']}, identical to the plain path")
    return {"counts": counts, "first_pass_s": wall}


# ---------------------------------------------------------------------------
# Phases 5-6: AffNet training (kernel B5 forward and backward)
# ---------------------------------------------------------------------------

# The published AffNet training run (run_me.sh:28-31, README "Training from
# scratch") against the frozen HardTFeatNet; one epoch of the steps that run
# here, the LR decay spanning the published 20 epochs of 10M pairs, a
# metrics line every 10 steps as published.
TRAIN_WARMUP, TRAIN_TIMED = 3, 10
TRAIN_CFG = TrainConfig(arch="AffNetFast", descriptor="TFeat",
                        loss="HardNegC", lr=0.005, wd=1e-4, momentum=0.9,
                        dampening=0.9, batch_size=1024, n_pairs=10_000_000,
                        epochs=1, total_epochs=20, log_interval=10)


def make_train_patches(seed: int):
    """The training patch set: the JAX CLI's single-image setting (2048
    classes x 4 views) on the committed 640x800 graf fixture."""
    img = np.load(os.path.join(FIXTURES, "detector_golden_fullres.npz"))["img"]
    return synthetic_pairs_from_image(img, n_classes=2048, views_per_class=4,
                                      seed=seed)


def _batched_theta(lafs, h, w):
    """affine_grid's theta for the batched sampler's function: grid x =
    2 * (m * (a00 gx + a01 gy) + w tx) / w - 1, and likewise y."""
    m = min(h, w)
    sc = torch.tensor([[2.0 * m / w], [2.0 * m / h]], device=lafs.device)
    return torch.cat([lafs[:, :, :2] * sc, 2.0 * lafs[:, :, 2:] - 1.0], 2)


def _library_sample(imgs, theta, ps):
    grid = F.affine_grid(theta, (imgs.shape[0], 1, ps, ps),
                         align_corners=False)
    return F.grid_sample(imgs[:, None], grid, mode="bilinear",
                         padding_mode="zeros", align_corners=False)[:, 0]


def _batched_bytes(imgs, lafs, ps):
    """Distinct buffer elements the samples of this run touch, and the
    batched tables' sample positions."""
    n, h, w = imgs.shape
    tables = batched_tables(n, h, w, imgs.device)
    u, v, row0, hh, ww = _sample_positions(lafs, tables[0], *tables[1:], ps,
                                           False)
    return _n_touched(imgs.reshape(n * h, w), u, v, row0, hh, ww), tables


def check_batched_fwd(imgs, lafs, ps) -> dict:
    """B5 forward at a training site against the plain version, bit for
    bit (it is B4's kernel)."""
    n, h, w = imgs.shape
    buf = imgs.reshape(n * h, w)
    n_touched, tables = _batched_bytes(imgs, lafs, ps)

    def kernel():
        return cuda_patches.sample_batched_cuda(buf, lafs, tables, ps, False)

    got = kernel()
    ref = extract_patches_batched(imgs, lafs, ps=ps)
    require(torch.equal(got, ref), f"batched fwd ps {ps}: not bit-identical")
    theta = _batched_theta(lafs, h, w)
    lib_err = float((_library_sample(imgs, theta, ps) - ref).abs().max())
    t_bytes, by = bound_ms(n_touched * 4 + n * 24 + n * ps * ps * 4,
                           30 * n * ps * ps)
    return dict(
        name=f"batched_fwd_ps{ps}", err=0.0, shape=(n, ps, ps),
        library_err=lib_err,
        ms=time_ms(kernel, 20), event_ms=event_median_ms(kernel, 20),
        plain_ms=time_ms(lambda: extract_patches_batched(imgs, lafs, ps=ps),
                         5),
        library_ms=time_ms(lambda: _library_sample(imgs, theta, ps), 20),
        bound_ms=t_bytes, bound_by=by)


def check_batched_bwd(full, lafs, seed) -> dict:
    """B5 backward at the training rewarp (PS 32 from the 2048 64x64 warps)
    against autograd of the plain version on random upstream weights g.
    LAF cotangent: rtol 1e-4, atol 1e-4 of its largest magnitude (another
    summation order), and identical from run to run; image cotangent:
    rtol 1e-5, atol 1e-5 (atomicAdd order)."""
    ps = 32
    n, h, w = full.shape
    buf = full.reshape(n * h, w)
    n_touched, tables = _batched_bytes(full, lafs, ps)
    gen = torch.Generator(device=full.device).manual_seed(seed)
    g = 2 * torch.rand((n, ps, ps), generator=gen, device=full.device) - 1

    def kernel(need_buf=False):
        return cuda_patches.sample_bwd_cuda(buf, lafs, tables, g, ps, False,
                                            need_buf, True)

    _, got_l = kernel()
    got_i, got_l2 = kernel(True)
    require(torch.equal(got_l, got_l2),
            "batched bwd: LAF cotangent differs from run to run")
    im = full.clone().requires_grad_(True)
    lf = lafs.clone().requires_grad_(True)
    out = extract_patches_batched(im, lf, ps=ps)
    ref_i, ref_l = torch.autograd.grad(out, (im, lf), g, retain_graph=True)
    scale = float(ref_l.abs().max())
    err = float((got_l - ref_l).abs().max())
    require(bool(torch.all((got_l - ref_l).abs()
                           <= 1e-4 * scale + 1e-4 * ref_l.abs())),
            f"batched bwd: LAF cotangent max err {err} (scale {scale})")
    err_i = float((got_i.reshape(full.shape) - ref_i).abs().max())
    require(bool(torch.all((got_i.reshape(full.shape) - ref_i).abs()
                           <= 1e-5 + 1e-5 * ref_i.abs())),
            f"batched bwd: image cotangent max err {err_i}")
    theta = _batched_theta(lafs, h, w).requires_grad_(True)
    lib_out = _library_sample(full, theta, ps)

    def lib_fwd_bwd():
        th = _batched_theta(lafs, h, w).requires_grad_(True)
        return torch.autograd.grad(_library_sample(full, th, ps), th, g)

    t_bytes, by = bound_ms(n_touched * 4 + n * ps * ps * 4 + 2 * n * 24,
                           40 * n * ps * ps)
    return dict(
        name="batched_bwd", err=err, err_img=err_i, laf_scale=scale,
        shape=(n, ps, ps),
        ms=time_ms(kernel, 20), event_ms=event_median_ms(kernel, 20),
        ms_with_image=time_ms(lambda: kernel(True), 20),
        plain_ms=time_ms(lambda: torch.autograd.grad(
            out, lf, g, retain_graph=True), 5),
        library_ms=time_ms(lambda: torch.autograd.grad(
            lib_out, theta, g, retain_graph=True), 20),
        library_fwd_bwd_ms=time_ms(lib_fwd_bwd, 20),
        bound_ms=t_bytes, bound_by=by)


def phase_train_kernels(batch, seed) -> dict:
    """B5 at the shapes one training step gives it: the 64x64 augment warp
    of 1024 patches (anchors; the positives' launch is the same shape) and
    the PS 32 rewarp of all 2048 by an initialized AffNetFast's shapes,
    forward and backward."""
    n, h, _ = batch[0].shape
    gen = torch.Generator(device=batch[0].device).manual_seed(seed)
    lafs = draw_affnet_lafs(n, tilt_for_epoch(0), gen, True)
    res = {"batched_fwd_ps64": check_batched_fwd(batch[0], lafs[0], h)}
    full = torch.cat([
        cuda_patches.sample_batched_cuda(
            x.reshape(n * h, h), laf, batched_tables(n, h, h, x.device), h,
            False) for x, laf in zip(batch, lafs)])
    net = init_params(AffNetFast(), torch.Generator().manual_seed(seed))
    net = net.to(full.device).train()
    st = (h - 32) // 2
    with torch.no_grad():
        A = net(full[:, st:st + 32, st:st + 32])
    base = torch.tensor([[0.5, 0.0, 0.5], [0.0, 0.5, 0.5]],
                        device=full.device).expand(2 * n, 2, 3)
    lafs32 = torch.cat([(32 / h) * (A @ base[:, :, :2]), base[:, :, 2:]], 2)
    lafs32 = lafs32.contiguous()
    res["batched_fwd_ps32"] = check_batched_fwd(full, lafs32, 32)
    res["batched_bwd"] = check_batched_bwd(full, lafs32, seed)
    return res


def _max_rel(got: dict, ref: dict) -> float:
    """Largest |got - ref| over each tensor's largest |ref|."""
    return max(float((got[k] - ref[k]).abs().max())
               / max(float(ref[k].abs().max()), 1e-30) for k in ref)


def check_plain_step(state, desc_fn, cfg, batch) -> dict:
    """One step from the same state and the same generator through the
    kernels and through the plain sampler on the card.  Loss rtol 1e-5,
    gradients within 1e-3 and parameters after SGD within 1e-5 of each
    tensor's largest magnitude, BatchNorm statistics within 1e-6."""
    model, dev = state.model, batch[0].device
    snap_model = copy.deepcopy(model.state_dict())
    snap_opt = copy.deepcopy(state.optimizer.state_dict())
    step0 = state.step
    runs = []
    for use_kernels in (True, False):
        model.load_state_dict(snap_model)
        state.optimizer.load_state_dict(copy.deepcopy(snap_opt))
        state.step = step0
        step_fn = make_affnet_train_step(desc_fn, cfg, use_kernels)
        reset_launch_counts()
        m = step_fn(state, batch, torch.Generator(device=dev).manual_seed(7),
                    tilt_for_epoch(0))
        sd = {k: v.clone() for k, v in model.state_dict().items()
              if v.is_floating_point()}
        runs.append(dict(
            loss=float(m["loss"]), counts=launch_counts(),
            grads={n: p.grad.clone() for n, p in model.named_parameters()},
            params={k: v for k, v in sd.items() if "running" not in k},
            stats={k: v for k, v in sd.items() if "running" in k}))
    kern, plain = runs
    require(kern["counts"]["batched_fwd"] == 3
            and kern["counts"].get("batched_fwd_ps64") == 2
            and kern["counts"].get("batched_fwd_ps32") == 1
            and kern["counts"]["batched_bwd"] == 1,
            f"plain-step check: kernel launches {kern['counts']}")
    require(plain["counts"]["batched_fwd"] == 0
            and plain["counts"]["batched_bwd"] == 0,
            f"plain-step check: the plain path launched {plain['counts']}")
    res = dict(loss=kern["loss"], loss_plain=plain["loss"],
               grads=_max_rel(kern["grads"], plain["grads"]),
               params=_max_rel(kern["params"], plain["params"]),
               stats=max(float((kern["stats"][k] - plain["stats"][k])
                               .abs().max()) for k in kern["stats"]))
    require(abs(res["loss"] - res["loss_plain"])
            <= 1e-5 * abs(res["loss_plain"]), f"plain-step loss: {res}")
    require(res["grads"] <= 1e-3 and res["params"] <= 1e-5
            and res["stats"] <= 1e-6, f"plain-step check: {res}")
    return res


def check_posdist_descent(desc_fn, cfg, batch, seed) -> list:
    """tests/test_train.py:81-101 at full width: the same batch and the
    same generator each step, PosDist, lr 5e-5: the loss must fall."""
    cfg = dataclasses.replace(cfg, loss="PosDist", lr=5e-5)
    dev = batch[0].device
    net = init_params(AffNetFast(), torch.Generator().manual_seed(seed))
    state = init_state(net.to(dev).train(), cfg)
    step_fn = make_affnet_train_step(desc_fn, cfg)
    got = [float(step_fn(state, batch,
                         torch.Generator(device=dev).manual_seed(42),
                         tilt_for_epoch(0))["loss"]) for _ in range(6)]
    require(bool(np.isfinite(got).all()) and got[-1] < got[0],
            f"PosDist on a fixed batch did not fall: {got}")
    return got


class TimedBatches:
    """``dataset`` whose ``batches()`` times the steps that consume them:
    a CUDA event on the card's stream before each batch is built and after
    the last step (the per-step times), and the host clock over the steps
    from ``warmup`` on, each end after a synchronize (the window)."""

    def __init__(self, dataset, warmup: int):
        self.dataset, self.warmup = dataset, warmup
        self.events, self.window_s = [], None

    def batches(self):
        it = iter(self.dataset.batches())
        t0 = None
        for i in itertools.count():
            if i == self.warmup:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
            batch = next(it, None)
            if batch is None:
                break
            yield batch
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - t0

    def step_ms(self) -> list:
        return [a.elapsed_time(b)
                for a, b in zip(self.events[:-1], self.events[1:])]


def phase_train(patches, labels, cfg, device) -> dict:
    """train_loop on the card at batch 1024: finite losses, 3 B5 forward and
    1 B5 backward launches per step, weights and BatchNorm statistics
    moved and finite; ms per step over the timed window of steps."""
    n_steps = TRAIN_WARMUP + TRAIN_TIMED
    ds = TimedBatches(DevicePairDataset(
        PairDataset(patches, labels, n_pairs=n_steps * cfg.batch_size,
                    batch_size=cfg.batch_size, seed=cfg.seed), device),
        TRAIN_WARMUP)
    desc_params = load_pretrained("HardTFeatNet")
    reset_launch_counts()
    with tempfile.TemporaryDirectory() as log_dir:
        t0 = time.perf_counter()
        state = train_loop(AffNetFast(), ds, cfg, log_dir=log_dir,
                           desc_params=desc_params, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        with open(os.path.join(log_dir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        require(os.path.exists(os.path.join(log_dir, "checkpoint_0.npz")),
                "train_loop wrote no checkpoint")
    log(f"train path launches ({n_steps} steps): {json.dumps(counts)}")
    n_logged = len(range(0, n_steps, cfg.log_interval))
    require(len(recs) == n_logged,
            f"{len(recs)} metrics lines for {n_steps} steps, not {n_logged}")
    losses = [r["loss"] for r in recs]
    require(bool(np.isfinite(losses).all()), f"losses not finite: {losses}")
    require(counts["batched_fwd"] == 3 * n_steps
            and counts.get("batched_fwd_ps64") == 2 * n_steps
            and counts.get("batched_fwd_ps32") == n_steps
            and counts["batched_bwd"] == n_steps,
            f"B5 launches {counts} for {n_steps} steps")
    # The unlogged steps' losses: a non-finite loss carries into the
    # gradients, so into every parameter and momentum buffer.
    init = init_params(AffNetFast(), torch.Generator().manual_seed(cfg.seed))
    for name, val in init.state_dict().items():
        if val.is_floating_point():
            got = state.model.state_dict()[name]
            require(bool(torch.isfinite(got).all()), f"{name} not finite")
            require(not torch.equal(got.cpu(), val), f"{name} did not move")
    step_ms = ds.step_ms()
    require(len(step_ms) == n_steps, f"{len(step_ms)} step times")
    return dict(state=state, counts=counts, losses=losses, wall_s=wall,
                window_ms=ds.window_s * 1e3 / TRAIN_TIMED,
                step_ms=step_ms[TRAIN_WARMUP:])


def run_training(seed, device) -> tuple:
    """Phases 5 (B5 kernels at the training shapes) and 6 (the training
    path); returns (kernel results, train results)."""
    cfg = dataclasses.replace(TRAIN_CFG, seed=seed)
    t = time.perf_counter()
    patches, labels = make_train_patches(seed)
    check = DevicePairDataset(PairDataset(patches, labels,
                                          n_pairs=cfg.batch_size,
                                          batch_size=cfg.batch_size,
                                          seed=seed + 1), device)
    batch = next(iter(check.batches()))
    res = phase_train_kernels(batch, seed)
    torch.cuda.synchronize()
    for r in res.values():
        log(f"kernel {r['name']} {r['shape']}: max_abs_err {r['err']:.3g} "
            f"ms {r['ms']:.4f} event_median_ms {r['event_ms']:.4f} "
            f"plain_ms {r['plain_ms']:.4f} library_ms {r['library_ms']:.4f} "
            f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']})")
    b = res["batched_bwd"]
    log(f"batched_bwd: LAF cotangent largest |value| {b['laf_scale']:.4g}; "
        f"with the image cotangent ms {b['ms_with_image']:.4f} "
        f"(image max_abs_err {b['err_img']:.3g}); library forward+backward "
        f"ms {b['library_fwd_bwd_ms']:.4f}; library forward max |diff| "
        f"{res['batched_fwd_ps64']['library_err']:.3g} (ps 64), "
        f"{res['batched_fwd_ps32']['library_err']:.3g} (ps 32)")
    log(f"phase train kernels wall_s: {time.perf_counter() - t:.3f}")

    t = time.perf_counter()
    tr = phase_train(patches, labels, cfg, device)
    log(f"train losses: {[round(x, 5) for x in tr['losses']]}")
    desc_fn = make_descriptor("TFeat", load_pretrained("HardTFeatNet"),
                              device)
    ps = check_plain_step(tr["state"], desc_fn, cfg, batch)
    log(f"plain-path step: loss {ps['loss']:.7f} vs {ps['loss_plain']:.7f}; "
        f"max |diff| / max |value|: grads {ps['grads']:.3g}, params "
        f"{ps['params']:.3g}; BN statistics max |diff| {ps['stats']:.3g}")
    pd = check_posdist_descent(desc_fn, cfg, batch, seed)
    log(f"PosDist on a fixed batch, lr 5e-5: {[round(x, 6) for x in pd]}")
    ms = tr["window_ms"]
    log(f"train_ms_per_step: {ms:.3f} (host clock over steps "
        f"{TRAIN_WARMUP}..{TRAIN_WARMUP + TRAIN_TIMED - 1}, synchronized at "
        f"both ends, / {TRAIN_TIMED}); pairs_per_s "
        f"{cfg.batch_size / ms * 1e3:.1f}; batch {cfg.batch_size}; "
        f"per step on the card's stream (CUDA events): median "
        f"{float(np.median(tr['step_ms'])):.3f}, min "
        f"{min(tr['step_ms']):.3f}, max {max(tr['step_ms']):.3f} "
        f"({[round(float(x), 3) for x in tr['step_ms']]})")
    log(f"phase train wall_s: {time.perf_counter() - t:.3f} (train_loop "
        f"{tr['wall_s']:.3f})")
    return res, tr


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--images", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    log(f"device: {name} x{torch.cuda.device_count()}, torch "
        f"{torch.__version__}, cuda {torch.version.cuda}; TF32 off for "
        "cuDNN convolutions and matmuls")

    t = time.perf_counter()
    build.library()
    log(f"build_seconds: {time.perf_counter() - t:.3f}")

    t = time.perf_counter()
    aff, desc = pretrained_nets()
    det = ScaleSpaceAffinePatchExtractor(CONFIG, shape_net=aff,
                                         desc_net=desc, device=device)
    imgs = make_images(args.seed, args.images)
    with torch.inference_mode():
        res = phase_kernels(det, torch.from_numpy(imgs[0]).to(device),
                            args.seed)
    torch.cuda.synchronize()
    for r in res.values():
        log(f"kernel {r['name']} {r['shape']}: max_abs_err {r['err']:.3g} "
            f"ms {r['ms']:.4f} event_median_ms {r['event_ms']:.4f} "
            f"plain_ms {r['plain_ms']:.4f} library_ms {r['library_ms']} "
            f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']})")
    log(f"phase kernels wall_s: {time.perf_counter() - t:.3f}")

    t = time.perf_counter()
    det_plain = ScaleSpaceAffinePatchExtractor(
        CONFIG, shape_net=aff, desc_net=desc, device=device,
        use_kernels=False)
    main_res = phase_main(det, det_plain, imgs)
    check_golden(device)
    log("golden 120x160 reference: detection and shape stage within the "
        "JAX tests' tolerances")
    log(f"phase main wall_s: {time.perf_counter() - t:.3f}")

    t = time.perf_counter()
    per_img, per_img_plain = [], []
    for _ in range(2):
        for img in imgs:
            for d, acc in ((det, per_img), (det_plain, per_img_plain)):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                d(img, describe=True)
                torch.cuda.synchronize()
                acc.append((time.perf_counter() - t1) * 1e3)
    log(f"end_to_end_ms_per_image: median {np.median(per_img):.3f} "
        f"(all {[round(x, 3) for x in per_img]}); plain path median "
        f"{np.median(per_img_plain):.3f}")
    log(f"phase times wall_s: {time.perf_counter() - t:.3f}")

    train_res, tr = run_training(args.seed, device)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    log(smi.splitlines()[0])

    # (result, counter, source, TPU kernel).  B4 at its two extraction
    # sites as before (launches: both sites together); B5 forward at the
    # augment warps (PS 64) and at the rewarp (PS 32), each with its site's
    # launches; B5 backward.  Launches: the extraction main path's counts
    # for B1-B4, the training path's for B5.
    src = {"blur": ("affnet_tpu_torch/csrc/blur.cu",
                    "affnet_tpu/ops/pallas_blur.py:60"),
           "detect": ("affnet_tpu_torch/csrc/detect.cu",
                      "affnet_tpu/ops/pallas_detect.py:84"),
           "topk": ("affnet_tpu_torch/csrc/topk.cu",
                    "affnet_tpu/ops/pallas_topk.py:46"),
           "patches": ("affnet_tpu_torch/csrc/patches.cu",
                       "affnet_tpu/ops/pallas_patches.py:94")}
    rows = [(r, main_res["counts"][key.split("_")[0]],
             *src[key.split("_")[0]]) for key, r in res.items()]
    for ps in (64, 32):
        rows.append((train_res[f"batched_fwd_ps{ps}"],
                     tr["counts"][f"batched_fwd_ps{ps}"],
                     "affnet_tpu_torch/csrc/patches.cu",
                     "affnet_tpu/ops/pallas_patches.py:94 via :665"))
    rows.append((train_res["batched_bwd"], tr["counts"]["batched_bwd"],
                 "affnet_tpu_torch/csrc/patches_bwd.cu",
                 "affnet_tpu/ops/pallas_patches.py:702"))
    kernels = [{
        "name": r["name"], "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"]}
        for r, launches, source, replaces in rows]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
