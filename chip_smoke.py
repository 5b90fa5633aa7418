#!/usr/bin/env python3
"""GPU smoke check of the PyTorch/CUDA port (affnet_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py [--seed 0] [--images 3]

Phases, each timed and each fatal on failure:

  1. build   — compile csrc/*.cu, one nvcc per source started together, and
               link them (affnet_tpu_torch/_build/); B7-bf16's kernels must
               hold tensor-core products (HMMA) and B7's float32 ones FFMA
               and no HMMA in the built SASS (cuobjdump -sass).
  2. kernels — every kernel of the extraction path against its plain PyTorch
               version on the card, at the shapes the 1080p main path gives
               it, and timed beside the plain version, a PyTorch library call
               where one computes the same function, and its bound: B1 at
               the initial blur and at each of the 29 launches of one
               image's pyramid (the level buffer bit-identical to the plain
               writer's; per-launch times and their sum per image, beside
               29 nn.Conv2d), B2's stencil at each of the 7 octaves (its
               responses and dedup counters bit-identical; the bound of the
               old kernel's 12 full maps beside the new one), its dedup and
               its refine at the flagship's top-k indices (bit-identical);
               B3 on the flat response vector (no padded copy) with planted
               ties, bit-identical, beside torch.topk, and the flagship's
               top-k as a whole under the profiler: no pad call, its device
               activities; B4 at the shape and desc sites, bit-identical
               (torch.equal), beside F.grid_sample.
     stage   — the pyramid and detection stage as a whole in float32, fast
               mode and the HesAffNet program's threshold mode: device
               activities and device ms per image of _responses and
               _multiscale_detect, from the profiler (also in the JSON
               line, under "stage").
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
               2048): the forward bit for bit, the backward's LAF
               cotangent equal to the replay of the kernel's order
               (ops/patches.py laf_cotangent_replay) and within rtol/atol
               1e-4 of autograd's; timed beside the plain version,
               F.affine_grid + F.grid_sample and its bound.
  6. train   — AffNet training at the published width through train_loop
               (AffNetFast, batch 1024, HardNegC against the frozen
               HardTFeatNet, SGD lr 0.005, synthetic pairs from the committed
               fixture): finite losses, 3 B5 forward and 1 B5 backward
               launches per step, weights and BatchNorm statistics moved, one
               step equal to the plain path's on the card, PosDist falling
               on a fixed batch; ms per training step and pairs/s.
  7. shape kernels — kernel B6 (the shape optimizer's differentiable
               pyramid sampler: B4's kernel and csrc/patches_bwd.cu on the
               pyramid's level table) on the 640x800 fixture's one-level
               pyramid with the 200 detected LAFs, whose levels differ:
               forward bit-identical to the plain version, the backward's
               LAF cotangent equal to the replay of the kernel's order and
               against autograd of the plain version, only the asked
               cotangents;
               timed beside the plain version, affine_grid + grid_sample and
               its bound.
  8. shape opt — the reference's shape-optimization script through the
               optimize_shapes program's functions: 200 features (border 32,
               mr_size 5.12, no shape iteration) on the 640x800 fixture,
               shear mode with H = I, GT pairs, SIFT, HardNegC, Adam lr 2.0,
               100 steps: loss and shape difference fall, 2 B6 forward and 2
               B6 backward launches per step, ms per Adam step; the first
               step equal to the plain path's on the card; then 10 steps with
               the TFeat descriptor (a CNN's backward on the path).
  9. fast    — the flagship as bench.py runs it: fast=True (bf16 nets and
               kernel B4-bf16 at both patch sites), desc_dtype="float16", on
               the images of phase 3: B4-bf16 bit-identical to its plain
               version at both sites (timed beside it, F.grid_sample on bf16
               and its bound), keypoints identical to the plain fast path on
               the card, the keypoint set against the float32 run (gate flips
               counted), float16 unit-norm descriptors, ms per image.
 10. conv kernels — kernel B7 (one layer of the flat eval layout: only
               its kept outputs, from its real channels) and B7-bf16 against
               the plain version at every call the flat stack makes on the
               flagship's inputs (AffNetFast's six trunk layers on the 3000
               shape-site patches, HardTFeatNet's 7x7 layer on the 2000
               desc-site patches), plus the "none" and "elu" activations on
               random inputs; timed beside the plain version, F.conv2d
               (cuDNN) on the layer's own work and that work's bound;
               B7-bf16's rounding against the float64 sum; nets with a
               5x5 layer and a 7x7 pad-1 layer (outside B7's contract)
               under the flat layout: one B7 launch, the rest stock, the
               features against the plain path.
 11. hesaffnet — the HesAffNet program at its command-line defaults (th=-1
               threshold mode, --do-ori: AffNetFast and OriNetFast32 over
               every NMS survivor) with the flat layout on the images of
               phase 3: B4 at the program's shape and ori sites (about 34k
               patches each) bit-identical to its plain version and timed
               beside F.grid_sample; each of the 12 B7 calls of a pass held
               against the plain version at the program's shapes and timed
               as in phase 10; 12 B7 launches per pass over an
               image, finite ellipses written and read back, keypoints
               against the same program through the plain versions on the
               card (LAFs within the detector tests' tolerance) and against
               the nchw layout (flips counted), ms per image beside nchw's,
               peak device memory; then the program's main in bulk mode
               (--mesh 1, two of the images as .npy files): one file per
               image holding the gated regions of the cap's strongest
               survivors (the cap binds at 1080p), against the
               single-image runs.
 12. flat extraction — the flagship top-k extraction with the flat layout
               in float32 and fast mode: 7 B7 (B7-bf16) launches per image,
               keypoints against the nchw runs counted, ms per image beside
               nchw's.
 13. hesaffbaum — the classical Hessian-Affine program (top-k 2000, 16
               handcrafted Baumberg iterations at PS 19): the reference's
               120x160 golden on the card; B4's generic instance at PS 19
               bit-identical to its plain version at each of the 16
               iterations of one image (per-launch device ms, bound, plain
               and F.grid_sample times); the program's main on the images
               (.npy): 16 B4 and 1 B3 launches per image, keypoints
               identical to the plain path on the card, ms per image.
 14. onepass — the OnePassSIR program (dense AffNet shape fields, the 3x
               boundary gate): the reference's 120x160 golden (dense map
               atol 1e-4, the 50-feature detector); B2's refine at every
               survivor of one image bit-identical to its plain version
               (timed); the program's main on the images in top-k mode
               with SIFT (2000) and in threshold mode (th 28.41,
               OriNetFast32): launches per image (refine 2 and B3 1 in
               top-k mode, refine 1 and no B3 in threshold mode, B4 1),
               keypoints identical to the plain path on the card, survivor
               counts, ms per image; the dense net's share of the
               extraction's device time.
 15. apps  — the inference programs on the images of phase 3: B4 at the
               external-keypoint site (the image itself as a one-level
               buffer; 8000 seeded keypoints of 2-30 px, a quarter near a
               border) at each of process_keypoints' three stages
               (AffNetFast, OriNetFast32, HardTFeatNet) bit-identical to
               its plain version, timed beside it, F.grid_sample and its
               bound; the outputs against the plain path on the card
               (tolerance 1e-5); describe_keypoints on each image with the
               counts from 0: 3 B4 launches per call and nothing else, ms
               per call; the describe_keypoints program's main on a .npy
               image; eval_graf's evaluate_pair (3000 features, AffNetFast,
               SIFT) and match_demo's match_images (2000) on an image and
               its seeded homography warp: B1-B4 launched, tentatives, true
               matches, inlier ratio, ms per pair, snn_match on the card
               against the CPU; profile_pipeline's main (--runs 3 --trace):
               the three stage lines, a trace naming B1-B4; the export
               round trip of AffNetFast and HardTFeatNet on the card at
               batches 3000 and 517 (within 1e-6 of the module).
 16. trainers — the published pipeline (run_me.sh:22-31) through the
               training programs' main on a PhotoTour-format --dataroot
               (an npz and a reference-format .pt cache of 2048 synthetic
               classes x 4 views from the fixture), batch 1024, 13 steps
               each: HardNet from scratch (train_descriptor, lr 0.1: no B5
               launch), AffNet against its checkpoint (train_affnet,
               HardNegC: 2 + 1 B5 forwards and 1 backward per step),
               OriNet at its defaults against it (train_orinet: 1 + 1 and
               1), the triplet trainer (train_affnet --loss
               random_sampling, TripletDataset: 3 + 1 and 1): finite
               losses, weights and statistics moved, the checkpoint read
               back into the net, ms per step and pairs/s; B5 at the new
               sites (the OriNet warp at PS 64 and its rewarp of 2N, the
               negatives' warp and the rewarp of 3N) bit-identical to its
               plain version, the rewarps' LAF cotangent equal to its
               replay, timed beside the plain version, affine_grid +
               grid_sample and its bound; one OriNet and one triplet step
               against the plain path on the card; train_loop's eval hook
               running evaluate_pair with the epoch's net (B1-B4 launch).
 17. parallel — data parallelism (affnet_tpu_torch/parallel.py): the
               AffNet step at batch 1024 on two gloo ranks sharing the
               card (spawned processes; a card per rank under NCCL as well
               where two or more cards are present) against one process:
               one step within the stated tolerances, three steps' losses,
               equal ranks, B5's launches per rank; B5 at a rank's shapes
               (512 anchors, the rewarp of 1024) against its plain
               version; train_descriptor, train_affnet and train_orinet
               through main --mesh 1 (a group of one under NCCL), 13 steps
               each, ms per step beside phase 16's; the HesAffNet program
               with --mesh 2 on three 1080p images: files equal to --mesh
               1's, B1-B4 launched as often.
 18. hpatches — the HPatches tasks (verification, matching, retrieval) on
               four in-memory sequences of 512 patches with HardTFeatNet
               and SIFT on the card: the 65 -> 32 resize and the
               descriptors against the CPU path (within 1e-5 on the same
               resized patches), the tasks' metrics against the CPU's, ms
               per patch.  No kernel of the port runs there (cuDNN nets,
               plain SIFT), as in JAX.

Kernel times ("ms") are device times from torch.profiler (CUPTI): the
card's busy time per call, without the host's launch overhead.  The log
also prints each kernel's median per-call time between CUDA events, which
includes that overhead.

Phases 1-9 run the nets' nchw layout; phases 10-12 set the flat layout
per call (models/cnn.py eval_layout), so AFFNET_EVAL_CONV need not be
set.  The package's entry points (the extractor, the training step, the
shape optimizer) run with TF32 off for cuDNN convolutions and matmuls
(affnet_tpu_torch.utils.float32_math), so the nets compute in float32 like
the JAX reference.  Imports torch, numpy and the standard library only.
The last line of stdout is {"ok": true, "device": {...}}; the line before
it the per-kernel JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import functools
import io
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from affnet_tpu_torch import (export, hpatches, keypoints, load_pretrained,
                              match, parallel)
from affnet_tpu_torch.cli import (describe_keypoints, eval_graf, extract_geom,
                                  hesaffbaum, hesaffnet, match_demo,
                                  optimize_shapes, pretrained,
                                  profile_pipeline, train_affnet,
                                  train_descriptor, train_orinet)
from affnet_tpu_torch.data import (DevicePairDataset, PairDataset,
                                   TripletDataset, synthetic_pairs_from_image,
                                   synthetic_pairs_from_images)
from affnet_tpu_torch.detector import (DetectorConfig,
                                       ScaleSpaceAffinePatchExtractor)
from affnet_tpu_torch.kernels import build
from affnet_tpu_torch.models import (AffNetFast, HardNet, HardTFeatNet,
                                     OriNetFast32, SIFTNet, params_from_jax,
                                     params_to_jax)
from affnet_tpu_torch.io_formats import read_ells, write_ells
from affnet_tpu_torch.models import cnn
from affnet_tpu_torch.models.cnn import init_params
from affnet_tpu_torch.laf import lafs_to_ells
from affnet_tpu_torch.models.dense import AffNetFastFullConv, local_norm_2d
from affnet_tpu_torch.models.zoo import PatchNet
from affnet_tpu_torch.ops import (EXTRACTION_KERNELS, FAST_EXTRACTION_KERNELS,
                                  cuda_blur, cuda_conv, cuda_detect,
                                  cuda_patches, cuda_topk, launch_counts,
                                  reset_launch_counts)
from affnet_tpu_torch.ops.conv_flat import conv_layer_plain, out_extent
from affnet_tpu_torch.ops.nms import M_CAND, ROW_S, masked_topk
from affnet_tpu_torch.ops.patches import (base_lin, batched_tables,
                                          extract_patches_batched,
                                          extract_patches_from_flat_pyramid,
                                          laf_cotangent_replay)
from affnet_tpu_torch.onepass import OnePassSIR
from affnet_tpu_torch.ops.scalespace import (build_flat_pyramid,
                                             gauss_kernel_1d, pyramid_steps,
                                             pyramid_views)
from affnet_tpu_torch.shape_opt import LAFShapeOptimizer
from affnet_tpu_torch.train import (TrainConfig, draw_affnet_lafs,
                                    draw_orinet, init_state, load_checkpoint,
                                    make_affnet_train_step, make_descriptor,
                                    make_orinet_train_step, orinet_lafs,
                                    tilt_for_epoch, train_loop)
from affnet_tpu_torch.utils import float32_math
from scripts.profile_detect_stage import stage_profile

H, W = 1080, 1920
NFEATS = 2000
ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")

# H100 SXM published peaks (NVIDIA data sheet): HBM rate and float32 rate
# outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

# bench.py's flagship configuration in float32 top-k mode, and as bench.py
# runs it (bench.py:65-67): fast mode, float16 descriptors.
CONFIG = DetectorConfig(num_features=NFEATS, border=5, mr_size=5.192,
                        num_baum_iters=1, patch_size=32)
FAST_CONFIG = dataclasses.replace(CONFIG, fast=True, desc_dtype="float16")


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
    return (pretrained(AffNetFast(), "AffNetFast"),
            pretrained(HardTFeatNet(), "HardTFeatNet"))


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
    require(torch.equal(got, ref), f"blur: not bit-identical, max err {err}")
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


def kernel_times(fn, name: str, n: int, reps: int = 10,
                 tries: int = 3) -> list:
    """Device ms of each of the ``n`` launches of kernel ``name`` that one
    ``fn()`` call makes, in launch order: their CUPTI intervals over
    ``reps`` warmed calls, averaged position by position.  Each window
    opens with a small kernel of another name and a synchronize: on the
    card's machine the profiler has missed the first launch of a window
    that began with the timed kernel itself (159 of 160 seen).  A window
    without exactly ``n x reps`` records is measured again, up to
    ``tries`` times, and logged."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.ones(1, device="cuda").mul_(2.0)
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA
                       and name in e.name)
        if len(spans) == n * reps:
            us = np.array([b - a for a, b in spans], np.float64)
            return [float(x) for x in us.reshape(reps, n).mean(axis=0) / 1e3]
        log(f"kernel_times: {name}: {len(spans)} launches under the "
            f"profiler, expected {n} x {reps} (try {attempt + 1} of "
            f"{tries})")
    raise AssertionError(f"{name}: the profiler did not see {n} x {reps} "
                         "launches")


def check_blur_image(img: torch.Tensor, plan) -> dict:
    """Every B1 launch of one image's pyramid (the initial blur, then each
    level from the one before, writing the level buffer, its padding and
    the next octave's first level): the buffer bit-identical to the plain
    writer's, so each launch equals its plain version on the same input;
    per-launch device ms beside its bound, and the sums per image."""
    steps = pyramid_steps(plan)
    _, buf = build_flat_pyramid(img, plan)
    pyr_ref, ref = build_flat_pyramid(img, plan, use_kernel=False)
    require(torch.equal(buf, ref), "blur: the pyramid buffer differs from "
            "the plain writer's")
    wmax = buf.shape[1]
    per = kernel_times(lambda: build_flat_pyramid(img, plan), "blur_",
                       len(steps))
    bounds, convs, inputs = [], [], []
    for st, ms in zip(steps, per):
        h, w = plan.octave_shapes[st.dst[0]]
        n = len(st.taps)
        written = h * wmax + (st.down is not None) * ((h + 1) // 2) * (
            (w + 1) // 2) + st.zero_src_pad * h * (wmax - w)
        t, by = bound_ms(4 * (h * w + written), 4 * n * h * w)
        bounds.append((t, by))
        src = img if st.src is None else pyr_ref[st.src[0]][st.src[1]]
        inputs.append(src.contiguous()[None, None])
        conv = torch.nn.Conv2d(1, 1, n, padding=n // 2, bias=False,
                               padding_mode="replicate").to(img.device)
        with torch.no_grad():
            conv.weight.copy_(torch.from_numpy(
                np.outer(st.taps, st.taps))[None, None])
        convs.append(conv)
        log(f"  blur launch {st.src}->{st.dst} {h}x{w} {n} taps"
            f"{' +down' if st.down else ''}: ms {ms:.4f} bound_ms {t:.5f} "
            f"({by})")

    def library():
        for conv, x in zip(convs, inputs):
            conv(x)

    t_bound = sum(t for t, _ in bounds)
    by = "bytes" if all(b == "bytes" for _, b in bounds) else "operations"
    return dict(
        name="blur_image", err=0.0, shape=(len(steps),), ms=sum(per),
        event_ms=event_median_ms(lambda: build_flat_pyramid(img, plan), 10),
        plain_ms=time_ms(lambda: build_flat_pyramid(img, plan,
                                                    use_kernel=False), 3),
        library_ms=time_ms(library, 3), bound_ms=t_bound, bound_by=by,
        per_launch=per)


def check_detect(det, img: torch.Tensor) -> dict:
    """B2's stencil at every octave of one image (into the response vector,
    the counters zeroed once), its dedup and its refine at the flagship's
    top-k indices: each bit-identical to its plain version; the stencil's
    device ms per octave and per image beside its bound, and beside the
    bound of the old kernel's full maps (12 an octave)."""
    p = det._plan(H, W)
    plan = p.plan
    th, border = det.cfg.effective_th, int(det.cfg.mr_size)
    L = plan.levels_per_octave
    pyr, buf = build_flat_pyramid(img, plan)
    resp = torch.empty(p.total, device=img.device)
    counters = torch.zeros((plan.n_octaves, cuda_detect.n_counters(L)),
                           dtype=torch.int32, device=img.device)

    def view(r, o):
        off, hw = p.octaves[o]
        h, w = plan.octave_shapes[o]
        return r[off:off + (L - 2) * hw].view(L - 2, h, w)

    def stencils():
        counters.zero_()
        for o in range(plan.n_octaves):
            cuda_detect.stencil_cuda(pyr[o], plan.sigmas[o], th, border,
                                     view(resp, o), counters[o])

    stencils()
    ref = torch.empty_like(resp)
    ref_cnt = torch.empty_like(counters)
    for o in range(plan.n_octaves):
        r, c = cuda_detect.stencil_plain(pyr[o], plan.sigmas[o], th, border)
        view(ref, o).copy_(r)
        ref_cnt[o] = c
    require(torch.equal(resp, ref) and torch.equal(counters, ref_cnt),
            "detect: stencil responses or counters not bit-identical")
    per = kernel_times(stencils, "detect_stencil", plan.n_octaves)
    res = {}
    bounds, old_bounds = [], []
    for o, ms in enumerate(per):
        h, w = plan.octave_shapes[o]
        n_px = h * w
        # per pixel: 14 flops per level response; per center level 27
        # maxes and 3 NMS flops.
        flops = n_px * (14 * L + 30 * (L - 2))
        bounds.append(bound_ms(4 * n_px * (2 * L - 2), flops))
        # The old kernel: 4 maps a center level, ~140 soft-argmax flops.
        old_bounds.append(bound_ms(4 * n_px * (L + 4 * (L - 2)),
                                   flops + n_px * (L - 2) * 140)[0])
        log(f"  detect stencil octave {o} {L}x{h}x{w}: ms {ms:.4f} bound_ms "
            f"{bounds[-1][0]:.5f} ({bounds[-1][1]}); old full-map bound "
            f"{old_bounds[-1]:.5f}")
    lv0 = pyr[0]
    res["detect"] = dict(
        name="detect", err=0.0, shape=tuple(lv0.shape), ms=per[0],
        event_ms=event_median_ms(lambda: cuda_detect.stencil_cuda(
            lv0, plan.sigmas[0], th, border, view(resp, 0), counters[0]), 20),
        plain_ms=time_ms(lambda: cuda_detect.stencil_plain(
            lv0, plan.sigmas[0], th, border), 5),
        library_ms=None, bound_ms=bounds[0][0], bound_by=bounds[0][1],
        old_bound_ms=old_bounds[0])
    res["detect_image"] = dict(
        name="detect_image", err=0.0, shape=(plan.n_octaves,), ms=sum(per),
        event_ms=event_median_ms(stencils, 10),
        plain_ms=time_ms(lambda: [cuda_detect.stencil_plain(
            pyr[o], plan.sigmas[o], th, border)
            for o in range(plan.n_octaves)], 3),
        library_ms=None, bound_ms=sum(b for b, _ in bounds),
        bound_by="bytes" if all(b == "bytes" for _, b in bounds)
        else "operations", old_bound_ms=sum(old_bounds), per_launch=per)

    before = resp.clone()
    got = resp.clone()
    cuda_detect.dedup_cuda(got, counters, p.octaves)
    cuda_detect.dedup_plain(ref, counters, p.octaves)
    require(torch.equal(got, ref), "dedup: not bit-identical")
    changed = int((got != before).sum())
    t, by = bound_ms(4 * (resp.numel() + changed + counters.numel()),
                     4 * resp.numel())
    res["dedup"] = dict(
        name="dedup", err=0.0, shape=(resp.numel(),),
        ms=time_ms(lambda: cuda_detect.dedup_cuda(got, counters, p.octaves),
                   20),
        event_ms=event_median_ms(lambda: cuda_detect.dedup_cuda(
            got, counters, p.octaves), 20),
        plain_ms=time_ms(lambda: cuda_detect.dedup_plain(
            got.clone(), counters, p.octaves), 5),
        library_ms=None, bound_ms=t, bound_by=by, changed=changed)

    idxs = det._multiscale_detect(img, p)["orig_idx"]
    res["refine"] = check_refine("refine", buf, idxs, p.refine_tables, th)
    return res


def check_refine(name: str, buf, idxs, tables, th: float) -> dict:
    """B2's refine at ``idxs`` bit-identical to its plain version; timed
    beside it and its bound (the buffer elements these points read: 5x5
    at three levels each)."""
    syx = cuda_detect.refine_cuda(buf, idxs, tables, th)
    syx_ref = cuda_detect.refine_plain(buf, idxs, tables, th)
    require(torch.equal(syx, syx_ref), f"{name}: not bit-identical")
    d = torch.searchsorted(tables.det_offsets, idxs, right=True) - 1
    lf = tables.ext_levels[d]
    hh, ww = tables.heights[lf].long(), tables.widths[lf].long()
    pix = idxs - tables.det_offsets[d]
    y, x = pix // ww, pix % ww
    off = torch.arange(-2, 3, device=buf.device)
    touched = []
    for k in range(3):
        rows = (tables.row_offsets[lf + k].long()[:, None]
                + torch.minimum((y[:, None] + off).clamp(min=0),
                                hh[:, None] - 1))
        cols = torch.minimum((x[:, None] + off).clamp(min=0), ww[:, None] - 1)
        touched.append((rows[:, :, None] * buf.shape[1]
                        + cols[:, None, :]).reshape(-1))
    n_touched = int(torch.unique(torch.cat(touched)).numel())
    t, by = bound_ms(4 * n_touched + idxs.numel() * (8 + 12),
                     idxs.numel() * (27 * 14 + 80))
    return dict(
        name=name, err=0.0, shape=(idxs.numel(), 3),
        ms=time_ms(lambda: cuda_detect.refine_cuda(buf, idxs, tables, th),
                   20),
        event_ms=event_median_ms(lambda: cuda_detect.refine_cuda(
            buf, idxs, tables, th), 20),
        plain_ms=time_ms(lambda: cuda_detect.refine_plain(
            buf, idxs, tables, th), 5),
        library_ms=None, bound_ms=t, bound_by=by)


def topk_pads(resp_all: torch.Tensor, k: int) -> dict:
    """The flagship's top-k (``masked_topk`` on the flat response vector,
    as ``_multiscale_detect`` calls it) under the profiler: the ATen pad
    calls it makes (B3 reads the flat vector, so none), its device
    activities and their device ms per call."""
    fn = functools.partial(masked_topk, resp_all, k)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    pads = sum(e.name in ("aten::pad", "aten::constant_pad_nd")
               for e in prof.events())
    return dict(pads=pads, **stage_profile(fn, reps=5))


def check_topk(det, img: torch.Tensor, seed: int) -> dict:
    """B3 on the flagship's flat response vector, read as rows of 1024
    with -1 past its end (no padded copy), with planted ties (equal values
    inside rows and the same value across rows): bit-identical to the plain
    version; timed beside it and beside torch.topk on the padded matrix.
    Then the flagship's top-k as a whole: no pad call (topk_pads)."""
    p = det._plan(H, W)
    resp_all = det._responses(img, p)[1]
    n = resp_all.numel()
    b = -(-n // ROW_S)
    x = resp_all.clone()
    g = torch.Generator(device="cpu").manual_seed(seed)
    rows = torch.randint(0, b - 1, (64,), generator=g).to(x.device)
    top = float(x.max()) + 1.0
    x[rows * ROW_S + 7] = top
    x[rows * ROW_S + 900] = top
    run = torch.arange(40, device=x.device)
    x[(rows[:8, None] * ROW_S + run).reshape(-1)] = 0.5 * top
    got = cuda_topk.row_topm_flat_cuda(x, M_CAND)
    ref = cuda_topk.row_topm_flat_plain(x, M_CAND)
    for a, r, what in zip(got, ref, ("vals", "cols", "leftover")):
        require(torch.equal(a, r), f"row_topm: {what} not bit-identical")
    err = float((got[0] - ref[0]).abs().max())
    x2d = F.pad(x, (0, b * ROW_S - n), value=-1.0).reshape(b, ROW_S)
    # Read once, write (vals, cols) + leftover; operations: the plain
    # version's m + 1 passes of ~2 per value (bytes bound it either way).
    t_bytes, by = bound_ms(n * 4 + b * (8 * M_CAND + 4),
                           2 * (M_CAND + 1) * n)
    pads = topk_pads(resp_all, min(det.cfg.prefilter_count(), p.total))
    require(pads["pads"] == 0, f"the flagship's top-k made {pads['pads']} "
            "pad calls")
    return dict(
        name="topk", err=err, shape=(n,),
        ms=time_ms(lambda: cuda_topk.row_topm_flat_cuda(x, M_CAND), 20),
        event_ms=event_median_ms(
            lambda: cuda_topk.row_topm_flat_cuda(x, M_CAND), 20),
        plain_ms=time_ms(lambda: cuda_topk.row_topm_flat_plain(x, M_CAND),
                         5),
        library_ms=time_ms(lambda: torch.topk(x2d, M_CAND, dim=1), 20),
        bound_ms=t_bytes, bound_by=by, topk_pads=pads["pads"],
        topk_activities=pads["launches"], topk_device_ms=pads["device_ms"])


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


def patch_work(buf, lafs, level, tables, ps, align=False):
    """The bound of B4's work at one site (its bytes: the in-level corners
    the samples need, the LAFs and levels, the patches; its operations: 30
    a sample) and the F.grid_sample grid of the same sample positions over
    the whole buffer (zero padding at the buffer's edges, not the
    level's): (bound ms, bound_by, grid)."""
    u, v, row0, h, w = _sample_positions(lafs, level, *tables, ps, align)
    n_touched = _n_touched(buf, u, v, row0, h, w)
    n = lafs.shape[0]
    t_bytes, by = bound_ms(n_touched * 4 + n * (24 + 4) + n * ps * ps * 4,
                           30 * n * ps * ps)
    gxn = (2.0 * u + 1.0) / buf.shape[1] - 1.0
    gyn = (2.0 * (v + row0) + 1.0) / buf.shape[0] - 1.0
    return t_bytes, by, torch.stack([gxn, gyn], -1).reshape(1, n * ps, ps, 2)


def check_patches(site: str, buf, lafs, level, tables, ps=32,
                  align=False, bf16=False) -> dict:
    """B4 (B4-bf16 with ``bf16``) at one patch site of finite LAFs: equal
    to its plain version bit for bit (torch.equal); timed beside it,
    F.grid_sample and its bound."""
    offs, hs, ws = tables

    def kernel():
        return cuda_patches.extract_patches_cuda(
            buf, lafs, level, offs, hs, ws, ps=ps, align_corners=align,
            bf16=bf16)

    def plain():
        return cuda_patches.extract_patches_pyramid(
            buf, lafs, level, offs, hs, ws, ps=ps, align_corners=align,
            use_kernel=False, bf16=bf16)[0]

    require(bool(torch.isfinite(lafs).all()), f"patches ({site}): LAFs "
            "not finite")
    got, ref = kernel(), plain()
    err = float((got - ref).abs().max())
    require(torch.equal(got, ref), f"patches{' bf16' if bf16 else ''} "
            f"({site}): not bit-identical, max err {err}")
    n = lafs.shape[0]
    t_bytes, by, grid = patch_work(buf, lafs, level, tables, ps, align)
    b4 = buf[None, None]
    if bf16:       # the yardstick samples a bf16 buffer (grid_sample wants
        b4, grid = b4.bfloat16(), grid.bfloat16()    # one dtype for both)
    return dict(
        name=f"patches_{'bf16_' if bf16 else ''}{site}", err=err,
        shape=(n, ps, ps), ms=time_ms(kernel, 20),
        event_ms=event_median_ms(kernel, 20), plain_ms=time_ms(plain, 5),
        library_ms=time_ms(lambda: F.grid_sample(
            b4, grid, mode="bilinear", padding_mode="zeros",
            align_corners=False), 20),
        bound_ms=t_bytes, bound_by=by)


def check_patch_sites(det, img: torch.Tensor, bf16: bool = False) -> dict:
    """B4 (or B4-bf16) at the shape and desc sites, on the inputs the
    extractor's stages give them."""
    res = {}
    p = det._plan(H, W)
    cand = det._multiscale_detect(img, p)
    cand["lafs"] = torch.cat([det.cfg.mr_size * cand["lafs"][:, :, 0:2],
                              cand["lafs"][:, :, 2:]], dim=2)
    res["shape"] = check_patches(
        "shape", cand["flat"], cand["lafs"].contiguous(),
        cand["ext_level"].to(torch.int32), p.tables, bf16=bf16)
    cand = det._sort_for_describe(det._affine_shape(cand, p), p, H, W)
    res["desc"] = check_patches(
        "desc", cand["flat"], cand["lafs"].contiguous(),
        cand["desc_level"].to(torch.int32), p.tables, bf16=bf16)
    return res


def check_program_sites(det, img: torch.Tensor) -> dict:
    """B4 at the HesAffNet program's two sites (every NMS survivor, about
    34k patches of PS 32 on a 1080p image): the shape site, and the ori
    site after AffNet's shapes and the gate, on the inputs the program's
    stages give them."""
    with torch.inference_mode(), float32_math():
        p = det._plan(H, W)
        cand = det._multiscale_detect(img, p)
        cand["lafs"] = torch.cat([det.cfg.mr_size * cand["lafs"][:, :, 0:2],
                                  cand["lafs"][:, :, 2:]], dim=2)
        res = {"hes_shape": check_patches(
            "hes_shape", cand["flat"], cand["lafs"].contiguous(),
            cand["ext_level"].to(torch.int32), p.tables)}
        cand = det._affine_shape(cand, p)
        res["hes_ori"] = check_patches(
            "hes_ori", cand["flat"], cand["lafs"].contiguous(),
            cand["ext_level"].to(torch.int32), p.tables,
            ps=det.ori_net.ps)
    return res


def phase_kernels(det, img: torch.Tensor, seed: int) -> dict:
    """Main-path inputs from one image through the extractor's stages, then
    each kernel against its plain version at those shapes."""
    res = {}
    res["blur"] = check_blur(img)
    p = det._plan(H, W)
    res["blur_image"] = check_blur_image(img, p.plan)
    res.update(check_detect(det, img))
    res["topk"] = check_topk(det, img, seed)
    for site, r in check_patch_sites(det, img).items():
        res[f"patches_{site}"] = r
    return res


def phase_stage(dets: dict, img: torch.Tensor) -> dict:
    """The pyramid and detection stage as a whole, per image: the device
    activities (kernels, copies, memsets) of ``_responses`` (the pyramid
    and detection) and of ``_multiscale_detect`` (and the selection and
    (sigma, y, x)), and their device ms, from the profiler, for each
    extractor of ``dets``."""
    res = {}
    for name, det in dets.items():
        p = det._plan(*img.shape)
        res[name] = {stage: stage_profile(functools.partial(
            getattr(det, stage), img, p))
            for stage in ("_responses", "_multiscale_detect")}
        for stage, r in res[name].items():
            log(f"stage {name} {stage}: {r['launches']:.0f} device "
                f"activities per image ({r['kernels']:.0f} kernels, "
                f"{r['copies']:.0f} copies, {r['memsets']:.0f} memsets), "
                f"device ms {r['device_ms']:.4f}")
    return res


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------

def check_outputs(out: dict, i: int, dtype=np.float32) -> None:
    n = len(out["resp"])
    require(n == NFEATS, f"image {i}: {n} valid keypoints, expected {NFEATS}")
    d = out["descs"]
    require(d.dtype == dtype, f"image {i}: descriptors {d.dtype}, not {dtype}")
    require(d.shape == (NFEATS, 128) and np.isfinite(d).all(),
            f"image {i}: descriptors not finite / wrong shape {d.shape}")
    norms = np.linalg.norm(d.astype(np.float32), axis=1)
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


def phase_main(det, det_plain, imgs, kernels=EXTRACTION_KERNELS,
               dtype=np.float32) -> dict:
    reset_launch_counts()
    t0 = time.perf_counter()
    outs = [det(img, describe=True) for img in imgs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    log(f"main path launches ({len(imgs)} images, fast={det.cfg.fast}): "
        f"{json.dumps(counts)}")
    for name in kernels:
        require(counts[name] > 0,
                f"kernel {name} was not launched on the main path")
    # fast mode samples in bf16 only, float32 mode in float32 only.
    other = "patches" if det.cfg.fast else "patches_bf16"
    require(counts[other] == 0, f"{other} launched in fast={det.cfg.fast}")
    for i, out in enumerate(outs):
        check_outputs(out, i, dtype)
        ref = det_plain(imgs[i], describe=True)
        require(np.array_equal(out["orig_idx"], ref["orig_idx"]),
                f"image {i}: keypoints differ from the plain path on the card")
        for k in ("resp", "lafs", "descs", "patches"):
            a, b = out[k].astype(np.float32), ref[k].astype(np.float32)
            err = float(np.abs(a - b).max())
            require(err <= 1e-3 * max(1.0, float(np.abs(b).max())),
                    f"image {i}: {k} differs from the plain path by {err}")
        log(f"image {i}: {len(out['resp'])} keypoints, n_detected "
            f"{out['n_detected']}, identical to the plain path")
    return {"counts": counts, "first_pass_s": wall, "outs": outs}


def time_per_image(runs, imgs, passes: int = 2) -> list:
    """Host-clock ms of each call, synchronized at both ends, for each run
    (a function of the image) in turn on every image, ``passes`` times."""
    times = [[] for _ in runs]
    for _ in range(passes):
        for img in imgs:
            for run, acc in zip(runs, times):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                run(img)
                torch.cuda.synchronize()
                acc.append((time.perf_counter() - t1) * 1e3)
    return times


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
    LAF cotangent: equal bit for bit to the replay of the kernel's order
    (ops/patches.py laf_cotangent_replay) and so from run to run, and
    within rtol 1e-4, atol 1e-4 of its largest magnitude of autograd's
    (another summation order); image cotangent: rtol 1e-5, atol 1e-5
    (atomicAdd order)."""
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
    require(torch.equal(got_l, laf_cotangent_replay(buf, lafs, *tables, g,
                                                    ps=ps)),
            "batched bwd: LAF cotangent differs from the replay of the "
            "kernel's order")
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


def check_plain_step(state, desc_fn, cfg, batch,
                     make_step=make_affnet_train_step,
                     b5=(2, 1, 1)) -> dict:
    """One step of ``make_step`` from the same state and the same generator
    through the kernels and through the plain sampler on the card; the
    kernel run launches ``b5`` = (B5 forwards at PS 64, at PS 32, B5
    backwards).  Loss rtol 1e-5, gradients within 1e-3 and parameters
    after SGD within 1e-5 of each tensor's largest magnitude, BatchNorm
    statistics within 1e-6."""
    model, dev = state.model, batch[0].device
    snap_model = copy.deepcopy(model.state_dict())
    snap_opt = copy.deepcopy(state.optimizer.state_dict())
    step0 = state.step
    runs = []
    for use_kernels in (True, False):
        model.load_state_dict(snap_model)
        state.optimizer.load_state_dict(copy.deepcopy(snap_opt))
        state.step = step0
        step_fn = make_step(desc_fn, cfg, use_kernels)
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
    require(kern["counts"]["batched_fwd"] == b5[0] + b5[1]
            and kern["counts"].get("batched_fwd_ps64", 0) == b5[0]
            and kern["counts"].get("batched_fwd_ps32", 0) == b5[1]
            and kern["counts"]["batched_bwd"] == b5[2],
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
    log(f"batched_bwd: LAF cotangent equal to the replay of the kernel's "
        f"order and from run to run, largest |value| {b['laf_scale']:.4g}; "
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


# ---------------------------------------------------------------------------
# Phases 7-8: shape optimization (kernel B6)
# ---------------------------------------------------------------------------

# The reference's script (optimization_script.py, as the optimize_shapes
# program mirrors it): 200 features, shear mode with H = I, GT gate 1 px,
# SIFT, HardNegC, Adam lr 2.0, 100 steps; ms per step over steps 10..99.
SHAPE_NFEATS, SHAPE_STEPS, SHAPE_TIMED_FROM = 200, 100, 10
SHAPE_LR, SHAPE_TFEAT_STEPS = 2.0, 10


def shape_problem(device) -> tuple:
    """(image, LAFs of view 1, LAFs of view 2, detections): the optimize
    program's detection and GT pairs on the 640x800 fixture."""
    img = np.load(os.path.join(FIXTURES, "detector_golden_fullres.npz"))["img"]
    img = np.ascontiguousarray(img, np.float32)
    det = ScaleSpaceAffinePatchExtractor(
        optimize_shapes.detector_config(SHAPE_NFEATS), device=device)
    lafs1, lafs2, n_det = optimize_shapes.gt_pairs(
        det, img, img, np.eye(3, dtype=np.float32), "shear", 1.0)
    return img, lafs1, lafs2, n_det


def shape_optimizer(name: str, device, use_kernels: bool = True):
    return LAFShapeOptimizer(
        optimize_shapes.make_descriptor(name, device=device),
        optimize_shapes.loss_fn("HardNegC"), lr=SHAPE_LR, patch_size=32,
        device=device, use_kernels=use_kernels)


def _pyramid_theta(nlafs, lvl, tables, buf_shape):
    """affine_grid's theta for B6's function over the whole buffer as one
    image (align_corners=False): x = 2 (m (a00 gx + a01 gy) + w tx) / W - 1,
    y = 2 (m (a10 gx + a11 gy) + h ty + row_off) / H - 1."""
    offs, hs, ws = tables
    lv = lvl.long()
    h, w = hs[lv].float(), ws[lv].float()
    m = torch.minimum(h, w)
    hb, wb = buf_shape
    sx, sy = (2.0 * m / wb)[:, None], (2.0 * m / hb)[:, None]
    row_x = torch.cat([nlafs[:, 0, :2] * sx,
                       (2.0 * w * nlafs[:, 0, 2] / wb - 1.0)[:, None]], 1)
    row_y = torch.cat([nlafs[:, 1, :2] * sy,
                       (2.0 * (h * nlafs[:, 1, 2] + offs[lv].float()) / hb
                        - 1.0)[:, None]], 1)
    return torch.stack([row_x, row_y], 1)


def _library_pyramid_sample(buf, theta, ps):
    n = theta.shape[0]
    grid = F.affine_grid(theta, (n, 1, ps, ps), align_corners=False)
    return F.grid_sample(buf[None, None], grid.reshape(1, n * ps, ps, 2),
                         mode="bilinear", padding_mode="zeros",
                         align_corners=False).reshape(n, ps, ps)


def check_pyramid_kernels(opt, st, seed) -> dict:
    """B6 forward and backward on view 1's pyramid at the 200 LAFs' own
    levels, against the plain version and autograd of it."""
    ps = opt.ps
    view = st.views[0]
    nlafs, lvl = opt.sampler_inputs(view, st.shapes[0].detach())
    nlafs, lvl = nlafs.contiguous(), lvl.to(torch.int32).contiguous()
    levels = torch.unique(lvl).tolist()
    require(len(levels) >= 2, f"B6 check: the LAFs use levels {levels}")
    buf, tables = view.flat, view.tables
    tab4 = (lvl, *tables)
    n = nlafs.shape[0]

    def fwd():
        return cuda_patches.sample_pyramid_cuda(buf, nlafs, tab4, ps, False)

    def plain_fwd():
        return extract_patches_from_flat_pyramid(buf, nlafs, lvl, *tables,
                                                 ps=ps)

    got = fwd()
    require(torch.equal(got, plain_fwd()), "B6 forward: not bit-identical")

    gen = torch.Generator(device=buf.device).manual_seed(seed)
    g = 2 * torch.rand((n, ps, ps), generator=gen, device=buf.device) - 1

    def bwd(need_buf=False):
        return cuda_patches.sample_pyramid_bwd_cuda(buf, nlafs, tab4, g, ps,
                                                    False, need_buf, True)

    _, got_l = bwd()
    got_b, got_l2 = bwd(True)
    require(torch.equal(got_l, got_l2),
            "B6 backward: LAF cotangent differs from run to run")
    require(torch.equal(got_l, laf_cotangent_replay(buf, nlafs, lvl, *tables,
                                                    g, ps=ps)),
            "B6 backward: LAF cotangent differs from the replay of the "
            "kernel's order")
    b = buf.clone().requires_grad_(True)
    lf = nlafs.clone().requires_grad_(True)
    out = extract_patches_from_flat_pyramid(b, lf, lvl, *tables, ps=ps)
    ref_b, ref_l = torch.autograd.grad(out, (b, lf), g, retain_graph=True)
    scale = float(ref_l.abs().max())
    err = float((got_l - ref_l).abs().max())
    require(bool(torch.all((got_l - ref_l).abs()
                           <= 1e-4 * scale + 1e-4 * ref_l.abs())),
            f"B6 backward: LAF cotangent max err {err} (scale {scale})")
    scale_b = float(ref_b.abs().max())
    err_b = float((got_b - ref_b).abs().max())
    require(bool(torch.all((got_b - ref_b).abs()
                           <= 1e-5 * scale_b + 1e-5 * ref_b.abs())),
            f"B6 backward: buffer cotangent max err {err_b} (scale "
            f"{scale_b})")
    # Through the autograd Function: the buffer needs no gradient, so the
    # backward computes the LAF cotangent only.
    lf2 = nlafs.clone().requires_grad_(True)
    before = cuda_patches.launches_pyramid_bwd
    view.sample(buf, lf2, lvl).backward(g)
    require(cuda_patches.launches_pyramid_bwd == before + 1
            and buf.grad is None and torch.equal(lf2.grad, got_l),
            "B6 backward through autograd: not the LAF cotangent alone")

    u, v, row0, h, w = _sample_positions(nlafs, lvl, *tables, ps, False)
    n_touched = _n_touched(buf, u, v, row0, h, w)
    fb, fby = bound_ms(n_touched * 4 + n * (24 + 4) + n * ps * ps * 4,
                       30 * n * ps * ps)
    bb, bby = bound_ms(n_touched * 4 + n * ps * ps * 4 + n * (4 + 2 * 24),
                       40 * n * ps * ps)
    theta = _pyramid_theta(nlafs, lvl, tables, buf.shape)
    theta_g = theta.clone().requires_grad_(True)
    lib_out = _library_pyramid_sample(buf, theta_g, ps)
    # The yardstick pads at the buffer's edges, not the level's: compare
    # where all four corners lie inside the level.
    inside = ((torch.floor(u) >= 0) & (torch.floor(u) + 1 <= w - 1)
              & (torch.floor(v) >= 0) & (torch.floor(v) + 1 <= h - 1))
    lib_err = float((lib_out.detach() - got).abs()[inside].max())
    fwd_res = dict(name="pyramid_fwd", err=0.0, shape=(n, ps, ps),
                   levels=levels, library_err=lib_err,
                   ms=time_ms(fwd, 20), event_ms=event_median_ms(fwd, 20),
                   plain_ms=time_ms(plain_fwd, 5),
                   library_ms=time_ms(
                       lambda: _library_pyramid_sample(buf, theta, ps), 20),
                   bound_ms=fb, bound_by=fby)
    bwd_res = dict(name="pyramid_bwd", err=err, err_buf=err_b,
                   laf_scale=scale, shape=(n, ps, ps),
                   ms=time_ms(bwd, 20), event_ms=event_median_ms(bwd, 20),
                   ms_with_buffer=time_ms(lambda: bwd(True), 20),
                   plain_ms=time_ms(lambda: torch.autograd.grad(
                       out, lf, g, retain_graph=True), 5),
                   library_ms=time_ms(lambda: torch.autograd.grad(
                       lib_out, theta_g, g, retain_graph=True), 20),
                   bound_ms=bb, bound_by=bby)
    return {"pyramid_fwd": fwd_res, "pyramid_bwd": bwd_res}


def check_shape_plain_step(img, lafs1, lafs2, device) -> dict:
    """The first Adam step from the same fresh state through the kernels
    and through the plain versions on the card: loss rtol 1e-5, the shapes'
    gradients within 1e-4 of their largest magnitude.  Adam's first step is
    lr * g / (|g| + eps), about lr * sign(g): where |g| is within that
    tolerance of zero the two paths may step opposite ways, so those
    elements are counted and printed, and the update must be equal (within
    1e-5 * lr) on every other element."""
    runs = []
    for use_kernels in (True, False):
        opt = shape_optimizer("SIFT", device, use_kernels)
        st = opt.prepare(lafs1, lafs2, img, img)
        start = [A.detach().clone() for A in st.shapes]
        reset_launch_counts()
        opt.step(st)
        runs.append(dict(
            loss=st.hist["loss"][0], counts=launch_counts(),
            grads=torch.cat([A.grad.flatten() for A in st.shapes]),
            update=torch.cat([(A.detach() - a).flatten()
                              for A, a in zip(st.shapes, start)])))
    kern, plain = runs
    require(kern["counts"]["pyramid_fwd"] == 2
            and kern["counts"]["pyramid_bwd"] == 2,
            f"shape plain-step check: kernel launches {kern['counts']}")
    require(plain["counts"]["pyramid_fwd"] == 0
            and plain["counts"]["pyramid_bwd"] == 0,
            f"shape plain-step check: the plain path launched "
            f"{plain['counts']}")
    scale = float(plain["grads"].abs().max())
    grad_err = float((kern["grads"] - plain["grads"]).abs().max())
    near0 = plain["grads"].abs() <= 1e-4 * scale
    upd_err = float((kern["update"] - plain["update"])[~near0].abs().max())
    res = dict(loss=kern["loss"], loss_plain=plain["loss"],
               grad_rel=grad_err / scale, n_near_zero=int(near0.sum()),
               n=int(near0.numel()), update_err=upd_err,
               n_opposite=int((torch.sign(kern["update"])
                               != torch.sign(plain["update"])).sum()))
    require(abs(res["loss"] - res["loss_plain"])
            <= 1e-5 * abs(res["loss_plain"]), f"shape plain-step loss: {res}")
    require(res["grad_rel"] <= 1e-4, f"shape plain-step gradients: {res}")
    require(upd_err <= 1e-5 * SHAPE_LR, f"shape plain-step update: {res}")
    return res


def run_shape_opt(device, seed) -> tuple:
    """Phases 7 (B6 at the shape optimizer's shapes) and 8 (the path)."""
    t = time.perf_counter()
    img, lafs1, lafs2, _ = shape_problem(device)
    opt = shape_optimizer("SIFT", device)
    res = check_pyramid_kernels(opt, opt.prepare(lafs1, lafs2, img, img),
                                seed)
    torch.cuda.synchronize()
    for r in res.values():
        log(f"kernel {r['name']} {r['shape']}: max_abs_err {r['err']:.3g} "
            f"ms {r['ms']:.4f} event_median_ms {r['event_ms']:.4f} "
            f"plain_ms {r['plain_ms']:.4f} library_ms {r['library_ms']:.4f} "
            f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']})")
    b = res["pyramid_bwd"]
    log(f"pyramid_fwd: levels {res['pyramid_fwd']['levels']}, library "
        f"forward max |diff| {res['pyramid_fwd']['library_err']:.3g} (samples "
        f"inside their level); pyramid_bwd: LAF cotangent equal to the "
        f"replay of the kernel's order and from run to run, largest "
        f"|value| {b['laf_scale']:.4g}, with the buffer cotangent ms "
        f"{b['ms_with_buffer']:.4f} (buffer max_abs_err {b['err_buf']:.3g})")
    log(f"phase shape kernels wall_s: {time.perf_counter() - t:.3f}")

    t = time.perf_counter()
    reset_launch_counts()
    img, lafs1, lafs2, n_det = shape_problem(device)
    st = opt.prepare(lafs1, lafs2, img, img)
    per_step = []
    for i in range(SHAPE_STEPS):
        if i == SHAPE_TIMED_FROM:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        before = (cuda_patches.launches_pyramid,
                  cuda_patches.launches_pyramid_bwd)
        opt.step(st)
        per_step.append((cuda_patches.launches_pyramid - before[0],
                         cuda_patches.launches_pyramid_bwd - before[1]))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (SHAPE_STEPS - SHAPE_TIMED_FROM)
    counts = launch_counts()
    log(f"shape-opt path launches (detection + {SHAPE_STEPS} steps): "
        f"{json.dumps(counts)}")
    require(all(c == (2, 2) for c in per_step),
            f"B6 launches per step (forward, backward) not (2, 2): "
            f"{sorted(set(per_step))}")
    for name in ("blur", "detect", "topk"):
        require(counts[name] > 0, f"kernel {name} not launched")
    h = st.hist
    n_pairs = len(lafs1)
    require(n_pairs >= 2, f"{n_pairs} GT pairs")
    require(bool(np.isfinite(h["loss"]).all()), "shape-opt loss not finite")
    require(h["loss"][-1] < h["loss"][0]
            and h["shape_diff"][-1] < h["shape_diff"][0],
            f"shape-opt: loss {h['loss'][0]} -> {h['loss'][-1]}, shape "
            f"diff {h['shape_diff'][0]} -> {h['shape_diff'][-1]}")
    log(f"shape opt: {n_det} detections -> {n_pairs} GT pairs; loss "
        f"{h['loss'][0]:.6f} -> {h['loss'][-1]:.6f}, shape diff "
        f"{h['shape_diff'][0]:.6f} -> {h['shape_diff'][-1]:.6f} over "
        f"{SHAPE_STEPS} steps (SIFT, HardNegC, Adam lr {SHAPE_LR})")
    log(f"shape_opt_ms_per_step: {ms:.3f} (host clock over steps "
        f"{SHAPE_TIMED_FROM}..{SHAPE_STEPS - 1}, synchronized at both ends)")
    ps = check_shape_plain_step(img, lafs1, lafs2, device)
    log(f"shape plain-path first step: loss {ps['loss']:.7f} vs "
        f"{ps['loss_plain']:.7f}; gradients max |diff| / max |value| "
        f"{ps['grad_rel']:.3g}; {ps['n_near_zero']} of {ps['n']} gradient "
        f"elements within 1e-4 of the largest of zero; update max |diff| "
        f"elsewhere {ps['update_err']:.3g}; steps of opposite sign "
        f"{ps['n_opposite']}")

    reset_launch_counts()
    opt_tf = shape_optimizer("TFeat", device)
    st_tf = opt_tf.prepare(lafs1, lafs2, img, img)
    for _ in range(SHAPE_TFEAT_STEPS):
        opt_tf.step(st_tf)
    tf_counts = launch_counts()
    require(tf_counts["pyramid_fwd"] == 2 * SHAPE_TFEAT_STEPS
            and tf_counts["pyramid_bwd"] == 2 * SHAPE_TFEAT_STEPS,
            f"TFeat shape opt launches {tf_counts}")
    lt = st_tf.hist["loss"]
    require(bool(np.isfinite(lt).all())
            and bool(np.isfinite(st_tf.hist["lafs1"][-1]).all()),
            f"TFeat shape opt not finite: {lt}")
    log(f"shape opt with TFeat, {SHAPE_TFEAT_STEPS} steps: loss "
        f"{lt[0]:.6f} -> {lt[-1]:.6f}, shape diff "
        f"{st_tf.hist['shape_diff'][0]:.6f} -> "
        f"{st_tf.hist['shape_diff'][-1]:.6f}")
    log(f"phase shape opt wall_s: {time.perf_counter() - t:.3f}")
    return res, dict(counts=counts, ms=ms)


# ---------------------------------------------------------------------------
# Phase 9: the flagship's fast mode (kernel B4-bf16)
# ---------------------------------------------------------------------------

def run_fast(aff, desc, imgs, f32_outs, f32_ms, device) -> tuple:
    t = time.perf_counter()
    det = ScaleSpaceAffinePatchExtractor(FAST_CONFIG, shape_net=aff,
                                         desc_net=desc, device=device)
    det_plain = ScaleSpaceAffinePatchExtractor(
        FAST_CONFIG, shape_net=aff, desc_net=desc, device=device,
        use_kernels=False)
    with torch.inference_mode():
        res = check_patch_sites(det, torch.from_numpy(imgs[0]).to(device),
                                bf16=True)
    torch.cuda.synchronize()
    for r in res.values():
        log(f"kernel {r['name']} {r['shape']}: max_abs_err {r['err']:.3g} "
            f"ms {r['ms']:.4f} event_median_ms {r['event_ms']:.4f} "
            f"plain_ms {r['plain_ms']:.4f} library_ms {r['library_ms']:.4f} "
            f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']})")
    main_res = phase_main(det, det_plain, imgs, FAST_EXTRACTION_KERNELS,
                          np.float16)
    for i, (out, ref) in enumerate(zip(main_res["outs"], f32_outs)):
        only_fast = np.setdiff1d(out["orig_idx"], ref["orig_idx"]).size
        only_f32 = np.setdiff1d(ref["orig_idx"], out["orig_idx"]).size
        log(f"image {i}: fast against float32 keypoint sets: "
            f"{'equal' if only_fast + only_f32 == 0 else 'differ'}, "
            f"{only_fast} only in fast mode, {only_f32} only in float32 "
            "(eig-ratio/boundary gate flips on bf16 shapes and their "
            "re-top-k refills)")
    per_img, per_img_plain = time_per_image(
        [functools.partial(d, describe=True) for d in (det, det_plain)], imgs)
    ms = float(np.median(per_img))
    log(f"fast_ms_per_image: median {ms:.3f} (all "
        f"{[round(x, 3) for x in per_img]}); plain fast path median "
        f"{np.median(per_img_plain):.3f}; float32 median {f32_ms:.3f}")
    log(f"phase fast wall_s: {time.perf_counter() - t:.3f}")
    return res, main_res["counts"], ms, main_res["outs"]


# ---------------------------------------------------------------------------
# Phases 10-12: the flat eval layout (kernel B7) and the HesAffNet program
# ---------------------------------------------------------------------------

PEAK_BF16_FLOP_PER_S = 989e12     # H100 SXM bf16 tensor peak (data sheet)
# The HesAffNet program's command-line defaults (affnet_tpu/cli/hesaffnet.py).
PROGRAM_TH = -1.0
PROGRAM_CAP = 16384
B7_PER_PROGRAM_PASS = 12          # AffNetFast 6 + OriNetFast32 6
B7_PER_EXTRACTION = 7             # AffNetFast 6 + HardTFeatNet 1


_TORCH_ACTS = {"none": lambda y: y, "relu": torch.relu, "tanh": torch.tanh,
               "elu": F.elu}


def _nchw(x, hw):
    c, total = x.shape
    h, wd = hw
    return x.reshape(c, total // (h * wd), h, wd).transpose(0, 1)


def bf16_rounding(x, w, bias, hw, pad, stride, max_patches: int = 256):
    """How B7-bf16's sums round, against a float32 chain: on the first
    ``max_patches`` patches, without the activation, the share of outputs
    of the kernel and of the plain version that differ from the float64
    sum of the same bf16 products rounded to bf16, and the largest such
    difference in bf16 ulps."""
    h, wd = hw
    xs = x[:, :max_patches * h * wd].contiguous()
    got = cuda_conv.conv_flat_cuda(xs, w, bias, hw, pad, "none", stride)
    plain = conv_layer_plain(xs, w, bias, hw, pad, "none", stride)
    w64 = w.to(torch.bfloat16).double().permute(3, 2, 0, 1)
    exact = F.conv2d(_nchw(xs, hw).double(), w64, bias.double(),
                     stride=stride, padding=pad)
    exact = exact.transpose(0, 1).reshape(got.shape).float().to(
        torch.bfloat16)

    def ulps(a):
        ia = a.view(torch.int16).int()
        ie = exact.view(torch.int16).int()
        return (ia - ie).abs()

    gu, pu = ulps(got), ulps(plain)
    return dict(kernel_share=float((gu > 0).float().mean()),
                kernel_max_ulps=int(gu.max()),
                plain_share=float((pu > 0).float().mean()),
                plain_max_ulps=int(pu.max()), n=int(got.numel()))


def log_conv_sass() -> None:
    """Whether B7-bf16's kernels issue tensor-core products (HMMA in the
    built library's SASS, from ``cuobjdump -sass``) and B7's float32
    kernels float32 FMAs (FFMA) and no HMMA; fatal if not."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    require(os.path.exists(tool), "cuobjdump not found: cannot read the "
            "kernels' SASS")
    sass = subprocess.run([tool, "-sass", build.library_path()],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts = {}
    for block in sass.split("Function : ")[1:]:
        fname = block.split("\n", 1)[0].strip()
        for kind in ("conv_bf16_kernel", "conv_f32_kernel"):
            if kind in fname:
                c = counts.setdefault(kind, [0, 0, 0])
                c[0] += 1
                c[1] += block.count("HMMA")
                c[2] += block.count("FFMA")
    bf, f32 = counts.get("conv_bf16_kernel"), counts.get("conv_f32_kernel")
    require(bf is not None and f32 is not None, f"conv kernels not found in "
            f"the SASS of {build.library_path()}")
    log(f"SASS (cuobjdump -sass): B7-bf16 {bf[0]} kernels, {bf[1]} HMMA "
        f"instructions; B7 float32 {f32[0]} kernels, {f32[2]} FFMA, "
        f"{f32[1]} HMMA")
    require(bf[1] >= bf[0], "B7-bf16 kernels without HMMA instructions")
    require(f32[1] == 0 and f32[2] > 0, "B7 float32 kernels must use FFMA "
            "and no tensor-core instruction")


def check_conv(name, x, w, bias, hw, pad, act, stride=1,
               reps: int = 20) -> dict:
    """B7 (B7-bf16 for bf16 x) against its plain version (the layer's own
    work, conv_layer_plain) on the card: float32 within 1e-5 of the
    output's largest magnitude (another summation order; the card's
    tanhf/expm1f within a few ulps), bf16 within that plus one bf16 ulp of
    the value (a float32 sum that differs in its last bits may round to the
    neighbouring bf16 value).  Timed beside the plain version and cuDNN
    (``library_ms``: F.conv2d, TF32 off, on the NCHW view of the same
    input at the layer's stride and padding, plus bias and activation;
    its difference to the kernel is logged as ``layer_err``: cuDNN picks
    its own algorithm and, in bf16, rounds before the bias).  ``bound_ms``
    is over the layer's own work: the input read once, the kept outputs
    written once, 2*k*k*C*O operations per kept output."""
    bf16 = x.dtype == torch.bfloat16
    x, w = x.contiguous(), w.contiguous()   # as conv_flat passes them

    def kernel():
        return cuda_conv.conv_flat_cuda(x, w, bias, hw, pad, act, stride)

    def plain():
        return conv_layer_plain(x, w, bias, hw, pad, act, stride)

    with float32_math():
        got, ref = kernel().float(), plain().float()
        scale = float(ref.abs().max())
        tol = 1e-5 * scale + (ref.abs() * 2.0 ** -7 if bf16 else 0.0)
        err = float((got - ref).abs().max())
        require(bool(torch.all((got - ref).abs() <= tol)),
                f"conv {name}: max err {err} (largest |value| {scale})")
        del ref, tol
        c, total = x.shape
        kh, kw, _, o = w.shape
        h, wd = hw
        n = total // (h * wd)
        oh, ow = out_extent(hw, kh, pad, stride)
        x4 = _nchw(x, hw).contiguous()
        w4 = w.permute(3, 2, 0, 1).to(x.dtype).contiguous()
        b = bias.to(x.dtype)
        act_fn = _TORCH_ACTS[act]

        def library():
            return act_fn(F.conv2d(x4, w4, b, stride=stride, padding=pad))

        layer_err = float((library().float().transpose(0, 1).reshape(
            o, -1) - got).abs().max())
        del got
        es = x.element_size()
        peak = PEAK_BF16_FLOP_PER_S if bf16 else PEAK_F32_FLOP_PER_S
        n_bytes = (c * total + o * n * oh * ow) * es + (c * kh * kw * o
                                                        + o) * 4
        t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
        t_ops = 2.0 * kh * kw * c * o * n * oh * ow / peak * 1e3
        res = dict(name=f"conv_{'bf16_' if bf16 else ''}{name}", err=err,
                   layer_err=layer_err,
                   shape=(c, o, kh, stride, pad, n, h, wd, act),
                   ms=time_ms(kernel, reps),
                   event_ms=event_median_ms(kernel, reps),
                   plain_ms=time_ms(plain, max(2, reps // 4)),
                   library_ms=time_ms(library, reps),
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        if bf16:
            res["rounding"] = bf16_rounding(x, w, bias, hw, pad, stride)
    return res


def log_conv(r: dict) -> None:
    log(f"kernel {r['name']} (C, O, k, stride, pad, N, H, W, act) "
        f"{r['shape']}: max_abs_err {r['err']:.3g} ms {r['ms']:.4f} "
        f"event_median_ms {r['event_ms']:.4f} plain_ms {r['plain_ms']:.4f} "
        f"library_ms {r['library_ms']:.4f} bound_ms {r['bound_ms']:.4f} "
        f"({r['bound_by']}); max |diff| to cuDNN {r['layer_err']:.3g}")
    if "rounding" in r:
        q = r["rounding"]
        log(f"kernel {r['name']} rounding against the float64 sum rounded "
            f"to bf16 ({q['n']} outputs, no activation): kernel differs in "
            f"{q['kernel_share']:.4%} (max {q['kernel_max_ulps']} ulp), "
            f"the plain float32 chain in {q['plain_share']:.4%} (max "
            f"{q['plain_max_ulps']} ulp)")


def check_conv_calls(run, names, reps: int = 20) -> dict:
    """``run()`` under the flat layout, with each B7 call it makes held
    against the plain version and timed (check_conv) on the inputs the
    path gives it, before the path goes on with the kernel's output.  The
    i-th call is ``names[i]``."""
    res = {}
    orig = cnn.conv_flat

    def spy(x, w, bias, img_hw, pad, act, stride, use_kernel=True):
        i = len(res)
        require(i < len(names), f"more B7 calls than the layers {names}")
        res[names[i]] = check_conv(names[i], x, w, bias, img_hw, pad, act,
                                   stride, reps)
        return orig(x, w, bias, img_hw, pad, act, stride,
                    use_kernel=use_kernel)

    cnn.conv_flat = spy
    try:
        with cnn.eval_layout("flat"):
            run()
    finally:
        cnn.conv_flat = orig
    require(list(res) == list(names), f"B7 calls {list(res)}, expected "
            f"{list(names)}")
    return res


def _net_pass(net, patches) -> None:
    with torch.inference_mode(), float32_math():
        net(patches)


def conv_site_inputs(det, img):
    """The shape site's patches (3000, PS 32) and the desc site's (2000)
    of one image, through the extractor's stages."""
    with torch.inference_mode():
        p = det._plan(H, W)
        cand = det._multiscale_detect(img, p)
        cand["lafs"] = torch.cat([det.cfg.mr_size * cand["lafs"][:, :, 0:2],
                                  cand["lafs"][:, :, 2:]], dim=2)
        shape_patches, _ = cuda_patches.extract_patches_pyramid(
            cand["flat"], cand["lafs"], cand["ext_level"], *p.tables, ps=32,
            bf16=det.cfg.fast)
        cand = det._sort_for_describe(det._affine_shape(cand, p), p, H, W)
        desc_patches, _ = cuda_patches.extract_patches_pyramid(
            cand["flat"], cand["lafs"], cand["desc_level"], *p.tables,
            ps=det.cfg.patch_size, bf16=det.cfg.fast)
    return shape_patches, desc_patches


def phase_conv(det, fast_det, img, seed) -> dict:
    """Phase 10: B7 and B7-bf16 at every layer shape of the flat stack on
    the flagship's inputs (AffNetFast's six trunk layers on the 3000
    shape-site patches and HardTFeatNet's 7x7 layer on the 2000 desc-site
    patches), each call held against the plain version where the net's
    flat pass makes it, plus the two activations the zoo's path does not
    use, on random inputs."""
    t = time.perf_counter()
    res = {}
    aff = [f"aff{i}" for i in range(1, 7)]
    for d, tag in ((det, ""), (fast_det, "bf16_")):
        shape_patches, desc_patches = conv_site_inputs(d, img)
        for net, patches, names in ((d.shape_net, shape_patches, aff),
                                    (d.desc_net, desc_patches, ["tfeat1"])):
            checked = check_conv_calls(
                functools.partial(_net_pass, net, patches), names)
            res.update({f"conv_{tag}{k}": r for k, r in checked.items()})
    gen = torch.Generator(device="cpu").manual_seed(seed)
    for act in ("none", "elu"):
        x = torch.randn((16, 64 * 1024), generator=gen).to(img.device)
        w = (torch.randn((3, 3, 16, 16), generator=gen) / 12.0).to(img.device)
        b = (0.1 * torch.randn((16,), generator=gen)).to(img.device)
        for dt in (torch.float32, torch.bfloat16):
            r = check_conv(f"small_{act}", x.to(dt), w, b, (32, 32), 1, act)
            log(f"kernel {r['name']} {r['shape']}: max_abs_err "
                f"{r['err']:.3g}")
    torch.cuda.synchronize()
    for r in res.values():
        log_conv(r)
    check_flat_route(img.device, seed)
    log(f"phase conv kernels wall_s: {time.perf_counter() - t:.3f}")
    return res


def check_flat_route(device, seed) -> None:
    """Nets whose middle layer B7 does not take (a 5x5 SAME layer; a 7x7
    layer at pad 1) under the flat layout on 3000 patches: the stack puts
    the first 3x3 layer through B7 (one launch, none failed) and hands the
    rest to the stock layers; the features within 1e-5 of the plain
    path's (the flat nets' bound, tests/test_torch_cuda.py)."""
    nn = torch.nn
    gen = torch.Generator(device="cpu").manual_seed(seed)
    patches = torch.rand((3000, 32, 32), generator=gen).to(device)
    for k, pad in ((5, 2), (7, 1)):
        require(not cuda_conv.b7_takes(16, 16, k, pad, 1, 32, 32),
                f"b7_takes: a {k}x{k} layer at pad {pad}")
        net = init_params(PatchNet([
            nn.Conv2d(1, 16, 3, 1, 1, bias=False), cnn.batch_norm(16),
            nn.ReLU(), nn.Conv2d(16, 16, k, 1, pad, bias=False),
            cnn.batch_norm(16), nn.ReLU(),
            nn.Conv2d(16, 32, 3, 2, 1, bias=False), cnn.batch_norm(32),
            nn.ReLU(), nn.AdaptiveAvgPool2d(1)]), gen).to(device).eval()
        with cnn.eval_layout("flat"), torch.inference_mode(), float32_math():
            before = cuda_conv.launches
            got = net.feature_vectors(patches)
            torch.cuda.synchronize()
            launched = cuda_conv.launches - before
            ref = net.feature_vectors(patches, use_kernels=False)
        err = float((got - ref).abs().max())
        require(launched == 1, f"flat route {k}x{k} pad {pad}: {launched} "
                "B7 launches, expected 1")
        require(bool(torch.all((got - ref).abs() <= 1e-5 + 1e-5
                               * ref.abs())),
                f"flat route {k}x{k} pad {pad}: max err {err}")
        log(f"flat route: a {k}x{k} pad-{pad} layer runs stock after 1 B7 "
            f"launch; features against the plain path max_abs_err "
            f"{err:.3g}")


def keypoint_flips(a: dict, b: dict) -> tuple:
    """Keypoints only in a, only in b (by orig_idx)."""
    return (np.setdiff1d(a["orig_idx"], b["orig_idx"]).size,
            np.setdiff1d(b["orig_idx"], a["orig_idx"]).size)


def phase_hesaffnet(imgs, device, smi) -> dict:
    """Phase 11: the HesAffNet program at its command-line defaults (th=-1
    threshold mode, max-keypoints 16384, --do-ori) with the flat layout,
    through the program's own functions (the card's machine has no PIL):
    every NMS survivor through AffNetFast and OriNetFast32.  One pass over
    the first image holds each of its 12 B7 calls against the plain
    version at the program's shapes and times it; then the counted run: 12
    B7 launches per pass over an image, ellipses written and read back;
    keypoints against the same program through the plain versions on the
    card (flips counted, the common LAFs within the detector tests'
    tolerance) and against the nchw layout; ms per image beside nchw's."""
    t = time.perf_counter()
    det = hesaffnet.make_extractor(th=PROGRAM_TH, max_keypoints=PROGRAM_CAP,
                                   do_ori=True, device=device)
    det_plain = hesaffnet.make_extractor(
        th=PROGRAM_TH, max_keypoints=PROGRAM_CAP, do_ori=True, device=device,
        use_kernels=False)
    flat = cnn.eval_layout("flat")(hesaffnet.image_to_ells)
    nchw = cnn.eval_layout("nchw")(hesaffnet.image_to_ells)
    sites = check_program_sites(det, torch.from_numpy(imgs[0]).to(device))
    torch.cuda.synchronize()
    for r in sites.values():
        log(f"kernel {r['name']} {r['shape']}: max_abs_err {r['err']:.3g} "
            f"ms {r['ms']:.4f} event_median_ms {r['event_ms']:.4f} "
            f"plain_ms {r['plain_ms']:.4f} library_ms {r['library_ms']:.4f} "
            f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']})")
    log(f"hesaffnet B4 checks wall_s: {time.perf_counter() - t:.3f}")
    convs = check_conv_calls(
        functools.partial(hesaffnet.image_to_ells, det, imgs[0],
                          do_ori=True),
        [f"hes_aff{i}" for i in range(1, 7)]
        + [f"hes_ori{i}" for i in range(1, 7)], reps=5)
    torch.cuda.synchronize()
    for r in convs.values():
        log_conv(r)
    log(f"hesaffnet B7 checks wall_s: {time.perf_counter() - t:.3f}")
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    outs, per_pass = [], []
    for img in imgs:
        before = cuda_conv.launches
        outs.append(flat(det, img, do_ori=True))
        per_pass.append(cuda_conv.launches - before)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts = launch_counts()
    log(f"hesaffnet path launches ({len(imgs)} images): "
        f"{json.dumps(counts)}")
    require(all(n == B7_PER_PROGRAM_PASS for n in per_pass),
            f"B7 launches per pass {per_pass}, expected "
            f"{B7_PER_PROGRAM_PASS}")
    # Threshold mode keeps every survivor without a top-k: no B3.
    for name in ("blur", "detect", "dedup", "refine", "patches", "conv"):
        require(counts[name] > 0, f"kernel {name} not launched on the "
                "hesaffnet path")
    require(counts["conv_bf16"] == 0 and counts["patches_bf16"] == 0,
            "bf16 kernels launched in float32")
    with tempfile.TemporaryDirectory() as tmp:
        for i, (img, (ells, out)) in enumerate(zip(imgs, outs)):
            n = len(ells)
            require(n > 0 and ells.shape == (n, 5)
                    and np.isfinite(ells).all(),
                    f"image {i}: ellipses {ells.shape} not finite")
            require(len(out["resp"]) == n and np.all(
                np.diff(out["orig_idx"]) > 0),
                f"image {i}: not in scan order")
            path = os.path.join(tmp, f"img{i}.ells")
            write_ells(path, ells)
            back = read_ells(path)
            require(back.shape == ells.shape and np.allclose(
                back, ells, rtol=0, atol=1e-9),
                f"image {i}: ellipses read back differ")
            _, ref = flat(det_plain, img, do_ori=True)
            _, alt = nchw(det, img, do_ori=True)
            require(ref["n_detected"] == out["n_detected"]
                    == alt["n_detected"], f"image {i}: survivor counts "
                    f"{out['n_detected']} {ref['n_detected']} "
                    f"{alt['n_detected']}")
            fp = keypoint_flips(out, ref)
            fn = keypoint_flips(out, alt)
            limit = max(2, 2 * n // 1000)
            require(max(fp) <= limit, f"image {i}: {fp} keypoints differ "
                    "from the plain path")
            require(max(fn) <= 5 * limit, f"image {i}: {fn} keypoints "
                    "differ from the nchw layout")
            common, ri, gi = np.intersect1d(ref["orig_idx"], out["orig_idx"],
                                            return_indices=True)
            lerr = np.abs(out["lafs"][gi] - ref["lafs"][ri]).reshape(
                len(common), -1).max(axis=1)
            # The port's detector tests' LAF tolerance: atol 1e-2 px, at
            # most 2 keypoints over it.
            require((lerr > 1e-2).sum() <= 2, f"image {i}: "
                    f"{(lerr > 1e-2).sum()} LAFs differ from the plain "
                    f"path by more than 1e-2 px (max {lerr.max():.3g})")
            n_det = int(out["n_detected"])
            cap = (f"raised: the JAX program retries at "
                   f"{1 << (n_det - 1).bit_length()}"
                   if n_det > PROGRAM_CAP else "holds")
            log(f"image {i}: {n_det} NMS survivors (cap {PROGRAM_CAP} {cap}), "
                f"{n} regions after the gate; B7 launches this pass "
                f"{per_pass[i]}; against the plain path {fp[0]} only here, "
                f"{fp[1]} only there (gate flips), LAF max |diff| "
                f"{lerr.max():.3g} px, {(lerr > 1e-2).sum()} over 1e-2; "
                f"against nchw {fn[0]} / {fn[1]}")
    mesh = check_program_mesh(det, imgs[:2], outs[:2], device)
    per_img, per_img_nchw = time_per_image(
        [functools.partial(flat, det, do_ori=True),
         functools.partial(nchw, det, do_ori=True)], imgs)
    ms, ms_nchw = float(np.median(per_img)), float(np.median(per_img_nchw))
    log(f"hesaffnet_ms_per_image (flat): median {ms:.3f} (all "
        f"{[round(x, 3) for x in per_img]}); nchw median {ms_nchw:.3f} (all "
        f"{[round(x, 3) for x in per_img_nchw]})")
    log(f"hesaffnet peak device memory (flat, first pass): {peak_gb:.3f} GB "
        f"on {smi}")
    log(f"phase hesaffnet wall_s: {time.perf_counter() - t:.3f}")
    return dict(counts=counts, convs=convs, sites=sites, ms=ms,
                ms_nchw=ms_nchw, mesh=mesh)


def _matched_regions(a: np.ndarray, b: np.ndarray, tol: float = 1e-2
                     ) -> np.ndarray:
    """For each ellipse of ``a``, whether ``b`` holds one with the same
    centre (within ``tol`` px in each coordinate) and shape (within rtol
    1e-2): the program tests' allowances (tests/test_torch_hesaffnet.py)."""
    order = np.argsort(b[:, 0], kind="stable")
    bx = b[order, 0]
    lo = np.searchsorted(bx, a[:, 0] - tol)
    hi = np.searchsorted(bx, a[:, 0] + tol, side="right")
    found = np.zeros(len(a), bool)
    for i in range(len(a)):
        c = b[order[lo[i]:hi[i]]]
        found[i] = bool(np.any(
            (np.abs(c[:, 1] - a[i, 1]) < tol)
            & np.all(np.abs(c[:, 2:] - a[i, 2:])
                     <= 1e-2 * np.abs(c[:, 2:]) + 1e-6, axis=1)))
    return found


def check_program_mesh(det, imgs, outs, device) -> dict:
    """The program's ``main`` with ``--mesh 1`` on two same-shape 1080p
    images (written as .npy: the card's machine has no PIL) under the flat
    layout, the launches counted from 0 around it: one file per image.
    At about 34k survivors the cap (16384, the command-line default)
    binds, so each file must hold the gated regions of the cap's strongest
    survivors, as JAX's bulk mode does: at most min(survivors, cap), and
    the regions of the same image's single-image run (phase 11's counted
    pass) whose response is at least the cap-th largest survivor response
    (torch.topk of the response vector), up to the gate-flip allowance of
    phase 11 each way."""
    t = time.perf_counter()
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for i, img in enumerate(imgs):
            paths.append(os.path.join(tmp, f"img{i}.npy"))
            np.save(paths[-1], img)
        reset_launch_counts()
        cnn.eval_layout("flat")(hesaffnet.main)(
            [",".join(paths), os.path.join(tmp, "o.ells"), "--do-ori",
             "--mesh", "1"])
        torch.cuda.synchronize()
        counts = launch_counts()
        log(f"hesaffnet --mesh 1 launches ({len(imgs)} images): "
            f"{json.dumps(counts)}")
        for name in ("blur", "detect", "dedup", "refine", "topk", "patches",
                     "conv"):
            require(counts[name] > 0, f"kernel {name} not launched by the "
                    "program's bulk mode")
        require(counts["conv"] == B7_PER_PROGRAM_PASS * len(imgs),
                f"bulk mode: {counts['conv']} B7 launches")
        for i, (img, (ells, out)) in enumerate(zip(imgs, outs)):
            got = read_ells(os.path.join(tmp, f"o_{i}.ells"))
            n_det = int(out["n_detected"])
            with torch.inference_mode():
                resp = det._responses(torch.from_numpy(img).to(device),
                                      det._plan(H, W))[1]
                kth = float(torch.topk(resp, min(PROGRAM_CAP, n_det))
                            .values[-1])
            expect = out["resp"] >= kth
            limit = max(2, 2 * len(ells) // 1000)
            require(n_det > PROGRAM_CAP, f"image {i}: {n_det} survivors: "
                    "the cap does not bind")
            require(len(got) <= min(n_det, PROGRAM_CAP)
                    and np.isfinite(got).all(),
                    f"image {i}: {len(got)} regions in the bulk file")
            extra = int((~_matched_regions(got, ells[expect])).sum())
            missing = int((~_matched_regions(ells[expect], got)).sum())
            require(extra <= limit and missing <= limit,
                    f"image {i}: the bulk file has {extra} regions not "
                    f"among the single run's {int(expect.sum())} strongest, "
                    f"and misses {missing} of them (allowance {limit})")
            log(f"image {i} --mesh 1: {len(got)} regions (survivors "
                f"{n_det}, cap {PROGRAM_CAP}); the single run's regions "
                f"among the cap's strongest {int(expect.sum())}: {extra} "
                f"only in the file, {missing} only in the single run")
            res[i] = dict(regions=len(got), expected=int(expect.sum()),
                          extra=extra, missing=missing)
    log(f"hesaffnet --mesh 1 wall_s: {time.perf_counter() - t:.3f}")
    return dict(counts=counts, images=res)


def phase_flat_extraction(aff, desc, imgs, nchw_outs, device) -> dict:
    """Phase 12: the flagship top-k extraction (describe=True) with the
    flat layout, in float32 and in fast mode: 7 B7 (B7-bf16) launches per
    image, the outputs' checks, keypoints against the nchw runs of phases
    3 and 9 counted, ms per image beside nchw's in the same phase."""
    t = time.perf_counter()
    res = {}
    for cfg, counter, dtype in ((CONFIG, "conv", np.float32),
                                (FAST_CONFIG, "conv_bf16", np.float16)):
        mode = "fast" if cfg.fast else "float32"
        det = ScaleSpaceAffinePatchExtractor(cfg, shape_net=aff,
                                             desc_net=desc, device=device)
        run = cnn.eval_layout("flat")(functools.partial(det, describe=True))
        reset_launch_counts()
        outs, per_img = [], []
        for img in imgs:
            before = launch_counts()[counter]
            outs.append(run(img))
            per_img.append(launch_counts()[counter] - before)
        counts = launch_counts()
        log(f"flat extraction launches ({mode}, {len(imgs)} images): "
            f"{json.dumps(counts)}")
        require(all(n == B7_PER_EXTRACTION for n in per_img),
                f"{mode}: B7 launches per image {per_img}")
        other = "conv" if cfg.fast else "conv_bf16"
        require(counts[other] == 0, f"{mode}: {other} launched")
        for i, (out, ref) in enumerate(zip(outs, nchw_outs[mode])):
            check_outputs(out, i, dtype)
            fl = keypoint_flips(out, ref)
            require(max(fl) <= 10, f"{mode} image {i}: {fl} keypoints "
                    "differ from nchw")
            log(f"image {i} ({mode}): flat against nchw keypoint sets "
                f"{fl[0]} / {fl[1]} only in one of them")
        per_flat, per_nchw = time_per_image(
            [run, cnn.eval_layout("nchw")(
                functools.partial(det, describe=True))], imgs)
        res[mode] = dict(counts=counts, ms=float(np.median(per_flat)),
                         ms_nchw=float(np.median(per_nchw)))
        log(f"flat_{mode}_ms_per_image: median {res[mode]['ms']:.3f} (all "
            f"{[round(x, 3) for x in per_flat]}); nchw median "
            f"{res[mode]['ms_nchw']:.3f} (all "
            f"{[round(x, 3) for x in per_nchw]})")
    log(f"phase flat extraction wall_s: {time.perf_counter() - t:.3f}")
    return res


# ---------------------------------------------------------------------------
# Phases 13-14: HesAffBaum and OnePassSIR
# ---------------------------------------------------------------------------

BAUM_ITERS = 16                   # affnet_tpu/cli/hesaffbaum.py --iters
EXTRACT_GEOM_MODES = {            # affnet_tpu/cli/extract_geom.py
    "topk_sift": ["2000", "--descriptor", "SIFT"],
    "th_ori": ["--th", "28.41", "--do-ori"],
}


def save_npy(tmp: str, imgs) -> list:
    """The images as .npy files (the programs' input without PIL)."""
    paths = []
    for i, img in enumerate(imgs):
        paths.append(os.path.join(tmp, f"img{i}.npy"))
        np.save(paths[-1], img)
    return paths


def baumberg_site_lafs(det, img):
    """The Baumberg site's (PS 19) inputs, iteration by iteration, as the
    extractor's ``_affine_shape`` makes them: (level buffer, extraction
    levels, the LAFs of each iteration)."""
    with torch.inference_mode(), float32_math():
        p = det._plan(*img.shape)
        cand = det._multiscale_detect(img, p)
        lafs0 = torch.cat([det.cfg.mr_size * cand["lafs"][:, :, 0:2],
                           cand["lafs"][:, :, 2:]], dim=2)
        lvl = cand["ext_level"].to(torch.int32)
        base_A = torch.eye(2, device=img.device).expand(len(lafs0), 2, 2)
        lafs, all_lafs = lafs0, []
        for _ in range(det.cfg.num_baum_iters):
            all_lafs.append(lafs.contiguous())
            patches = extract_patches_from_flat_pyramid(
                cand["flat"], lafs, lvl, *p.tables, ps=det.shape_net.ps)
            base_A = det.shape_net(patches) @ base_A
            lafs = torch.cat([base_A @ lafs0[:, :, 0:2], lafs0[:, :, 2:]],
                             dim=2)
    return cand["flat"], lvl, all_lafs


def check_baumberg_site(det, img) -> dict:
    """B4's generic instance at PS 19 at each of the 16 Baumberg iterations
    of one image: bit-identical to its plain version at every iteration;
    device ms of each launch (one image's 16 in order), its bound, the
    plain version's and F.grid_sample's time on the same work, each per
    launch averaged over the 16."""
    tables = det._plan(*img.shape).tables
    buf, lvl, all_lafs = baumberg_site_lafs(det, img)
    ps = det.shape_net.ps

    def kernel():
        return [cuda_patches.extract_patches_cuda(buf, lafs, lvl, *tables,
                                                  ps=ps)
                for lafs in all_lafs]

    def plain():
        return [extract_patches_from_flat_pyramid(buf, lafs, lvl, *tables,
                                                  ps=ps)
                for lafs in all_lafs]

    for i, (got, ref) in enumerate(zip(kernel(), plain())):
        require(torch.equal(got, ref), f"patches (Baumberg iteration {i}, "
                f"PS {ps}): not bit-identical, max err "
                f"{float((got - ref).abs().max())}")
    per = kernel_times(kernel, "sample_patches", len(all_lafs))
    work = [patch_work(buf, lafs, lvl, tables, ps) for lafs in all_lafs]
    b4 = buf[None, None]
    for i, (ms, (t, by, _)) in enumerate(zip(per, work)):
        log(f"  B4 PS {ps} Baumberg iteration {i}: ms {ms:.4f} bound_ms "
            f"{t:.5f} ({by})")
    n = len(all_lafs)
    bys = {by for _, by, _ in work}
    return dict(
        name="patches_baum", err=0.0, shape=(len(lvl), ps, ps),
        ms=sum(per) / n, event_ms=event_median_ms(kernel, 10) / n,
        plain_ms=time_ms(plain, 3) / n,
        library_ms=time_ms(lambda: [F.grid_sample(
            b4, g, mode="bilinear", padding_mode="zeros",
            align_corners=False) for _, _, g in work], 5) / n,
        bound_ms=sum(t for t, _, _ in work) / n,
        bound_by=bys.pop() if len(bys) == 1 else "operations",
        per_launch=per)


def check_golden_baum(device) -> None:
    """The reference's HesAffBaum golden (detector_golden.npz: 50
    features, 16 iterations, the handcrafted estimator) on the card, at
    the JAX test's tolerances (tests/test_detector.py)."""
    g = np.load(os.path.join(FIXTURES, "detector_golden.npz"))
    out = hesaffbaum.make_extractor(50, BAUM_ITERS, device)(g["img"])
    require(len(out["resp"]) == len(g["baum_resp"]),
            f"golden Baumberg: {len(out['resp'])} keypoints, expected "
            f"{len(g['baum_resp'])}")
    np.testing.assert_allclose(out["lafs"], g["baum_lafs"], atol=1e-2)
    np.testing.assert_allclose(out["resp"], g["baum_resp"], atol=0.1,
                               rtol=1e-4)


def phase_hesaffbaum(imgs, device) -> dict:
    """Phase 13: the HesAffBaum program (top-k 2000, border 5, mrSize
    5.192, 16 handcrafted Baumberg iterations at PS 19): the golden; B4 at
    PS 19 at each iteration of the first image; the program's ``main`` on
    each image (.npy) with the launches counted from 0 around the runs: 16
    B4 and 1 B3 launches per image; keypoints against the plain path on
    the card; ms per image."""
    t = time.perf_counter()
    check_golden_baum(device)
    log("golden 120x160 HesAffBaum: within the JAX test's tolerances")
    det = hesaffbaum.make_extractor(NFEATS, BAUM_ITERS, device)
    det_plain = hesaffbaum.make_extractor(NFEATS, BAUM_ITERS, device,
                                          use_kernels=False)
    site = check_baumberg_site(det, torch.from_numpy(imgs[0]).to(device))
    log(f"hesaffbaum B4 checks wall_s: {time.perf_counter() - t:.3f}")
    with tempfile.TemporaryDirectory() as tmp:
        paths = save_npy(tmp, imgs)
        reset_launch_counts()
        for i, path in enumerate(paths):
            hesaffbaum.main([path, os.path.join(tmp, f"o{i}.ells"),
                             str(NFEATS)])
        torch.cuda.synchronize()
        counts = launch_counts()
        log(f"hesaffbaum path launches ({len(imgs)} images): "
            f"{json.dumps(counts)}")
        n = len(imgs)
        require(counts["patches"] == BAUM_ITERS * n and counts["topk"] == n,
                f"hesaffbaum: {counts['patches']} B4 and {counts['topk']} "
                f"B3 launches over {n} images, expected {BAUM_ITERS} and 1 "
                "per image")
        for name in ("blur", "detect", "dedup", "refine"):
            require(counts[name] > 0, f"kernel {name} not launched on the "
                    "hesaffbaum path")
        require(counts["patches_bf16"] == 0, "B4-bf16 launched")
        for i, img in enumerate(imgs):
            ells = read_ells(os.path.join(tmp, f"o{i}.ells"))
            out, ref = det(img), det_plain(img)
            require(np.array_equal(out["orig_idx"], ref["orig_idx"]),
                    f"image {i}: keypoints differ from the plain path")
            lerr = float(np.abs(out["lafs"] - ref["lafs"]).max())
            require(lerr == 0.0, f"image {i}: LAFs differ from the plain "
                    f"path by {lerr}")
            mine = lafs_to_ells(torch.from_numpy(out["lafs"]))
            require(len(ells) == len(out["resp"]) > 1000
                    and np.allclose(ells, mine.numpy(), rtol=0, atol=1e-9),
                    f"image {i}: the program's file differs from the run")
            log(f"image {i}: {len(ells)} regions of {NFEATS} (the gate's "
                f"survivors of 3000 after {BAUM_ITERS} iterations), "
                f"n_detected {out['n_detected']}; keypoints identical to "
                f"the plain path, LAF max |diff| {lerr}")
    per_img, per_plain = time_per_image([det, det_plain], imgs)
    ms = float(np.median(per_img))
    log(f"hesaffbaum_ms_per_image: median {ms:.3f} (all "
        f"{[round(x, 3) for x in per_img]}); plain path median "
        f"{np.median(per_plain):.3f}")
    log(f"phase hesaffbaum wall_s: {time.perf_counter() - t:.3f}")
    return dict(counts=counts, site=site, ms=ms)


def check_golden_onepass(device) -> None:
    """The reference's OnePassSIR golden (onepass_golden.npz) on the card:
    the dense map (atol 1e-4) and the 50-feature detector (the JAX test's
    tolerances, tests/test_onepass.py)."""
    g = np.load(os.path.join(FIXTURES, "onepass_golden.npz"))
    dense = AffNetFastFullConv.pretrained().to(device)
    with torch.inference_mode(), float32_math():
        got = dense(torch.from_numpy(g["img"]).to(device)).cpu().numpy()
    np.testing.assert_allclose(got, g["dense_map"], atol=1e-4)
    err = float(np.abs(got - g["dense_map"]).max())
    det = OnePassSIR(DetectorConfig(num_features=50, border=15,
                                    mr_size=5.192), device=device)
    out = det(g["img"])
    require(len(out["resp"]) == 50, "golden OnePassSIR: keypoint count")
    np.testing.assert_allclose(out["resp"], g["resp"], atol=0.1, rtol=1e-4)
    np.testing.assert_allclose(out["lafs"], g["lafs"], atol=1e-2)
    log(f"golden 120x160 OnePassSIR: dense map max |diff| {err:.3g} "
        "(atol 1e-4); detector within the JAX test's tolerances")


def phase_onepass(imgs, device) -> dict:
    """Phase 14: the OnePassSIR program (border 15, mrSize 5.192, the dense
    AffNet on each octave's level 0, the 3x boundary gate): the golden; B2's
    refine at every survivor of the first image, bit for bit; the
    program's ``main`` on each image (.npy) in top-k mode with SIFT (2000)
    and in threshold mode (th 28.41, OriNetFast32), the launches counted
    from 0 around each; keypoints against the plain path on the card; ms
    per image; the dense net's share of the extractor's device time."""
    t = time.perf_counter()
    check_golden_onepass(device)
    det = extract_geom.make_extractor(device=device)
    img0 = torch.from_numpy(imgs[0]).to(device)
    with torch.inference_mode(), float32_math():
        p = det._plan(*img0.shape)
        flat, resp = det._responses(img0, p)
        surv = torch.nonzero(resp > 0)[:, 0]
        refine = check_refine("refine_survivors", flat, surv,
                              p.refine_tables, det.cfg.effective_th)
        dense_ms = time_ms(lambda: det.shape_fields(p, flat), 5)
        levels0 = [lv[0].contiguous()[None, None]
                   for lv in pyramid_views(flat, p.plan)]
        norm_ms = time_ms(lambda: [local_norm_2d(x) for x in levels0], 5)
        run_ms = time_ms(lambda: det.run(img0), 5)
    torch.cuda.synchronize()
    log(f"onepass refine at every survivor: {surv.numel()} survivors of "
        f"image 0, bit-identical")
    log(f"onepass dense AffNet ({len(levels0)} octaves' fields, cuDNN "
        f"under nchw): device ms {dense_ms:.4f} of the top-k extraction's "
        f"{run_ms:.4f} per image (share {dense_ms / run_ms:.3f}); its "
        f"local_norm_2d (33x33 windows) {norm_ms:.4f}")
    res = dict(refine=refine, dense_ms=dense_ms, norm_ms=norm_ms,
               run_ms=run_ms, modes={})
    with tempfile.TemporaryDirectory() as tmp:
        paths = save_npy(tmp, imgs)
        for mode, flags in EXTRACT_GEOM_MODES.items():
            th = mode == "th_ori"
            reset_launch_counts()
            for i, path in enumerate(paths):
                extract_geom.main([path, os.path.join(tmp, f"{mode}{i}.ells"),
                                   *flags, "--save-lafs",
                                   os.path.join(tmp, f"{mode}{i}.npy")])
            torch.cuda.synchronize()
            counts = launch_counts()
            log(f"onepass {mode} path launches ({len(imgs)} images): "
                f"{json.dumps(counts)}")
            n = len(imgs)
            want = {"refine": n if th else 2 * n, "topk": 0 if th else n,
                    "patches": n}
            got = {k: counts[k] for k in want}
            require(got == want, f"onepass {mode}: launches {got}, expected "
                    f"{want}")
            for name in ("blur", "detect", "dedup"):
                require(counts[name] > 0, f"kernel {name} not launched on "
                        f"the onepass {mode} path")
            kw = dict(th=28.41, do_ori=True) if th else dict(
                descriptor="SIFT")
            runs = [extract_geom.make_extractor(device=device,
                                                use_kernels=uk, **kw)
                    for uk in (True, False)]
            call = dict(do_ori=th, describe=not th)
            for i, img in enumerate(imgs):
                lafs = np.load(os.path.join(tmp, f"{mode}{i}.npy"))
                out, ref = (d(img, **call) for d in runs)
                require(np.array_equal(out["orig_idx"], ref["orig_idx"])
                        and out["n_detected"] == ref["n_detected"],
                        f"onepass {mode} image {i}: keypoints differ from "
                        "the plain path")
                errs = {k: float(np.abs(out[k].astype(np.float32)
                                        - ref[k].astype(np.float32)).max())
                        for k in out if k not in ("orig_idx", "oct_idx",
                                                  "level_idx", "n_detected")}
                require(max(errs.values()) <= 1e-4, f"onepass {mode} image "
                        f"{i}: differs from the plain path {errs}")
                require(np.isfinite(lafs).all() and lafs.shape == (
                    len(out["resp"]), 2, 3) and np.allclose(
                    lafs, out["lafs"], rtol=0, atol=1e-5),
                    f"onepass {mode} image {i}: the program's LAFs differ "
                    "from the run")
                log(f"onepass {mode} image {i}: {len(lafs)} regions, "
                    f"{out['n_detected']} survivors past the 3x gate; "
                    f"keypoints identical to the plain path, max |diff| "
                    f"{errs}")
            per_img, per_plain = time_per_image(
                [functools.partial(d, **call) for d in runs], imgs)
            res["modes"][mode] = dict(counts=counts,
                                      ms=float(np.median(per_img)))
            log(f"onepass_{mode}_ms_per_image: median "
                f"{res['modes'][mode]['ms']:.3f} (all "
                f"{[round(x, 3) for x in per_img]}); plain path median "
                f"{np.median(per_plain):.3f}")
    log(f"phase onepass wall_s: {time.perf_counter() - t:.3f}")
    return res


# ---------------------------------------------------------------------------
# Phase 15: the inference programs (external keypoints, matching, stage
# timers, export)
# ---------------------------------------------------------------------------

N_KEYPOINTS = 8000                # a typical SIFT count on a 1080p image
EXPORT_BATCHES = (3000, 517)
PROFILE_KERNELS = ("blur_", "detect_stencil", "row_topm", "sample_patches")


def card_keypoints(seed: int, n: int, h: int, w: int) -> tuple:
    """n seeded keypoints (x, y, size, OpenCV angle): centres uniform over
    the image, sizes 2-30 px, and a quarter of them within 3 x size of a
    border (some outside the image)."""
    rng = np.random.RandomState(seed)
    size = rng.uniform(2.0, 30.0, n)
    x, y = rng.uniform(0, w, n), rng.uniform(0, h, n)
    near = np.nonzero(rng.rand(n) < 0.25)[0]
    off = rng.uniform(-1.0, 3.0, len(near)) * size[near]
    side = rng.randint(0, 4, len(near))
    x[near] = np.where(side == 0, off, np.where(side == 1, w - off,
                                                 x[near]))
    y[near] = np.where(side == 2, off, np.where(side == 3, h - off,
                                                 y[near]))
    return tuple(a.astype(np.float32) for a in
                 (x, y, size, rng.uniform(-180.0, 180.0, n)))


def keypoint_nets(device) -> list:
    """AffNetFast, OriNetFast32 and HardTFeatNet with the shipped weights,
    on the card."""
    return [pretrained(net, name).to(device).eval() for net, name in
            ((AffNetFast(), "AffNetFast"), (OriNetFast32(), "OriNetFast"),
             (HardTFeatNet(), "HardTFeatNet"))]


def check_keypoint_site(img, lafs, nets) -> dict:
    """B4 at the keypoint site (the image as a one-level buffer, PS 32) at
    each of process_keypoints' three stages: bit-identical to its plain
    version on that stage's LAFs; per-launch device ms (the three launches
    of one call, in order), each stage's bound, the plain version's and
    F.grid_sample's time on the same work, averaged over the three; the
    share of samples outside the image (B4's masked path)."""
    h, w = img.shape
    tables = batched_tables(1, h, w, img.device)
    lvl = torch.zeros(len(lafs), dtype=torch.int32, device=img.device)
    with torch.inference_mode():
        stage_lafs = [lafs,
                      keypoints.process_keypoints(img, lafs, nets[0])["lafs"],
                      keypoints.process_keypoints(img, lafs,
                                                  *nets[:2])["lafs"]]
    stage_lafs = [x.contiguous() for x in stage_lafs]
    outside = []
    for i, x in enumerate(stage_lafs):
        got = cuda_patches.extract_patches_cuda(img, x, lvl, *tables[1:])
        ref = extract_patches_from_flat_pyramid(img, x, lvl, *tables[1:])
        require(torch.equal(got, ref), f"patches (keypoint stage {i}): not "
                f"bit-identical, max err {float((got - ref).abs().max())}")
        u, v, _, hh, ww = _sample_positions(x, lvl, *tables[1:], 32, False)
        out = (u < 0) | (u > ww - 1) | (v < 0) | (v > hh - 1)
        outside.append((float(out.float().mean()),
                        float(out.flatten(1).any(1).float().mean())))
    require(min(o[1] for o in outside) > 0.1, "keypoint site: too few "
            f"patches reach past the image {outside}")

    def call():
        with torch.inference_mode():
            return keypoints.process_keypoints(img, lafs, *nets)

    per = kernel_times(call, "sample_patches", 3)
    work = [patch_work(img, x, lvl, tables[1:], 32) for x in stage_lafs]
    b4 = img[None, None]
    for i, (ms, (t, by, _), o) in enumerate(zip(per, work, outside)):
        log(f"  B4 keypoint stage {i}: ms {ms:.4f} bound_ms {t:.5f} ({by}); "
            f"samples outside the image {o[0]:.3f}, patches reaching past "
            f"it {o[1]:.3f}")
    bys = {by for _, by, _ in work}
    return dict(
        name="patches_keypoints", err=0.0, shape=(len(lafs), 32, 32),
        ms=sum(per) / 3,
        event_ms=event_median_ms(lambda: [
            cuda_patches.extract_patches_cuda(img, x, lvl, *tables[1:])
            for x in stage_lafs], 10) / 3,
        plain_ms=time_ms(lambda: [
            extract_patches_from_flat_pyramid(img, x, lvl, *tables[1:])
            for x in stage_lafs], 3) / 3,
        library_ms=time_ms(lambda: [F.grid_sample(
            b4, g, mode="bilinear", padding_mode="zeros",
            align_corners=False) for _, _, g in work], 5) / 3,
        bound_ms=sum(t for t, _, _ in work) / 3,
        bound_by=bys.pop() if len(bys) == 1 else "operations",
        per_launch=per, outside=outside)


def host_ms(fn, reps: int = 3) -> list:
    """Host-clock ms of ``reps`` warmed fn() calls, synchronized at both
    ends."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    return times


def warp_homography(img: torch.Tensor, seed: int) -> tuple:
    """A second view of ``img`` under a seeded homography H (view 1 -> 2:
    rotation within 10 degrees, scale 0.85-1.1, perspective up to 2e-5
    about the centre), made on the card with F.grid_sample (bilinear,
    zeros outside): (view 2, H as float32 numpy)."""
    rng = np.random.RandomState(seed)
    h, w = img.shape
    a = np.deg2rad(rng.uniform(-10, 10))
    s = rng.uniform(0.85, 1.1)
    core = np.array([[s * np.cos(a), -s * np.sin(a), 0.0],
                     [s * np.sin(a), s * np.cos(a), 0.0],
                     [rng.uniform(-2e-5, 2e-5), rng.uniform(-2e-5, 2e-5),
                      1.0]])
    c = np.array([[1.0, 0.0, w / 2], [0.0, 1.0, h / 2], [0.0, 0.0, 1.0]])
    H = c @ core @ np.linalg.inv(c)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64),
                            torch.arange(w, dtype=torch.float64),
                            indexing="ij")
    pts = torch.from_numpy(np.linalg.inv(H)) @ torch.stack(
        [xs.ravel(), ys.ravel(), torch.ones(h * w, dtype=torch.float64)])
    u, v = pts[0] / pts[2], pts[1] / pts[2]
    grid = torch.stack([(2 * u + 1) / w - 1, (2 * v + 1) / h - 1], -1)
    view = F.grid_sample(img[None, None], grid.reshape(1, h, w, 2).float()
                         .to(img.device), mode="bilinear",
                         padding_mode="zeros", align_corners=False)[0, 0]
    return view.contiguous(), H.astype(np.float32)


def check_snn_card_cpu(d1: np.ndarray, d2: np.ndarray, device) -> dict:
    """snn_match on the card against the CPU on the same descriptors: the
    nearest neighbours and masks equal wherever the ratio is not within
    1e-5 of the threshold; the disagreements there are counted."""
    got = [t.cpu().numpy() for t in match.snn_match(
        torch.from_numpy(d1).to(device), torch.from_numpy(d2).to(device))]
    ref = [t.numpy() for t in match.snn_match(torch.from_numpy(d1),
                                              torch.from_numpy(d2))]
    near = np.abs(ref[3] - 0.8) <= 1e-5
    bad = ((got[0] != ref[0]) | (got[1] != ref[1])) & ~near
    require(not bad.any(), f"snn_match: {int(bad.sum())} rows differ "
            "between the card and the CPU away from the threshold")
    differ = int(((got[0] != ref[0]) | (got[1] != ref[1])).sum())
    return dict(rows=len(d1), near_threshold=int(near.sum()),
                disagree=differ,
                ratio_err=float(np.abs(got[3] - ref[3]).max()))


def phase_apps(imgs, device, seed: int) -> dict:
    """Phase 15: the inference programs on the 1080p images.  B4 at the
    keypoint site (8000 seeded keypoints, AffNetFast, OriNetFast32,
    HardTFeatNet): each launch bit-identical, 3 launches per call, the
    outputs against the plain path on the card; describe_keypoints over
    the images with the launches counted from 0; the describe_keypoints
    program's main on a .npy image; eval_graf's evaluate_pair (3000
    features, AffNetFast, SIFT) and match_demo's match_images (2000) on an
    image and its seeded homography warp, B1-B4 launched, snn_match card
    against CPU; profile_pipeline's main with --runs 3 --trace; the export
    round trip of AffNetFast and HardTFeatNet."""
    t = time.perf_counter()
    res = {}
    nets = keypoint_nets(device)
    img0 = torch.from_numpy(imgs[0]).to(device)
    kps = [card_keypoints(seed + i, N_KEYPOINTS, H, W)
           for i in range(len(imgs))]
    lafs0 = keypoints.lafs_from_keypoints(*kps[0], (H, W)).to(device)
    res["site"] = check_keypoint_site(img0, lafs0, nets)
    with torch.inference_mode():
        out = keypoints.process_keypoints(img0, lafs0, *nets)
        ref = keypoints.process_keypoints(img0, lafs0, *nets,
                                          use_kernels=False)
    errs = {k: float((out[k] - ref[k]).abs().max()) for k in ref}
    require(max(errs.values()) <= 1e-5, "process_keypoints: differs from "
            f"the plain path on the card (tolerance 1e-5) {errs}")
    log(f"process_keypoints ({N_KEYPOINTS} keypoints, 1080p): outputs "
        f"against the plain path on the card, max |diff| {errs} "
        "(tolerance 1e-5)")
    with torch.inference_mode():
        dev_ms = time_ms(lambda: keypoints.process_keypoints(
            img0, lafs0, *nets), 5)
    reset_launch_counts()
    outs = [keypoints.describe_keypoints(img, *kp, shape_net=nets[0],
                                         ori_net=nets[1], desc_net=nets[2],
                                         device=device)
            for img, kp in zip(imgs, kps)]
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"describe_keypoints path launches ({len(imgs)} images): "
        f"{json.dumps(counts)}")
    require(counts["patches"] == 3 * len(imgs) and all(
        v == 0 for k, v in counts.items() if k != "patches"),
        f"describe_keypoints: launches {counts}, expected 3 B4 per call "
        "and nothing else")
    for o in outs:
        require(o["descs"].shape == (N_KEYPOINTS, 128)
                and np.isfinite(o["descs"]).all() and np.allclose(
                    np.linalg.norm(o["descs"], axis=1), 1.0, atol=1e-4),
                "describe_keypoints: descriptors not finite unit vectors")
    per_call = host_ms(lambda: keypoints.describe_keypoints(
        imgs[0], *kps[0], shape_net=nets[0], ori_net=nets[1],
        desc_net=nets[2], device=device))
    res.update(counts=counts, device_ms=dev_ms,
               ms=float(np.median(per_call)))
    log(f"describe_keypoints_ms_per_call: median {res['ms']:.3f} (all "
        f"{[round(x, 3) for x in per_call]}); process_keypoints device ms "
        f"{dev_ms:.4f}")

    with tempfile.TemporaryDirectory() as tmp:
        npy, kp_txt = os.path.join(tmp, "img.npy"), os.path.join(tmp, "k.txt")
        np.save(npy, imgs[0])
        np.savetxt(kp_txt, np.stack(kps[0], 1))
        lafs_txt, descs = os.path.join(tmp, "l.txt"), os.path.join(tmp,
                                                                   "d.npy")
        describe_keypoints.main([npy, kp_txt, lafs_txt, "--descs", descs])
        rows, d = np.loadtxt(lafs_txt), np.load(descs)
        require(rows.shape == (N_KEYPOINTS, 7) and np.isfinite(rows).all()
                and d.shape == (N_KEYPOINTS, 128) and np.isfinite(d).all()
                and np.allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-4),
                "describe_keypoints program: bad output files")
        log(f"describe_keypoints program: {len(rows)} rows of 7 columns and "
            "unit-norm descriptors")

        view2, Hm = warp_homography(img0, seed)
        img2 = view2.cpu().numpy()
        det = eval_graf.make_extractor(device=device)
        demo = match_demo.make_extractor(device=device)
        reset_launch_counts()
        n_tent, n_true, ratio, t1, _, _ = eval_graf.evaluate_pair(
            det, imgs[0], img2, Hm)
        m1, _, _, _ = match_demo.match_images(demo, imgs[0], img2)
        torch.cuda.synchronize()
        counts = launch_counts()
        log(f"matching path launches (evaluate_pair and match_images): "
            f"{json.dumps(counts)}")
        for name in EXTRACTION_KERNELS:
            require(counts[name] > 0, f"kernel {name} not launched on the "
                    "matching path")
        require(n_true >= 20, f"evaluate_pair: {n_tent} tentatives, only "
                f"{n_true} true matches")
        pair_ms = host_ms(lambda: eval_graf.evaluate_pair(det, imgs[0], img2,
                                                          Hm))
        demo_ms = host_ms(lambda: match_demo.match_images(demo, imgs[0],
                                                          img2))
        d1 = det(imgs[0], describe=True)["descs"]
        d2 = det(img2, describe=True)["descs"]
        snn = check_snn_card_cpu(d1, d2, device)
        res["matching"] = dict(counts=counts, tentatives=n_tent,
                               true=n_true, ratio=ratio,
                               demo_tentatives=len(m1),
                               ms=float(np.median(pair_ms)),
                               demo_ms=float(np.median(demo_ms)), snn=snn)
        log(f"eval_graf evaluate_pair (3000 features, AffNetFast, SIFT) on "
            f"image 0 and its homography warp: {n_tent} tentatives {n_true} "
            f"true matches {ratio:.4f} inl.ratio; ms per pair median "
            f"{res['matching']['ms']:.3f} (all "
            f"{[round(x, 3) for x in pair_ms]})")
        log(f"match_demo match_images (2000 features): {len(m1)} tentatives;"
            f" ms per pair median {res['matching']['demo_ms']:.3f}")
        log(f"snn_match card against CPU on {snn['rows']} x {len(d2)} "
            f"descriptors: {snn['disagree']} rows differ, "
            f"{snn['near_threshold']} rows within 1e-5 of the threshold, "
            f"ratio max |diff| {snn['ratio_err']:.3g}")

        trace = os.path.join(tmp, "trace")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            timer = profile_pipeline.main([npy, "--runs", "3", "--trace",
                                           trace])
        printed = buf.getvalue().splitlines()
        for line in printed:
            log(f"  profile_pipeline: {line}")
        require(timer.counts == dict.fromkeys(profile_pipeline.STAGES, 3)
                and all(any(ln.startswith(f"{s}: ") for ln in printed)
                        for s in profile_pipeline.STAGES),
                "profile_pipeline: stage lines missing")
        traces = [os.path.join(trace, f) for f in os.listdir(trace)]
        require(len(traces) == 1, f"profile_pipeline: {traces}")
        with open(traces[0]) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
        missing = [k for k in PROFILE_KERNELS
                   if not any(k in n for n in names)]
        require(not missing, f"profile_pipeline trace lacks {missing}")
        res["profile"] = {s: 1e3 * timer.totals[s] / timer.counts[s]
                          for s in profile_pipeline.STAGES}
        log(f"profile_pipeline trace: {os.path.getsize(traces[0])} bytes, "
            f"names {list(PROFILE_KERNELS)}")

    res["export"] = {}
    for net, name in zip((nets[0], nets[2]), ("AffNetFast", "HardTFeatNet")):
        t1 = time.perf_counter()
        loaded = export.load_exported(export.export_patch_net(net))
        export_s = time.perf_counter() - t1
        errs = []
        for n in EXPORT_BATCHES:
            x = torch.rand((n, 32, 32), device=device,
                           generator=torch.Generator(device).manual_seed(n))
            with torch.no_grad(), float32_math():
                errs.append(float((loaded(x) - net(x)).abs().max()))
        require(max(errs) <= 1e-6, f"export {name}: {errs}")
        res["export"][name] = errs
        log(f"export {name}: exported and reloaded on the card in "
            f"{export_s:.2f} s; max |diff| against the module at batches "
            f"{EXPORT_BATCHES}: {errs} (tolerance 1e-6)")
    log(f"phase apps wall_s: {time.perf_counter() - t:.3f}")
    return res


# ---------------------------------------------------------------------------
# Phase 16: the trainers (the published pipeline, OriNet, triplets)
# ---------------------------------------------------------------------------

TRAINER_CLASSES, TRAINER_VIEWS = 2048, 4
TRAINER_BATCH = 1024
TRAINER_STEPS = TRAIN_WARMUP + TRAIN_TIMED
# B5 launches per step of each run: (forwards at PS 64, at PS 32, backwards).
TRAINER_B5 = {"descriptor": (0, 0, 0), "affnet": (2, 1, 1),
              "orinet": (1, 1, 1), "triplet": (3, 1, 1)}


def trainer_images(seed: int) -> list:
    """Four 640x800 training images from the committed graf fixture: rolled,
    every other one flipped, with seeded noise (float64, as
    ``load_train_images`` returns images)."""
    base = np.load(os.path.join(FIXTURES, "detector_golden_fullres.npz"))["img"]
    out = []
    for i in range(4):
        rng = np.random.RandomState(seed + 100 + i)
        img = np.roll(base, (rng.randint(base.shape[0]),
                             rng.randint(base.shape[1])), axis=(0, 1))
        if i % 2:
            img = img[:, ::-1]
        out.append(np.clip(img + rng.normal(0.0, 2.0, img.shape), 0, 255))
    return out


def make_dataroot(root: str, seed: int) -> tuple:
    """A PhotoTour-format --dataroot: the multi-image synthetic classes of
    the fixture images (2048 classes x 4 views, 64x64), split into two
    caches of 1024 classes: an npz and a reference-format .pt, a pickled
    (patches (N, 1, 64, 64), labels) pair, so load_total_datasets and
    convert_pt_cache both run.  Returns (patches, labels) as the trainers
    read them."""
    patches, labels = synthetic_pairs_from_images(
        trainer_images(seed), n_classes=TRAINER_CLASSES,
        views_per_class=TRAINER_VIEWS, seed=seed)
    half = len(patches) // 2
    np.savez(os.path.join(root, "a_synthetic.npz"), patches=patches[:half],
             labels=labels[:half])
    torch.save((torch.from_numpy(patches[half:, None]),
                torch.from_numpy(labels[half:] - labels[half])),
               os.path.join(root, "b_synthetic.pt"))
    return patches, labels


def run_trainer(kind: str, main, argv: list, net_cls, log_dir: str,
                tag: str = "") -> dict:
    """One training program's main on the card over TRAINER_STEPS batches
    of 1024 (--n-pairs sized to them, so the cut is in the data), its
    dataset timed (TimedBatches).  Checks: finite losses; every parameter
    and BatchNorm statistic finite and moved from the seeded init; exactly
    TRAINER_B5[kind] B5 launches per step and no other kernel; the
    checkpoint read back through load_checkpoint into a fresh net, equal to
    the trained one.  ms per step: host clock over steps 3-12,
    synchronized, / 10.  ``tag`` marks the run's log lines."""
    modules = (train_affnet, train_orinet, train_descriptor)
    real = train_affnet.make_dataset
    timed = {}

    def timed_dataset(args):
        timed["ds"] = TimedBatches(real(args), TRAIN_WARMUP)
        return timed["ds"]

    saved = [m.make_dataset for m in modules]
    for m in modules:
        m.make_dataset = timed_dataset
    try:
        reset_launch_counts()
        t0 = time.perf_counter()
        state = main(argv + [
            "--log-dir", log_dir, "--batch-size", str(TRAINER_BATCH),
            "--n-pairs", str(TRAINER_STEPS * TRAINER_BATCH), "--epochs",
            "1", "--no-eval"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        for m, f in zip(modules, saved):
            m.make_dataset = f
    log(f"trainer {kind}{tag}: launches ({TRAINER_STEPS} steps) "
        f"{json.dumps(counts)}")
    require(state.step == TRAINER_STEPS, f"trainer {kind}{tag}: {state.step} "
            "steps")
    n64, n32, nb = (TRAINER_STEPS * k for k in TRAINER_B5[kind])
    require(counts.get("batched_fwd_ps64", 0) == n64
            and counts.get("batched_fwd_ps32", 0) == n32
            and counts["batched_fwd"] == n64 + n32
            and counts["batched_bwd"] == nb
            and all(v == 0 for k, v in counts.items()
                    if not k.startswith("batched_")),
            f"trainer {kind}{tag}: launches {counts}, expected {TRAINER_B5[kind]}"
            " per step")
    (run_dir,) = [os.path.join(log_dir, d) for d in os.listdir(log_dir)]
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        losses = [json.loads(line)["loss"] for line in f]
    require(len(losses) == 2 and bool(np.isfinite(losses).all()),
            f"trainer {kind}{tag}: losses {losses}")
    trained = {k: v.cpu() for k, v in state.model.state_dict().items()
               if v.is_floating_point()}
    init = init_params(net_cls(), torch.Generator().manual_seed(0),
                       gain=net_cls.init_gain).state_dict()
    for name, val in trained.items():
        require(bool(torch.isfinite(val).all()), f"{kind}: {name} not finite")
        require(not torch.equal(val, init[name]), f"{kind}: {name} did not "
                "move")
    ckpt = os.path.join(run_dir, "checkpoint_0.npz")
    tree, epoch = load_checkpoint(ckpt)
    back = net_cls()
    back.load_state_dict(params_from_jax(tree))
    require(epoch == 1 and all(torch.equal(v, trained[k]) for k, v in
                               back.state_dict().items() if k in trained),
            f"trainer {kind}{tag}: the checkpoint does not hold the trained net")
    ds = timed["ds"]
    step_ms = ds.step_ms()
    require(len(step_ms) == TRAINER_STEPS, f"{len(step_ms)} step times")
    ms = ds.window_s * 1e3 / TRAIN_TIMED
    log(f"trainer {kind}{tag}: ms_per_step {ms:.3f} (host clock over steps "
        f"{TRAIN_WARMUP}..{TRAINER_STEPS - 1}, synchronized, / "
        f"{TRAIN_TIMED}); pairs_per_s {TRAINER_BATCH / ms * 1e3:.1f}; per "
        f"step on the card's stream (CUDA events) median "
        f"{float(np.median(step_ms[TRAIN_WARMUP:])):.3f}; losses "
        f"{[round(x, 5) for x in losses]}; main wall_s {wall:.3f}")
    return dict(state=state, counts=counts, losses=losses, ms=ms, ckpt=ckpt,
                step_ms=step_ms[TRAIN_WARMUP:], wall_s=wall)


def _rewarp_lafs(shapes: torch.Tensor, h: int) -> torch.Tensor:
    """warp_by_predicted_transform's PS 32 LAFs for (N, 2, 2) shapes on
    h x h patches."""
    base = torch.tensor([[0.5, 0.0, 0.5], [0.0, 0.5, 0.5]],
                        device=shapes.device).expand(len(shapes), 2, 3)
    return torch.cat([(32 / h) * (shapes @ base[:, :, :2]),
                      base[:, :, 2:]], 2).contiguous()


def check_new_b5_sites(ori_model, trip_model, pairs, triplets, seed) -> dict:
    """B5 at this phase's new sites, on a batch of the runs' data and the
    trained nets' predictions (copies, in train mode as in the steps): the
    OriNet step's PS 64 warp of the anchors by rotation x scale with
    shifts, its PS 32 rewarp of the 2N patches by the predicted rotations;
    the triplet step's PS 64 warp of the negatives, its PS 32 rewarp of
    3N.  Each forward bit-identical to its plain version and timed beside
    it, affine_grid + grid_sample and its bound (check_batched_fwd); the
    rewarps' backward: LAF cotangent equal to its replay and against
    autograd (check_batched_bwd)."""
    dev = pairs[0].device
    n, h, _ = pairs[0].shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    res = {}
    lafs64 = orinet_lafs(draw_orinet(n, gen), h, h).contiguous()
    res["batched_fwd_ori_ps64"] = check_batched_fwd(pairs[0], lafs64, h)
    rot = cuda_patches.sample_batched_cuda(
        pairs[0].reshape(n * h, h), lafs64, batched_tables(n, h, h, dev), h,
        False)
    st = (h - 32) // 2
    net = copy.deepcopy(ori_model)
    with torch.no_grad():
        R = torch.cat([net(x[:, st:st + 32, st:st + 32])
                       for x in (rot, pairs[1])])
    full = torch.cat([rot, pairs[1]])
    res["batched_fwd_ori_ps32"] = check_batched_fwd(full, _rewarp_lafs(R, h),
                                                    32)
    res["batched_bwd_ori"] = check_batched_bwd(full, _rewarp_lafs(R, h),
                                               seed)

    lafs = draw_affnet_lafs(n, tilt_for_epoch(0), gen, True, negative=True)
    res["batched_fwd_triplet_ps64"] = check_batched_fwd(triplets[2],
                                                        lafs[2], h)
    fulls = [cuda_patches.sample_batched_cuda(
        x.reshape(n * h, h), laf, batched_tables(n, h, h, dev), h, False)
        for x, laf in zip(triplets, lafs)]
    net = copy.deepcopy(trip_model)
    with torch.no_grad():
        A = torch.cat([net(x[:, st:st + 32, st:st + 32]) for x in fulls])
    full = torch.cat(fulls)
    res["batched_fwd_triplet_ps32"] = check_batched_fwd(
        full, _rewarp_lafs(A, h), 32)
    res["batched_bwd_triplet"] = check_batched_bwd(full, _rewarp_lafs(A, h),
                                                   seed)
    for key, r in res.items():
        r["name"] = key
    return res


def check_eval_hook(patches, labels, desc_params, device, seed) -> dict:
    """train_loop for one epoch of 3 steps at batch 1024 (AffNetFast,
    HardNegC against the trained HardNet) with an eval_fn that runs
    eval_graf.evaluate_pair (1000 features, the epoch's net as the shape
    net, SIFT) on the 640x800 fixture and its seeded homography warp: the
    hook is called once, after the epoch, with the live net in eval mode,
    and B1-B4 launch inside it."""
    img = np.load(os.path.join(FIXTURES, "detector_golden_fullres.npz"))["img"]
    view2, Hm = warp_homography(torch.from_numpy(img).to(device), seed)
    view2 = view2.cpu().numpy()
    calls = []

    def hook(model, epoch):
        det = ScaleSpaceAffinePatchExtractor(
            DetectorConfig(num_features=1000, border=5, mr_size=5.192,
                           num_baum_iters=1, patch_size=32),
            shape_net=model, desc_net=SIFTNet(patch_size=32), device=device)
        reset_launch_counts()
        n_tent, n_true, ratio, _, _, _ = eval_graf.evaluate_pair(
            det, img, view2, Hm)
        torch.cuda.synchronize()
        calls.append(dict(epoch=epoch, model=model, training=model.training,
                          counts=launch_counts(), tentatives=n_tent,
                          true=n_true, ratio=ratio))

    cfg = dataclasses.replace(TRAIN_CFG, descriptor="HardNet", seed=seed,
                              total_epochs=None)
    ds = DevicePairDataset(PairDataset(patches, labels,
                                       n_pairs=3 * cfg.batch_size,
                                       batch_size=cfg.batch_size,
                                       seed=seed + 2), device)
    with tempfile.TemporaryDirectory() as log_dir:
        state = train_loop(AffNetFast(), ds, cfg, log_dir=log_dir,
                           desc_params=desc_params, device=device,
                           eval_fn=hook)
    require(len(calls) == 1 and calls[0]["epoch"] == 0
            and calls[0]["model"] is state.model
            and not calls[0]["training"] and state.model.training,
            f"eval hook: calls {[(c['epoch'], c['training']) for c in calls]}")
    c = calls[0]
    require(all(c["counts"][k] > 0 for k in EXTRACTION_KERNELS),
            f"eval hook: B1-B4 did not all launch {c['counts']}")
    log(f"eval hook (train_loop, 3 steps, then evaluate_pair at 1000 "
        f"features on the fixture and its warp): {c['tentatives']} "
        f"tentatives, {c['true']} true, ratio {c['ratio']:.4f}; launches "
        f"{json.dumps(c['counts'])}")
    return c


def phase_trainers(device, seed: int, tmp: str) -> dict:
    """Phase 16, in the directory ``tmp`` (its dataroot and checkpoints
    serve phase 17): the published pipeline (run_me.sh:22-31) through the
    training programs' main at batch 1024, 13 steps each: HardNet from
    scratch (train_descriptor, lr 0.1, no B5), AffNet against that
    checkpoint (train_affnet, HardNegC, lr 0.005), the OriNet trainer at
    its defaults against it (train_orinet), and the triplet trainer
    (train_affnet --loss random_sampling, TripletDataset); B5 at the new
    sites against its plain version; one OriNet and one triplet step
    against the plain path on the card; the per-epoch eval hook."""
    t = time.perf_counter()
    res = {}
    root = os.path.join(tmp, "6Brown")
    os.makedirs(root)
    patches, labels = make_dataroot(root, seed)
    log(f"trainers: {len(patches)} patches of {TRAINER_CLASSES} classes "
        f"(.npz + .pt) in {time.perf_counter() - t:.3f} s")
    data = ["--dataroot", root]
    res["descriptor"] = run_trainer(
        "descriptor", train_descriptor.main, data + [
            "--arch", "HardNet", "--loss", "HardNet", "--lr", "0.1"],
        HardNet, os.path.join(tmp, "desc"))
    require(os.path.exists(os.path.join(root, "b_synthetic.npz")),
            "convert_pt_cache wrote no npz")
    hardnet = ["--descriptor", "HardNet", "--desc-weights",
               res["descriptor"]["ckpt"]]
    res["affnet"] = run_trainer(
        "affnet", train_affnet.main, data + hardnet + [
            "--loss", "HardNegC", "--lr", "0.005"],
        AffNetFast, os.path.join(tmp, "affnet"))
    res["orinet"] = run_trainer("orinet", train_orinet.main,
                                data + hardnet, OriNetFast32,
                                os.path.join(tmp, "orinet"))
    res["triplet"] = run_trainer(
        "triplet", train_affnet.main, data + hardnet + [
            "--loss", "random_sampling", "--lr", "0.005"],
        AffNetFast, os.path.join(tmp, "triplet"))
    desc_params, _ = load_checkpoint(res["descriptor"]["ckpt"])
    res["root"], res["patches"], res["labels"] = root, patches, labels
    log(f"phase trainers runs wall_s: {time.perf_counter() - t:.3f}")

    t = time.perf_counter()
    pairs = next(iter(DevicePairDataset(PairDataset(
        patches, labels, n_pairs=TRAINER_BATCH, batch_size=TRAINER_BATCH,
        seed=seed + 1), device).batches()))
    triplets = tuple(torch.from_numpy(x).to(device) for x in next(iter(
        TripletDataset(patches, labels, TRAINER_BATCH, TRAINER_BATCH,
                       seed=seed + 1).batches())))
    res["sites"] = check_new_b5_sites(res["orinet"]["state"].model,
                                      res["triplet"]["state"].model,
                                      pairs, triplets, seed)
    desc_fn = make_descriptor("HardNet", desc_params, device)
    for kind, make_step, batch in (("orinet", make_orinet_train_step, pairs),
                                   ("triplet", make_affnet_train_step,
                                    triplets)):
        st = res[kind]["state"]
        cfg = TrainConfig(arch=type(st.model).__name__, descriptor="HardNet",
                          loss="HardNet" if kind == "orinet"
                          else "random_sampling", lr=0.005,
                          batch_size=TRAINER_BATCH,
                          n_pairs=TRAINER_STEPS * TRAINER_BATCH, epochs=1)
        ps = check_plain_step(st, desc_fn, cfg, batch, make_step,
                              TRAINER_B5[kind])
        res[kind]["plain_step"] = ps
        log(f"trainer {kind}: plain-path step on the card: loss "
            f"{ps['loss']:.7f} vs {ps['loss_plain']:.7f}; max |diff| / max "
            f"|value|: grads {ps['grads']:.3g}, params {ps['params']:.3g}; "
            f"BN statistics max |diff| {ps['stats']:.3g}")
    log(f"phase trainers checks wall_s: {time.perf_counter() - t:.3f}")
    t = time.perf_counter()
    res["hook"] = check_eval_hook(patches, labels, desc_params, device, seed)
    log(f"phase trainers eval hook wall_s: {time.perf_counter() - t:.3f}")
    return res


# ---------------------------------------------------------------------------
# Phase 17: data parallelism
# ---------------------------------------------------------------------------

PARALLEL_STEPS = 3
# B5 launches per AffNet step and rank: (forwards at PS 64, at PS 32,
# backwards), as on one card.
PARALLEL_B5 = TRAINER_B5["affnet"]


def _param_update_errs(got: dict, ref: dict, start: dict) -> tuple:
    """(largest |got - ref| of a parameter over the largest magnitude of its
    one-process update, largest |got - ref| of a BatchNorm statistic)."""
    upd, stats = 0.0, 0.0
    for key, r in ref.items():
        err = float(np.abs(got[key] - r).max())
        if "running" in key:
            stats = max(stats, err)
        else:
            scale = float(np.abs(r - start[key]).max())
            require(scale > 0, f"sharded steps: {key} did not move")
            upd = max(upd, err / scale)
    return upd, stats


def check_sharded_steps(patches, labels, device, seed, ranks_device) -> dict:
    """AffNet steps at batch 1024 (HardNegC against the frozen
    HardTFeatNet, phase 6's configuration; dropout on) through
    parallel.run_steps on two ranks of ``ranks_device`` ("cuda:0": both
    on the one card over gloo; "cuda": a card each over NCCL) against the
    same steps in one process on the card.  One step: loss rtol 1e-5 and
    BatchNorm statistics atol 1e-6 (the CPU tests' tolerances,
    tests/test_torch_parallel.py), every parameter within 1e-2 of its
    one-process update (the CPU tests hold 2e-3 at batch 16; at 1024 the
    hardest of 1023 negatives is a near tie for more anchors, and a tie
    that rounding flips moves that anchor's share of the gradient:
    measured 4.3e-3); then PARALLEL_STEPS steps from the same start:
    losses rtol 1e-5 (the parameters drift apart through the loss's
    hardest negatives, whose choice flips under rounding: logged), B5
    launched PARALLEL_B5 times per step on each rank and nothing else, ms
    per step on each side.  Both ranks end equal in every case."""
    cfg = dataclasses.replace(TRAIN_CFG, seed=seed)
    batches = list(PairDataset(patches, labels,
                               n_pairs=PARALLEL_STEPS * cfg.batch_size,
                               batch_size=cfg.batch_size,
                               seed=seed + 3).batches())
    net = init_params(AffNetFast(), torch.Generator().manual_seed(seed))
    start = {k: v.numpy() for k, v in net.state_dict().items()
             if v.is_floating_point()}
    case = dict(mode="affnet", arch="AffNetFast", cfg=cfg,
                start=params_to_jax(net.state_dict()),
                desc_params=load_pretrained("HardTFeatNet"))
    cases = [dict(case, batches=batches[:1]), dict(case, batches=batches)]
    t = time.perf_counter()
    one = parallel.run_steps(0, device, None, cases)
    t_one = time.perf_counter() - t
    t = time.perf_counter()
    two = parallel.spawn(parallel.run_steps, 2, ranks_device, args=(cases,))
    t_two = time.perf_counter() - t
    upd, stats = _param_update_errs(two[0]["state"], one[0]["state"], start)
    upd3, stats3 = _param_update_errs(two[1]["state"], one[1]["state"],
                                      start)
    loss_rel = max(abs(a - b) / abs(b) for k in (0, 1)
                   for a, b in zip(two[k]["losses"], one[k]["losses"]))
    log(f"sharded AffNet steps ({ranks_device}, 2 ranks x "
        f"{cfg.batch_size // 2}): one step: parameters max |diff| / update "
        f"{upd:.3g}, BN statistics max |diff| {stats:.3g}; "
        f"{PARALLEL_STEPS} steps: losses {two[1]['losses']} vs one process "
        f"{one[1]['losses']} (max rel over both runs {loss_rel:.3g}), "
        f"parameters {upd3:.3g}, statistics {stats3:.3g}; ranks differ by "
        f"{two[0]['rank_spread']}, {two[1]['rank_spread']}; ms per step "
        f"(host clock, loss read back) two ranks "
        f"{[round(x, 3) for x in two[1]['step_ms']]}, one process "
        f"{[round(x, 3) for x in one[1]['step_ms']]}; wall_s {t_two:.3f} "
        f"(spawn included) vs {t_one:.3f}; rank 0 launches "
        f"({PARALLEL_STEPS} steps) {json.dumps(two[1]['counts'])}")
    require(loss_rel <= 1e-5, f"sharded steps: losses {two} vs {one}")
    require(upd <= 1e-2 and stats <= 1e-6, f"sharded step: parameters "
            f"{upd}, statistics {stats}")
    require(two[0]["rank_spread"] == 0.0 and two[1]["rank_spread"] == 0.0,
            "sharded steps: the ranks' parameters differ")
    n64, n32, nb = (PARALLEL_STEPS * k for k in PARALLEL_B5)
    for who, r in (("rank 0", two[1]), ("one process", one[1])):
        c = r["counts"]
        require(c.get("batched_fwd_ps64", 0) == n64
                and c.get("batched_fwd_ps32", 0) == n32
                and c["batched_bwd"] == nb
                and all(v == 0 for k, v in c.items()
                        if not k.startswith("batched_")),
                f"sharded steps, {who}: launches {c}")
    return dict(one=one[1], two=two[1], loss_rel=loss_rel, update_err=upd,
                stats_err=stats, update_err_steps=upd3,
                stats_err_steps=stats3, counts=two[1]["counts"],
                step_ms=float(np.median(two[1]["step_ms"][1:])),
                one_step_ms=float(np.median(one[1]["step_ms"][1:])))


def check_program_pipeline(imgs, device) -> dict:
    """The HesAffNet program's bulk mode with --mesh 2 on three same-size
    1080p images (.npy): the images dealt over min(2, cards) cards
    (parallel.make_sharded_image_pipeline), the count of cards on stderr,
    files equal byte for byte to --mesh 1's (one card), B1-B4 launched as
    often as under --mesh 1; ms per image of each."""
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = save_npy(tmp, imgs)
        for mesh in (1, 2):
            err = io.StringIO()
            reset_launch_counts()
            t = time.perf_counter()
            with contextlib.redirect_stderr(err):
                hesaffnet.main([",".join(paths), os.path.join(
                    tmp, f"m{mesh}.ells"), "--do-ori", "--mesh", str(mesh)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            cards = min(mesh, torch.cuda.device_count())
            require(f"--mesh {mesh}: {cards} card(s)" in err.getvalue(),
                    f"--mesh {mesh}: stderr {err.getvalue()!r}")
            files = []
            for i in range(len(imgs)):
                with open(os.path.join(tmp, f"m{mesh}_{i}.ells"), "rb") as f:
                    files.append(f.read())
            res[mesh] = dict(counts=launch_counts(), files=files,
                             ms_per_image=wall * 1e3 / len(imgs),
                             cards=cards)
    require(res[2]["files"] == res[1]["files"],
            "hesaffnet --mesh 2: files differ from --mesh 1's")
    require(res[2]["counts"] == res[1]["counts"]
            and all(res[2]["counts"][k] > 0 for k in EXTRACTION_KERNELS),
            f"hesaffnet --mesh 2 launches {res[2]['counts']} vs "
            f"{res[1]['counts']}")
    log(f"hesaffnet --mesh 2 on {len(imgs)} images ({res[2]['cards']} "
        f"card(s)): files equal to --mesh 1's; ms per image (main, host "
        f"clock, model load included) {res[2]['ms_per_image']:.3f} vs "
        f"{res[1]['ms_per_image']:.3f}; launches "
        f"{json.dumps(res[2]['counts'])}")
    return res


def phase_parallel(imgs, trainers, device, seed: int, tmp: str) -> dict:
    """Phase 17: data parallelism on the card.  Two gloo ranks sharing
    cuda:0 run PARALLEL_STEPS AffNet steps at batch 1024 against one
    process (and, with two or more cards, a card per rank under NCCL); B5
    at a rank's shapes (512 anchors, the rewarp of 1024) against its plain
    version; train_descriptor, train_affnet and train_orinet through main
    --mesh 1 (a group of one under NCCL) as in phase 16, their first loss
    equal to phase 16's and ms per step beside it; the HesAffNet program
    with --mesh 2."""
    t = time.perf_counter()
    patches, labels = trainers["patches"], trainers["labels"]
    res = {"gloo": check_sharded_steps(patches, labels, device, seed,
                                       "cuda:0")}
    if torch.cuda.device_count() >= 2:
        res["nccl"] = check_sharded_steps(patches, labels, device, seed,
                                          "cuda")
    else:
        log("sharded AffNet steps, a card per rank under NCCL: not run "
            f"({torch.cuda.device_count()} card)")
    half = TRAIN_CFG.batch_size // 2
    batch = tuple(torch.from_numpy(x[:half]).to(device) for x in next(iter(
        PairDataset(patches, labels, TRAIN_CFG.batch_size,
                    TRAIN_CFG.batch_size, seed=seed + 3).batches())))
    sites = phase_train_kernels(batch, seed)
    for key, r in sites.items():
        r["name"] = key.replace("batched_", "batched_sharded_")
    res["sites"] = sites
    log(f"phase parallel steps wall_s: {time.perf_counter() - t:.3f}")

    t = time.perf_counter()
    data = ["--dataroot", trainers["root"], "--mesh", "1"]
    hardnet = ["--descriptor", "HardNet", "--desc-weights",
               trainers["descriptor"]["ckpt"]]
    runs = {"descriptor": (train_descriptor.main, [
                "--arch", "HardNet", "--loss", "HardNet", "--lr", "0.1"],
                HardNet),
            "affnet": (train_affnet.main, hardnet + [
                "--loss", "HardNegC", "--lr", "0.005"], AffNetFast),
            "orinet": (train_orinet.main, hardnet, OriNetFast32)}
    res["mesh1"] = {}
    for kind, (main, argv, net_cls) in runs.items():
        r = run_trainer(kind, main, data + argv, net_cls,
                        os.path.join(tmp, f"{kind}_mesh1"), tag=" --mesh 1")
        ref = trainers[kind]
        require(abs(r["losses"][0] - ref["losses"][0])
                <= 1e-4 * abs(ref["losses"][0]),
                f"trainer {kind} --mesh 1: first loss {r['losses'][0]} vs "
                f"{ref['losses'][0]} without a group")
        log(f"trainer {kind} --mesh 1 (NCCL, a group of one): ms_per_step "
            f"{r['ms']:.3f} vs {ref['ms']:.3f} without a group (phase 16); "
            f"losses {r['losses']} vs {ref['losses']}")
        res["mesh1"][kind] = r
    log(f"phase parallel trainers wall_s: {time.perf_counter() - t:.3f}")

    t = time.perf_counter()
    res["program"] = check_program_pipeline(imgs, device)
    log(f"phase parallel program wall_s: {time.perf_counter() - t:.3f}")
    return res


# ---------------------------------------------------------------------------
# Phase 18: the HPatches benchmark
# ---------------------------------------------------------------------------

HP_SEQS, HP_PATCHES = 4, 512
HP_SHEETS = {"e1": (1, 3.0), "h1": (2, 8.0), "t1": (3, 15.0)}


def hpatches_sequences(seed: int) -> list:
    """HP_SEQS in-memory HPatches sequences (alternately i_ and v_), each
    of HP_PATCHES 65x65 patches cut from the 640x800 fixture at seeded
    places (ref), and the sheets e1, h1, t1: the same places shifted by up
    to 1, 2, 3 px with seeded noise of 3, 8, 15 grey levels (as
    tests/test_hpatches.py), rounded to grey levels as read_sheet reads
    them."""
    img = np.load(os.path.join(FIXTURES, "detector_golden_fullres.npz"))[
        "img"].astype(np.float64)
    rng = np.random.RandomState(seed + 18)
    h, w = img.shape
    seqs = []
    for k in range(HP_SEQS):
        ys = rng.randint(3, h - 65 - 3, HP_PATCHES)
        xs = rng.randint(3, w - 65 - 3, HP_PATCHES)

        def sheet(shift, noise):
            dy = rng.randint(-shift, shift + 1, HP_PATCHES)
            dx = rng.randint(-shift, shift + 1, HP_PATCHES)
            out = np.stack([img[y:y + 65, x:x + 65]
                            for y, x in zip(ys + dy, xs + dx)])
            out = out + rng.normal(0.0, noise, out.shape)
            return np.clip(np.round(out), 0, 255).astype(np.float32)

        ref = sheet(0, 0.0)
        warped = {name: sheet(*spec) for name, spec in HP_SHEETS.items()}
        seqs.append(hpatches.Sequence(f"{'iv'[k % 2]}_chip{k}", ref, warped))
    return seqs


def _run_tasks(seqs, desc_fn) -> dict:
    """The three tasks, each array described once (the memo of
    hpatches.run_benchmark, which holds what it keys)."""
    cache = {}

    def cached(p):
        if id(p) not in cache:
            cache[id(p)] = (p, desc_fn(p))
        return cache[id(p)][1]

    return {"verification": hpatches.task_verification(seqs, cached),
            "matching": hpatches.task_matching(seqs, cached),
            "retrieval": hpatches.task_retrieval(seqs, cached)}


def phase_hpatches(device, seed: int) -> dict:
    """Phase 18: the HPatches tasks on the card over HP_SEQS in-memory
    sequences (the card's machine has no PIL to read sheets), with the
    TFeat (HardTFeatNet) and SIFT descriptors: the 65 -> 32 resize on the
    card against the CPU's (within 1 grey level, at most 1% of the pixels:
    the tests' tolerance against PIL), HardTFeatNet on the card against
    the CPU on the same resized patches and SIFT's descriptors card
    against CPU within 1e-5; the three tasks on the card and on the CPU,
    their metrics within 0.01; ms per patch described on the card."""
    t = time.perf_counter()
    seqs = hpatches_sequences(seed)
    sheets = [s.ref for s in seqs] + [w for s in seqs
                                     for w in s.warped.values()]
    allp = np.concatenate(sheets)
    res = {}
    rs = hpatches.resize_patches(allp, 32, device)
    rs_cpu = hpatches.resize_patches(allp, 32, "cpu")
    diff = (rs.cpu() - rs_cpu).abs()
    res["resize_max"] = float(diff.max())
    res["resize_share"] = float((diff > 0).float().mean())
    require(res["resize_max"] <= 1.0 and res["resize_share"] <= 0.01,
            f"hpatches resize: card vs CPU max {res['resize_max']}, "
            f"{res['resize_share']:.4%} of the pixels")
    net = pretrained(HardTFeatNet(), "HardTFeatNet").eval()
    net_card = copy.deepcopy(net).to(device)
    with float32_math(), torch.no_grad():
        d_card = net_card(rs).cpu()
        d_cpu = net(rs.cpu())
    res["tfeat_err"] = float((d_card - d_cpu).abs().max())
    require(res["tfeat_err"] <= 1e-5, f"hpatches TFeat: card vs CPU "
            f"{res['tfeat_err']}")
    for name in ("TFeat", "SIFT"):
        fn, _ = hpatches.make_descriptor_fn(name, device=device)
        fn_cpu, _ = hpatches.make_descriptor_fn(name, device="cpu")
        fn(allp[:64])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn(allp)
        ms = (time.perf_counter() - t0) * 1e3
        ref = fn_cpu(allp)
        err = float(np.abs(got - ref).max())
        if name == "SIFT":
            require(err <= 1e-5, f"hpatches SIFT: card vs CPU {err}")
        tasks = _run_tasks(seqs, fn)
        tasks_cpu = _run_tasks(seqs, fn_cpu)
        worst = max(abs(tasks[t_][k] - tasks_cpu[t_][k])
                    for t_ in tasks for k in tasks[t_])
        require(worst <= 0.01, f"hpatches {name}: card {tasks} vs CPU "
                f"{tasks_cpu}")
        log(f"hpatches {name}: {len(allp)} patches in {ms:.3f} ms on the "
            f"card ({ms / len(allp) * 1e3:.3f} us per patch, host clock, "
            f"descriptors back on the host); card vs CPU descriptors max "
            f"|diff| {err:.3g}; tasks {json.dumps(tasks)}; the CPU's differ "
            f"by at most {worst:.3g}")
        res[name] = dict(ms=ms, err=err, tasks=tasks, worst=worst)
    log(f"hpatches resize 65 -> 32 card vs CPU: max {res['resize_max']}, "
        f"{res['resize_share']:.4%} of the pixels differ; HardTFeatNet on "
        f"the same patches card vs CPU max |diff| {res['tfeat_err']:.3g}")
    log(f"phase hpatches wall_s: {time.perf_counter() - t:.3f}")
    return res



def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--images", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    # Phases 1-9 run the nchw layout whatever AFFNET_EVAL_CONV says;
    # phases 10-12 set theirs per call.
    with cnn.eval_layout("nchw"):
        return run_phases(args)


def run_phases(args) -> int:
    device = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    log(f"device: {name} x{torch.cuda.device_count()}, torch "
        f"{torch.__version__}, cuda {torch.version.cuda}; the package's "
        "entry points run with TF32 off for cuDNN convolutions and matmuls")

    t = time.perf_counter()
    build.library()
    log(f"build_seconds: {time.perf_counter() - t:.3f}")
    log_conv_sass()

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
    tk = res["topk"]
    log(f"flagship top-k (masked_topk on the flat response vector): "
        f"{tk['topk_pads']} pad calls, {tk['topk_activities']:.0f} device "
        f"activities, device ms {tk['topk_device_ms']:.4f} per call")
    log(f"phase kernels wall_s: {time.perf_counter() - t:.3f}")

    t = time.perf_counter()
    with torch.inference_mode():
        stage = phase_stage({
            "float32": det,
            "fast": ScaleSpaceAffinePatchExtractor(
                FAST_CONFIG, shape_net=aff, desc_net=desc, device=device),
            "program": hesaffnet.make_extractor(
                th=PROGRAM_TH, max_keypoints=PROGRAM_CAP, do_ori=True,
                device=device)}, torch.from_numpy(imgs[0]).to(device))
    log(f"phase stage wall_s: {time.perf_counter() - t:.3f}")

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
    per_img, per_img_plain = time_per_image(
        [functools.partial(d, describe=True) for d in (det, det_plain)], imgs)
    f32_ms = float(np.median(per_img))
    log(f"end_to_end_ms_per_image: median {f32_ms:.3f} "
        f"(all {[round(x, 3) for x in per_img]}); plain path median "
        f"{np.median(per_img_plain):.3f}")
    log(f"phase times wall_s: {time.perf_counter() - t:.3f}")

    train_res, tr = run_training(args.seed, device)
    shape_res, so = run_shape_opt(device, args.seed)
    fast_res, fast_counts, _, fast_outs = run_fast(
        aff, desc, imgs, main_res["outs"], f32_ms, device)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]

    fast_det = ScaleSpaceAffinePatchExtractor(FAST_CONFIG, shape_net=aff,
                                              desc_net=desc, device=device)
    conv_res = phase_conv(det, fast_det, torch.from_numpy(imgs[0]).to(device),
                          args.seed)
    hes = phase_hesaffnet(imgs, device, smi)
    flat_res = phase_flat_extraction(
        aff, desc, imgs, {"float32": main_res["outs"], "fast": fast_outs},
        device)
    baum = phase_hesaffbaum(imgs, device)
    onepass = phase_onepass(imgs, device)
    apps = phase_apps(imgs, device, args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        trainers = phase_trainers(device, args.seed, tmp)
        par = phase_parallel(imgs, trainers, device, args.seed, tmp)
    phase_hpatches(device, args.seed)
    for r in (baum["site"], onepass["refine"], apps["site"],
              *trainers["sites"].values(), *par["sites"].values()):
        log(f"kernel {r['name']} {r['shape']}: max_abs_err {r['err']:.3g} "
            f"ms {r['ms']:.4f} event_median_ms {r['event_ms']:.4f} "
            f"plain_ms {r['plain_ms']:.4f} library_ms {r['library_ms']} "
            f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']})")
    log(smi)

    # (result, counter, source, TPU kernel).  B4 at its two extraction
    # sites as before (launches: both sites together); B5 forward at the
    # augment warps (PS 64) and at the rewarp (PS 32), each with its site's
    # launches; B5 backward; B6 forward and backward; B4-bf16 at its two
    # sites (launches: both together).  Launches: the extraction main
    # path's counts for B1-B4, the training path's for B5, the shape
    # optimization path's for B6, the fast extraction path's for B4-bf16.
    src = {"blur": ("affnet_tpu_torch/csrc/blur.cu",
                    "affnet_tpu/ops/pallas_blur.py:60"),
           "detect": ("affnet_tpu_torch/csrc/detect.cu",
                      "affnet_tpu/ops/pallas_detect.py:84"),
           "dedup": ("affnet_tpu_torch/csrc/detect.cu",
                     "affnet_tpu/ops/pallas_detect.py:84 with "
                     "affnet_tpu/detector.py:183-195"),
           "refine": ("affnet_tpu_torch/csrc/detect.cu",
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
    rows.append((shape_res["pyramid_fwd"], so["counts"]["pyramid_fwd"],
                 "affnet_tpu_torch/csrc/patches.cu",
                 "affnet_tpu/ops/pallas_patches.py:94 via :729"))
    rows.append((shape_res["pyramid_bwd"], so["counts"]["pyramid_bwd"],
                 "affnet_tpu_torch/csrc/patches_bwd.cu",
                 "affnet_tpu/ops/pallas_patches.py:757"))
    for r in fast_res.values():
        rows.append((r, fast_counts["patches_bf16"],
                     "affnet_tpu_torch/csrc/patches.cu",
                     "affnet_tpu/ops/pallas_patches.py:94 (mxu_dtype=bf16, "
                     ":214-247)"))
    # B4 at the HesAffNet program's two sites, with that path's launches
    # (phase 11: both sites together).
    for r in hes["sites"].values():
        rows.append((r, hes["counts"]["patches"],
                     "affnet_tpu_torch/csrc/patches.cu",
                     "affnet_tpu/ops/pallas_patches.py:94"))
    # B7 and B7-bf16 at the flagship's layer shapes (phase 10), with the
    # launches of the flagship under flat (phase 12) in float32 and in fast
    # mode; B7 at the HesAffNet program's shapes, with that path's
    # launches (phase 11).
    for key, r in conv_res.items():
        bf16 = key.startswith("conv_bf16")
        rows.append((r, flat_res["fast"]["counts"]["conv_bf16"] if bf16
                     else flat_res["float32"]["counts"]["conv"],
                     "affnet_tpu_torch/csrc/conv.cu",
                     "affnet_tpu/ops/pallas_conv.py:77"
                     + (" (compute_dtype=bf16)" if bf16 else "")))
    for r in hes["convs"].values():
        rows.append((r, hes["counts"]["conv"],
                     "affnet_tpu_torch/csrc/conv.cu",
                     "affnet_tpu/ops/pallas_conv.py:77"))
    # B4's generic instance at the HesAffBaum program's Baumberg site (PS
    # 19), with that path's launches (phase 13); B2's refine at every
    # survivor, with the OnePassSIR path's refine launches in both modes
    # (phase 14: at every survivor, and at the top-k's indices in top-k
    # mode).
    rows.append((baum["site"], baum["counts"]["patches"],
                 "affnet_tpu_torch/csrc/patches.cu",
                 "affnet_tpu/ops/pallas_patches.py:94"))
    rows.append((onepass["refine"],
                 sum(m["counts"]["refine"]
                     for m in onepass["modes"].values()),
                 "affnet_tpu_torch/csrc/detect.cu",
                 "affnet_tpu/ops/pallas_detect.py:84"))
    # B4 at the external-keypoint site (the image as a one-level buffer),
    # with the describe_keypoints path's launches (phase 15: 3 per image).
    rows.append((apps["site"], apps["counts"]["patches"],
                 "affnet_tpu_torch/csrc/patches.cu",
                 "affnet_tpu/ops/pallas_patches.py:94 via "
                 "affnet_tpu/keypoints.py:67"))
    # B5 forward at the OriNet step's sites and the triplet step's, each
    # with that run's launches at its patch size (phase 16).
    for kind in ("ori", "triplet"):
        for ps in (64, 32):
            rows.append((trainers["sites"][f"batched_fwd_{kind}_ps{ps}"],
                         trainers["orinet" if kind == "ori" else kind]
                         ["counts"][f"batched_fwd_ps{ps}"],
                         "affnet_tpu_torch/csrc/patches.cu",
                         "affnet_tpu/ops/pallas_patches.py:94 via :665 ("
                         + ("affnet_tpu/train.py:315-341" if kind == "ori"
                            else "affnet_tpu/train.py:225-232") + ")"))
    # B5 at a rank's shapes of the sharded AffNet step (phase 17: 512
    # anchors, the rewarp of 1024), with rank 0's launches over the
    # two-rank steps.
    for key, r in par["sites"].items():
        bwd = key == "batched_bwd"
        rows.append((r, par["gloo"]["counts"][key],
                     "affnet_tpu_torch/csrc/patches"
                     + ("_bwd.cu" if bwd else ".cu"),
                     "affnet_tpu/ops/pallas_patches.py:"
                     + ("702" if bwd else "94 via :665")
                     + " (affnet_tpu/parallel.py:55-78)"))
    kernels = [{
        "name": r["name"], "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"]}
        for r, launches, source, replaces in rows]
    print(json.dumps({"kernels": kernels, "stage": stage}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
