#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port's extraction or training
path.

``--path extract`` (default) runs chip_smoke.py's extraction configuration
(1080x1920, 2000 features, AffNetFast + HardTFeatNet, float32, TF32 off) on
seeded images; ``--path train`` runs chip_smoke.py's training
configuration (AffNetFast at batch 1024 against HardTFeatNet, HardNegC,
SGD) for a few steps after warm-up.  Under torch.profiler it prints: wall
ms per image or step, device-busy ms (the union of kernel intervals on the
card), the idle share, device time by kind (convolutions, the B5 sampler,
BatchNorm, other) and by kernel name.  Writes the Chrome trace to --trace
(default port_trace.json).

    python3 scripts/profile_torch_port.py [--path extract|train] [--seed 0]
        [--images 2] [--steps 5] [--trace F]

Needs a CUDA card; imports torch, numpy and the standard library only.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from affnet_tpu_torch import load_pretrained  # noqa: E402
from affnet_tpu_torch.data import DevicePairDataset, PairDataset  # noqa: E402
from affnet_tpu_torch.detector import ScaleSpaceAffinePatchExtractor  # noqa: E402
from affnet_tpu_torch.models import AffNetFast  # noqa: E402
from affnet_tpu_torch.models.cnn import init_params  # noqa: E402
from affnet_tpu_torch.train import (init_state,  # noqa: E402
                                    make_affnet_train_step, make_descriptor)


def busy_ms(events) -> float:
    """Length of the union of the device kernels' intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "Activity Buffer" not in e.name)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3                       # us -> ms


def device_time_by_kind(events) -> dict:
    """Device ms by kind of kernel, from the kernel names."""
    kinds = {"conv": ("conv", "cudnn", "xmma", "gemm", "wgrad", "dgrad",
                      "implicit", "winograd", "fft"),
             "sampler": ("sample_patches",),
             "batchnorm": ("batch_norm", "bn_"),
             "copy": ("memcpy", "memset")}
    out = {k: 0.0 for k in list(kinds) + ["other"]}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or "Activity Buffer" in e.name:
            continue
        name = e.name.lower()
        kind = next((k for k, keys in kinds.items()
                     if any(key in name for key in keys)), "other")
        out[kind] += (e.time_range.end - e.time_range.start) / 1e3
    return out


def profile_train(args):
    """(profile, wall ms per step) of --steps training steps."""
    cfg = chip_smoke.TRAIN_CFG
    n = 3 + args.steps
    patches, labels = chip_smoke.make_train_patches(args.seed)
    ds = DevicePairDataset(PairDataset(patches, labels,
                                       n_pairs=n * cfg.batch_size,
                                       batch_size=cfg.batch_size,
                                       seed=args.seed), "cuda")
    net = init_params(AffNetFast(), torch.Generator().manual_seed(args.seed))
    state = init_state(net.cuda().train(), cfg)
    step = make_affnet_train_step(
        make_descriptor("TFeat", load_pretrained("HardTFeatNet"), "cuda"),
        cfg)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    batches = list(ds.batches())
    for batch in batches[:3]:                        # build + warm up
        step(state, batch, gen, 3.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches[3:]:
            step(state, batch, gen, 3.0)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / args.steps
    return prof, wall, args.steps, "step"


def profile_extract(args):
    """(profile, wall ms per image) of --images extractions."""
    aff, desc = chip_smoke.pretrained_nets()
    det = ScaleSpaceAffinePatchExtractor(chip_smoke.CONFIG, shape_net=aff,
                                         desc_net=desc, device="cuda")
    imgs = chip_smoke.make_images(args.seed, args.images)
    det(imgs[0], describe=True)                      # build + warm up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for img in imgs:
            det(img, describe=True)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / len(imgs)
    return prof, wall, len(imgs), "image"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--path", choices=("extract", "train"),
                    default="extract")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--images", type=int, default=2)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--trace", default="port_trace.json",
                    help="Chrome trace output path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_port: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    run = profile_train if args.path == "train" else profile_extract
    prof, wall, count, unit = run(args)
    busy = busy_ms(prof.events()) / count
    print(f"device: {torch.cuda.get_device_name(0)}")
    print(f"wall_ms_per_{unit} {wall:.3f} device_busy_ms_per_{unit} "
          f"{busy:.3f} idle_share {1.0 - busy / wall:.3f}")
    kinds = device_time_by_kind(prof.events())
    print(f"device_ms_per_{unit}_by_kind " + " ".join(
        f"{k} {v / count:.3f}" for k, v in kinds.items()))
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=30, max_name_column_width=60))
    os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
    prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
