#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port's extraction, training or
shape-optimization path.

``--path extract`` (default) runs chip_smoke.py's extraction configuration
(1080x1920, 2000 features, AffNetFast + HardTFeatNet, float32, TF32 off) on
seeded images, ``--path fast`` the same in fast mode (bf16 nets and
sampler, float16 descriptors); ``--path train`` runs chip_smoke.py's
training configuration (AffNetFast at batch 1024 against HardTFeatNet,
HardNegC, SGD) for a few steps after warm-up, and ``--path descriptor``,
``orinet`` or ``triplet`` chip_smoke.py phase 16's other training steps
at batch 1024 (HardNet from scratch at lr 0.1; OriNetFast32 with the
HardNet loss; the triplet AffNet step with the random-sampling loss on
host-built TripletDataset batches, as the program runs it; the last two
against a seeded HardNet descriptor); ``--path shape`` its
shape-optimization configuration (200 LAF pairs on the 640x800 fixture,
SIFT, HardNegC, Adam lr 2.0) for --steps steps after 10 of warm-up.  Under
torch.profiler it prints: wall ms per image or step, device-busy ms (the
union of kernel intervals on the card), the idle share, device time by
kind (convolutions, the patch samplers, BatchNorm, copies, other) and by
kernel name.  Writes the Chrome trace to --trace (default
port_trace.json).

    python3 scripts/profile_torch_port.py [--path extract|fast|train|shape|
        descriptor|orinet|triplet]
        [--seed 0] [--images 2] [--steps 5] [--trace F]

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
from affnet_tpu_torch.data import (DevicePairDataset, PairDataset,  # noqa: E402
                                   TripletDataset)
from affnet_tpu_torch.detector import ScaleSpaceAffinePatchExtractor  # noqa: E402
from affnet_tpu_torch.models import (AffNetFast, HardNet,  # noqa: E402
                                     OriNetFast32, params_to_jax)
from affnet_tpu_torch.models.cnn import init_params  # noqa: E402
from affnet_tpu_torch.train import (STEP_MAKERS, init_state,  # noqa: E402
                                    make_descriptor)


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
                      "implicit", "winograd", "fft", "cutlass"),
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


# --path -> (net, train_loop mode, loss, lr, frozen descriptor): the
# training steps of chip_smoke.py phases 6 and 16.
TRAIN_PATHS = {
    "train": (AffNetFast, "affnet", "HardNegC", 0.005, "TFeat"),
    "descriptor": (HardNet, "descriptor", "HardNet", 0.1, None),
    "orinet": (OriNetFast32, "orinet", "HardNet", 0.005, "HardNet"),
    "triplet": (AffNetFast, "affnet", "random_sampling", 0.005, "HardNet"),
}


def profile_train(args):
    """(profile, wall ms per step) of --steps training steps, each batch
    built as the step's program builds it (the host-built triplets copied
    to the card inside the timed steps)."""
    net_cls, mode, loss, lr, desc = TRAIN_PATHS[args.path]
    cfg = chip_smoke.dataclasses.replace(
        chip_smoke.TRAIN_CFG, arch=net_cls.__name__, loss=loss, lr=lr,
        descriptor=desc or "pixels")
    n = 3 + args.steps
    patches, labels = chip_smoke.make_train_patches(args.seed)
    if args.path == "triplet":
        ds = TripletDataset(patches, labels, n * cfg.batch_size,
                            cfg.batch_size, seed=args.seed)
    else:
        ds = DevicePairDataset(PairDataset(patches, labels,
                                           n_pairs=n * cfg.batch_size,
                                           batch_size=cfg.batch_size,
                                           seed=args.seed), "cuda")
    net = init_params(net_cls(), torch.Generator().manual_seed(args.seed),
                      gain=net_cls.init_gain)
    state = init_state(net.cuda().train(), cfg)
    params = (load_pretrained("HardTFeatNet") if desc == "TFeat" else
              params_to_jax(init_params(HardNet(), torch.Generator()
                                        .manual_seed(args.seed + 1))
                            .state_dict()))
    step = STEP_MAKERS[mode](
        None if desc is None else make_descriptor(desc, params, "cuda"),
        cfg)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    batches = iter(ds.batches())

    def run_step():
        batch = tuple(torch.as_tensor(x, device="cuda") for x in next(batches))
        step(state, batch, gen, 3.0)

    for _ in range(3):                               # build + warm up
        run_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            run_step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / args.steps
    return prof, wall, args.steps, "step"


def profile_shape(args):
    """(profile, wall ms per step) of --steps shape-optimization steps."""
    img, lafs1, lafs2, _ = chip_smoke.shape_problem("cuda")
    opt = chip_smoke.shape_optimizer("SIFT", "cuda")
    st = opt.prepare(lafs1, lafs2, img, img)
    for _ in range(10):                              # build + warm up
        opt.step(st)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            opt.step(st)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / args.steps
    return prof, wall, args.steps, "step"


def profile_extract(args):
    """(profile, wall ms per image) of --images extractions."""
    aff, desc = chip_smoke.pretrained_nets()
    config = chip_smoke.FAST_CONFIG if args.path == "fast" \
        else chip_smoke.CONFIG
    det = ScaleSpaceAffinePatchExtractor(config, shape_net=aff,
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
    ap.add_argument("--path", choices=("extract", "fast", "shape",
                                       *TRAIN_PATHS), default="extract")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--images", type=int, default=2)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--trace", default="port_trace.json",
                    help="Chrome trace output path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_port: no CUDA device", file=sys.stderr)
        return 2
    # TF32 stays off: the extractor and the training step pin float32 math
    # themselves (affnet_tpu_torch.utils.float32_math).
    run = (profile_train if args.path in TRAIN_PATHS
           else {"shape": profile_shape}.get(args.path, profile_extract))
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
