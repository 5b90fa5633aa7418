#!/usr/bin/env python3
"""Launches and device time of the extractor's pyramid and detection stage,
and ms per image end to end, for one checkout of the PyTorch/CUDA port.

    python3 scripts/profile_detect_stage.py [--root DIR] [--images 3]
        [--seed 0] [--e2e]

``--root`` is the repository root whose ``affnet_tpu_torch`` and
``chip_smoke.py`` are measured (default: this one), so one command can
measure two checkouts in turns (unpack the other with ``git archive`` into
a directory that ``.gitignore`` lists).  On 1080x1920 images from
``chip_smoke.make_images``, for the flagship (``chip_smoke.CONFIG``, in
float32 and in fast mode) and the HesAffNet program (th=-1, max-keypoints
16384): the device activities (kernels, copies, memsets) that one call of
``_responses`` (the pyramid and detection) and of ``_multiscale_detect``
(and the selection and (sigma, y, x)) makes per image, and their summed
device time, from torch.profiler (CUPTI).  With ``--e2e`` also the
host-clock ms per image of the whole extraction (flagship ``describe=True``
in both modes; the program with ``--do-ori`` under the flat layout), median
of 2 passes over the images.  Prints one JSON line.  Needs a CUDA card;
imports torch, numpy and the standard library only.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def stage_profile(fn, reps: int = 1, tries: int = 3) -> dict:
    """Device activities per ``fn()`` call (kernels, copies, memsets) and
    their summed device ms, from torch.profiler over ``reps`` warmed calls.
    The profiler has returned windows without any device record on the
    card's machine: such a window is measured again, up to ``tries``
    times."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and "Activity Buffer" not in e.name]
        if events:
            break
    else:
        raise AssertionError("the profiler saw no device activity")
    copies = sum("memcpy" in e.name.lower() for e in events)
    memsets = sum("memset" in e.name.lower() for e in events)
    us = sum(e.time_range.end - e.time_range.start for e in events)
    return {"launches": len(events) / reps,
            "kernels": (len(events) - copies - memsets) / reps,
            "copies": copies / reps, "memsets": memsets / reps,
            "device_ms": us / reps / 1e3}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--images", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--e2e", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    from affnet_tpu_torch.cli import hesaffnet
    from affnet_tpu_torch.detector import ScaleSpaceAffinePatchExtractor
    from affnet_tpu_torch.models import cnn
    assert os.path.dirname(cs.__file__) == root, cs.__file__

    device = torch.device("cuda")
    aff, desc = cs.pretrained_nets()
    dets = {
        "float32": ScaleSpaceAffinePatchExtractor(
            cs.CONFIG, shape_net=aff, desc_net=desc, device=device),
        "fast": ScaleSpaceAffinePatchExtractor(
            cs.FAST_CONFIG, shape_net=aff, desc_net=desc, device=device),
        "program": hesaffnet.make_extractor(
            th=cs.PROGRAM_TH, max_keypoints=cs.PROGRAM_CAP, do_ori=True,
            device=device)}
    imgs = [torch.from_numpy(x).to(device)
            for x in cs.make_images(args.seed, args.images)]
    out = {"root": root, "device": torch.cuda.get_device_name(0),
           "smi": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True,
               timeout=60).stdout.strip()}
    with torch.inference_mode():
        for name, det in dets.items():
            p = det._plan(*imgs[0].shape)
            res = {}
            for stage in ("_responses", "_multiscale_detect"):
                per = [stage_profile(functools.partial(
                    getattr(det, stage), img, p)) for img in imgs]
                res[stage] = {k: float(np.mean([r[k] for r in per]))
                              for k in per[0]}
            out[name] = res
    if args.e2e:
        runs = {
            "float32": functools.partial(dets["float32"], describe=True),
            "fast": functools.partial(dets["fast"], describe=True),
            "program": functools.partial(
                cnn.eval_layout("flat")(hesaffnet.image_to_ells),
                dets["program"], do_ori=True)}
        host = [x.cpu().numpy() for x in imgs]
        for name, run in runs.items():
            run(host[0])
            times = []
            for _ in range(2):
                for img in host:
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    run(img)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t) * 1e3)
            out[name]["ms_per_image"] = float(np.median(times))
            out[name]["ms_all"] = times
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
