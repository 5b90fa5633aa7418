#!/usr/bin/env python3
"""Device time of the patch sampler (B4, B4-bf16, B5 and B6 forward) and of
the row top-m B3 at the main paths' sites, for one checkout of the
PyTorch/CUDA port, or for two in turns.

    python3 scripts/bench_sampler_topk.py [--root DIR] [--seed 0]
    python3 scripts/bench_sampler_topk.py --compare OTHER [--seed 0]

``--root`` is the repository root whose ``affnet_tpu_torch`` and
``chip_smoke.py`` are measured (default: this one).  ``--compare OTHER``
runs this script on OTHER, this checkout, this checkout and OTHER, one
process each, and prints every run and each side's median per site: unpack
the other commit with ``git archive`` into a directory that ``.gitignore``
lists (``_check/``).

Sites, on 1080x1920 images from ``chip_smoke.make_images`` (the first one)
and the inputs each checkout's own stages give them:

  - ``shape``, ``desc`` (B4) and ``bf16_shape``, ``bf16_desc`` (B4-bf16):
    the flagship (``chip_smoke.CONFIG``, ``FAST_CONFIG``);
  - ``hes_shape``, ``hes_ori`` (B4): the HesAffNet program (th=-1, every
    NMS survivor, ``--do-ori``), about 34k patches each;
  - ``batched_ps64``, ``batched_ps32`` (B5 forward): one training step's
    augment warp (1024 64x64 patches) and rewarp (2048 32x32 patches by an
    initialized AffNetFast), as chip_smoke's phase 5 makes them;
  - ``pyramid`` (B6 forward): the 200 LAFs of chip_smoke's phase 7;
  - ``topk`` (B3): one launch on the flagship's flat response vector (a
    checkout whose B3 takes a (B, 1024) matrix gets the padded copy, made
    outside the timed call), and ``topk_stage``: the flagship's whole top-k
    (``masked_topk``), the pad included where the checkout makes one, as
    device activities and device ms per call.

Kernel times are CUPTI device ms per call (``chip_smoke.time_ms``, 20
calls).  Each site also records whether the kernel's output equals its
plain version's bit for bit (``torch.equal``; ``exact``), so the same run
holds either checkout's kernels to exactness.  Prints one JSON line (the
card's name and power limit in it).
Needs a CUDA card; imports torch, numpy and the standard library only.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 20


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def measure(root: str, seed: int) -> dict:
    """Every site's device ms per call for the checkout at ``root``."""
    sys.path.insert(0, root)
    import chip_smoke as cs
    from affnet_tpu_torch.cli import hesaffnet
    from affnet_tpu_torch.data import DevicePairDataset, PairDataset
    from affnet_tpu_torch.detector import ScaleSpaceAffinePatchExtractor
    from affnet_tpu_torch.models import AffNetFast
    from affnet_tpu_torch.models.cnn import init_params
    from affnet_tpu_torch.ops import cuda_patches, cuda_topk
    from affnet_tpu_torch.ops.nms import M_CAND, ROW_S, masked_topk
    from affnet_tpu_torch.ops.patches import (
        batched_tables, extract_patches_from_flat_pyramid)
    from affnet_tpu_torch.train import draw_affnet_lafs, tilt_for_epoch
    from scripts.profile_detect_stage import stage_profile
    assert os.path.dirname(cs.__file__) == root, cs.__file__

    device = torch.device("cuda")
    H, W = cs.H, cs.W
    img = torch.from_numpy(cs.make_images(seed, 1)[0]).to(device)
    aff, desc = cs.pretrained_nets()
    ms, exact = {}, {}

    def time_site(name, fn, plain):
        exact[name] = all(torch.equal(a, b) for a, b in zip(
            *(x if isinstance(x, tuple) else (x,) for x in (fn(), plain()))))
        ms[name] = cs.time_ms(fn, REPS)

    def pyramid_sites(det, tag, program=False):
        p = det._plan(H, W)
        cand = det._multiscale_detect(img, p)
        cand["lafs"] = torch.cat([det.cfg.mr_size * cand["lafs"][:, :, 0:2],
                                  cand["lafs"][:, :, 2:]], dim=2)
        bf16 = det.cfg.fast
        sites = [("shape", cand["flat"], cand["lafs"].contiguous(),
                  cand["ext_level"].to(torch.int32), det.shape_net.ps)]
        cand = det._affine_shape(cand, p)
        if program:
            sites.append(("ori", cand["flat"], cand["lafs"].contiguous(),
                          cand["ext_level"].to(torch.int32),
                          det.ori_net.ps))
        else:
            cand = det._sort_for_describe(cand, p, H, W)
            sites.append(("desc", cand["flat"], cand["lafs"].contiguous(),
                          cand["desc_level"].to(torch.int32),
                          det.cfg.patch_size))
        for site, buf, lafs, lvl, ps in sites:
            time_site(f"{tag}{site}",
                      lambda: cuda_patches.extract_patches_cuda(
                          buf, lafs, lvl, *p.tables, ps=ps, bf16=bf16),
                      lambda: extract_patches_from_flat_pyramid(
                          buf, lafs, lvl, *p.tables, ps=ps, bf16=bf16))

    with torch.inference_mode():
        det = ScaleSpaceAffinePatchExtractor(cs.CONFIG, shape_net=aff,
                                             desc_net=desc, device=device)
        pyramid_sites(det, "")
        pyramid_sites(ScaleSpaceAffinePatchExtractor(
            cs.FAST_CONFIG, shape_net=aff, desc_net=desc, device=device),
            "bf16_")
        pyramid_sites(hesaffnet.make_extractor(
            th=cs.PROGRAM_TH, max_keypoints=cs.PROGRAM_CAP, do_ori=True,
            device=device), "hes_", program=True)

        p = det._plan(H, W)
        resp = det._responses(img, p)[1]
        n = resp.numel()
        b = -(-n // ROW_S)
        x2d = torch.nn.functional.pad(
            resp, (0, b * ROW_S - n), value=-1.0).reshape(b, ROW_S)
        plain = lambda: cuda_topk.row_topm_plain(x2d, M_CAND)
        if hasattr(cuda_topk, "row_topm_flat_cuda"):
            time_site("topk", lambda: cuda_topk.row_topm_flat_cuda(
                resp, M_CAND), plain)
        else:
            time_site("topk", lambda: cuda_topk.row_topm_cuda(x2d, M_CAND),
                      plain)
        stage = stage_profile(lambda: masked_topk(
            resp, min(det.cfg.prefilter_count(), p.total)), reps=5)

        # B5: one training step's warps, as chip_smoke's phase 5 makes them.
        cfg = cs.TRAIN_CFG
        patches, labels = cs.make_train_patches(seed)
        batch = next(iter(DevicePairDataset(PairDataset(
            patches, labels, n_pairs=cfg.batch_size,
            batch_size=cfg.batch_size, seed=seed + 1), device).batches()))
        nb, h, _ = batch[0].shape
        gen = torch.Generator(device=device).manual_seed(seed)
        lafs = draw_affnet_lafs(nb, tilt_for_epoch(0), gen, True)
        buf64 = batch[0].reshape(nb * h, h)
        tab64 = batched_tables(nb, h, h, device)
        time_site("batched_ps64", lambda: cuda_patches.sample_batched_cuda(
            buf64, lafs[0], tab64, h, False),
            lambda: extract_patches_from_flat_pyramid(
                buf64, lafs[0], *tab64, ps=h))
        full = torch.cat([cuda_patches.sample_batched_cuda(
            x.reshape(nb * h, h), laf, batched_tables(nb, h, h, device), h,
            False) for x, laf in zip(batch, lafs)])
        net = init_params(AffNetFast(), torch.Generator().manual_seed(seed))
        net = net.to(device).train()
        st = (h - 32) // 2
        A = net(full[:, st:st + 32, st:st + 32])
        base = torch.tensor([[0.5, 0.0, 0.5], [0.0, 0.5, 0.5]],
                            device=device).expand(2 * nb, 2, 3)
        lafs32 = torch.cat([(32 / h) * (A @ base[:, :, :2]), base[:, :, 2:]],
                           2).contiguous()
        buf32 = full.reshape(2 * nb * h, h)
        tab32 = batched_tables(2 * nb, h, h, device)
        time_site("batched_ps32", lambda: cuda_patches.sample_batched_cuda(
            buf32, lafs32, tab32, 32, False),
            lambda: extract_patches_from_flat_pyramid(
                buf32, lafs32, *tab32, ps=32))

    # B6: chip_smoke's phase 7 inputs.
    img6, lafs1, lafs2, _ = cs.shape_problem(device)
    opt = cs.shape_optimizer("SIFT", device)
    sp = opt.prepare(lafs1, lafs2, img6, img6)
    view = sp.views[0]
    with torch.no_grad():
        nlafs, lvl = opt.sampler_inputs(view, sp.shapes[0].detach())
    nlafs, lvl = nlafs.contiguous(), lvl.to(torch.int32).contiguous()
    tab6 = (lvl, *view.tables)
    with torch.no_grad():
        time_site("pyramid", lambda: cuda_patches.sample_pyramid_cuda(
            view.flat, nlafs, tab6, opt.ps, False),
            lambda: extract_patches_from_flat_pyramid(
                view.flat, nlafs, *tab6, ps=opt.ps))
    return {"root": root, "device": torch.cuda.get_device_name(0),
            "smi": smi(), "ms": ms, "exact": exact, "topk_stage": stage}


def compare(other: str, seed: int) -> dict:
    """This script on ``other``, here, here, ``other``: the four runs and
    each side's median ms per site."""
    runs = []
    for root in (other, HERE, HERE, other):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--root", root,
             "--seed", str(seed)], capture_output=True, text=True,
            timeout=1800)
        if proc.returncode != 0:
            raise RuntimeError(f"{root}: exit {proc.returncode}\n"
                               f"{proc.stderr[-4000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    sides = {}
    for name, idx in (("other", (0, 3)), ("this", (1, 2))):
        ms = [runs[i]["ms"] for i in idx]
        sides[name] = {k: float(np.median([m[k] for m in ms]))
                       for k in ms[0]}
    return {"other": os.path.abspath(other), "this": HERE, "runs": runs,
            "median_ms": sides,
            "exact": {k: all(r["exact"][k] for r in runs)
                      for k in runs[0]["exact"]},
            "speedup": {k: sides["other"][k] / sides["this"][k]
                        for k in sides["this"]}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--compare", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    if args.compare:
        out = compare(args.compare, args.seed)
    else:
        out = measure(os.path.abspath(args.root), args.seed)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
