"""Per-stage timing of the extraction pipeline.

Counterpart of ``affnet_tpu/cli/profile_pipeline.py``: it replaces the
reference's ad-hoc time.time() prints (SparseImgRepresenter.py:163-164,
196, 201; extract_geom_and_desc_upisup.py:37-45) with fenced stage
timings (:class:`..utils.StageTimer`, :func:`..utils.fence`) of the
pyramid (``ops/scalespace.build_flat_pyramid``), the pyramid with
detection and top-k (``_multiscale_detect``) and the whole extraction
with AffNetFast shapes and HardNet descriptors (``run(describe=True)``,
the descriptors read back), after one warm-up pass; ``--trace DIR`` writes
a ``torch.profiler`` Chrome trace of one more full pass into DIR.
HardNet carries the port's seeded init (``models.cnn.init_params``, seed
0), as JAX's carries ``PRNGKey(0)``'s: the timing does not depend on it.
Runs on the card unless ``--device cpu`` asks for the CPU.

Images are read as the RGB mean in [0, 255] with PIL; a ``.npy`` file is
read with numpy.  ``--resize WxH`` needs PIL.

Usage: python -m affnet_tpu_torch.cli.profile_pipeline [img.png]
       [--nfeats 2000] [--resize 1920x1080] [--runs 5] [--trace DIR]
       [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import resolve_device
from ..detector import DetectorConfig, ScaleSpaceAffinePatchExtractor
from ..models import AffNetFast
from ..ops.scalespace import build_flat_pyramid
from ..utils import StageTimer, fence, profiler_trace
from . import pretrained
from .extract_geom import make_descriptor
from .hesaffnet import load_gray

STAGES = ("pyramid", "pyramid+detect+topk",
          "full (detect+shape+patches+HardNet)")


def main(argv=None) -> StageTimer:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("input_image", nargs="?", default="test-graf/img1.png")
    parser.add_argument("--nfeats", type=int, default=2000)
    parser.add_argument("--resize", type=str, default=None,
                        help="WxH, e.g. 1920x1080")
    parser.add_argument("--runs", type=int, default=5)
    parser.add_argument("--trace", default=None,
                        help="directory for a torch.profiler Chrome trace")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (the plain versions)")
    args = parser.parse_args(argv)

    img = load_gray(args.input_image)
    if args.resize:
        from PIL import Image
        w, h = map(int, args.resize.split("x"))
        img = np.asarray(Image.fromarray(img.astype(np.uint8)).resize(
            (w, h), Image.BILINEAR), np.float32)
    h, w = img.shape
    dev = resolve_device(args.device)
    x = torch.from_numpy(np.ascontiguousarray(img)).to(dev)

    cfg = DetectorConfig(num_features=args.nfeats, border=5, mr_size=5.192,
                         num_baum_iters=1, th=None, patch_size=32)
    det = ScaleSpaceAffinePatchExtractor(
        cfg, shape_net=pretrained(AffNetFast(), "AffNetFast"),
        desc_net=make_descriptor("HardNet"), device=dev)
    p = det._plan(h, w)

    def full():
        out = det.run(x, describe=True)
        out["descs"].cpu()
        return out

    stages = (lambda: build_flat_pyramid(x, p.plan)[1],
              lambda: det._multiscale_detect(x, p)["resp"], full)
    timer = StageTimer()
    with torch.inference_mode():
        for fn in stages:                # warm-up
            fence(fn())
        for _ in range(args.runs):
            for name, fn in zip(STAGES, stages):
                with timer.stage(name):
                    fence(fn())
        print(f"image {w}x{h}, {args.nfeats} features, {args.runs} runs:")
        print(timer.report())
        if args.trace:
            with profiler_trace(args.trace):
                full()
            print(f"profiler trace -> {args.trace}")
    return timer


if __name__ == "__main__":
    main()
