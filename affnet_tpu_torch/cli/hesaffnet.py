"""HesAffNet: image -> affine regions (Oxford .ells file) with AffNetFast.

Counterpart of ``affnet_tpu/cli/hesaffnet.py``, with its defaults: mrSize
5.192, border 5, one AffNet shape iteration, ``th=-1`` (threshold mode:
every NMS survivor that passes the shape gate, in scan order); ``--topk``
keeps the ``nfeats`` strongest instead.  ``--do-ori`` adds OriNetFast32
(the shipped OriNetFast weights), ``--fast`` the bf16 mode.  Runs on the
card unless ``--device cpu`` asks for the plain versions on the CPU.

Usage: python -m affnet_tpu_torch.cli.hesaffnet img.png out.txt [nfeats]
       [--topk] [--th TH] [--max-keypoints N] [--do-ori] [--fast]
       [--device cpu]

``--max-keypoints`` caps top-k mode only: threshold mode keeps every
survivor, which is what the JAX program returns after raising its cap to a
power of two.  ``--mesh`` (bulk mode over a device mesh) is not ported: it
waits for the data-parallel runner, and the program refuses it.

The nets' eval layout follows ``AFFNET_EVAL_CONV``: "nchw" (default, cuDNN)
or "flat" (kernel B7); ``models.cnn.eval_layout`` sets it for a block.

Size limits of the kernels, none of which a flag here reaches: B2 takes up
to 20 levels per octave (this program uses 3), B4 any patch size of 2 or
more (it uses 32), B1 any odd tap count.  B7 takes
kernels up to 32 rows and maps up to 1024 pixels wide; the flat stack runs
a layer outside its own rules (output channels not a multiple of 8, a
kernel as large as the map, a map with an odd pixel count) through the
stock layers, so no net of the zoo reaches B7's limits.
"""

from __future__ import annotations

import argparse
from typing import Dict, Tuple

import numpy as np
import torch

from .. import load_pretrained
from ..detector import DetectorConfig, ScaleSpaceAffinePatchExtractor
from ..io_formats import write_ells
from ..laf import lafs_to_ells
from ..models import AffNetFast, OriNetFast32, params_from_jax


def load_gray(fname: str) -> np.ndarray:
    """RGB mean-channel grayscale in [0, 255], float32, like the reference.
    Needs PIL (imported here, not with the module)."""
    from PIL import Image
    img = Image.open(fname).convert("RGB")
    return np.mean(np.asarray(img), axis=2).astype(np.float32)


def make_extractor(nfeats: int = 2000, topk: bool = False, th: float = -1.0,
                   max_keypoints: int = 16384, do_ori: bool = False,
                   fast: bool = False, device="cuda",
                   use_kernels: bool = True
                   ) -> ScaleSpaceAffinePatchExtractor:
    """The program's extractor: pretrained AffNetFast, and OriNetFast32
    with ``do_ori``."""
    cfg = DetectorConfig(num_features=nfeats, border=5, mr_size=5.192,
                         num_baum_iters=1, th=None if topk else th,
                         max_keypoints=max_keypoints, fast=fast)
    aff = AffNetFast()
    aff.load_state_dict(params_from_jax(load_pretrained("AffNetFast")))
    ori = None
    if do_ori:
        ori = OriNetFast32()
        ori.load_state_dict(params_from_jax(load_pretrained("OriNetFast")))
    return ScaleSpaceAffinePatchExtractor(cfg, shape_net=aff, ori_net=ori,
                                          device=device,
                                          use_kernels=use_kernels)


def image_to_ells(det: ScaleSpaceAffinePatchExtractor, img: np.ndarray,
                  do_ori: bool = False
                  ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """(H, W) grayscale image -> ((N, 5) float32 ellipses, the extractor's
    output), everything after ``load_gray``."""
    out = det(img, do_ori=do_ori)
    ells = lafs_to_ells(torch.from_numpy(out["lafs"])).numpy()
    return ells, out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("input_image")
    parser.add_argument("output_fname")
    parser.add_argument("nfeats", type=int, nargs="?", default=2000)
    parser.add_argument("--topk", action="store_true",
                        help="top-k mode (th=None) instead of the reference "
                             "CLI's th=-1 keep-all mode")
    parser.add_argument("--th", type=float, default=-1.0)
    parser.add_argument("--max-keypoints", type=int, default=16384,
                        help="cap on the top-k counts (threshold mode keeps "
                             "every survivor)")
    parser.add_argument("--do-ori", action="store_true")
    parser.add_argument("--fast", action="store_true",
                        help="bf16 patch sampling and nets (float32 "
                             "detection)")
    parser.add_argument("--mesh", type=int, default=0,
                        help="not ported: bulk mode over a device mesh")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (the plain versions)")
    args = parser.parse_args(argv)
    if args.mesh:
        raise SystemExit("--mesh (bulk mode over a device mesh) is not "
                         "ported yet: it waits for the data-parallel "
                         "runner; run one image per call")
    det = make_extractor(args.nfeats, args.topk, args.th,
                         args.max_keypoints, args.do_ori, args.fast,
                         args.device)
    ells, _ = image_to_ells(det, load_gray(args.input_image), args.do_ori)
    write_ells(args.output_fname, ells)
    print(f"{len(ells)} affine regions -> {args.output_fname}")


if __name__ == "__main__":
    main()
