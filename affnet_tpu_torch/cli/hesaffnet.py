"""HesAffNet: image -> affine regions (Oxford .ells file) with AffNetFast.

Counterpart of ``affnet_tpu/cli/hesaffnet.py``, with its defaults: mrSize
5.192, border 5, one AffNet shape iteration, ``th=-1`` (threshold mode:
every NMS survivor that passes the shape gate, in scan order); ``--topk``
keeps the ``nfeats`` strongest instead.  ``--do-ori`` adds OriNetFast32
(the shipped OriNetFast weights), ``--fast`` the bf16 mode.  Runs on the
card unless ``--device cpu`` asks for the plain versions on the CPU.

Usage: python -m affnet_tpu_torch.cli.hesaffnet img.png out.txt [nfeats]
       [--topk] [--th TH] [--max-keypoints N] [--do-ori] [--fast]
       [--mesh N] [--device cpu]

``input_image`` may list several images, comma-separated.  Without
``--mesh`` the program runs the first.  With ``--mesh N`` (any N >= 1) and
more than one image it runs every image in turn on the one card and writes
``{base}_{i}{ext}`` for image i, as JAX's bulk mode does; the images must
share one size (the program refuses mixed sizes, as JAX does).  JAX shards
that mode over an N-device mesh; the port's sharding over devices waits
for its data-parallel runner, so N selects the mode and nothing else.

``--max-keypoints`` caps top-k mode, and threshold mode in bulk mode only:
a single image keeps every survivor, which is what the JAX program returns
after raising its cap to a power of two; JAX's bulk mode runs its program
at the cap as it stands, so each of its files holds the ``max-keypoints``
strongest survivors that pass the shape gate, in descending response
order, and so do the port's (``capped`` in the extractor).

Images are read as the RGB mean in [0, 255] with PIL; a ``.npy`` file (an
(H, W) or (H, W, 3) array) is read with numpy and needs no PIL.

The nets' eval layout follows ``AFFNET_EVAL_CONV``: "nchw" (default, cuDNN)
or "flat" (kernel B7); ``models.cnn.eval_layout`` sets it for a block.

Size limits of the kernels, none of which a flag here reaches: B2 takes up
to 20 levels per octave (this program uses 3), B4 any patch size of 2 or
more (it uses 32), B1 any odd tap count.  B7 takes square kernels of 3 or
7 with pad 0 or (k-1)/2, stride 1 or 2, outputs a multiple of 8, and in
float32 at most 512 threads' worth of output rows (Ho x ceil(Wo/8) <= 512)
per patch, within its shared-memory budgets (``ops.cuda_conv.b7_takes``
states the whole contract).  The flat stack runs each layer that B7 does
not take, and every layer after it, through the stock layers, as it does
a layer outside its own rules (a kernel as large as the map, a map with an
odd pixel count); the zoo's nets use 3x3 and 7x7 kernels on maps up to
32x32.
"""

from __future__ import annotations

import argparse
import os
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
    Needs PIL (imported here, not with the module), except for a ``.npy``
    file: an (H, W) array, or (H, W, 3) whose channel mean is taken."""
    if fname.endswith(".npy"):
        arr = np.load(fname)
        return (np.mean(arr, axis=2) if arr.ndim == 3 else arr).astype(
            np.float32)
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
                  do_ori: bool = False, capped: bool = False
                  ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """(H, W) grayscale image -> ((N, 5) float32 ellipses, the extractor's
    output), everything after ``load_gray``; ``capped``: bulk mode's
    survivors (module docstring)."""
    out = det(img, do_ori=do_ori, capped=capped)
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
                        help="bulk mode: run comma-separated same-size "
                             "images in turn on the one card, one output "
                             "file each")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (the plain versions)")
    args = parser.parse_args(argv)
    paths = args.input_image.split(",")
    bulk = bool(args.mesh) and len(paths) > 1
    imgs = [load_gray(p) for p in (paths if bulk else paths[:1])]
    shapes = {im.shape for im in imgs}
    if len(shapes) > 1:
        raise SystemExit(
            "--mesh bulk mode runs one program over same-shape images, but "
            f"the inputs have {len(shapes)} distinct sizes {sorted(shapes)}; "
            "resize them to a common size or run per-shape groups")
    det = make_extractor(args.nfeats, args.topk, args.th,
                         args.max_keypoints, args.do_ori, args.fast,
                         args.device)
    if bulk:
        base, ext = os.path.splitext(args.output_fname)
        fnames = [f"{base}_{i}{ext}" for i in range(len(imgs))]
    else:
        fnames = [args.output_fname]
    for img, fname in zip(imgs, fnames):
        ells, _ = image_to_ells(det, img, args.do_ori, capped=bulk)
        write_ells(fname, ells)
        print(f"{len(ells)} affine regions -> {fname}")


if __name__ == "__main__":
    main()
