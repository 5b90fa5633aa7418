"""HesAffBaum: the classical Hessian-Affine baseline, image -> affine regions
(Oxford .ells file) with the handcrafted Baumberg iteration.

Counterpart of ``affnet_tpu/cli/hesaffbaum.py``, with its settings: top-k
mode (``nfeats`` strongest), border 5, mrSize 5.192, ``--iters`` (16)
Baumberg steps at PS 19 (kernel B4's generic instance samples each step's
patches).  Runs on the card unless ``--device cpu`` asks for the plain
versions on the CPU.

Usage: python -m affnet_tpu_torch.cli.hesaffbaum img.png out.txt [nfeats]
       [--iters 16] [--device cpu]

Images are read as the RGB mean in [0, 255] with PIL; a ``.npy`` file (an
(H, W) or (H, W, 3) array) is read with numpy and needs no PIL.
"""

from __future__ import annotations

import argparse

import torch

from ..detector import DetectorConfig, ScaleSpaceAffinePatchExtractor
from ..io_formats import write_ells
from ..laf import lafs_to_ells
from ..models.handcrafted import AffineShapeEstimator
from .hesaffnet import load_gray


def make_extractor(nfeats: int = 2000, iters: int = 16, device="cuda",
                   use_kernels: bool = True
                   ) -> ScaleSpaceAffinePatchExtractor:
    """The program's extractor: top-k mode and ``iters`` Baumberg steps."""
    cfg = DetectorConfig(num_features=nfeats, border=5, mr_size=5.192,
                         num_baum_iters=iters, th=None)
    return ScaleSpaceAffinePatchExtractor(
        cfg, shape_net=AffineShapeEstimator(patch_size=19), device=device,
        use_kernels=use_kernels)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("input_image")
    parser.add_argument("output_fname")
    parser.add_argument("nfeats", type=int, nargs="?", default=2000)
    parser.add_argument("--iters", type=int, default=16)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (the plain versions)")
    args = parser.parse_args(argv)
    img = load_gray(args.input_image)
    det = make_extractor(args.nfeats, args.iters, args.device)
    ells = lafs_to_ells(torch.from_numpy(det(img)["lafs"])).numpy()
    write_ells(args.output_fname, ells)
    print(f"{len(ells)} affine regions -> {args.output_fname}")


if __name__ == "__main__":
    main()
