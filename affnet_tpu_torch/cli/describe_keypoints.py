"""Externally detected keypoints -> AffNet shapes, OriNet orientations and
descriptors (the kornia-notebook workflow,
examples/SIFT-AffNet-HardNet-kornia-matching.ipynb cells 0-10).

Counterpart of ``affnet_tpu/cli/describe_keypoints.py``, with its flags and
files.  Keypoint file: one ``x y size [angle_deg]`` row per keypoint (any
detector: OpenCV SIFT/DoG, ORB, your own).  Output: a 7-column LAF file
``x y a11 a12 a21 a22 resp`` (%10.5f, resp = 0 placeholder) or ``.npy``,
plus optional descriptors (``.npy``).  AffNetFast, OriNetFast32 (the
shipped OriNetFast weights) and HardTFeatNet carry the shipped weights.
Runs on the card unless ``--device cpu`` asks for the CPU.

Images are read as the RGB mean in [0, 255] with PIL; a ``.npy`` file (an
(H, W) or (H, W, 3) array) is read with numpy and needs no PIL.

Usage:
  python -m affnet_tpu_torch.cli.describe_keypoints img.png kpts.txt \
      out_lafs.txt [--descs out_descs.npy] [--descriptor SIFT|TFeat|none] \
      [--mr-size 6.0] [--no-shape] [--no-ori] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..keypoints import describe_keypoints
from ..models import AffNetFast, HardTFeatNet, OriNetFast32, SIFTNet
from . import pretrained
from .hesaffnet import load_gray


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("image")
    p.add_argument("keypoints", help="text file: x y size [angle] per row")
    p.add_argument("output", help=".txt (x y A flat) or .npy LAF output")
    p.add_argument("--descs", default=None, help=".npy descriptor output")
    p.add_argument("--descriptor", default="TFeat",
                   choices=["SIFT", "TFeat", "none"])
    p.add_argument("--mr-size", type=float, default=6.0)
    p.add_argument("--no-shape", action="store_true")
    p.add_argument("--no-ori", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    img = load_gray(args.image)
    kp = np.loadtxt(args.keypoints, ndmin=2).astype(np.float32)
    x, y, size = kp[:, 0], kp[:, 1], kp[:, 2]
    angle = kp[:, 3] if kp.shape[1] > 3 else None
    shape_net = None if args.no_shape else pretrained(AffNetFast(),
                                                      "AffNetFast")
    ori_net = None if args.no_ori else pretrained(OriNetFast32(),
                                                  "OriNetFast")
    desc_net = {"TFeat": lambda: pretrained(HardTFeatNet(), "HardTFeatNet"),
                "SIFT": lambda: SIFTNet(patch_size=32),
                "none": lambda: None}[args.descriptor]()

    out = describe_keypoints(img, x, y, size, angle, mr_size=args.mr_size,
                             shape_net=shape_net, ori_net=ori_net,
                             desc_net=desc_net, device=args.device)
    lafs = out["lafs"]
    if args.output.endswith(".npy"):
        np.save(args.output, lafs)
    else:
        flat = np.concatenate([
            lafs[:, 0, 2:3], lafs[:, 1, 2:3],
            lafs[:, 0, 0:1], lafs[:, 0, 1:2],
            lafs[:, 1, 0:1], lafs[:, 1, 1:2],
            np.zeros((len(lafs), 1), np.float32)], axis=1)
        np.savetxt(args.output, flat, fmt="%10.5f")
    if args.descs and "descs" in out:
        np.save(args.descs, out["descs"])
    print(f"{len(lafs)} keypoints -> {args.output}"
          + (f" + {args.descs}" if args.descs else ""))


if __name__ == "__main__":
    main()
