"""Estimate each patch's upright affine shape with AffNetFast.

Counterpart of ``affnet_tpu/cli/detect_affine_shape.py``.  Input: an
HPatches-style patch-column image (H = N * W, each cell W x W).  Output: N
rows ``a11 0 a21 a22`` (%10.5f).  Runs on the card unless ``--device cpu``
asks for the CPU.

Reference CLI: examples/just_shape/detect_affine_shape.py:36-70.
Usage: python -m affnet_tpu_torch.cli.detect_affine_shape imgs/face.png
       out.txt [--weights AffNetFast|x.npz] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import load_params_npz, load_pretrained, resolve_device
from ..io_formats import write_upright_affine
from ..models import AffNetFast, params_from_jax
from ..utils import float32_math


def load_patch_column(fname: str, ps: int = 32) -> np.ndarray:
    """Grayscale patch-column image -> (N, ps, ps) float patches in [0, 1].
    Cells are resized with bilinear interpolation (cv2 INTER_LINEAR in the
    reference, :43-46).  Needs PIL, imported here."""
    from PIL import Image
    img = np.asarray(Image.open(fname).convert("L"), np.float32)
    h, w = img.shape
    n_patches = h // w
    out = np.zeros((n_patches, ps, ps), np.float32)
    for i in range(n_patches):
        cell = Image.fromarray(img[i * w:(i + 1) * w, 0:w])
        out[i] = np.asarray(cell.resize((ps, ps), Image.BILINEAR), np.float32)
    return out / 255.0


def affine_shapes(patches: np.ndarray, weights: str = "AffNetFast",
                  device="cuda") -> np.ndarray:
    """(N, 32, 32) patches -> (N, 2, 2) upright shapes from AffNetFast with
    the shipped weights ``weights`` (a name under ``weights/``) or an npz
    in the JAX package's layout, with TF32 off."""
    dev = resolve_device(device)
    tree = (load_params_npz(weights) if weights.endswith(".npz")
            else load_pretrained(weights))
    net = AffNetFast()
    net.load_state_dict(params_from_jax(tree))
    with torch.inference_mode(), float32_math():
        A = net.to(dev)(torch.from_numpy(patches).to(dev))
    return A.cpu().numpy()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("input_image")
    parser.add_argument("output_file")
    parser.add_argument("--weights", default="AffNetFast",
                        help="pretrained weight name or .npz path")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    A = affine_shapes(load_patch_column(args.input_image, ps=AffNetFast.ps),
                      args.weights, args.device)
    write_upright_affine(args.output_file, A)
    print(f"{len(A)} affine shapes -> {args.output_file}")


if __name__ == "__main__":
    main()
