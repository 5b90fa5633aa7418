"""One-pass dense-AffNet extraction (OnePassSIR): image -> Oxford .ells
file, and optionally LAFs and descriptors, with per-stage timing prints.

Counterpart of ``affnet_tpu/cli/extract_geom.py``, with its settings:
border 15, mrSize 5.192, no Baumberg loop, the dense AffNet from the
shipped AffNetFast weights (the dense trunk has its layers), PS 32.  Top-k
mode keeps the ``nfeats`` strongest; ``--th`` (e.g. 28.41, the classical
HessianAffine threshold) keeps every survivor of the boundary gate, in scan
order.  ``--do-ori`` adds OriNetFast32 (the shipped OriNetFast weights),
``--descriptor`` SIFT or HardNet (``--desc-weights``: an npz in the JAX
package's layout), ``--fast`` the bf16 mode (the dense AffNet stays
float32).  Runs on the card unless ``--device cpu`` asks for the plain
versions on the CPU.

HardNet without ``--desc-weights`` is initialized from the port's own
seeded init (``models.cnn.init_params``, seed 0): its weights are not the
ones JAX's ``PRNGKey(0)`` gives.

Usage: python -m affnet_tpu_torch.cli.extract_geom img.png out.txt 2000
       [--descriptor SIFT] [--save-descs d.npy]
       python -m affnet_tpu_torch.cli.extract_geom img.png out.txt
       --th 28.41 --do-ori --save-lafs lafs1.npy

Images are read as the RGB mean in [0, 255] with PIL; a ``.npy`` file (an
(H, W) or (H, W, 3) array) is read with numpy and needs no PIL.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch

from .. import load_params_npz, load_pretrained
from ..detector import DetectorConfig
from ..io_formats import write_ells, write_lafs_npy
from ..laf import lafs_to_ells
from ..models import HardNet, OriNetFast32, params_from_jax
from ..models.cnn import init_params
from ..models.sift import SIFTNet
from ..onepass import OnePassSIR
from .hesaffnet import load_gray


def make_descriptor(name: Optional[str], weights: Optional[str] = None):
    """The ``--descriptor`` net: None, SIFT (PS 32) or HardNet (from an
    npz, or the port's seeded init)."""
    if name is None:
        return None
    if name == "SIFT":
        return SIFTNet(patch_size=32)
    net = HardNet()
    if weights:
        net.load_state_dict(params_from_jax(load_params_npz(weights)))
    else:
        init_params(net, torch.Generator().manual_seed(0))
    return net.eval()


def make_extractor(nfeats: int = 2000, th: Optional[float] = None,
                   do_ori: bool = False, descriptor: Optional[str] = None,
                   desc_weights: Optional[str] = None, fast: bool = False,
                   max_keypoints: int = 16384, device="cuda",
                   use_kernels: bool = True) -> OnePassSIR:
    """The program's extractor."""
    cfg = DetectorConfig(num_features=nfeats, border=15, mr_size=5.192,
                         num_baum_iters=0, th=th,
                         max_keypoints=max_keypoints, patch_size=32,
                         fast=fast)
    ori = None
    if do_ori:
        ori = OriNetFast32()
        ori.load_state_dict(params_from_jax(load_pretrained("OriNetFast")))
    return OnePassSIR(cfg, ori_net=ori,
                      desc_net=make_descriptor(descriptor, desc_weights),
                      device=device, use_kernels=use_kernels)


def extract(det: OnePassSIR, img: np.ndarray, do_ori: bool = False
            ) -> Dict[str, np.ndarray]:
    """The extractor's output on one (H, W) image, ``ells`` added, with the
    program's timing prints."""
    t0 = time.time()
    out = det(img, do_ori=do_ori, describe=det.desc_net is not None)
    print(f"det time = {time.time() - t0:.3f}")
    t0 = time.time()
    out["ells"] = lafs_to_ells(torch.from_numpy(out["lafs"])).numpy()
    print(f"LAFs2ell time = {time.time() - t0:.3f}")
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("input_image")
    parser.add_argument("output_fname")
    parser.add_argument("nfeats", type=int, nargs="?", default=2000)
    parser.add_argument("--th", type=float, default=None,
                        help="threshold mode (e.g. 28.41, the classical "
                             "HessianAffine default)")
    parser.add_argument("--do-ori", action="store_true")
    parser.add_argument("--descriptor", default=None,
                        choices=[None, "SIFT", "HardNet"])
    parser.add_argument("--desc-weights", default=None)
    parser.add_argument("--fast", action="store_true",
                        help="bf16 patch sampling and nets (float32 "
                             "detection and dense AffNet)")
    parser.add_argument("--save-lafs", default=None)
    parser.add_argument("--save-descs", default=None)
    parser.add_argument("--max-keypoints", type=int, default=16384,
                        help="cap on the top-k counts (threshold mode keeps "
                             "every survivor)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (the plain versions)")
    args = parser.parse_args(argv)
    img = load_gray(args.input_image)
    det = make_extractor(args.nfeats, args.th, args.do_ori, args.descriptor,
                         args.desc_weights, args.fast, args.max_keypoints,
                         args.device)
    out = extract(det, img, args.do_ori)
    write_ells(args.output_fname, out["ells"])
    if args.save_lafs:
        write_lafs_npy(args.save_lafs, out["lafs"])
    if args.save_descs and "descs" in out:
        np.save(args.save_descs, out["descs"])
    print(f"{len(out['ells'])} regions -> {args.output_fname}")


if __name__ == "__main__":
    main()
