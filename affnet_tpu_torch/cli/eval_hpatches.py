"""HPatches benchmark: verification, matching and retrieval.

Counterpart of ``affnet_tpu/cli/eval_hpatches.py`` with its flags, plus
``--device``: the three HPatches descriptor tasks over a local
``hpatches-release`` tree (``hpatches.run_benchmark``), one JSON object on
stdout.  When the tree is absent the program prints JAX's skip line,
``{"skipped": true, "reason": "no HPatches data at ..."}``, and exits 0.
The descriptors run on the card unless ``--device cpu`` asks for the CPU.

Usage:
    python -m affnet_tpu_torch.cli.eval_hpatches \\
        --root datasets/hpatches-release --descriptor TFeat \\
        [--weights my_hardnet.npz] [--max-seqs 20] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default="datasets/hpatches-release")
    p.add_argument("--descriptor", default="TFeat",
                   choices=["TFeat", "HardNet", "SIFT", "pixels"])
    p.add_argument("--weights", default=None,
                   help=".npz params (e.g. a from-scratch-trained HardNet)")
    p.add_argument("--max-seqs", type=int, default=None)
    p.add_argument("--tasks", default="verification,matching,retrieval")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain versions)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ..hpatches import run_benchmark
    try:
        out = run_benchmark(args.root, descriptor=args.descriptor,
                            weights=args.weights, max_seqs=args.max_seqs,
                            tasks=tuple(args.tasks.split(",")),
                            device=args.device)
    except FileNotFoundError as e:
        print(json.dumps({"skipped": True,
                          "reason": f"no HPatches data at {e}"}))
        return 0
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
