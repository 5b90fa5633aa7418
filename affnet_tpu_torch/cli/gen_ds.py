"""Download and cache the 6 Brown/PhotoTour datasets.

Counterpart of ``affnet_tpu/cli/gen_ds.py`` (reference: gen_ds.py:28-86,
run_me.sh:2-8): for each subset, ``<root>/<name>.npz`` (patches uint8,
labels) from the extracted ``<root>/<name>`` directory, downloaded first
when it is missing; read by ``data.load_total_datasets``.  Without a
network, place the extracted datasets under the root.

Usage: python -m affnet_tpu_torch.cli.gen_ds [--root dataset/6Brown]
"""

from __future__ import annotations

import argparse
import os

from ..data import cache_phototour


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default="dataset/6Brown")
    parser.add_argument("--subsets", nargs="*", default=[
        "liberty", "notredame", "yosemite",
        "liberty_harris", "notredame_harris", "yosemite_harris"])
    args = parser.parse_args(argv)

    os.makedirs(args.root, exist_ok=True)
    for name in args.subsets:
        try:
            path = cache_phototour(args.root, name, download=True)
            print(f"{name}: cached at {path}")
        except Exception as e:  # no network: report and go on
            print(f"{name}: FAILED ({e}); place the extracted dataset at "
                  f"{os.path.join(args.root, name)} and re-run")


if __name__ == "__main__":
    main()
