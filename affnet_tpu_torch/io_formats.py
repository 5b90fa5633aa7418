"""Oxford ellipse files: header ``1.0`` and the row count, then one row
``x y a b c`` per region at ``%10.10f``.  Byte-compatible with
``affnet_tpu/io_formats.py``'s ``write_ells``/``read_ells`` (the reference
CLI's format)."""

from __future__ import annotations

import numpy as np


def write_ells(path: str, ells: np.ndarray) -> None:
    """ells: (N, 5) rows x y a b c."""
    ells = np.asarray(ells)
    with open(path, "w") as f:
        f.write("1.0\n")
        f.write(f"{len(ells)}\n")
        for row in ells:
            f.write(" ".join(f"{v:10.10f}" for v in row) + "\n")


def read_ells(path: str) -> np.ndarray:
    """(N, 5) float64 rows of an ellipse file."""
    with open(path) as f:
        lines = f.read().strip().splitlines()
    n = int(float(lines[1]))
    rows = [list(map(float, ln.split())) for ln in lines[2:2 + n]]
    return np.array(rows, np.float64).reshape(n, 5)
