"""File formats, byte-compatible with ``affnet_tpu/io_formats.py`` (the
reference CLIs' formats):

- Oxford ellipse files: header ``1.0`` and the row count, then one row
  ``x y a b c`` per region at ``%10.10f``;
- upright affine shapes: rows ``a11 0 a21 a22`` at ``%10.5f``;
- homographies: 3x3 whitespace-separated text;
- LAFs as ``.npy``.
"""

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


def write_upright_affine(path: str, a_matrices: np.ndarray) -> None:
    """(N, 2, 2) upright shapes (a12 == 0) -> rows ``a11 0 a21 a22``."""
    A = np.asarray(a_matrices)
    flat = np.stack([A[:, 0, 0], A[:, 0, 1], A[:, 1, 0], A[:, 1, 1]], axis=1)
    np.savetxt(path, flat, fmt="%10.5f")


def read_homography(path: str) -> np.ndarray:
    """A 3x3 float64 homography from a whitespace-separated text file."""
    return np.loadtxt(path).astype(np.float64).reshape(3, 3)


def write_lafs_npy(path: str, lafs: np.ndarray) -> None:
    """LAFs as an ``.npy`` array, as given."""
    np.save(path, np.asarray(lafs))
