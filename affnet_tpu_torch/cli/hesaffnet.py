"""Image loading shared by the port's command-line programs.

``load_gray`` is the counterpart of ``affnet_tpu/cli/hesaffnet.py``'s; the
HesAffNet program itself is not ported yet.
"""

from __future__ import annotations

import numpy as np


def load_gray(fname: str) -> np.ndarray:
    """RGB mean-channel grayscale in [0, 255], float32, like the reference.
    Needs PIL (imported here, not with the module)."""
    from PIL import Image
    img = Image.open(fname).convert("RGB")
    return np.mean(np.asarray(img), axis=2).astype(np.float32)
