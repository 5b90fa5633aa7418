"""Kernel B3: per-row top-m, stage 1 of the exact two-stage global top-k.

Replaces ``affnet_tpu/ops/pallas_topk.py:_row_topm_kernel`` (entry
``row_topm_pallas``).  CUDA source: ``csrc/topk.cu``.

The flat contract: a float32 vector of n values read as rows of 1024, the
entries at or after n reading as -1.0 (as the JAX package's padded copy
holds them), so the caller pads nothing.  For each row: m rounds of (row
max, lowest column holding it, mask that column to -1), then the row max
of what is left.  Outputs are bit-identical to the plain version
(:func:`row_topm_flat_plain`): the kernel only compares and moves values.
Inputs must be free of NaN (detector responses are finite for a finite
image).  :func:`row_topm_plain` on the padded (B, 1024) matrix is the JAX
package's ``nms._row_topm``, the yardstick of the CPU tests.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..kernels.build import check_tensor, launch, stream_of

Tensor = torch.Tensor

ROW_WIDTH = 1024   # csrc/topk.cu: 32 values per lane of one warp
MAX_N = (1 << 31) - 1 - ROW_WIDTH      # csrc/topk.cu: 32-bit indices
MAX_M = 32

launches = 0


def row_topm_plain(x2d: Tensor, m: int) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch version (the JAX ``nms._row_topm``): returns
    (vals (B, m) f32, cols (B, m) int32, leftover (B,) f32); among equal
    values the lowest column is taken first."""
    b, s = x2d.shape
    col = torch.arange(s, device=x2d.device).expand(b, s)
    cur = x2d
    vals, cols = [], []
    for _ in range(m):
        rmax = cur.max(dim=1, keepdim=True).values
        amax = torch.where(cur >= rmax, col, s).min(dim=1,
                                                    keepdim=True).values
        vals.append(rmax[:, 0])
        cols.append(amax[:, 0])
        cur = torch.where(col == amax, -1.0, cur)
    return (torch.stack(vals, 1), torch.stack(cols, 1).to(torch.int32),
            cur.max(dim=1).values)


def row_topm_flat_plain(values: Tensor, m: int
                        ) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain version of B3's flat contract: the (n,) vector padded with -1
    to whole rows of 1024, then :func:`row_topm_plain`."""
    n = values.numel()
    b = -(-n // ROW_WIDTH)
    x2d = F.pad(values, (0, b * ROW_WIDTH - n), value=-1.0)
    return row_topm_plain(x2d.reshape(b, ROW_WIDTH), m)


def row_topm_flat_cuda(values: Tensor, m: int
                       ) -> Tuple[Tensor, Tensor, Tensor]:
    """Launch B3 on a contiguous float32 (n,) CUDA tensor, read as
    ceil(n / 1024) rows (no padded copy)."""
    global launches
    check_tensor(values, "values", torch.float32, 1)
    n = values.numel()
    if not 1 <= n <= MAX_N:
        raise ValueError(f"row_topm: need 1 <= n <= {MAX_N}, got {n}")
    if not 1 <= m <= MAX_M:
        raise ValueError(f"row_topm: need 1 <= m <= {MAX_M}, got {m}")
    b = -(-n // ROW_WIDTH)
    vals = torch.empty((b, m), dtype=torch.float32, device=values.device)
    cols = torch.empty((b, m), dtype=torch.int32, device=values.device)
    leftover = torch.empty((b,), dtype=torch.float32, device=values.device)
    launch("launch_row_topm", values.data_ptr(), n, vals.data_ptr(),
           cols.data_ptr(), leftover.data_ptr(), b, m, stream_of(values))
    launches += 1
    return vals, cols, leftover


def row_topm_flat(values: Tensor, m: int, use_kernel: bool = True
                  ) -> Tuple[Tensor, Tensor, Tensor]:
    """B3 on the flat vector for a CUDA tensor; the plain version for a CPU
    tensor or when ``use_kernel`` is False."""
    if values.device.type == "cpu" or not use_kernel:
        return row_topm_flat_plain(values, m)
    return row_topm_flat_cuda(values.contiguous(), m)

