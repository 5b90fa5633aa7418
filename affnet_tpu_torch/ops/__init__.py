"""Plain tensor ops of the extraction and training paths and the wrappers of
their CUDA kernels (``cuda_*.py``, ``batched_sampler.py``).  Each wrapper
keeps a plain integer count: one per kernel launch, nowhere else."""

from . import cuda_blur, cuda_detect, cuda_patches, cuda_topk

# Kernel name -> (module, counter attribute).
COUNTERS = {
    "blur": (cuda_blur, "launches"),
    "detect": (cuda_detect, "launches"),
    "topk": (cuda_topk, "launches"),
    "patches": (cuda_patches, "launches"),
    "batched_fwd": (cuda_patches, "launches_batched"),
    "batched_bwd": (cuda_patches, "launches_bwd"),
}

# The kernels the extraction path must launch.
EXTRACTION_KERNELS = ("blur", "detect", "topk", "patches")


def launch_counts() -> dict:
    """The counts of COUNTERS, and B5 forward's by patch size
    (``batched_fwd_ps64``: the augment warps; ``batched_fwd_ps32``: the
    rewarp)."""
    counts = {name: getattr(mod, attr)
              for name, (mod, attr) in COUNTERS.items()}
    counts.update({f"batched_fwd_ps{ps}": n for ps, n
                   in sorted(cuda_patches.launches_batched_ps.items())})
    return counts


def reset_launch_counts() -> None:
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)
    cuda_patches.launches_batched_ps.clear()
