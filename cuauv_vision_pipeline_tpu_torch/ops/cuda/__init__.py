"""Hand-written CUDA kernels (``csrc/``) and their torch wrappers.

Each wrapper counts its kernel launches in a plain integer attribute
(``wrapper.launches``), so a run can show that the main path went through
the kernel; :func:`launch_counts` reads them all.
"""

from __future__ import annotations

from typing import Dict

from .ccl_kernel import label_cuda, label_cuda_batched
from .morph_kernel import fused_morph
from .nms_kernel import nms_fixed_cuda
from .spacing_kernel import spacing_select

WRAPPERS = {
    "label_cuda": label_cuda,
    "label_cuda_batched": label_cuda_batched,
    "fused_morph": fused_morph,
    "nms_fixed": nms_fixed_cuda,
    "spacing_select": spacing_select,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def add_launch_counts(counts: Dict[str, int]) -> None:
    """Add ``counts`` (keyed as :func:`launch_counts` gives them) to the
    wrappers' own: a CUDA graph's replay launches its kernels without
    calling their wrappers."""
    for name, n in counts.items():
        WRAPPERS[name].launches += n


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
