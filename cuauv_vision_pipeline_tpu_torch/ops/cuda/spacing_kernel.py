"""Greedy min-distance keypoint selection on the GPU (``csrc/spacing.cu``).

Replaces the spacing fixpoint of the JAX package's ``detect_describe``
(``cuauv_vision_pipeline_tpu/ops/feature.py:618-656``, a ``lax.while_loop``
over a ``[K, K]`` conflict matrix inside the jitted graph; it has no Pallas
kernel). In eager torch that loop would read ``torch.any(...)`` on the host
every round, a device-to-host sync in the middle of the bins chain; the
kernel runs the whole selection in two launches and never syncs.

The plain version, :func:`spacing_select_plain` below, is that fixpoint in
torch ops: CPU tensors take it; CUDA tensors launch the kernel (counting one
launch) or raise.

Design (see the source's header): a grid launch fills the conflict matrix
as bit rows in a scratch this wrapper allocates (K²/8 bytes: 32 KB at the
bins path's K = 512, 2 MB at K = 4096), then one block runs the fixpoint's
keep/kill rounds on bitsets with ``__syncthreads_or`` as the loop test.
Integer arithmetic throughout: the kept set is exact, no tolerance.

Bound on this card: the distance tests and the 10 bytes per candidate take
well under a microsecond at K = 512; the two launches and the block's
barriers are what it costs.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "spacing_select": (_I, [_P, _P, _P, _P, _P, _I, ctypes.c_longlong, _I, _P]),
    "spacing_error_string": (ctypes.c_char_p, [_I]),
}


def spacing_select_plain(
    ys: torch.Tensor, xs: torch.Tensor, cand: torch.Tensor, min_distance: int
) -> torch.Tensor:
    """The greedy selection in torch ops (the plain version of
    ``csrc/spacing.cu``): the JAX package's fixpoint over the ``[K, K]``
    conflict matrix, one host-tested round at a time. ``ys``/``xs`` integer
    ``[K]`` strongest first, ``cand`` bool ``[K]``; returns kept bool ``[K]``:
    ``cand[i]`` and no kept ``j < i`` with ``dy² + dx² < min_distance²``.

    It builds the whole ``[K, K]`` int64 distance matrix (and bool ones of
    the same shape): 128 MB at K = 4096, growing with K². Fine for the
    tests and the card's checks; the kernel needs K²/8 bytes."""
    y = ys.to(torch.int64)
    x = xs.to(torch.int64)
    K = cand.shape[0]
    idx = torch.arange(K, device=cand.device)
    d2 = (y[:, None] - y[None, :]) ** 2 + (x[:, None] - x[None, :]) ** 2
    # conflicts[i, j]: candidate j is stronger (earlier) and too close
    conflicts = (d2 < int(min_distance) ** 2) & (idx[None, :] < idx[:, None]) & cand[None, :]
    kept = torch.zeros_like(cand)
    killed = torch.zeros_like(cand)
    while True:
        undec = cand & ~kept & ~killed
        if not bool(undec.any()):
            return kept
        newly_kept = undec & ~(conflicts & ~killed[None, :]).any(dim=1)
        kept = kept | newly_kept
        killed = killed | ((undec & ~newly_kept) & (conflicts & kept[None, :]).any(dim=1))


def spacing_select(
    ys: torch.Tensor, xs: torch.Tensor, cand: torch.Tensor, min_distance: int
) -> torch.Tensor:
    """Greedy min-distance selection of ``K`` candidates, strongest first:
    ``ys``/``xs`` int32 ``[K]``, ``cand`` bool ``[K]``, any ``K >= 1``.
    Returns kept bool ``[K]``. A CPU tensor goes to
    :func:`spacing_select_plain`; a CUDA tensor launches the kernel (and
    counts one launch) or raises."""
    if cand.device.type == "cpu":
        return spacing_select_plain(ys, xs, cand, min_distance)
    if cand.device.type != "cuda":
        raise ValueError(f"cand must be a CUDA or CPU tensor, got {cand.device}")
    if cand.ndim != 1 or cand.shape[0] < 1:
        raise ValueError(f"cand must be [K] with 1 <= K, got {tuple(cand.shape)}")
    if int(min_distance) < 0:
        raise ValueError(f"min_distance must be >= 0, got {min_distance}")
    K = cand.shape[0]
    dev = cand.device
    _build.check_tensor("cand", cand, torch.bool, (K,), dev)
    _build.check_tensor("ys", ys, torch.int32, (K,), dev)
    _build.check_tensor("xs", xs, torch.int32, (K,), dev)

    lib = _build.load("spacing", _SIGNATURES)
    scratch = torch.empty((K + 31) // 32 * K, dtype=torch.int32, device=dev)
    kept = torch.empty(K, dtype=torch.bool, device=dev)
    spacing_select.launches += 1
    err = lib.spacing_select(
        ys.data_ptr(), xs.data_ptr(), cand.data_ptr(), kept.data_ptr(),
        scratch.data_ptr(), K, int(min_distance) ** 2, dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, "spacing", err, "spacing_select launch")
    return kept


spacing_select.launches = 0
