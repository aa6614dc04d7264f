"""The one frame generator every traffic mix feeds: seeded underwater scenes.

A scene is a teal, noisy backdrop (green-shifted, so its LAB a* sits well
below neutral, as a ZED sees the pool) with red discs (buoys) and small red
speckles (clutter that passes the same threshold). The mix's data file gives
the counts, sizes and colours; the seed places them.

Every seed draws the same multiset of disc and speckle radii and the same
disc count per frame, in another order and at other places, so the device
work of a ring barely depends on the seed. With ``eyes`` = 2 each scene is
also seen by a second camera as the same frame shifted left by a disparity
drawn from the mix's range (a stereo pair), and the ring interleaves the
two eyes: frame 2p is the left eye of pair p, 2p + 1 its right eye.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

_MASK63 = (1 << 63) - 1


def substream(seed: int, stream: int) -> int:
    """A seed for one independent stream of a run's random numbers."""
    return (int(seed) * 1_000_003 + 7919 * stream) & _MASK63


def _spread(lo: float, hi: float, n: int, gen: torch.Generator) -> List[float]:
    """n values evenly spread over [lo, hi], in a seeded order."""
    if n == 0:
        return []
    vals = torch.linspace(float(lo), float(hi), n, dtype=torch.float64)
    return vals[torch.randperm(n, generator=gen)].tolist()


def _cycle(counts: Sequence[int], n: int) -> List[int]:
    return [int(counts[i % len(counts)]) for i in range(n)]


def _draw_discs(frames: torch.Tensor, owner: List[int], radii: List[float],
                base_bgr: Sequence[int], jitter: int, gen: torch.Generator) -> None:
    n, H, W, _ = frames.shape
    for i, r in zip(owner, radii):
        cy = float(torch.rand((), generator=gen, dtype=torch.float64)) * H
        cx = float(torch.rand((), generator=gen, dtype=torch.float64)) * W
        colour = [min(255, max(0, int(c) + int(torch.randint(-jitter, jitter + 1, (), generator=gen))))
                  for c in base_bgr]
        y0, y1 = max(0, int(cy - r)), min(H, int(cy + r) + 1)
        x0, x1 = max(0, int(cx - r)), min(W, int(cx + r) + 1)
        if y0 >= y1 or x0 >= x1:
            continue
        ys = torch.arange(y0, y1, device=frames.device, dtype=torch.float32)[:, None]
        xs = torch.arange(x0, x1, device=frames.device, dtype=torch.float32)[None, :]
        inside = (ys - cy) ** 2 + (xs - cx) ** 2 <= r * r
        region = frames[i, y0:y1, x0:x1]
        region[inside] = torch.tensor(colour, dtype=torch.uint8, device=frames.device)


def make_scenes(n: int, height: int, width: int, scene: Dict, seed: int,
                device: torch.device) -> torch.Tensor:
    """``n`` u8 BGR frames ``[n, height, width, 3]`` on ``device``, made
    from ``seed`` by the parameters of a mix's ``scene`` entry."""
    eyes = int(scene.get("eyes", 1))
    if eyes not in (1, 2) or n % eyes:
        raise ValueError(f"{n} frames cannot hold {eyes} eyes")
    views = n // eyes
    params = torch.Generator().manual_seed(substream(seed, 1))
    noise = torch.Generator(device=device).manual_seed(substream(seed, 2))

    lo = torch.tensor(scene["backdrop_bgr_low"], dtype=torch.int16, device=device)
    hi = torch.tensor(scene["backdrop_bgr_high"], dtype=torch.int16, device=device)
    frames = torch.randint(0, 1 << 15, (views, height, width, 3), generator=noise,
                           device=device, dtype=torch.int16)
    frames = (lo + frames % (hi - lo)).to(torch.uint8)

    for kind in ("disc", "speckle"):
        counts = _cycle(scene[f"{kind}s_per_frame"], views)
        owner = [i for i, c in enumerate(counts) for _ in range(c)]
        radii = _spread(*scene[f"{kind}_radius_px"], len(owner), params)
        _draw_discs(frames, owner, radii, scene[f"{kind}_bgr"], int(scene.get(f"{kind}_jitter", 0)), params)

    if eyes == 1:
        return frames
    shifts = [int(round(d)) for d in _spread(*scene["disparity_px"], views, params)]
    right = torch.stack([torch.roll(frames[p], -s, dims=1) for p, s in enumerate(shifts)])
    return torch.stack([frames, right], dim=1).reshape(n, height, width, 3)
