"""Host-side contour extraction and polygon geometry.

A copy of ``cuauv_vision_pipeline_tpu.utils.contours`` (numpy and ctypes
only); its native fast paths are the port's own ``native/src/imgeom.cpp``
(byte for byte the JAX package's), loaded through the port's
``native.library_path()``. tests/test_torch_bins_module.py holds its point
sets against the JAX package's copy.

The device path (ops/ccl.py) returns label maps and per-blob stats; these
helpers produce cv2-style *point lists* for the host-only consumers —
drawing, polygon moments, rotated rectangles (reference utils/feature.py,
modules/bins.py:10-81, handlers/*). Tracing runs on the downloaded mask and
only for debug/geometry work, never in the device hot loop.

Contours are returned in cv2.findContours shape convention: ``[N, 1, 2]``
int32 arrays of (x, y) points, outer boundaries traced counterclockwise
(in image coordinates with y down this appears clockwise on screen, same as
OpenCV). Point *sets* match OpenCV's border following; the start point is
the topmost-leftmost boundary pixel.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Tuple

import numpy as np

# Moore neighborhood in counterclockwise order starting from west:
# (dx, dy) pairs.
def _cross2(a, b) -> float:
    return float(a[0] * b[1] - a[1] * b[0])


_MOORE = np.array(
    [(-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1)],
    dtype=np.int32,
)


_NATIVE_SENTINEL = object()
_native_trace = _NATIVE_SENTINEL  # lazily resolved; None = unavailable


def _load_native_tracer():
    """ctypes handle to vp_trace_boundary in libframebus.so, or None.

    The native tracer is a 1:1 twin of the Python loop below (~10 ns vs
    ~10 us per boundary pixel); parity is pinned (for the JAX package's
    copy) by tests/test_utils_feature.py::test_native_tracer_matches_python.
    Set CUAUV_NATIVE_TRACE=0 to force the Python path.
    """
    global _native_trace
    if _native_trace is not _NATIVE_SENTINEL:
        return _native_trace
    _native_trace = None
    if os.environ.get("CUAUV_NATIVE_TRACE", "1") != "0":
        try:
            from .. import native as _native_pkg

            lib = ctypes.CDLL(_native_pkg.library_path())
            fn = lib.vp_trace_boundary
            fn.restype = ctypes.c_int64
            fn.argtypes = [
                ctypes.c_void_p,  # fg (uint8, padded, C-contiguous)
                ctypes.c_int64,  # H
                ctypes.c_int64,  # W
                ctypes.c_int64,  # sy
                ctypes.c_int64,  # sx
                ctypes.c_int64,  # start_dir (Moore index of a bg neighbor)
                ctypes.c_void_p,  # out_xy (int32 pairs)
                ctypes.c_int64,  # max_pts
            ]
            _native_trace = fn
        except Exception:
            _native_trace = None
    return _native_trace


class _NativeTraceSession:
    """Per-find_contours native tracing state: cached data pointers and one
    reusable output buffer (grown once to the tracer's worst-case step budget
    if a contour overflows). trace() returns a VIEW into the buffer — callers
    must materialize (the ``- 1`` un-pad copy does) before the next trace()."""

    __slots__ = ("_fn", "_H", "_W", "_fg_ptr", "_buf", "_buf_ptr", "_fg_u8")

    def __init__(self, fn, fg: np.ndarray):
        self._fn = fn
        self._fg_u8 = np.ascontiguousarray(fg, dtype=np.uint8)
        self._H, self._W = self._fg_u8.shape
        self._fg_ptr = self._fg_u8.ctypes.data
        self._buf = np.empty((1 << 16, 2), dtype=np.int32)
        self._buf_ptr = self._buf.ctypes.data

    def trace(self, sy: int, sx: int, start_dir: int = 0) -> np.ndarray:
        n = self._fn(
            self._fg_ptr, self._H, self._W, sy, sx, start_dir,
            self._buf_ptr, len(self._buf),
        )
        if n < 0:  # contour longer than the buffer: grow to the step budget
            # worst case emits the start point + one point per budget step
            self._buf = np.empty((4 * self._H * self._W + 2, 2), dtype=np.int32)
            self._buf_ptr = self._buf.ctypes.data
            n = self._fn(
                self._fg_ptr, self._H, self._W, sy, sx, start_dir,
                self._buf_ptr, len(self._buf),
            )
        assert n >= 0, "native tracer overflowed its worst-case buffer"
        return self._buf[:n].reshape(-1, 1, 2)


def _trace_boundary(
    fg: np.ndarray, start: Tuple[int, int], prev_dir: int = 0
) -> np.ndarray:
    """Moore-neighbor boundary tracing (Jacob's stopping criterion). fg is a
    padded bool array.

    prev_dir is the _MOORE index of a KNOWN-bg neighbor of the start pixel —
    0 (west) for outer boundaries started at a component's topmost-leftmost
    pixel; 2 (south) for hole boundaries started at the fg pixel just above a
    hole's topmost-leftmost pixel (the hole pixel itself is the bg anchor; a
    wrong anchor breaks Jacob's criterion and the trace runs its full step
    budget)."""
    sy, sx = start
    contour = [(sx, sy)]
    cy, cx = sy, sx
    first_move: Optional[Tuple[int, int, int]] = None

    for _ in range(4 * fg.size):
        # search the Moore neighborhood clockwise starting after prev_dir
        found = False
        for k in range(1, 9):
            d = (prev_dir + k) % 8
            dx, dy = _MOORE[d]
            ny, nx = cy + dy, cx + dx
            if fg[ny, nx]:
                # next boundary pixel; new backtrack = direction of the
                # previous (bg) neighbor as seen from the new pixel
                bdx, bdy = _MOORE[(d + 7) % 8]
                # position we checked just before finding fg (a bg pixel)
                prev_bg = (cy + _MOORE[(d - 1) % 8][1], cx + _MOORE[(d - 1) % 8][0])
                # direction from new pixel back to that bg pixel
                rel = (prev_bg[1] - nx, prev_bg[0] - ny)  # (dx, dy)
                idx = _dir_index(rel)
                move = (cy, cx, d)
                if first_move is None:
                    first_move = move
                elif (cy, cx) == (sy, sx) and move == first_move:
                    return np.array(contour[:-1], dtype=np.int32).reshape(-1, 1, 2)
                cy, cx = ny, nx
                contour.append((cx, cy))
                prev_dir = idx
                found = True
                break
        if not found:
            break  # isolated pixel
    return np.array(
        contour[:-1] if len(contour) > 1 else contour, dtype=np.int32
    ).reshape(-1, 1, 2)


_DIR_LOOKUP = {tuple(d): i for i, d in enumerate(map(tuple, _MOORE))}


def _dir_index(rel: Tuple[int, int]) -> int:
    return _DIR_LOOKUP[rel]


def find_contours(
    mask: np.ndarray, external_only: bool = True
) -> List[np.ndarray]:
    """Extract boundary contours of a binary mask.

    external_only=True matches cv2.RETR_EXTERNAL (outer boundaries only);
    False additionally traces hole boundaries (cv2.RETR_LIST equivalent).
    """
    mask = np.asarray(mask)
    if mask.ndim == 3:
        mask = mask[..., 0]
    fg = np.pad(mask != 0, 1, constant_values=False)

    contours: List[np.ndarray] = []
    H, W = fg.shape

    # Outer boundary starts: fg pixel whose west neighbor is bg and which is
    # the first (raster order) pixel of a not-yet-traced component. Run
    # starts from the labeler ARE exactly those pixels, in raster order — no
    # separate argwhere pass over the image, and no label raster needed.
    starts = _first_starts(_component_runs(fg), start_dir=0)
    contours.extend(_trace_starts(fg, starts))

    if not external_only:
        contours.extend(_hole_contours(fg))
    # cv2 returns contours bottom-to-top of the image in modern versions;
    # keep raster order of discovery (top-to-bottom) — callers in the
    # reference never rely on list order beyond max()/filters.
    return contours


def _hole_contours(fg: np.ndarray) -> List[np.ndarray]:
    """Boundaries of holes (bg regions not connected to the border).

    A hole is a 4-connected bg component (cv2's hole connectivity) whose runs
    never touch the image border — found from the run labeler directly, no
    iterative flood fill. Hole dedup for *tracing* then uses 8-connected
    labeling of the hole mask (diagonal-touching holes share a surrounding
    boundary and are traced once), preserving the original semantics."""
    bg = ~fg
    H, W = fg.shape
    bg_runs = _component_runs(bg, connectivity=4)
    ys, ss, es, roots = (bg_runs[:, i] for i in range(4))
    on_border = (ys == 0) | (ys == H - 1) | (ss == 0) | (es == W)
    border_roots = np.unique(roots[on_border])
    hole_runs = bg_runs[~np.isin(roots, border_roots)]
    if len(hole_runs) == 0:
        return []
    holes = np.zeros_like(bg)
    for y, s, e, _root in hole_runs.tolist():
        holes[y, s:e] = True
    # trace the fg boundary around each hole: start at the pixel just above
    # each hole's first pixel (raster order); start_dir=2 = the bg anchor is
    # the hole pixel to the south
    starts = _first_starts(
        _component_runs(holes, connectivity=8), start_dir=2, y_off=-1
    )
    return _trace_starts(fg, starts)


def _label_components(fg: np.ndarray) -> np.ndarray:
    """Host-side 8-connected labeling: run-length union-find (see _label_core)."""
    return _label_core(fg, want_labels=True)[0]


def _component_runs(fg: np.ndarray, connectivity: int = 8) -> np.ndarray:
    """Foreground runs with resolved component roots, raster order.

    Returns an int32 ``[N, 4]`` array of ``(y, start, end, root)`` rows — the
    first run of each root is the component's topmost-leftmost pixel (a Moore
    trace start), so callers get trace starts without any full-image argwhere
    pass."""
    return _label_core(fg, want_labels=False, connectivity=connectivity)[1]


def _first_starts(
    runs: np.ndarray, start_dir: int, y_off: int = 0
) -> np.ndarray:
    """Trace starts from a run list: int32 [n, 3] of (sy, sx, start_dir),
    one per component (its first run in raster order = topmost-leftmost)."""
    if len(runs) == 0:
        return np.empty((0, 3), np.int32)
    _, first_idx = np.unique(runs[:, 3], return_index=True)
    first_idx.sort()
    sel = runs[first_idx]
    out = np.empty((len(sel), 3), np.int32)
    out[:, 0] = sel[:, 0] + y_off
    out[:, 1] = sel[:, 1]
    out[:, 2] = start_dir
    return out


_native_trace_all = _NATIVE_SENTINEL  # lazily resolved; None = unavailable


def _load_native_trace_all():
    """ctypes handle to vp_trace_all in libframebus.so, or None."""
    global _native_trace_all
    if _native_trace_all is not _NATIVE_SENTINEL:
        return _native_trace_all
    _native_trace_all = None
    if os.environ.get("CUAUV_NATIVE_TRACE", "1") != "0":
        try:
            from .. import native as _native_pkg

            lib = ctypes.CDLL(_native_pkg.library_path())
            fn = lib.vp_trace_all
            fn.restype = ctypes.c_int64
            fn.argtypes = [
                ctypes.c_void_p,  # fg (uint8, padded, C-contiguous)
                ctypes.c_int64,  # H
                ctypes.c_int64,  # W
                ctypes.c_void_p,  # starts (int32 [n, 3])
                ctypes.c_int64,  # n_starts
                ctypes.c_void_p,  # out_xy (int32 pairs)
                ctypes.c_int64,  # max_pts
                ctypes.c_void_p,  # out_offsets (int64 [n+1])
            ]
            _native_trace_all = fn
        except Exception:
            _native_trace_all = None
    return _native_trace_all


def _trace_starts(fg: np.ndarray, starts: np.ndarray) -> List[np.ndarray]:
    """Trace every (sy, sx, start_dir) boundary start; [N, 1, 2] un-padded
    contours in starts order.

    One vp_trace_all call traces the whole batch (the per-contour FFI round
    trip dominated dense masks); contours are disjoint-range views into one
    freshly allocated buffer. Falls back to the per-contour native tracer,
    then to the pure-Python tracer."""
    if len(starts) == 0:
        return []
    fn_all = _load_native_trace_all()
    if fn_all is not None:
        fg_u8 = np.ascontiguousarray(fg, dtype=np.uint8)
        H, W = fg_u8.shape
        starts_c = np.ascontiguousarray(starts, dtype=np.int32)
        offs = np.empty(len(starts) + 1, dtype=np.int64)
        cap = max(1 << 16, 16 * len(starts))
        while True:
            buf = np.empty((cap, 2), dtype=np.int32)
            n = fn_all(
                fg_u8.ctypes.data, H, W, starts_c.ctypes.data, len(starts_c),
                buf.ctypes.data, cap, offs.ctypes.data,
            )
            if n >= 0:
                break
            # worst case: every tracer step of every contour emits a point
            assert cap < 4 * H * W + 2, "batch tracer overflowed worst case"
            cap = 4 * H * W + 2
        bounds = offs.tolist()
        return [
            buf[bounds[i] : bounds[i + 1]].reshape(-1, 1, 2)
            for i in range(len(starts_c))
        ]
    fn = _load_native_tracer()
    session = _NativeTraceSession(fn, fg) if fn is not None else None
    out: List[np.ndarray] = []
    for sy, sx, sd in starts.tolist():
        if session is not None:
            contour = session.trace(sy, sx, start_dir=sd)
        else:
            contour = _trace_boundary(fg, (sy, sx), prev_dir=sd)
        out.append(contour - 1)  # un-pad (copies out of the session buffer)
    return out


_native_runs = _NATIVE_SENTINEL  # lazily resolved; None = unavailable


def _load_native_runs():
    """ctypes handle to vp_component_runs in libframebus.so, or None.

    The native labeler is a 1:1 twin of the Python sweep in _label_core
    (identical run lists and label rasters — pinned by
    tests/test_utils_feature.py). It turns the per-run Python loop into a
    C row scan: a dense noisy 720p mask (~180k runs) labels in ~3 ms where
    the Python sweep takes ~300 ms. Set CUAUV_NATIVE_TRACE=0 to force the
    Python path (same switch as the tracer: both are imgeom.cpp kernels).
    """
    global _native_runs
    if _native_runs is not _NATIVE_SENTINEL:
        return _native_runs
    _native_runs = None
    if os.environ.get("CUAUV_NATIVE_TRACE", "1") != "0":
        try:
            from .. import native as _native_pkg

            lib = ctypes.CDLL(_native_pkg.library_path())
            fn = lib.vp_component_runs
            fn.restype = ctypes.c_int64
            fn.argtypes = [
                ctypes.c_void_p,  # fg (uint8, C-contiguous, unpadded)
                ctypes.c_int64,  # H
                ctypes.c_int64,  # W
                ctypes.c_int64,  # connectivity (8 or 4)
                ctypes.c_void_p,  # labels_out (int32 H*W) or None
                ctypes.c_void_p,  # runs_out (int32 [max_runs, 4])
                ctypes.c_int64,  # max_runs
            ]
            _native_runs = fn
        except Exception:
            _native_runs = None
    return _native_runs


def _label_core(
    fg: np.ndarray, want_labels: bool, connectivity: int = 8
) -> Tuple[Optional[np.ndarray], List[Tuple[int, int, int, int]]]:
    """Run-length union-find labeling.

    Python work is O(row runs), not O(pixels) — each row's foreground runs
    come from one vectorized diff, and only run-to-run overlaps (dilated by
    1 for 8-connectivity) touch the union-find. A 720p mask with a handful
    of blobs labels in ~0.5 ms where the old per-pixel loop took ~220 ms
    (it dominated the bins module's host leg).

    want_labels=False skips the raster writes and the final full-image remap
    gather and returns only the run list (find_contours' path: it needs trace
    starts and dedup roots, never the label image)."""
    H, W = fg.shape
    fn = _load_native_runs()
    if fn is not None:
        fg_u8 = np.ascontiguousarray(fg, dtype=np.uint8)
        max_runs = H * ((W + 1) // 2) + 1  # every row fully striped
        runs = np.empty((max_runs, 4), dtype=np.int32)
        labels = np.zeros((H, W), dtype=np.int32) if want_labels else None
        n = fn(
            fg_u8.ctypes.data, H, W, connectivity,
            None if labels is None else labels.ctypes.data,
            runs.ctypes.data, max_runs,
        )
        assert n >= 0, "native labeler overflowed its worst-case run buffer"
        return labels, runs[:n].copy()
    labels = np.zeros((H, W), dtype=np.int32) if want_labels else None
    parent = [0]

    def find(a: int) -> int:
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    def union(a: int, b: int) -> None:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)

    # run extraction for ALL rows in one vectorized pass: diff a
    # zero-bordered int8 view; +1/-1 transitions are run starts/ends
    # Transition scan stays in bool end-to-end: numpy's nonzero has a fast
    # SIMD path for bool input only (int8 diff + 2-D nonzero measured ~3 ms
    # at 720p; this pipeline ~0.3 ms — it was the labeler's dominant term).
    bordered = np.zeros((H, W + 2), bool)
    # `fg != 0` on an already-bool array silently casts the whole image
    # (~0.8 ms at 720p); assign bool input directly
    bordered[:, 1:-1] = fg if fg.dtype == np.bool_ else fg != 0
    trans = bordered[:, 1:] != bordered[:, :-1]
    idx = np.flatnonzero(trans.ravel())  # transitions, row-major: starts/ends alternate
    ty, tx = np.divmod(idx, W + 1)
    rising = bordered[ty, tx + 1]  # a rising edge enters foreground
    sy = ty[rising]
    sx = tx[rising]
    ex = tx[~rising]  # matching run ends (same order, row-major)
    # distinct occupied rows + their slice bounds into the flat run arrays —
    # the Python sweep below then pays only for rows that HAVE runs (a mostly
    # empty 720p mask has a few hundred occupied rows out of 722)
    occ_rows, row_starts = np.unique(sy, return_index=True)
    row_bounds = np.append(row_starts, len(sy)).tolist()
    occ_l = occ_rows.tolist()
    sx_l = sx.tolist()
    ex_l = ex.tolist()

    # prev-run overlap test, two-pointer form: store (ps - pad, pe, lab),
    # accept while stored_start < e, skip while pe < s + (1 - pad). pad=1
    # gives the 8-connectivity dilated overlap (ps <= e and pe >= s); pad=0
    # gives strict column overlap (ps < e and pe > s) = 4-connectivity.
    pad = 1 if connectivity == 8 else 0
    skip_off = 1 - pad
    all_runs: List[Tuple[int, int, int, int]] = []  # (y, s, e, lab-at-creation)
    next_label = 1
    prev_runs: list = []  # (start-pad, end, label) of the row above
    prev_y = -2
    for i, y in enumerate(occ_l):
        lo, hi = row_bounds[i], row_bounds[i + 1]
        if y != prev_y + 1:
            prev_runs = []  # gap row: nothing to connect to
        prev_y = y
        runs = []
        j = 0  # two-pointer sweep over prev_runs (both lists are sorted)
        for s, e in zip(sx_l[lo:hi], ex_l[lo:hi]):
            lab = 0
            while j < len(prev_runs) and prev_runs[j][1] < s + skip_off:
                j += 1
            k = j
            while k < len(prev_runs) and prev_runs[k][0] < e:
                pl = prev_runs[k][2]
                if lab == 0:
                    lab = find(pl)
                else:
                    union(lab, pl)
                k += 1
            if lab == 0:
                lab = next_label
                parent.append(next_label)
                next_label += 1
            if want_labels:
                labels[y, s:e] = lab
            all_runs.append((y, s, e, lab))
            runs.append((s - pad, e, lab))
        prev_runs = runs
    out_runs = np.array(
        [(y, s, e, find(lab)) for y, s, e, lab in all_runs], dtype=np.int32
    ).reshape(-1, 4)
    if want_labels and next_label > 1:
        remap = np.array([find(i) for i in range(next_label)], dtype=np.int32)
        labels = remap[labels]
    return labels, out_runs


# ---------------------------------------------------------------------------
# Polygon geometry (cv2-compatible math on contour point lists)
# ---------------------------------------------------------------------------


def polygon_moments(contour: np.ndarray) -> dict:
    """cv2.moments of a contour: Green's-theorem polygon moments
    (m00/m10/m01 sufficient for the reference's centroid use,
    reference utils/feature.py:240-252)."""
    pts = np.asarray(contour, dtype=np.float64).reshape(-1, 2)
    x = pts[:, 0]
    y = pts[:, 1]
    xn = np.roll(x, -1)
    yn = np.roll(y, -1)
    cross = x * yn - xn * y
    m00 = cross.sum() / 2.0
    m10 = (cross * (x + xn)).sum() / 6.0
    m01 = (cross * (y + yn)).sum() / 6.0
    # cv2 reports positive area for its own traversal order; normalize sign
    if m00 < 0:
        m00, m10, m01 = -m00, -m10, -m01
    return {"m00": m00, "m10": m10, "m01": m01}


def contour_area(contour: np.ndarray) -> float:
    """cv2.contourArea: |shoelace| of the polygon."""
    return polygon_moments(contour)["m00"]


def contour_perimeter(contour: np.ndarray, closed: bool = True) -> float:
    """cv2.arcLength."""
    pts = np.asarray(contour, dtype=np.float64).reshape(-1, 2)
    if len(pts) < 2:
        return 0.0
    diffs = np.diff(pts, axis=0)
    length = float(np.sqrt((diffs**2).sum(axis=1)).sum())
    if closed:
        length += float(np.linalg.norm(pts[-1] - pts[0]))
    return length


def approx_poly_dp(contour: np.ndarray, epsilon: float, closed: bool = True) -> np.ndarray:
    """cv2.approxPolyDP: Douglas-Peucker simplification."""
    pts = np.asarray(contour, dtype=np.float64).reshape(-1, 2)
    if len(pts) < 3:
        return np.asarray(contour, dtype=np.int32).reshape(-1, 1, 2)

    def dp(points: np.ndarray) -> List[np.ndarray]:
        if len(points) < 3:
            return list(points)
        start, end = points[0], points[-1]
        seg = end - start
        seg_len = np.linalg.norm(seg)
        if seg_len == 0:
            dists = np.linalg.norm(points - start, axis=1)
        else:
            rel = points - start
            dists = np.abs(seg[0] * rel[:, 1] - seg[1] * rel[:, 0]) / seg_len
        i = int(np.argmax(dists))
        if dists[i] > epsilon:
            left = dp(points[: i + 1])
            right = dp(points[i:])
            return left[:-1] + right
        return [start, end]

    if closed:
        # split at the two farthest points to approximate a closed curve
        far = int(np.argmax(np.linalg.norm(pts - pts[0], axis=1)))
        first = dp(np.vstack([pts[: far + 1]]))
        second = dp(np.vstack([pts[far:], pts[:1]]))
        out = first[:-1] + second[:-1]
    else:
        out = dp(pts)
    return np.round(np.array(out)).astype(np.int32).reshape(-1, 1, 2)


_native_hull = _NATIVE_SENTINEL  # lazily resolved; None = unavailable


def _load_native_hull():
    """ctypes handle to vp_convex_hull in libframebus.so, or None.

    A 1:1 native twin of the monotone-chain loop below (same sort order,
    dedup, `<= 0` pop and output order, the identical sequence of IEEE
    double ops — bit-equal hulls pinned by tests/test_utils_feature.py).
    min_area_rect runs per blob in the bins host leg; the Python chain's
    ~1 ms on a 1000-point contour becomes ~15 us. CUAUV_NATIVE_TRACE=0
    forces the Python path (same switch as the other imgeom.cpp kernels).
    """
    global _native_hull
    if _native_hull is not _NATIVE_SENTINEL:
        return _native_hull
    _native_hull = None
    if os.environ.get("CUAUV_NATIVE_TRACE", "1") != "0":
        try:
            from .. import native as _native_pkg

            lib = ctypes.CDLL(_native_pkg.library_path())
            fn = lib.vp_convex_hull
            fn.restype = ctypes.c_int64
            fn.argtypes = [
                ctypes.c_void_p,  # pts_xy (float64 [n, 2], C-contiguous)
                ctypes.c_int64,  # n
                ctypes.c_void_p,  # out_xy (float64, >= 2n doubles)
            ]
            _native_hull = fn
        except Exception:
            _native_hull = None
    return _native_hull


def convex_hull(points: np.ndarray) -> np.ndarray:
    """Andrew monotone chain; returns hull points CCW as [N, 2] float64.

    The stack loop runs on scalar tuples, not ndarray slices — per-point
    ndarray arithmetic made 1000-point contour hulls cost ~20 ms; scalars
    bring it to ~1 ms (min_area_rect runs per blob in the bins host leg).
    Before the loop, candidates are reduced to per-row x-extremes: a point
    strictly between its row's min and max x is a convex combination of the
    two, so it can never be a hull VERTEX (and the `<= 0` pop already drops
    collinear boundary points). A 1000-point traced contour shrinks to
    ~2x(rows) candidates, which is what the scalar loop then pays for."""
    pts = np.asarray(points, dtype=np.float64).reshape(-1, 2)
    fn = _load_native_hull()
    if fn is not None and len(pts) > 0:
        pts_c = np.ascontiguousarray(pts)
        out = np.empty((2 * len(pts_c), 2), dtype=np.float64)
        n = fn(pts_c.ctypes.data, len(pts_c), out.ctypes.data)
        return out[:n].copy()
    if len(pts) > 8:
        ys = pts[:, 1]
        yu, inv = np.unique(ys, return_inverse=True)
        if len(yu) * 2 < len(pts):  # reduction actually shrinks the set
            xmin = np.full(len(yu), np.inf)
            xmax = np.full(len(yu), -np.inf)
            np.minimum.at(xmin, inv, pts[:, 0])
            np.maximum.at(xmax, inv, pts[:, 0])
            pts = np.concatenate(
                [np.stack([xmin, yu], 1), np.stack([xmax, yu], 1)]
            )
    pts = np.unique(pts, axis=0)
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]
    seq = [(float(x), float(y)) for x, y in pts.tolist()]

    def half(s):
        out: List[Tuple[float, float]] = []
        for px, py in s:
            while len(out) >= 2:
                ax, ay = out[-2]
                bx, by = out[-1]
                if (bx - ax) * (py - ay) - (by - ay) * (px - ax) <= 0:
                    out.pop()
                else:
                    break
            out.append((px, py))
        return out

    lower = half(seq)
    upper = half(seq[::-1])
    return np.array(lower[:-1] + upper[:-1], dtype=np.float64)


def min_area_rect(
    contour: np.ndarray,
) -> Tuple[Tuple[float, float], Tuple[float, float], float]:
    """cv2.minAreaRect via rotating calipers on the convex hull.

    Returns ((cx, cy), (w, h), angle_deg) with cv2's convention
    (angle in (0, 90]; w is the extent along the edge defining the angle).
    """
    hull = convex_hull(contour)
    if len(hull) == 0:
        return ((0.0, 0.0), (0.0, 0.0), 0.0)
    if len(hull) == 1:
        return ((float(hull[0][0]), float(hull[0][1])), (0.0, 0.0), 0.0)
    if len(hull) == 2:
        c = hull.mean(axis=0)
        d = hull[1] - hull[0]
        return (
            (float(c[0]), float(c[1])),
            (float(np.linalg.norm(d)), 0.0),
            float(np.degrees(np.arctan2(d[1], d[0])) % 180.0),
        )

    best = None
    n = len(hull)
    for i in range(n):
        edge = hull[(i + 1) % n] - hull[i]
        norm = np.linalg.norm(edge)
        if norm == 0:
            continue
        ux = edge / norm
        uy = np.array([-ux[1], ux[0]])
        proj_x = hull @ ux
        proj_y = hull @ uy
        w = proj_x.max() - proj_x.min()
        h = proj_y.max() - proj_y.min()
        area = w * h
        if best is None or area < best[0]:
            cx = (proj_x.max() + proj_x.min()) / 2
            cy = (proj_y.max() + proj_y.min()) / 2
            center = cx * ux + cy * uy
            angle = np.degrees(np.arctan2(ux[1], ux[0]))
            best = (area, center, w, h, angle)

    _, center, w, h, angle = best
    # normalize to cv2's convention: angle in (0, 90]
    angle = angle % 180.0
    if angle >= 90.0:
        angle -= 90.0
        w, h = h, w
    elif angle < 0:
        angle += 90.0
        w, h = h, w
    if angle == 0.0:
        angle = 90.0
        w, h = h, w
    return ((float(center[0]), float(center[1])), (float(w), float(h)), float(angle))


def min_enclosing_circle(
    contour: np.ndarray,
) -> Tuple[Tuple[float, float], float]:
    """cv2.minEnclosingCircle (Welzl on the convex hull)."""
    pts = convex_hull(contour)
    if len(pts) == 0:
        return (0.0, 0.0), 0.0
    rng = np.random.default_rng(0)
    pts = pts[rng.permutation(len(pts))]

    def circle_two(a, b):
        c = (a + b) / 2
        return c, float(np.linalg.norm(a - b) / 2)

    def circle_three(a, b, c):
        ax, ay = a
        bx, by = b
        cx, cy = c
        d = 2 * (ax * (by - cy) + bx * (cy - ay) + cx * (ay - by))
        if abs(d) < 1e-12:
            # collinear: widest pair
            pairs = [(a, b), (b, c), (a, c)]
            return max(
                (circle_two(p, q) for p, q in pairs), key=lambda t: t[1]
            )
        ux = (
            (ax**2 + ay**2) * (by - cy)
            + (bx**2 + by**2) * (cy - ay)
            + (cx**2 + cy**2) * (ay - by)
        ) / d
        uy = (
            (ax**2 + ay**2) * (cx - bx)
            + (bx**2 + by**2) * (ax - cx)
            + (cx**2 + cy**2) * (bx - ax)
        ) / d
        center = np.array([ux, uy])
        return center, float(np.linalg.norm(center - a))

    def inside(c, r, p, eps=1e-7):
        return np.linalg.norm(p - c) <= r + eps

    c, r = pts[0], 0.0
    for i, p in enumerate(pts):
        if inside(c, r, p):
            continue
        c, r = p, 0.0
        for j in range(i):
            q = pts[j]
            if inside(c, r, q):
                continue
            c, r = circle_two(p, q)
            for k in range(j):
                s = pts[k]
                if inside(c, r, s):
                    continue
                c, r = circle_three(p, q, s)
    return (float(c[0]), float(c[1])), float(r)


def fit_ellipse(
    contour: np.ndarray,
) -> Tuple[Tuple[float, float], Tuple[float, float], float]:
    """cv2.fitEllipse-style least-squares ellipse (Fitzgibbon direct fit).

    Returns ((cx, cy), (major_diam, minor_diam), angle_deg)."""
    pts = np.asarray(contour, dtype=np.float64).reshape(-1, 2)
    if len(pts) < 5:
        raise ValueError("fit_ellipse needs at least 5 points")
    x = pts[:, 0]
    y = pts[:, 1]
    xm, ym = x.mean(), y.mean()
    xs, ys = x - xm, y - ym
    D1 = np.column_stack([xs**2, xs * ys, ys**2])
    D2 = np.column_stack([xs, ys, np.ones_like(xs)])
    S1 = D1.T @ D1
    S2 = D1.T @ D2
    S3 = D2.T @ D2
    T = -np.linalg.solve(S3, S2.T)
    M = S1 + S2 @ T
    C = np.array([[0, 0, 2], [0, -1, 0], [2, 0, 0]], dtype=np.float64)
    Mh = np.linalg.solve(C, M)
    eigval, eigvec = np.linalg.eig(Mh)
    cond = 4 * eigvec[0] * eigvec[2] - eigvec[1] ** 2
    a1 = eigvec[:, np.nonzero(cond > 0)[0][0]].real
    coeffs = np.concatenate([a1, T @ a1])
    A, B, Cc, D, E, F = coeffs
    B /= 2; D /= 2; E /= 2
    den = B * B - A * Cc
    cx = (Cc * D - B * E) / den
    cy = (A * E - B * D) / den
    num = 2 * (A * E * E + Cc * D * D + F * B * B - 2 * B * D * E - A * Cc * F)
    s = np.sqrt(((A - Cc) ** 2 + 4 * B * B))
    a_ax = np.sqrt(num / (den * (s - (A + Cc))))
    b_ax = np.sqrt(num / (den * (-s - (A + Cc))))
    angle = 0.5 * np.degrees(np.arctan2(2 * B, A - Cc))
    major, minor = 2 * a_ax, 2 * b_ax
    if major < minor:
        major, minor = minor, major
        angle += 90.0
    angle = (angle + 180.0) % 180.0  # cv2 measures from the vertical
    return ((cx + xm, cy + ym), (minor, major), angle)
