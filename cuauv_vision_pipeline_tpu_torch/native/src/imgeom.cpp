// Host-side image geometry kernels for the Python utils layer.
//
// Moore-neighbor boundary tracing (Jacob's stopping criterion), a 1:1 native
// twin of utils/contours._trace_boundary.  The Python loop costs ~10 us per
// boundary pixel (it dominated the bins module's host leg after labeling was
// vectorized); this loop costs ~10 ns per boundary pixel.  Semantics are
// intentionally IDENTICAL to the Python tracer — the parity test
// (tests/test_utils_feature.py) runs both on random masks and requires
// bit-equal point lists, so the cv2-golden tests cover this path too.
//
// Parity target: cv2.findContours point sets (reference utils/feature.py
// wraps cv2; modules/bins.py + handlers consume the point lists).

#include <algorithm>
#include <cstdint>
#include <cstddef>
#include <cstring>
#include <vector>

namespace {

// Word-at-a-time row scanning: the labeler's cost is almost entirely the
// byte scans (skip background, then measure the run), ~1.6 ns/px compiled
// scalar.  Eight bytes per load with the classic SWAR zero-byte test cuts
// that ~10x; masks are mostly background so the zero-skip loop does 32
// bytes per iteration.

inline int64_t scan_zeros(const uint8_t* row, int64_t x, int64_t W) {
  // first x' >= x with row[x'] != 0 (or W)
  while (x + 32 <= W) {
    uint64_t a, b, c, d;
    std::memcpy(&a, row + x, 8);
    std::memcpy(&b, row + x + 8, 8);
    std::memcpy(&c, row + x + 16, 8);
    std::memcpy(&d, row + x + 24, 8);
    if (a | b | c | d) break;
    x += 32;
  }
  while (x + 8 <= W) {
    uint64_t v;
    std::memcpy(&v, row + x, 8);
    if (v) {
      // first nonzero byte (little-endian): trailing zero BITS / 8
      return x + (__builtin_ctzll(v) >> 3);
    }
    x += 8;
  }
  while (x < W && !row[x]) ++x;
  return x;
}

inline int64_t scan_nonzeros(const uint8_t* row, int64_t x, int64_t W) {
  // first x' >= x with row[x'] == 0 (or W)
  constexpr uint64_t LO = 0x0101010101010101ULL;
  constexpr uint64_t HI = 0x8080808080808080ULL;
  while (x + 8 <= W) {
    uint64_t v;
    std::memcpy(&v, row + x, 8);
    const uint64_t zero = (v - LO) & ~v & HI;  // high bit set per zero byte
    if (zero) return x + (__builtin_ctzll(zero) >> 3);
    x += 8;
  }
  while (x < W && row[x]) ++x;
  return x;
}

// Moore neighborhood in the same order as utils/contours._MOORE:
// (dx, dy) pairs — W, SW, S, SE, E, NE, N, NW in image coords (y down).
constexpr int MOORE_DX[8] = {-1, -1, 0, 1, 1, 1, 0, -1};
constexpr int MOORE_DY[8] = {0, 1, 1, 1, 0, -1, -1, -1};

inline int dir_index(int dx, int dy) {
  // Inverse of the _MOORE table ((dx,dy) in {-1,0,1}^2 \ {0,0}).
  for (int i = 0; i < 8; ++i)
    if (MOORE_DX[i] == dx && MOORE_DY[i] == dy) return i;
  return 0;  // unreachable for valid rel offsets
}

}  // namespace

extern "C" {

// Trace one boundary starting at (sy, sx) in the PADDED bool/uint8 mask
// fg[H][W] (border row/col must be 0, exactly like the np.pad(...) the
// Python caller applies).  start_dir is the Moore index of a KNOWN-bg
// neighbor of the start pixel: 0 (west) for outer boundaries started at a
// component's topmost-leftmost pixel, 2 (south) for hole boundaries started
// at the fg pixel just above the hole's topmost-leftmost pixel.
//
// out_xy receives (x, y) int32 pairs; max_pts bounds the OUTPUT length.
// Returns the number of points written, or -1 if the contour would exceed
// max_pts (caller retries with a bigger buffer).  The returned point list
// matches _trace_boundary exactly, including the trailing-point trim.
int64_t vp_trace_boundary(const uint8_t* fg, int64_t H, int64_t W,
                          int64_t sy, int64_t sx, int64_t start_dir,
                          int32_t* out_xy, int64_t max_pts) {
  (void)H;
  int64_t n = 0;  // points currently in out_xy
  if (max_pts < 1) return -1;
  out_xy[0] = (int32_t)sx;
  out_xy[1] = (int32_t)sy;
  n = 1;

  int prev_dir = (int)start_dir & 7;  // backtrack: bg neighbor we came from
  int64_t cy = sy, cx = sx;
  // Jacob's criterion state: the first (pixel, direction) move taken.
  bool have_first = false;
  int64_t first_y = 0, first_x = 0;
  int first_d = 0;

  const int64_t step_budget = 4 * H * W;
  for (int64_t step = 0; step < step_budget; ++step) {
    bool found = false;
    for (int k = 1; k <= 8; ++k) {
      const int d = (prev_dir + k) & 7;
      const int64_t ny = cy + MOORE_DY[d];
      const int64_t nx = cx + MOORE_DX[d];
      if (fg[ny * W + nx]) {
        // bg pixel checked just before this fg hit
        const int pd = (d + 7) & 7;
        const int64_t bg_y = cy + MOORE_DY[pd];
        const int64_t bg_x = cx + MOORE_DX[pd];
        // backtrack for the next pixel: direction new->that bg pixel
        const int idx = dir_index((int)(bg_x - nx), (int)(bg_y - ny));
        if (!have_first) {
          have_first = true;
          first_y = cy;
          first_x = cx;
          first_d = d;
        } else if (cy == sy && cx == sx && cy == first_y && cx == first_x &&
                   d == first_d) {
          return n - 1;  // closed: drop the duplicated start
        }
        cy = ny;
        cx = nx;
        if (n >= max_pts) return -1;
        out_xy[2 * n] = (int32_t)cx;
        out_xy[2 * n + 1] = (int32_t)cy;
        ++n;
        prev_dir = idx;
        found = true;
        break;
      }
    }
    if (!found) break;  // isolated pixel
  }
  return n > 1 ? n - 1 : n;
}

// Batch boundary tracing: trace every start in one call, writing UN-PADDED
// (x-1, y-1) point pairs contiguously into out_xy with per-contour offsets.
// One ctypes round trip replaces n_starts of them — on a dense noisy mask
// (~15k contours) the per-call FFI overhead dominated the actual tracing.
// starts is int32 [n][3] = (sy, sx, start_dir) in PADDED coords, exactly
// what vp_trace_boundary takes.  out_offsets has n_starts+1 slots; contour i
// occupies out_xy[2*out_offsets[i] : 2*out_offsets[i+1]].  Returns the total
// point count, or -1 if max_pts would be exceeded (caller grows + retries).
int64_t vp_trace_all(const uint8_t* fg, int64_t H, int64_t W,
                     const int32_t* starts, int64_t n_starts,
                     int32_t* out_xy, int64_t max_pts,
                     int64_t* out_offsets) {
  int64_t total = 0;
  for (int64_t i = 0; i < n_starts; ++i) {
    out_offsets[i] = total;
    const int64_t n = vp_trace_boundary(
        fg, H, W, starts[3 * i], starts[3 * i + 1], starts[3 * i + 2],
        out_xy + 2 * total, max_pts - total);
    if (n < 0) return -1;
    for (int64_t p = 2 * total; p < 2 * (total + n); ++p) out_xy[p] -= 1;
    total += n;
  }
  out_offsets[n_starts] = total;
  return total;
}

// Run-length union-find connected-component labeling, the native twin of
// utils/contours._label_core.  Semantics are IDENTICAL to the Python sweep
// (labels assigned from 1 in raster creation order, union-by-min, final
// root = find(label-at-creation)) so the parity test can require bit-equal
// run lists and label rasters on random masks.
//
// fg is the UNPADDED mask (any nonzero = foreground).  connectivity is 8 or
// 4 (8 dilates the row-overlap test by one column on each side, exactly the
// `pad` trick in the Python loop).  runs_out receives (y, start, end, root)
// int32 quadruples in raster order; labels_out (optional, pass NULL to
// skip) receives the resolved root per pixel (0 = background).  Returns the
// number of runs written, or -1 if they would exceed max_runs.
int64_t vp_component_runs(const uint8_t* fg, int64_t H, int64_t W,
                          int64_t connectivity, int32_t* labels_out,
                          int32_t* runs_out, int64_t max_runs) {
  const int pad = (connectivity == 8) ? 1 : 0;
  const int skip_off = 1 - pad;

  std::vector<int32_t> parent(1, 0);
  auto find = [&parent](int32_t a) {
    while (parent[a] != a) {
      parent[a] = parent[parent[a]];
      a = parent[a];
    }
    return a;
  };

  int64_t n_runs = 0;
  int32_t next_label = 1;
  // previous row's runs: (start - pad, end, label); two-pointer sweep
  std::vector<int32_t> prev_s, prev_e, prev_l, cur_s, cur_e, cur_l;

  for (int64_t y = 0; y < H; ++y) {
    const uint8_t* row = fg + y * W;
    cur_s.clear();
    cur_e.clear();
    cur_l.clear();
    int64_t x = 0;
    size_t j = 0;  // two-pointer index into prev_* (both sorted by column)
    while (x < W) {
      x = scan_zeros(row, x, W);
      if (x >= W) break;
      const int64_t s = x;
      x = scan_nonzeros(row, x, W);
      const int64_t e = x;

      int32_t lab = 0;
      while (j < prev_s.size() && prev_e[j] < s + skip_off) ++j;
      size_t k = j;
      while (k < prev_s.size() && prev_s[k] < e) {
        const int32_t pl = prev_l[k];
        if (lab == 0) {
          lab = find(pl);
        } else {
          int32_t ra = find(lab), rb = find(pl);
          if (ra != rb) parent[ra > rb ? ra : rb] = ra > rb ? rb : ra;
          if (rb < lab) lab = rb;  // keep lab a root candidate (min so far)
        }
        ++k;
      }
      if (lab == 0) {
        lab = next_label++;
        parent.push_back(lab);
      }
      if (n_runs >= max_runs) return -1;
      runs_out[4 * n_runs + 0] = (int32_t)y;
      runs_out[4 * n_runs + 1] = (int32_t)s;
      runs_out[4 * n_runs + 2] = (int32_t)e;
      runs_out[4 * n_runs + 3] = lab;  // resolved to root in the final pass
      ++n_runs;
      cur_s.push_back((int32_t)(s - pad));
      cur_e.push_back((int32_t)e);
      cur_l.push_back(lab);
    }
    prev_s.swap(cur_s);
    prev_e.swap(cur_e);
    prev_l.swap(cur_l);
  }

  for (int64_t i = 0; i < n_runs; ++i) {
    const int32_t root = find(runs_out[4 * i + 3]);
    runs_out[4 * i + 3] = root;
    if (labels_out) {
      const int64_t y = runs_out[4 * i + 0];
      int32_t* lrow = labels_out + y * W;
      for (int32_t c = runs_out[4 * i + 1]; c < runs_out[4 * i + 2]; ++c)
        lrow[c] = root;
    }
  }
  return n_runs;
}

// Convex hull (Andrew monotone chain), the native twin of
// utils/contours.convex_hull.  Bit-equal to the Python loop: same sort
// order (x primary, y secondary — what np.unique(axis=0) / np.lexsort
// produce), same exact-duplicate dedup, same `<= 0` cross-product pop
// (drops collinear points), same output order lower[:-1] + upper[:-1]
// (CCW in image coords).  All arithmetic is the identical sequence of
// IEEE double ops (the build has no FMA contraction), so the parity test
// can require bit-equal vertex arrays on random point sets.
//
// pts_xy is n (x, y) float64 pairs (any order, duplicates fine); out_xy
// must hold at least 2 * n doubles.  Returns the number of hull points
// written (the dedup'd point count when it is <= 2, matching Python).
int64_t vp_convex_hull(const double* pts_xy, int64_t n, double* out_xy) {
  struct P {
    double x, y;
  };
  std::vector<P> p(n);
  for (int64_t i = 0; i < n; ++i) p[i] = {pts_xy[2 * i], pts_xy[2 * i + 1]};
  std::sort(p.begin(), p.end(), [](const P& a, const P& b) {
    return a.x < b.x || (a.x == b.x && a.y < b.y);
  });
  p.erase(std::unique(p.begin(), p.end(),
                      [](const P& a, const P& b) {
                        return a.x == b.x && a.y == b.y;
                      }),
          p.end());
  const int64_t m = (int64_t)p.size();
  if (m <= 2) {
    for (int64_t i = 0; i < m; ++i) {
      out_xy[2 * i] = p[i].x;
      out_xy[2 * i + 1] = p[i].y;
    }
    return m;
  }
  auto cross = [](const P& a, const P& b, const P& c) {
    return (b.x - a.x) * (c.y - a.y) - (b.y - a.y) * (c.x - a.x);
  };
  std::vector<P> lower, upper;
  lower.reserve(m);
  upper.reserve(m);
  for (int64_t i = 0; i < m; ++i) {
    while (lower.size() >= 2 &&
           cross(lower[lower.size() - 2], lower.back(), p[i]) <= 0)
      lower.pop_back();
    lower.push_back(p[i]);
  }
  for (int64_t i = m - 1; i >= 0; --i) {
    while (upper.size() >= 2 &&
           cross(upper[upper.size() - 2], upper.back(), p[i]) <= 0)
      upper.pop_back();
    upper.push_back(p[i]);
  }
  int64_t k = 0;
  for (size_t i = 0; i + 1 < lower.size(); ++i) {
    out_xy[2 * k] = lower[i].x;
    out_xy[2 * k + 1] = lower[i].y;
    ++k;
  }
  for (size_t i = 0; i + 1 < upper.size(); ++i) {
    out_xy[2 * k] = upper[i].x;
    out_xy[2 * k + 1] = upper[i].y;
    ++k;
  }
  return k;
}

}  // extern "C"
