// Connected-component labeling by tile union-find (sm_90a).
//
// Replaces the Pallas strip kernel
// cuauv_vision_pipeline_tpu/ops/pallas/ccl_kernel.py (label_pallas,
// label_pallas_batched). Labels: every foreground pixel gets the raster index
// y*W + x of its component's topmost-leftmost pixel; background gets 2^30.
//
// The output array is the union-find forest (out[p] = parent of p; a root
// points at itself): no scratch array. Three launches on the caller's stream,
// each one block per 32x32 tile (8 warps, a warp per tile row, 4 rows each),
// no host round trip, no iteration count:
//
//   local   the tile's mask comes into shared memory in 4-byte loads. A warp
//           ballot gives each row's foreground bits, so every pixel's parent
//           starts as the first pixel of its run in the row (no atomics for
//           horizontal links). Runs then link to the runs they touch in the
//           row above, once per pair of runs (up_links), in a union-find on
//           a shared-memory parent array; run starts resolve their roots,
//           and each pixel writes out[p] = the raster index of its
//           tile-local root (background: 2^30).
//   border  only pixels with a scanned neighbour (left, up-left, up,
//           up-right) in another tile: a tile's top row, its left column
//           and, for 8-connectivity, its right column (up-right). The same
//           once-per-pair-of-runs rules skip links that another link implies,
//           so a tile of solid foreground makes two links, not ~190. Links
//           go to out in global memory.
//   final   out[p] = find(p) in place for foreground pixels, read from the
//           mask (background is never looked up). Most pixels' parent is
//           their tile-local root; each distinct one is resolved once per
//           tile and shared in shared memory, so a frame-wide component does
//           not send every warp to read its root's entry (one L2 line that
//           ~65k warp reads would queue on).
//
// Every union (shared or global) links the larger root under the smaller
// with atomicCAS, only while the larger one is still a root, and retries
// from the new roots otherwise (Anderson & Woll's root-only linking in the
// union-find of Playne & Hawick, arxiv 1708.08180): trees only merge at
// roots, and the finds of a union may shorten paths (path halving: a node is
// pointed at its grandparent, an ancestor), since no link is ever made but at
// a root. Every link points to a smaller index, so a component's root is its
// minimum raster index however the atomics interleave; tile-local raster
// order is monotone in the image's, so a local root is its local component's
// minimum too. The result is exact and deterministic. The final phase stores
// nothing but a pixel's own final root (a halving store there, a grandparent,
// could land after the root and leave a label wrong). Batched images each use
// their own forest at out + b*H*W (blockIdx.z = b); no neighbour outside rows
// [0, H) of its own image is read.
//
// Bound: bytes (1 B mask read + 4 B label written per pixel). The local
// phase reads the mask once and writes every label once, coalesced; the
// border and final phases read the mask again and touch only foreground
// labels, and their global atomics are the few links between tiles.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kSentinel = 1 << 30;
constexpr int kTile = 32;           // tile side; a warp per tile row
constexpr int kWarps = 8;           // warps per tile block
constexpr int kRows = kTile / kWarps;  // rows per thread
constexpr unsigned kAll = 0xffffffffu;
static_assert(kTile * kWarps == kTile * kTile / 4, "one 4-byte mask load per thread");

__device__ __forceinline__ int32_t load(const int32_t* p) {
    // volatile: other threads re-link parents while this one walks them
    return *reinterpret_cast<const volatile int32_t*>(p);
}

__device__ __forceinline__ int32_t find_root(const int32_t* parent, int32_t p) {
    int32_t q = load(parent + p);
    while (q != p) {
        p = q;
        q = load(parent + p);
    }
    return p;
}

// find with path halving: each visited node is pointed at its grandparent.
// Safe under concurrent unions: links are made only at roots (CAS), a node
// that is not a root never becomes one again, and a grandparent read at any
// time is in the node's tree and smaller, so the stores keep every tree and
// never touch a root.
__device__ __forceinline__ int32_t find_halve(int32_t* parent, int32_t p) {
    while (true) {
        const int32_t q = load(parent + p);
        if (q == p) return p;
        const int32_t g = load(parent + q);
        if (g == q) return q;
        parent[p] = g;
        p = g;
    }
}

// parent is a shared-memory array (local phase) or out (border phase)
__device__ void unite(int32_t* parent, int32_t a, int32_t b) {
    while (true) {
        a = find_halve(parent, a);
        b = find_halve(parent, b);
        if (a == b) return;
        if (a > b) {
            const int32_t t = a;
            a = b;
            b = t;
        }
        // link b under a if b is still a root; else another union linked it
        // meanwhile: retry from the new roots
        if (atomicCAS(parent + b, b, a) == b) return;
    }
}

// The links from a foreground pixel to the row above that its run needs
// (left: the pixel to its left is foreground and in its run; ul, u, ur: the
// pixels up-left, up, up-right are foreground). A run links once to each run
// of the row above that it touches: from its first pixel to the run straight
// above it, or else to the runs up-left and up-right; from a later pixel only
// up-right, where a run above starts. link(d) takes the column offset d.
template <typename Link>
__device__ __forceinline__ void up_links(bool left, bool ul, bool u, bool ur,
                                         int connectivity, Link link) {
    if (connectivity == 8) {
        if (left) {
            if (ur && !u) link(1);
        } else if (u) {
            link(0);
        } else {
            if (ul) link(-1);
            if (ur) link(1);
        }
    } else if (u && !(left && ul)) {
        link(0);
    }
}

__device__ __forceinline__ bool bit(uint32_t row, int i) {
    return i >= 0 && i < kTile && ((row >> i) & 1u);
}

__global__ void __launch_bounds__(kTile * kWarps)
local_kernel(const uint8_t* __restrict__ mask, int32_t* __restrict__ out, int H,
             int W, int connectivity, int wide_loads) {
    __shared__ __align__(16) uint8_t fgs[kTile * kTile];  // 0 outside the image
    __shared__ int32_t parent[kTile * kTile];             // tile-local indices
    __shared__ uint32_t rows[kTile];                      // foreground bits per row
    const int lx = threadIdx.x, wy = threadIdx.y;
    const int x0 = blockIdx.x * kTile, y0 = blockIdx.y * kTile;
    const size_t base = static_cast<size_t>(blockIdx.z) * H * W;

    // the tile's mask, 4 bytes a thread (byte by byte where rows are not
    // 4-byte aligned)
    {
        const int t = wy * kTile + lx;
        const int y = y0 + t / (kTile / 4), x = x0 + (t % (kTile / 4)) * 4;
        uint32_t w = 0;
        if (y < H && x < W) {
            const uint8_t* src = mask + base + static_cast<size_t>(y) * W + x;
            if (wide_loads) {
                w = *reinterpret_cast<const uint32_t*>(src);
            } else {
                for (int k = 0; k < 4 && x + k < W; ++k)
                    w |= static_cast<uint32_t>(src[k]) << (8 * k);
            }
        }
        reinterpret_cast<uint32_t*>(fgs)[t] = w;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRows; ++i) {  // parent = the first pixel of its run
        const int ly = wy + i * kWarps, t = ly * kTile + lx;
        const bool fg = fgs[t] != 0;
        const uint32_t row = __ballot_sync(kAll, fg);
        if (lx == 0) rows[ly] = row;
        if (fg) {
            const uint32_t gaps = ~row & ((1u << lx) - 1u);
            parent[t] = ly * kTile + (gaps ? 32 - __clz(gaps) : 0);
        }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
        const int ly = wy + i * kWarps, t = ly * kTile + lx;
        const uint32_t row = rows[ly];
        if (bit(row, lx) && ly > 0) {
            const uint32_t up = rows[ly - 1];
            up_links(bit(row, lx - 1), bit(up, lx - 1), bit(up, lx), bit(up, lx + 1),
                     connectivity, [&](int d) { unite(parent, t, t - kTile + d); });
        }
    }
    __syncthreads();

    // run starts take their roots; every pixel's parent is a run start (or
    // the root), so its root is then at most two reads away
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
        const int ly = wy + i * kWarps, t = ly * kTile + lx;
        const uint32_t row = rows[ly];
        if (bit(row, lx) && !bit(row, lx - 1)) parent[t] = find_root(parent, t);
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
        const int ly = wy + i * kWarps, t = ly * kTile + lx;
        const int y = y0 + ly, x = x0 + lx;
        if (y < H && x < W) {
            int32_t label = kSentinel;
            if (bit(rows[ly], lx)) {
                const int32_t r = parent[parent[t]];
                label = (y0 + r / kTile) * W + x0 + r % kTile;
            }
            out[base + static_cast<size_t>(y) * W + x] = label;
        }
    }
}

// One block per tile: warp 0 its top row, warp 1 its left column, warp 2 its
// right column (up-right links of 8-connectivity). Each rule skips a link
// only where links that are made imply it (checked against an exact
// labelling on random masks with tiles down to 2x2).
__global__ void __launch_bounds__(3 * kTile)
border_kernel(const uint8_t* __restrict__ mask, int32_t* out, int H, int W,
              int connectivity) {
    const int lane = threadIdx.x, side = threadIdx.y;
    const int x0 = blockIdx.x * kTile, y0 = blockIdx.y * kTile;
    const size_t base = static_cast<size_t>(blockIdx.z) * H * W;
    const uint8_t* m = mask + base;
    int32_t* o = out + base;
    int y = y0 + lane, x = x0;
    if (side == 0) {
        y = y0;
        x = x0 + lane;
    } else {
        if (side == 2) x = x0 + kTile - 1;
        // the top row's pixels belong to warp 0; the image's first column
        // has no left neighbour; 4-connectivity has no up-right link
        if (lane == 0 || (side == 1 && x == 0) || (side == 2 && connectivity != 8)) return;
    }
    if (y >= H || x >= W) return;
    auto fg = [&](int yy, int xx) {
        return yy >= 0 && xx >= 0 && xx < W && m[static_cast<size_t>(yy) * W + xx] != 0;
    };
    if (!fg(y, x)) return;
    const int32_t p = y * W + x;
    auto link = [&](int32_t q) { unite(o, p, q); };

    if (side == 0) {
        // the row above is another tile's: the in-tile rule, on the image
        if (y > 0)
            up_links(lane > 0 && fg(y, x - 1), fg(y - 1, x - 1), fg(y - 1, x),
                     fg(y - 1, x + 1), connectivity, [&](int d) { link(p - W + d); });
        if (lane == 0 && fg(y, x - 1)) link(p - 1);  // the corner's left
    } else if (side == 1) {
        // up and up-left foreground: the pixel above is linked to up-left
        // (its own left) by this rule or, in the top row, as the corner, and
        // the left pixel is in up-left's tile-local component; up-left alone
        // links it, and the left with it
        const bool u = fg(y - 1, x), ul = fg(y - 1, x - 1), l = fg(y, x - 1);
        if (connectivity == 8) {
            if (ul) {
                if (!u) link(p - W - 1);
            } else if (l) {
                link(p - 1);
            }
        } else if (l && !(u && ul)) {
            link(p - 1);
        }
    } else if (fg(y - 1, x + 1) && !fg(y - 1, x)) {
        // up foreground: up-right, in the right tile's left column, is
        // linked to its left (up) by that column's rule
        link(p - W + 1);
    }
}

__global__ void __launch_bounds__(kTile * kWarps)
final_kernel(const uint8_t* __restrict__ mask, int32_t* out, int H, int W) {
    __shared__ int32_t claim[kTile * kTile];  // which pixel resolves a local value
    __shared__ int32_t roots[kTile * kTile];  // its root
    const int lx = threadIdx.x, wy = threadIdx.y;
    const int x0 = blockIdx.x * kTile, y0 = blockIdx.y * kTile;
    const size_t base = static_cast<size_t>(blockIdx.z) * H * W;
    const uint8_t* m = mask + base;
    int32_t* o = out + base;
#pragma unroll
    for (int i = 0; i < kRows; ++i) claim[(wy + i * kWarps) * kTile + lx] = -1;
    __syncthreads();

    // each foreground pixel's parent v; key = v's index in the tile, if
    // there (all but border pixels: their tile-local root). A run's pixels
    // share their key, so only a lane whose left neighbour's key differs
    // claims it.
    int32_t v[kRows];
    int key[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
        const int ly = wy + i * kWarps, y = y0 + ly, x = x0 + lx;
        v[i] = kSentinel;
        key[i] = -1;
        if (y < H && x < W && m[static_cast<size_t>(y) * W + x]) {
            v[i] = load(o + y * W + x);
            const int vy = v[i] / W - y0, vx = v[i] % W - x0;
            if (v[i] != y * W + x && vy >= 0 && vy < kTile && vx >= 0 && vx < kTile)
                key[i] = vy * kTile + vx;
        }
        const int left = __shfl_up_sync(kAll, key[i], 1);
        if (key[i] >= 0 && (lx == 0 || left != key[i]))
            atomicCAS(&claim[key[i]], -1, ly * kTile + lx);
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
        if (key[i] >= 0 && claim[key[i]] == (wy + i * kWarps) * kTile + lx)
            roots[key[i]] = find_root(o, v[i]);
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
        const int32_t q = (y0 + wy + i * kWarps) * W + x0 + lx;
        if (v[i] == kSentinel || v[i] == q) continue;  // background, or a root
        // a parent outside the tile (a border pixel's) is walked directly
        const int32_t root = key[i] >= 0 ? roots[key[i]] : find_root(o, v[i]);
        if (root != v[i]) o[q] = root;
    }
}

}  // namespace

extern "C" {

// mask: uint8 [B, H, W] (nonzero = foreground); out: int32 [B, H, W].
// B*H*W < 2^30, B and ceil(H/32) <= 65535 (checked by the wrapper).
// Returns 0 or the first CUDA error of the launches.
int ccl_label(const void* mask, void* out, int B, int H, int W, int connectivity,
              int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto* m = static_cast<const uint8_t*>(mask);
    auto* o = static_cast<int32_t*>(out);
    const int wide = W % 4 == 0 && reinterpret_cast<uintptr_t>(mask) % 4 == 0;

    const dim3 tiles((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
    local_kernel<<<tiles, dim3(kTile, kWarps), 0, s>>>(m, o, H, W, connectivity, wide);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;

    border_kernel<<<tiles, dim3(kTile, 3), 0, s>>>(m, o, H, W, connectivity);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;

    final_kernel<<<tiles, dim3(kTile, kWarps), 0, s>>>(m, o, H, W);
    return cudaGetLastError();
}

const char* ccl_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
