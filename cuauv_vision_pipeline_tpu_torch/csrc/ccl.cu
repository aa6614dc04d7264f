// Connected-component labeling by union-find in device memory (sm_90a).
//
// Replaces the Pallas strip kernel
// cuauv_vision_pipeline_tpu/ops/pallas/ccl_kernel.py (label_pallas,
// label_pallas_batched). Labels: every foreground pixel gets the raster index
// y*W + x of its component's topmost-leftmost pixel; background gets 2^30.
//
// Three launches on the caller's stream, no host round trip:
//   init     parent[p] = p (foreground) or 2^30 (background)
//   merge    each foreground pixel unions with its already-scanned
//            foreground neighbours; a union links the larger root under the
//            smaller one with atomicCAS (only while it is still a root) and
//            retries from the new roots otherwise (the union-find of Playne &
//            Hawick, arxiv 1708.08180, with Anderson & Woll's root-only
//            linking so that trees never split and path compression is safe)
//   compress out[p] = find(p) - b*H*W
// Links always point to smaller indices, so a component's final root is its
// minimum raster index however the atomics interleave: exact and
// deterministic. Batched images share one index space (b*H*W + y*W + x);
// neighbours are only taken inside rows [0, H) of the same image.
//
// Bound: bytes (1 B mask read + 4 B label written per pixel); the parent
// array is scratch that stays mostly in the 50 MB L2 at 1080p.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kSentinel = 1 << 30;
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

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

// find_root, then point every node on the walked path straight at the root.
// Safe under concurrent unions: links are made only at roots (CAS), so a
// node's set of ancestors only grows and the root found stays an ancestor of
// every node below it on the path; a non-root never becomes a root again, so
// these plain stores never touch a root.
__device__ __forceinline__ int32_t find_compress(int32_t* parent, int32_t p) {
    const int32_t root = find_root(parent, p);
    int32_t q = load(parent + p);
    while (q > root) {
        parent[p] = root;
        p = q;
        q = load(parent + p);
    }
    return root;
}

__device__ void unite(int32_t* parent, int32_t a, int32_t b) {
    while (true) {
        a = find_compress(parent, a);
        b = find_compress(parent, b);
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

__global__ void init_kernel(const uint8_t* __restrict__ mask,
                            int32_t* __restrict__ parent, int32_t n) {
    const int32_t p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p < n) parent[p] = mask[p] ? p : kSentinel;
}

__global__ void merge_kernel(const uint8_t* __restrict__ mask, int32_t* parent,
                             int H, int W, int connectivity) {
    const int x = blockIdx.x * kBlockX + threadIdx.x;
    const int y = blockIdx.y * kBlockY + threadIdx.y;
    if (x >= W || y >= H) return;
    const int32_t p = blockIdx.z * H * W + y * W + x;
    if (!mask[p]) return;
    if (x > 0 && mask[p - 1]) unite(parent, p, p - 1);
    if (y > 0) {
        const int32_t up = p - W;
        if (mask[up]) unite(parent, p, up);
        if (connectivity == 8) {
            if (x > 0 && mask[up - 1]) unite(parent, p, up - 1);
            if (x + 1 < W && mask[up + 1]) unite(parent, p, up + 1);
        }
    }
}

__global__ void compress_kernel(const uint8_t* __restrict__ mask,
                                const int32_t* parent, int32_t* __restrict__ out,
                                int H, int W) {
    const int x = blockIdx.x * kBlockX + threadIdx.x;
    const int y = blockIdx.y * kBlockY + threadIdx.y;
    if (x >= W || y >= H) return;
    const int32_t base = blockIdx.z * H * W;
    const int32_t p = base + y * W + x;
    out[p] = mask[p] ? find_root(parent, p) - base : kSentinel;
}

}  // namespace

extern "C" {

// mask: uint8 [B, H, W] (nonzero = foreground); out: int32 [B, H, W];
// parent: int32 [B*H*W] scratch. B*H*W < 2^30 (checked by the wrapper).
// Returns 0 or the first CUDA error of the launches.
int ccl_label(const void* mask, void* out, void* parent, int B, int H, int W,
              int connectivity, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto* m = static_cast<const uint8_t*>(mask);
    auto* par = static_cast<int32_t*>(parent);
    const int32_t n = B * H * W;

    init_kernel<<<(n + 255) / 256, 256, 0, s>>>(m, par, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;

    const dim3 block(kBlockX, kBlockY);
    const dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY, B);
    merge_kernel<<<grid, block, 0, s>>>(m, par, H, W, connectivity);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;

    compress_kernel<<<grid, block, 0, s>>>(m, par, static_cast<int32_t*>(out), H, W);
    return cudaGetLastError();
}

const char* ccl_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
