// Fused 5x5-rect morphology in one pass over the mask (sm_90a).
//
// Replaces the Pallas kernel
// cuauv_vision_pipeline_tpu/ops/pallas/morph_kernel.py:fused_morph: up to
// four erode/dilate stages (open_close = erode, dilate, dilate, erode) on a
// u8 mask with one read and one write of device memory.
//
// Each block owns a kTileH x kTileW output tile and loads it with a kHalo
// ring on all four sides into shared memory (CUDA tiles are narrower than
// the image, unlike the Pallas full-width strips, so columns need a halo
// too). A 5x5 stage invalidates a 2-pixel ring at the tile edge, so an
// 8-pixel halo keeps the core exact through 4 stages. Per stage: a 5-tap
// min/max along rows (tile cells outside the image read as the stage's
// identity: 255 for erode, 0 for dilate — cv2 BORDER_CONSTANT), then along
// columns. Only the core goes back to device memory.
//
// Bound: bytes (1 B read + 1 B written per pixel).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileH = 32;
constexpr int kTileW = 128;
constexpr int kHalo = 8;
constexpr int kR = 2;  // 5x5 radius
constexpr int kSH = kTileH + 2 * kHalo;
constexpr int kSW = kTileW + 2 * kHalo;
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

__device__ __forceinline__ uint8_t op(uint8_t a, uint8_t b, bool erode) {
    return erode ? (a < b ? a : b) : (a > b ? a : b);
}

__global__ void __launch_bounds__(kBlockX * kBlockY)
fused_morph_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                   int H, int W, unsigned stage_bits, int n_stages) {
    __shared__ uint8_t a[kSH][kSW];
    __shared__ uint8_t t[kSH][kSW];
    const size_t plane = static_cast<size_t>(H) * W;
    const uint8_t* src = in + blockIdx.z * plane;
    uint8_t* dst = out + blockIdx.z * plane;
    const int y0 = blockIdx.y * kTileH - kHalo;
    const int x0 = blockIdx.x * kTileW - kHalo;

    for (int ly = threadIdx.y; ly < kSH; ly += kBlockY) {
        const int gy = y0 + ly;
        for (int lx = threadIdx.x; lx < kSW; lx += kBlockX) {
            const int gx = x0 + lx;
            const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
            a[ly][lx] = inside ? src[static_cast<size_t>(gy) * W + gx] : 0;
        }
    }
    __syncthreads();

    for (int s = 0; s < n_stages; ++s) {
        const bool erode = (stage_bits >> s) & 1u;
        const uint8_t ident = erode ? 255 : 0;
        // rows: out-of-image cells read as the identity
        for (int ly = threadIdx.y; ly < kSH; ly += kBlockY) {
            const int gy = y0 + ly;
            const bool row_in = gy >= 0 && gy < H;
            for (int lx = threadIdx.x; lx < kSW; lx += kBlockX) {
                uint8_t acc = ident;
                for (int d = -kR; d <= kR; ++d) {
                    const int cx = lx + d;
                    const int gx = x0 + cx;
                    if (cx < 0 || cx >= kSW) continue;  // tile edge: outside the core's reach
                    const uint8_t v = (row_in && gx >= 0 && gx < W) ? a[ly][cx] : ident;
                    acc = op(acc, v, erode);
                }
                t[ly][lx] = acc;
            }
        }
        __syncthreads();
        // columns
        for (int ly = threadIdx.y; ly < kSH; ly += kBlockY) {
            for (int lx = threadIdx.x; lx < kSW; lx += kBlockX) {
                uint8_t acc = ident;
                for (int d = -kR; d <= kR; ++d) {
                    const int cy = ly + d;
                    if (cy < 0 || cy >= kSH) continue;
                    acc = op(acc, t[cy][lx], erode);
                }
                a[ly][lx] = acc;
            }
        }
        __syncthreads();
    }

    for (int ly = kHalo + threadIdx.y; ly < kHalo + kTileH; ly += kBlockY) {
        const int gy = y0 + ly;
        if (gy >= H) break;
        for (int lx = kHalo + threadIdx.x; lx < kHalo + kTileW; lx += kBlockX) {
            const int gx = x0 + lx;
            if (gx < W) dst[static_cast<size_t>(gy) * W + gx] = a[ly][lx];
        }
    }
}

}  // namespace

extern "C" {

// in/out: uint8 [B, H, W]; stage s erodes if bit s of stage_bits is set,
// else dilates. Returns 0 or the CUDA error of the launch.
int morph_fused(const void* in, void* out, int B, int H, int W,
                unsigned stage_bits, int n_stages, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    const dim3 block(kBlockX, kBlockY);
    const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
    fused_morph_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), H, W,
        stage_bits, n_stages);
    return cudaGetLastError();
}

const char* morph_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
