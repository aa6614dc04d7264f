// Fused 5x5-rect morphology in one pass over the mask (sm_90a).
//
// Replaces the Pallas kernel
// cuauv_vision_pipeline_tpu/ops/pallas/morph_kernel.py:fused_morph: up to
// four erode/dilate stages (open_close = erode, dilate, dilate, erode) on a
// u8 image of any values, with one read and one write of device memory. Each
// stage sees cells outside the image as its identity (255 for erode, 0 for
// dilate: cv2 BORDER_CONSTANT, as the composed calls re-pad per op).
//
// Design: registers and warp shuffles only, no shared memory, no barrier.
//   - A block is one warp; it owns a strip 128 px wide and kRows output
//     rows. Each lane holds 4 adjacent pixels of a row as two u16x2 words,
//     (p0, p1) and (p2, p3), so a three-input min/max of packed pixels is
//     one Hopper DPX instruction (__vimin3_u16x2 / __vimax3_u16x2, one
//     VIMNMX3.U16x2 in the SASS). The u8x4 form, one word of 4 pixels, needs
//     __vminu4, which sm_90a emulates in several integer instructions.
//   - Rows: the two words' 5-tap windows share their middle three taps, so
//     4 pixels take 3 DPX ops, 3 funnel shifts and 2 shuffles (the
//     neighbour lanes' edge words). Columns: a lane holds its rows in
//     registers, and two output rows share their middle three rows, so 4
//     pixels take 3 DPX ops per output row.
//   - The halo shrinks: a lane loads kRows + 4 * stages rows, and stage s
//     works only on the rows its successors need, 2 fewer above and below
//     per stage. Horizontally the warp's outer lanes (2 per side for four
//     stages) are the halo and are not written.
//   - Out-of-image cells are set to the stage's identity before each stage,
//     only in warps whose loaded rows or columns leave the image (a branch
//     that is the same for the whole warp); interior warps run with no
//     bounds test at all.
//   - Global traffic: one 4-byte load per lane and row (a warp reads one
//     128-byte line per row) and one 4-byte store; byte loads and stores
//     where W % 4 != 0 or a pointer is not 4-byte aligned. A lane's loads
//     are independent of each other, so all of them can be in flight.
//   - 16 rows per warp: at 1080p the grid is 18 x 68 single-warp blocks,
//     ~9 per SM, so the SMs' loads even out; 32 rows halve the row halo but
//     leave ~4.6 warps per SM and twice the registers.
// Bound: bytes. 1 B read + 1 B written per pixel, 4.15 MB at 1080p (1.24 us
// at 3.35 TB/s). The least integer work is one packed 5-tap op per pixel and
// pass: 2 passes x 4 stages = 8 ops per pixel, 0.5 us at the INT32 rate.
// The halo costs 128/112 of the core in columns and (kRows + 16) / kRows in
// rows, in loads and in work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 16;   // output rows per warp (a block is one warp)
constexpr int kLaneW = 4;   // pixels per lane
constexpr int kWarpW = 32 * kLaneW;
constexpr unsigned kAll = 0xffffffffu;

// pixels p0..p3 of a lane <-> words a = (p0, p1), b = (p2, p3)
__device__ __forceinline__ void unpack(uint32_t v, uint32_t& a, uint32_t& b) {
    a = __byte_perm(v, 0, 0x4140);
    b = __byte_perm(v, 0, 0x4342);
}

__device__ __forceinline__ uint32_t pack(uint32_t a, uint32_t b) {
    return __byte_perm(a, b, 0x6420);
}

template <bool Erode>
__device__ __forceinline__ uint32_t op3(uint32_t a, uint32_t b, uint32_t c) {
    return Erode ? __vimin3_u16x2(a, b, c) : __vimax3_u16x2(a, b, c);
}

template <bool Erode>
__device__ __forceinline__ uint32_t identity() {
    return Erode ? 0x00ff00ffu : 0u;
}

// One 5x5 stage on rows [0, N) of a, b (row i is image row y_top + i); on
// return rows [0, N - 4) hold the stage's output for image rows y_top + 2 + i.
template <bool Erode, int N, int M>
__device__ __forceinline__ void run_stage(uint32_t (&a)[M], uint32_t (&b)[M], bool edge,
                                          int y_top, int H, uint32_t keep_a,
                                          uint32_t keep_b) {
    static_assert(N <= M && N > 4, "stage rows");
    const uint32_t id = identity<Erode>();
    if (edge) {
#pragma unroll
        for (int i = 0; i < N; ++i) {
            const int y = y_top + i;
            const bool row_in = y >= 0 && y < H;
            a[i] = row_in ? (a[i] & keep_a) | (id & ~keep_a) : id;
            b[i] = row_in ? (b[i] & keep_b) | (id & ~keep_b) : id;
        }
    }
    // rows: the taps of p0..p3 at -2..+2 are the words (p-2, p-1), (p-1, p0),
    // a, (p1, p2), b, (p3, p4), (p4, p5); the middle three are shared
#pragma unroll
    for (int i = 0; i < N; ++i) {
        const uint32_t left = __shfl_up_sync(kAll, b[i], 1);     // (p-2, p-1)
        const uint32_t right = __shfl_down_sync(kAll, a[i], 1);  // (p4, p5)
        const uint32_t mid = op3<Erode>(a[i], __funnelshift_r(a[i], b[i], 16), b[i]);
        a[i] = op3<Erode>(left, __funnelshift_r(left, a[i], 16), mid);
        b[i] = op3<Erode>(mid, __funnelshift_r(b[i], right, 16), right);
    }
    // columns, two output rows at a time: rows i+1..i+3 are shared
    static_assert(N % 2 == 0, "pairs of rows");
#pragma unroll
    for (int i = 0; i + 4 < N; i += 2) {
        const uint32_t mid_a = op3<Erode>(a[i + 1], a[i + 2], a[i + 3]);
        const uint32_t mid_b = op3<Erode>(b[i + 1], b[i + 2], b[i + 3]);
        a[i] = op3<Erode>(a[i], mid_a, a[i + 4]);
        b[i] = op3<Erode>(b[i], mid_b, b[i + 4]);
        a[i + 1] = op3<Erode>(mid_a, a[i + 4], a[i + 5]);
        b[i + 1] = op3<Erode>(mid_b, b[i + 4], b[i + 5]);
    }
}

// Aligned: W and x are multiples of 4, so a lane's pixels are all in the
// image or all out of it (check: the warp may reach outside the image).
template <bool Aligned>
__device__ __forceinline__ uint32_t load4(const uint8_t* row, int x, int W, bool check) {
    if (Aligned)
        return !check || (x >= 0 && x < W) ? __ldg(reinterpret_cast<const unsigned*>(row + x)) : 0u;
    uint32_t v = 0;
#pragma unroll
    for (int j = 0; j < kLaneW; ++j)
        if (!check || (x + j >= 0 && x + j < W)) v |= uint32_t(__ldg(row + x + j)) << (8 * j);
    return v;
}

template <bool Aligned>
__device__ __forceinline__ void store4(uint8_t* row, int x, int W, bool check, uint32_t v) {
    if (Aligned) {
        if (!check || x < W) *reinterpret_cast<unsigned*>(row + x) = v;
        return;
    }
#pragma unroll
    for (int j = 0; j < kLaneW; ++j)
        if (!check || x + j < W) row[x + j] = uint8_t(v >> (8 * j));
}

// Stage s erodes if bit s of Bits is set, else dilates.
template <unsigned Bits, int NS, bool Aligned>
__global__ void __launch_bounds__(32)
morph_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int H, int W) {
    constexpr int kHalo = 2 * NS;  // 2 px per 5x5 stage
    constexpr int kIn = kRows + 2 * kHalo;
    constexpr int kCoreW = kWarpW - 2 * kHalo;
    constexpr int kHaloLanes = kHalo / kLaneW;
    static_assert(kHalo % kLaneW == 0, "the halo is whole lanes");

    const int lane = threadIdx.x;
    const int y0 = blockIdx.y * kRows;  // first output row
    const int xw = blockIdx.x * kCoreW - kHalo;  // the warp's first column
    const int x = xw + kLaneW * lane;
    const size_t plane = static_cast<size_t>(H) * W;
    const uint8_t* src = in + blockIdx.z * plane;
    uint8_t* dst = out + blockIdx.z * plane;
    const bool edge = y0 < kHalo || y0 + kRows + kHalo > H || xw < 0 || xw + kWarpW > W;

    uint32_t a[kIn], b[kIn];
#pragma unroll
    for (int i = 0; i < kIn; ++i) {
        const int y = y0 - kHalo + i;
        uint32_t v = 0;
        if (!edge || (y >= 0 && y < H))
            v = load4<Aligned>(src + static_cast<size_t>(y) * W, x, W, edge);
        unpack(v, a[i], b[i]);
    }

    // per-pixel in-image masks of this lane's two words (edge warps only)
    uint32_t keep_a = 0, keep_b = 0;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        keep_a |= (x + j >= 0 && x + j < W) ? 0xffffu << (16 * j) : 0u;
        keep_b |= (x + 2 + j >= 0 && x + 2 + j < W) ? 0xffffu << (16 * j) : 0u;
    }

    const int y_top = y0 - kHalo;
    run_stage<(Bits & 1u) != 0, kIn>(a, b, edge, y_top, H, keep_a, keep_b);
    if constexpr (NS > 1)
        run_stage<(Bits & 2u) != 0, kIn - 4>(a, b, edge, y_top + 2, H, keep_a, keep_b);
    if constexpr (NS > 2)
        run_stage<(Bits & 4u) != 0, kIn - 8>(a, b, edge, y_top + 4, H, keep_a, keep_b);
    if constexpr (NS > 3)
        run_stage<(Bits & 8u) != 0, kIn - 12>(a, b, edge, y_top + 6, H, keep_a, keep_b);

    if (lane < kHaloLanes || lane >= 32 - kHaloLanes) return;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
        const int y = y0 + i;
        if (edge && y >= H) break;
        store4<Aligned>(dst + static_cast<size_t>(y) * W, x, W, edge, pack(a[i], b[i]));
    }
}

template <unsigned Bits, int NS>
cudaError_t launch(const uint8_t* in, uint8_t* out, int B, int H, int W, cudaStream_t stream) {
    constexpr int kCoreW = kWarpW - 4 * NS;
    const dim3 grid((W + kCoreW - 1) / kCoreW, (H + kRows - 1) / kRows, B);
    const bool aligned = W % kLaneW == 0 && reinterpret_cast<uintptr_t>(in) % kLaneW == 0 &&
                         reinterpret_cast<uintptr_t>(out) % kLaneW == 0;
    if (aligned)
        morph_kernel<Bits, NS, true><<<grid, 32, 0, stream>>>(in, out, H, W);
    else
        morph_kernel<Bits, NS, false><<<grid, 32, 0, stream>>>(in, out, H, W);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// in/out: uint8 [B, H, W]; stage s erodes if bit s of stage_bits is set,
// else dilates: open_close = (0b1001, 4), open = (0b01, 2), close = (0b10, 2).
// Returns 0 or the CUDA error of the launch.
int morph_fused(const void* in, void* out, int B, int H, int W, unsigned stage_bits,
                int n_stages, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    const auto* src = static_cast<const uint8_t*>(in);
    auto* dst = static_cast<uint8_t*>(out);
    const auto s = static_cast<cudaStream_t>(stream);
    if (n_stages == 4 && stage_bits == 0b1001u) return launch<0b1001u, 4>(src, dst, B, H, W, s);
    if (n_stages == 2 && stage_bits == 0b01u) return launch<0b01u, 2>(src, dst, B, H, W, s);
    if (n_stages == 2 && stage_bits == 0b10u) return launch<0b10u, 2>(src, dst, B, H, W, s);
    return cudaErrorInvalidValue;
}

const char* morph_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
