// Greedy fixed-budget NMS, one thread block per image (Hopper, sm_90a).
//
// Replaces the NMS loop of the JAX package's decode
// (cuauv_vision_pipeline_tpu/models/yolo/decode.py:150-206 nms_fixed), which
// XLA runs as one lax.fori_loop of max_det rounds inside the jitted graph.
// Eager torch would spend ~15 small launches on each round; here the whole
// loop is one launch for a batch of images.
//
// Per image, in one block: a prologue turns each candidate's box (and angle)
// into its IoU terms -- for ProbIoU the center, the covariance a, b, c and
// sqrt(max(ab - c^2, 0)); for AABB IoU the corners and the area -- into a
// [6, P] scratch row in device memory, and copies the scores into shared
// memory (the alive scores). Then each round is a block-wide argmax of the
// alive scores (warp shuffles, then one warp over the warps' winners; equal
// scores go to the lowest index, as jnp.argmax does). A best score <= 0 ends
// the picks. Otherwise every thread zeroes its alive candidates of the best
// one's class (any class when class_aware is 0) whose IoU with it is >=
// iou_thresh, and the best one itself. Threads stride over the candidates,
// so any pool size P runs (P = 512 by default, the anchor count when the
// pool is disabled).
//
// Float semantics: the arithmetic is the plain version's
// (ops/cuda/nms_kernel.py _nms_geometry, _probiou_rows, _aabb_rows), operation
// for operation and in the same order, with torch's NaN rules for max/min
// and clamp. Built with --fmad=false (ops/cuda/_build.py), so no product is
// contracted into an FMA; an IoU near the threshold then compares exactly
// as in the plain version on the card.
//
// Bound on this card: neither bytes (the pool is read once, ~14 KB at
// P = 512) nor operations (~40 per candidate and round), but the chain of
// max_det dependent rounds, each two block barriers and two reductions.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr float kEps = static_cast<float>(1e-7);
constexpr float kInv12 = static_cast<float>(1.0 / 12.0);
constexpr float kMinUnion = static_cast<float>(1e-9);
constexpr int kMaxThreads = 1024;

// torch.maximum / torch.minimum / torch.clamp: NaN in, NaN out
__device__ __forceinline__ float t_max(float a, float b) {
    return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float t_min(float a, float b) {
    return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float t_clamp(float v, float lo, float hi) {
    return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// (s, j) beats (os, oj): higher score, or the same score at a lower index
__device__ __forceinline__ void take_better(float& s, int& j, float os, int oj) {
    if (os > s || (os == s && oj < j)) {
        s = os;
        j = oj;
    }
}

__device__ __forceinline__ void warp_argmax(float& s, int& j) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const float os = __shfl_down_sync(0xffffffffu, s, off);
        const int oj = __shfl_down_sync(0xffffffffu, j, off);
        take_better(s, j, os, oj);
    }
}

template <bool Rotated>
__device__ __forceinline__ float iou(const float* g, int P, int j, float kx, float ky, float ka,
                                     float kb, float kc, float kr) {
    if (Rotated) {
        const float x2 = g[j], y2 = g[P + j], a2 = g[2 * P + j], b2 = g[3 * P + j];
        const float c2 = g[4 * P + j], r2 = g[5 * P + j];
        const float sa = ka + a2, sb = kb + b2, sc = kc + c2;
        const float dx = kx - x2, dy = ky - y2;
        const float det = sa * sb - sc * sc;
        const float denom = det + kEps;
        const float t1 = (sa * (dy * dy) + sb * (dx * dx)) / denom * 0.25f;
        const float t2 = sc * (x2 - kx) * dy / denom * 0.5f;
        const float t3 = 0.5f * logf(det / (4.0f * kr * r2 + kEps) + kEps);
        const float bd = t_clamp(t1 + t2 + t3, kEps, 100.0f);
        return 1.0f - sqrtf(1.0f - expf(-bd) + kEps);
    }
    const float x1 = t_max(kx, g[j]), y1 = t_max(ky, g[P + j]);
    const float x2 = t_min(ka, g[2 * P + j]), y2 = t_min(kb, g[3 * P + j]);
    const float inter = t_max(x2 - x1, 0.0f) * t_max(y2 - y1, 0.0f);
    return inter / t_max(kc + g[4 * P + j] - inter, kMinUnion);
}

template <bool Rotated>
__global__ void __launch_bounds__(kMaxThreads)
nms_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
           const int* __restrict__ classes, const float* __restrict__ angles,
           float* __restrict__ geom, int* __restrict__ picked, uint8_t* __restrict__ valid,
           int P, int max_det, float iou_thresh, int class_aware) {
    extern __shared__ float alive[];  // [P]
    __shared__ float warp_s[32];
    __shared__ int warp_j[32];
    __shared__ float best_s;
    __shared__ int best_j;

    const int img = blockIdx.x;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nwarps = blockDim.x >> 5;
    boxes += static_cast<size_t>(img) * P * 4;
    scores += static_cast<size_t>(img) * P;
    classes += static_cast<size_t>(img) * P;
    float* g = geom + static_cast<size_t>(img) * 6 * P;
    picked += static_cast<size_t>(img) * max_det;
    valid += static_cast<size_t>(img) * max_det;

    for (int j = tid; j < P; j += blockDim.x) {
        const float x1 = boxes[4 * j], y1 = boxes[4 * j + 1];
        const float x2 = boxes[4 * j + 2], y2 = boxes[4 * j + 3];
        if (Rotated) {
            const float w = x2 - x1, h = y2 - y1;
            const float w2 = w * w * kInv12, h2 = h * h * kInv12;
            const float t = angles[static_cast<size_t>(img) * P + j];
            const float c = cosf(t), s = sinf(t);
            const float a = w2 * c * c + h2 * s * s;
            const float b = w2 * s * s + h2 * c * c;
            const float cc = (w2 - h2) * c * s;
            g[j] = (x1 + x2) * 0.5f;
            g[P + j] = (y1 + y2) * 0.5f;
            g[2 * P + j] = a;
            g[3 * P + j] = b;
            g[4 * P + j] = cc;
            g[5 * P + j] = sqrtf(t_max(a * b - cc * cc, 0.0f));
        } else {
            g[j] = x1;
            g[P + j] = y1;
            g[2 * P + j] = x2;
            g[3 * P + j] = y2;
            g[4 * P + j] = t_max(x2 - x1, 0.0f) * t_max(y2 - y1, 0.0f);
            g[5 * P + j] = 0.0f;
        }
        alive[j] = scores[j];
    }
    __syncthreads();

    int r = 0;
    for (; r < max_det; ++r) {
        float s = -INFINITY;
        int j = INT_MAX;
        for (int i = tid; i < P; i += blockDim.x) take_better(s, j, alive[i], i);
        warp_argmax(s, j);
        if (lane == 0) {
            warp_s[warp] = s;
            warp_j[warp] = j;
        }
        __syncthreads();
        if (warp == 0) {
            s = lane < nwarps ? warp_s[lane] : -INFINITY;
            j = lane < nwarps ? warp_j[lane] : INT_MAX;
            warp_argmax(s, j);
            if (lane == 0) {
                best_s = s;
                best_j = j;
            }
        }
        __syncthreads();
        const int k = best_j;
        if (!(best_s > 0.0f)) break;  // block-uniform
        if (tid == 0) {
            picked[r] = k;
            valid[r] = 1;
        }
        const float kx = g[k], ky = g[P + k], ka = g[2 * P + k], kb = g[3 * P + k];
        const float kc = g[4 * P + k], kr = g[5 * P + k];
        const int kcls = classes[k];
        for (int i = tid; i < P; i += blockDim.x) {
            if (!(alive[i] > 0.0f)) continue;  // zeroing it changes no later pick
            if (i == k) {
                alive[i] = 0.0f;
            } else if ((!class_aware || classes[i] == kcls) &&
                       iou<Rotated>(g, P, i, kx, ky, ka, kb, kc, kr) >= iou_thresh) {
                alive[i] = 0.0f;
            }
        }
        __syncthreads();
    }
    for (int i = r + tid; i < max_det; i += blockDim.x) {
        picked[i] = -1;
        valid[i] = 0;
    }
}

}  // namespace

extern "C" {

// boxes [B, P, 4] xyxy, scores [B, P], classes i32 [B, P], angles [B, P] or
// null (AABB IoU), geom scratch [B, 6, P]; writes picked i32 [B, max_det]
// and valid u8 [B, max_det]. Returns 0 or the CUDA error of the launch.
int nms_fixed(const void* boxes, const void* scores, const void* classes, const void* angles,
              void* geom, void* picked, void* valid, int B, int P, int max_det,
              float iou_thresh, int class_aware, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (B < 1 || P < 1 || max_det < 1) return cudaErrorInvalidValue;
    int threads = (P + 31) / 32 * 32;
    threads = threads > kMaxThreads ? kMaxThreads : threads;
    const size_t smem = static_cast<size_t>(P) * sizeof(float);
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* bx = static_cast<const float*>(boxes);
    const auto* sc = static_cast<const float*>(scores);
    const auto* cl = static_cast<const int*>(classes);
    auto* g = static_cast<float*>(geom);
    auto* pk = static_cast<int*>(picked);
    auto* vd = static_cast<uint8_t*>(valid);
    if (angles != nullptr) {
        if (smem > 48 * 1024) {
            err = cudaFuncSetAttribute(nms_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
            if (err != cudaSuccess) return err;
        }
        nms_kernel<true><<<B, threads, smem, s>>>(bx, sc, cl, static_cast<const float*>(angles), g,
                                                 pk, vd, P, max_det, iou_thresh, class_aware);
    } else {
        if (smem > 48 * 1024) {
            err = cudaFuncSetAttribute(nms_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
            if (err != cudaSuccess) return err;
        }
        nms_kernel<false><<<B, threads, smem, s>>>(bx, sc, cl, nullptr, g, pk, vd, P, max_det,
                                                  iou_thresh, class_aware);
    }
    return cudaGetLastError();
}

const char* nms_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
