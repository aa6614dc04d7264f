// Greedy min-distance keypoint selection for any K (Hopper, sm_90a).
//
// Replaces the spacing fixpoint of the JAX package's detect_describe
// (cuauv_vision_pipeline_tpu/ops/feature.py:618-656), which XLA runs as a
// lax.while_loop inside the jitted graph. In eager torch each round of that
// loop would end in a host read of torch.any(...): a device-to-host sync in
// the middle of the bins chain, repeated a data-dependent number of times.
// Here the whole selection is two launches and never syncs.
//
// Input: K candidates, strongest first (ys, xs int32, cand bool). Output:
// kept[i] iff cand[i] and no kept j < i lies closer than min_distance
// (dy^2 + dx^2 < min_d2) -- exactly the sequential greedy set. Integer
// arithmetic throughout (64-bit squares), so the result is exact.
//
// 1. spacing_conflicts_kernel fills the conflict matrix as bit rows -- bit j
//    of row i set iff j < i, cand[j] and the two are too close -- in a
//    caller's scratch of words * K uint32 (K^2 / 8 bytes: 32 KB at K = 512,
//    2 MB at K = 4096, L2-resident), word-major (conf[w * K + i]) so a warp
//    reads consecutive words. A grid of one thread per (row, word) pair,
//    at most 32 distance tests each.
// 2. spacing_fixpoint_kernel runs the fixpoint of the JAX loop on bitsets,
//    in one block of up to 1024 threads, each owning ceil(K / 1024)
//    candidates, with the kept/dead bitsets in shared memory (K / 4 bytes):
//    each round keeps every undecided candidate none of whose stronger
//    conflicts is still alive (kept or undecided), then kills every
//    undecided candidate with a kept stronger conflict; __syncthreads_or
//    ends the loop when none is left undecided. Each round decides at least
//    the strongest undecided candidate, and in practice most of them
//    (rounds = depth of the conflict chains, a handful).
//
// Bound on this card: the distance tests the greedy set needs (each
// candidate against the kept stronger ones, 6 integer ops) and the bytes (9 B
// per candidate read, 1 B written) take well under a microsecond at K = 512;
// the kernel's time is the two launches and a few block barriers per round,
// on one SM for the fixpoint.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kFillThreads = 256;

// One thread per (row i, word w <= i / 32): word w of row i's conflict bits.
__global__ void __launch_bounds__(kFillThreads)
spacing_conflicts_kernel(const int* __restrict__ ys, const int* __restrict__ xs,
                         const uint8_t* __restrict__ cand, uint32_t* __restrict__ conf, int K,
                         long long min_d2) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const int w = blockIdx.y;
    if (i >= K || w > (i >> 5)) return;
    const long long yi = ys[i], xi = xs[i];
    const int j0 = w << 5;
    const int j1 = min(j0 + 32, i);
    uint32_t bits = 0;
    for (int j = j0; j < j1; ++j) {
        const long long dy = yi - ys[j], dx = xi - xs[j];
        if (cand[j] && dy * dy + dx * dx < min_d2) bits |= 1u << (j - j0);
    }
    conf[static_cast<size_t>(w) * K + i] = bits;
}

// The keep/kill rounds over conf, kept/dead bitsets in shared memory (dead
// holding the non-candidates and the bits past K on entry); then kept out.
__global__ void __launch_bounds__(kThreads)
spacing_fixpoint_kernel(const uint8_t* __restrict__ cand, const uint32_t* __restrict__ conf,
                        uint8_t* __restrict__ kept_out, int K) {
    extern __shared__ uint32_t smem[];
    const int words = (K + 31) >> 5;
    uint32_t* kept = smem;          // [words]
    uint32_t* dead = smem + words;  // [words]: not a candidate, or killed
    const int tid = threadIdx.x, nt = blockDim.x;
    const size_t stride = K;
    for (int w = tid; w < words; w += nt) {
        uint32_t not_cand = 0;
        for (int b = 0; b < 32; ++b) {
            const int j = (w << 5) + b;
            if (j >= K || !cand[j]) not_cand |= 1u << b;
        }
        kept[w] = 0;
        dead[w] = not_cand;
    }
    __syncthreads();
    bool more = true;
    while (more) {
        // keep: an undecided candidate with no alive stronger conflict
        for (int i = tid; i < K; i += nt) {
            const int wi = i >> 5;
            const uint32_t bit = 1u << (i & 31);
            if ((kept[wi] | dead[wi]) & bit) continue;
            uint32_t alive = 0;
            for (int w = 0; w <= wi; ++w) alive |= conf[w * stride + i] & ~dead[w];
            if (!alive) atomicOr(&kept[wi], bit);
        }
        __syncthreads();
        // kill: an undecided candidate with a kept stronger conflict
        int undecided = 0;
        for (int i = tid; i < K; i += nt) {
            const int wi = i >> 5;
            const uint32_t bit = 1u << (i & 31);
            if ((kept[wi] | dead[wi]) & bit) continue;
            uint32_t hit = 0;
            for (int w = 0; w <= wi; ++w) hit |= conf[w * stride + i] & kept[w];
            if (hit) {
                atomicOr(&dead[wi], bit);
            } else {
                undecided = 1;
            }
        }
        more = __syncthreads_or(undecided) != 0;
    }
    for (int i = tid; i < K; i += nt) kept_out[i] = (kept[i >> 5] >> (i & 31)) & 1u;
}

}  // namespace

extern "C" {

// ys, xs int32 [K], cand u8 [K] (0/1); writes kept u8 [K] (0/1). scratch:
// ceil(K / 32) * K uint32 words of device memory. K >= 1. Returns 0 or the
// CUDA error of the launches.
int spacing_select(const void* ys, const void* xs, const void* cand, void* kept, void* scratch,
                   int K, long long min_d2, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    const int words = K < 1 ? 0 : (K + 31) >> 5;
    if (words == 0 || words > 65535 || scratch == nullptr) return cudaErrorInvalidValue;  // grid.y
    const auto s = static_cast<cudaStream_t>(stream);
    const uint8_t* c = static_cast<const uint8_t*>(cand);
    uint32_t* conf = static_cast<uint32_t*>(scratch);
    const dim3 grid((K + kFillThreads - 1) / kFillThreads, words);
    spacing_conflicts_kernel<<<grid, kFillThreads, 0, s>>>(
        static_cast<const int*>(ys), static_cast<const int*>(xs), c, conf, K, min_d2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const size_t smem = 2 * static_cast<size_t>(words) * sizeof(uint32_t);
    if (smem > 48 * 1024) {  // K past 196,608
        err = cudaFuncSetAttribute(spacing_fixpoint_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
        if (err != cudaSuccess) return err;
    }
    const int threads = K < kThreads ? words * 32 : kThreads;
    spacing_fixpoint_kernel<<<1, threads, smem, s>>>(c, conf, static_cast<uint8_t*>(kept), K);
    return cudaGetLastError();
}

const char* spacing_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
